"""The port's ZUTIS in its RN and DINO encoder families against the JAX
package's (zutis_tpu/models/zutis.py), in f32 at the parity harness's rtol
2e-4 / atol 2e-5, at the JAX tests' tiny configurations
(tests/test_checkpoint_families.py, tests/test_trainer_batched_eval.py,
tests/test_models_parity.py):

  * `forward`, with and without `inference`, both outputs: RN upsampled
    (its attnpool the text-space projection), RN without the upsample (the
    `dilatedRN*` archs) at an odd input size, DINO (vision_to_text_ffn
    before the upsample, no projection after);
  * the weights both ways: a JAX tree through `params_from_jax`; the
    port's `export_params` (the raw flax tree under `__flax_raw__/`, as the
    JAX `export_zutis` writes it, key for key) read by the JAX
    `load_params_any`, and the JAX export read by the port's
    `load_params_any`, each giving the same outputs;
  * a synthetic official-layout DINO checkpoint through
    `load_dino_encoder`, equal to the JAX `convert_dino_encoder`;
  * what the families refuse: `forward_padded`, ToMe, widths that do not
    fit, a DINO or CLIP tower of the other family.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_oracle import TorchDeiTBlock
from zutis_tpu.core.checkpoint import load_params_any as jax_load_params_any
from zutis_tpu.models import weights as jw
from zutis_tpu.models.zutis import ZUTIS as JZUTIS
from zutis_tpu_torch.core.checkpoint import load_params_any
from zutis_tpu_torch.models import factory
from zutis_tpu_torch.models.weights import (FLAX_RAW_PREFIX, export_params,
                                            params_from_jax, params_to_jax)
from zutis_tpu_torch.models.zutis import ZUTIS

RTOL, ATOL = 2e-4, 2e-5
COMMON = dict(n_queries=6, n_decoder_layers=2, n_heads=2)
CFGS = {
    "rn": dict(encoder_family="rn", rn_layers=(1, 1, 1, 1), rn_width=8,
               width=256, text_dim=16, input_resolution=64, **COMMON),
    "dilated rn": dict(encoder_family="rn", rn_layers=(1, 1, 1, 1),
                       rn_width=8, width=256, text_dim=16,
                       input_resolution=64, upsample_tokens=False, **COMMON),
    "dino": dict(encoder_family="dino", width=16, text_dim=16, patch_size=16,
                 input_resolution=32, dino_embed_dim=32, dino_depth=2,
                 dino_heads=2, **COMMON),
}
SHAPES = {"rn": (64, 64), "dilated rn": (97, 71), "dino": (64, 48)}


def seeded_port_model(name, seed=1):
    """The port's model at CFGS[name] with seeded parameters, its
    BatchNorm affine and statistics drawn off the identity by a numpy
    generator (variances in [0.5, 2])."""
    model = ZUTIS(**CFGS[name], device="cpu").init_params(
        torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for key, v in model.state_dict().items():
            if key.endswith("running_var"):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, v.shape)))
            elif ".bn" in key or "downsample.1." in key:
                base = 1.0 if key.endswith("weight") else 0.0
                v.copy_(torch.from_numpy(base + 0.2 * rng.normal(size=v.shape)))
    return model


@functools.lru_cache(maxsize=None)
def jax_model(name, decoder_pool=1):
    """(the flax ZUTIS, a parameter tree for it): the seeded port model's
    through `params_to_jax`, which must have the tree's structure and
    shapes that flax's init gives (traced, not run)."""
    jm = JZUTIS(**CFGS[name], decoder_pool=decoder_pool)
    h, w = SHAPES[name]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3, h, w)))["params"]
    params = params_to_jax(seeded_port_model(name).state_dict())
    assert jax.tree.structure(params) == jax.tree.structure(shapes)
    for got, want in zip(jax.tree.leaves(params), jax.tree.leaves(shapes)):
        assert got.shape == want.shape and got.dtype == np.float32
    return jm, params


@functools.lru_cache(maxsize=None)
def _jitted(jm, inference):
    return jax.jit(lambda p, x: jm.apply({"params": p}, x,
                                         inference=inference))


def jax_forward(jm, params, x, inference=False):
    return _jitted(jm, inference)(params, x)


def port_model(name, params=None):
    model = ZUTIS(**CFGS[name], device="cpu")
    if params is not None:
        model.load_state_dict(params_from_jax(params), strict=True)
    return model


def image(name, b=2, seed=0):
    h, w = SHAPES[name]
    return np.random.default_rng(seed).normal(size=(b, 3, h, w)).astype(
        np.float32)


@pytest.fixture(scope="module", params=list(CFGS))
def family(request):
    jm, params = jax_model(request.param)
    return request.param, jm, params, port_model(request.param, params)


def assert_outputs_equal(got, want):
    for key in ("mask_proposals", "patch_tokens"):
        assert tuple(got[key].shape) == tuple(np.shape(want[key])), key
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)


@pytest.mark.parametrize("inference", [False, True])
def test_forward_equals_jax(family, inference):
    name, jm, params, model = family
    x = image(name)
    want = jax_forward(jm, params, jnp.asarray(x), inference)
    with torch.no_grad():
        got = model(torch.from_numpy(x), inference=inference)
    assert_outputs_equal(got, want)
    grid = {"rn": (4, 4), "dilated rn": (3, 2), "dino": (8, 6)}[name]
    layers = 1 if inference else COMMON["n_decoder_layers"]
    assert got["mask_proposals"].shape == (2, layers, 6, *grid)
    assert got["patch_tokens"].shape == (2, *grid, 16)


def test_forward_on_the_torch_attention_path(family):
    name, jm, params, _ = family
    model = ZUTIS(**CFGS[name], attn_impl="torch", device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    x = image(name, seed=3)
    with torch.no_grad():
        got = model(torch.from_numpy(x), inference=True)
    assert_outputs_equal(got, jax_forward(jm, params, jnp.asarray(x), True))


def test_export_params_is_the_jax_export(family, tmp_path):
    """Key for key and value for value the JAX `export_zutis` of the same
    parameters; read back by the JAX `load_params_any` as the same tree."""
    name, jm, params, model = family
    ours = export_params(model)
    theirs = jw.export_zutis(params)
    assert sorted(ours) == sorted(theirs)
    assert all(k.startswith(FLAX_RAW_PREFIX) for k in ours)
    for k, v in theirs.items():
        assert ours[k].dtype == np.float32, k
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)
    path = str(tmp_path / "final_model.npz")
    np.savez(path, **ours)
    restored = jax_load_params_any(path)
    x = jnp.asarray(image(name, seed=4))
    assert_outputs_equal(
        {k: torch.from_numpy(np.asarray(v)) for k, v in
         jax_forward(jm, restored, x, True).items()},
        jax_forward(jm, params, x, True))


def test_load_params_any_reads_the_jax_export(family, tmp_path):
    name, jm, params, _ = family
    path = str(tmp_path / "final_model.npz")
    np.savez(path, **jw.export_zutis(params))
    model = port_model(name)
    model.load_state_dict(load_params_any(path), strict=True)
    x = image(name, seed=5)
    with torch.no_grad():
        got = model(torch.from_numpy(x), inference=True)
    assert_outputs_equal(got, jax_forward(jm, params, jnp.asarray(x), True))


def test_params_to_jax_inverts_params_from_jax(family):
    name, _, params, model = family
    back = params_to_jax(model.state_dict())
    flat_a = {jax.tree_util.keystr(k): v
              for k, v in jax.tree_util.tree_leaves_with_path(params)}
    flat_b = {jax.tree_util.keystr(k): v
              for k, v in jax.tree_util.tree_leaves_with_path(back)}
    assert sorted(flat_a) == sorted(flat_b)
    for k, v in flat_a.items():
        np.testing.assert_array_equal(flat_b[k], v, err_msg=k)


def _official_dino(path, dim=32, depth=2, grid=2):
    """An official DINO ViT checkpoint's layout (the fused `attn.qkv`, a
    [1, 1 + g*g, d] pos_embed, and a head the encoder does not read)."""
    torch.manual_seed(2)
    sd = {"patch_embed.proj.weight": torch.randn(dim, 3, 16, 16) * 0.05,
          "patch_embed.proj.bias": torch.randn(dim) * 0.1,
          "cls_token": torch.randn(1, 1, dim),
          "pos_embed": torch.randn(1, grid * grid + 1, dim),
          "norm.weight": 1 + 0.1 * torch.randn(dim),
          "norm.bias": 0.1 * torch.randn(dim),
          "head.weight": torch.randn(7, dim)}
    for i in range(depth):
        blk = TorchDeiTBlock(dim, 2)
        sd.update({f"blocks.{i}.{k}": v for k, v in blk.state_dict().items()})
    torch.save(sd, path)


def test_load_dino_encoder_equals_convert_dino_encoder(tmp_path):
    jm, params = jax_model("dino")
    path = tmp_path / "dino_vitbase16_pretrain.pth"
    _official_dino(path)
    enc = jw.convert_dino_encoder(jw.load_torch_state_dict(str(path)))
    params = dict(params, encoder=enc)
    model = port_model("dino", jax_model("dino")[1])  # other weights first
    assert factory.load_dino_encoder(model, str(path)) is model
    want = params_from_jax(params)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    x = image("dino", seed=6)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert_outputs_equal(got, jax_forward(jm, params, jnp.asarray(x)))


def test_loaders_refuse_the_other_family(tmp_path):
    path = tmp_path / "dino.pth"
    _official_dino(path)
    with pytest.raises(ValueError, match="DINO ZUTIS"):
        factory.load_dino_encoder(port_model("rn"), str(path))
    torch.save({"visual.class_embedding": torch.zeros(4)}, tmp_path / "vit.pt")
    with pytest.raises(ValueError, match="vit visual tower"):
        factory.load_clip_visual(port_model("dino"), str(tmp_path / "vit.pt"))


@pytest.mark.parametrize("name", ["rn", "dino"])
def test_forward_padded_is_the_vit_familys(name):
    x = torch.zeros(1, 3, 64, 64)
    with pytest.raises(ValueError, match="RN .overlapping convs. and DINO "
                                         "models evaluate per-image"):
        port_model(name).forward_padded(x, [[4, 4]])


@pytest.mark.parametrize("kw,match", [
    (dict(CFGS["rn"], tome_r=2), "ToMe token merging is implemented for the "
                                 "CLIP ViT encoder family only"),
    (dict(CFGS["rn"], width=128), "width must be rn_width\\*32=256"),
    (dict(CFGS["dino"], width=32), "width must equal text_dim=16"),
    (dict(CFGS["rn"], encoder_family="convnext"), "encoder_family"),
])
def test_family_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        ZUTIS(**kw, device="cpu")


def test_decoder_pool_applies_to_every_family():
    for name in ("rn", "dino"):
        _, params = jax_model(name)
        jm = JZUTIS(**CFGS[name], decoder_pool=2)
        model = ZUTIS(**CFGS[name], decoder_pool=2, device="cpu")
        model.load_state_dict(params_from_jax(params), strict=True)
        x = image(name, seed=7)
        with torch.no_grad():
            got = model(torch.from_numpy(x), inference=True)
        assert_outputs_equal(got, jax_forward(jm, params, jnp.asarray(x), True))
