"""The port's SelfMask (zutis_tpu_torch/models/selfmask.py) against the JAX
package's flax module (zutis_tpu/models/selfmask.py), through the weights
bridge, in f32 at rtol 2e-4, atol 2e-5, at the JAX tests' tiny config
(embed 32, 2 heads, 1-2 layers, stored grid 4, patch 8):

  * `forward`'s mask_pred and objectness at the stored grid and at sizes
    that are neither it nor patch multiples (padded by
    `pad_to_patch_multiple`), on the kernel and "torch" attention paths;
  * `best_masks` equal, a pixel that differs only where the JAX
    probability lies within atol of 0.5 being reported;
  * `interpolate_pos_embed_exact` against the JAX one (the identity at the
    stored grid);
  * the reference checkpoint layout: a `tests/torch_oracle.py::
    TorchSelfMask` state dict saved as a `.pt` goes through the port's
    `load_selfmask` and through `convert_selfmask_checkpoint`, and the two
    models give the same outputs; wrapped checkpoints, extra keys and a
    missing key.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_oracle import TorchSelfMask
from zutis_tpu.models.selfmask import SelfMask as JaxSelfMask
from zutis_tpu.models.selfmask import convert_selfmask_checkpoint
from zutis_tpu.models.selfmask import pad_to_patch_multiple as jax_pad
from zutis_tpu.models.vit import interpolate_pos_embed_exact as jax_interp
from zutis_tpu_torch.models.selfmask import SelfMask, pad_to_patch_multiple
from zutis_tpu_torch.models.vit import interpolate_pos_embed_exact
from zutis_tpu_torch.models.weights import (load_selfmask,
                                            selfmask_params_from_jax,
                                            selfmask_reference_state_dict)

RTOL, ATOL = 2e-4, 2e-5
TINY = dict(n_queries=5, patch_size=8, n_decoder_layers=2, embed_dim=32,
            heads=2, base_grid=4, depth=2)


@pytest.fixture(scope="module")
def pair():
    jm = JaxSelfMask(**TINY)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))["params"])
    ours = SelfMask(**TINY, device="cpu")
    ours.load_state_dict(selfmask_params_from_jax(params), strict=True)
    return jm, params, ours


def _input(seed, b, h, w):
    x = np.random.default_rng(seed).normal(size=(b, 3, h, w))
    return pad_to_patch_multiple(x.astype(np.float32), 8)


@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("h,w", [(32, 32), (29, 35), (45, 61), (64, 24)])
def test_forward_equals_jax(pair, h, w, impl):
    jm, params, ours = pair
    x = _input(h * w, 2, h, w)
    np.testing.assert_array_equal(x, jax_pad(x.copy()[..., :h, :w], 8))
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    for m in ours.modules():
        if hasattr(m, "attn_impl"):
            m.attn_impl = impl
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    hh, ww = x.shape[-2] // 8 * 2, x.shape[-1] // 8 * 2
    assert got["mask_pred"].shape == (2, TINY["n_queries"], hh, ww)
    for key in ("mask_pred", "objectness"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("h,w", [(32, 32), (29, 35), (45, 61)])
def test_best_masks_equal_jax(pair, h, w):
    jm, params, ours = pair
    xp = _input(7 + h, 2, h, w)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, method=JaxSelfMask.best_masks))(params,
                                                           jnp.asarray(xp)))
    with torch.no_grad():
        got = ours.best_masks(torch.from_numpy(xp)).numpy()
        out = ours(torch.from_numpy(xp))
    assert got.dtype == np.uint8
    assert got.shape == want.shape == xp.shape[:1] + xp.shape[2:]
    # the probabilities of the chosen query, to tell a near-tie from a fault
    up = torch.nn.functional.interpolate(out["mask_pred"], scale_factor=4,
                                         mode="bilinear")[..., :xp.shape[2],
                                                          :xp.shape[3]]
    best = out["objectness"].argmax(1)
    prob = up[torch.arange(2), best].numpy()
    differ = got != want
    if differ.any():
        print(f"best_masks: {int(differ.sum())} pixels differ, all within "
              f"{np.abs(prob[differ] - 0.5).max():.2e} of 0.5")
    assert (np.abs(prob[differ] - 0.5) <= ATOL).all()
    assert differ.mean() < 1e-3


@pytest.mark.parametrize("size", [(4, 4), (5, 7), (3, 9), (86, 64)])
def test_interpolate_pos_embed_exact_equals_jax(size):
    pe = np.random.default_rng(1).normal(size=(17, 24)).astype(np.float32)
    got = interpolate_pos_embed_exact(torch.from_numpy(pe), size).numpy()
    want = np.asarray(jax_interp(jnp.asarray(pe), size))
    assert got.shape == (1 + size[0] * size[1], 24)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if size == (4, 4):
        np.testing.assert_array_equal(got, pe)


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    torch.manual_seed(0)
    oracle = TorchSelfMask(dim=32, heads=2, depth=2, patch=8, grid=4,
                           n_queries=5, dec_layers=2).eval()
    sd = oracle.state_dict()
    path = tmp_path_factory.mktemp("selfmask") / "selfmask_nq20.pt"
    torch.save(sd, path)
    return path, sd


def test_reference_layout_loads_as_the_jax_converter_reads_it(
        reference_checkpoint):
    path, sd = reference_checkpoint
    ours = load_selfmask(str(path), device="cpu", heads=2)
    assert (ours.n_queries, ours.patch_size, ours.embed_dim) == (5, 8, 32)
    assert len(ours.encoder.blocks) == 2 and len(ours.decoder.layers) == 2
    jm = JaxSelfMask(**TINY)
    params = convert_selfmask_checkpoint(sd)
    for h, w in [(32, 32), (37, 43)]:
        xp = _input(h, 1, h, w)
        want = jax.jit(jm.apply)({"params": params}, jnp.asarray(xp))
        with torch.no_grad():
            got = ours(torch.from_numpy(xp))
        for key in ("mask_pred", "objectness"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), rtol=RTOL,
                                       atol=ATOL, err_msg=key)
    # the fused qkv lands in in_proj_weight in its q, k, v order
    np.testing.assert_array_equal(
        ours.encoder.blocks[1].attn.in_proj_weight.detach().numpy(),
        sd["encoder.blocks.1.attn.qkv.weight"].numpy())


def test_loader_unwraps_ignores_extras_and_refuses_a_missing_key(
        reference_checkpoint, tmp_path):
    path, sd = reference_checkpoint
    want = load_selfmask(str(path), device="cpu", heads=2).state_dict()
    wrapped = tmp_path / "wrapped.pt"
    torch.save({"state_dict": {**sd, "encoder.head.weight": torch.ones(3)},
                "epoch": 7}, wrapped)
    got = load_selfmask(str(wrapped), device="cpu", heads=2).state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    missing = tmp_path / "missing.pt"
    torch.save({k: v for k, v in sd.items() if k != "ffn.layers.1.bias"},
               missing)
    with pytest.raises(RuntimeError, match="ffn.layers.1.bias"):
        load_selfmask(str(missing), device="cpu", heads=2)


def test_default_architecture_is_deit_s8_with_20_queries(tmp_path):
    """The reference's shapes read back as DeiT-S/8 (6 heads), 20 queries,
    6 decoder layers; init_params is the same on every call."""
    model = SelfMask(device="cpu").init_params(
        torch.Generator().manual_seed(3))
    path = tmp_path / "selfmask_nq20.pt"
    sd = selfmask_reference_state_dict(model)
    assert "encoder.blocks.11.attn.qkv.weight" in sd
    assert "decoder.layers.5.self_attn.in_proj_weight" in sd
    torch.save(sd, path)
    loaded = load_selfmask(str(path), device="cpu")
    assert loaded.encoder.blocks[0].attn.heads == 6
    assert (loaded.n_queries, len(loaded.encoder.blocks),
            len(loaded.decoder.layers)) == (20, 12, 6)
    assert loaded.encoder.pos_embed.shape == (1, 28 * 28 + 1, 384)
    again = SelfMask(device="cpu").init_params(
        torch.Generator().manual_seed(3))
    for (k, a), b in zip(loaded.state_dict().items(),
                         again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
