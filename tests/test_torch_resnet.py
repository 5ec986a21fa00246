"""The port's CLIP ModifiedResNet (zutis_tpu_torch/models/resnet.py) against
the JAX package's flax modules (zutis_tpu/models/resnet.py), module by
module, on numpy-seeded parameters and inputs in f32 at the parity
harness's rtol 2e-4 / atol 2e-5:

  * FrozenBatchNorm with random statistics;
  * Bottleneck with and without its downsample, at stride 1 and 2;
  * AttentionPool2d on a grid other than its stored one;
  * ModifiedResNet's forward, attnpool_tokens and encode_image at odd
    input sizes (97 x 71: the stride-2 stem and every pool floor);
  * a synthetic OpenAI-layout RN checkpoint (with the `num_batches_tracked`
    counts torch's BatchNorm writes) through `load_clip_visual`, equal to
    the JAX `convert_clip_rn_visual` of the same file;
  * `encode_images` with the ModifiedResNet as the bank encoder.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zutis_tpu.models import resnet as jr
from zutis_tpu.models import weights as jw
from zutis_tpu_torch.models import factory, resnet
from zutis_tpu_torch.models.weights import (put_bottleneck,
                                            rn_visual_params_from_jax)
from zutis_tpu_torch.models.zutis import ZUTIS

RTOL, ATOL = 2e-4, 2e-5
# the JAX tests' tiny RN: one block a stage, stem width 8 (embed 256)
TINY = dict(layers=(1, 1, 1, 1), width=8, output_dim=16, heads=4,
            input_resolution=64)


def _randomise(tree, seed):
    """Every leaf of a flax tree redrawn from a numpy generator (so BN
    statistics and affine parameters are not the identity); variances
    positive."""
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    out = {}
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        a = rng.normal(size=np.shape(leaf)).astype(np.float32)
        if "running_var" in name:
            a = rng.uniform(0.5, 2.0, size=np.shape(leaf)).astype(np.float32)
        elif "kernel" in name and np.ndim(leaf) == 4:  # conv: fan-in scaled
            a /= np.sqrt(np.prod(np.shape(leaf)[:3]))
        elif "kernel" in name:
            a /= np.sqrt(np.shape(leaf)[0])
        out[name] = a
    return jax.tree_util.tree_map_with_path(
        lambda p, _: out[jax.tree_util.keystr(p)], tree)


def _jit_method(jm, method):
    return jax.jit(lambda p, x: jm.apply({"params": p}, x, method=method))


def _nhwc(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))


def test_frozen_batchnorm_equals_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)  # NCHW
    jm = jr.FrozenBatchNorm(5)
    params = _randomise(jm.init(jax.random.PRNGKey(0), _nhwc(x))["params"], 1)
    want = np.asarray(jm.apply({"params": params}, _nhwc(x)))
    bn = resnet.FrozenBatchNorm(5)
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(params["running_mean"]),
                        "running_var": torch.from_numpy(params["running_var"])})
    with torch.no_grad():
        got = bn(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the statistics are buffers: no gradient, no optimiser step reaches them
    assert [n for n, _ in bn.named_parameters()] == ["weight", "bias"]
    assert [n for n, _ in bn.named_buffers()] == ["running_mean", "running_var"]


@pytest.mark.parametrize("inplanes,planes,stride", [
    (32, 8, 1),    # no downsample: inplanes == 4 planes
    (16, 8, 1),    # a 1 x 1 downsample, no pool
    (32, 8, 2),    # pool and downsample
], ids=["identity", "downsample", "stride 2"])
def test_bottleneck_equals_jax(inplanes, planes, stride):
    x = np.random.default_rng(2).normal(size=(2, inplanes, 11, 9)).astype(
        np.float32)
    jm = jr.Bottleneck(planes, stride=stride)
    params = _randomise(jm.init(jax.random.PRNGKey(0), _nhwc(x))["params"], 3)
    assert ("downsample_conv" in params) == (stride > 1 or inplanes != 4 * planes)
    want = np.asarray(jm.apply({"params": params}, _nhwc(x)))
    block = resnet.Bottleneck(inplanes, planes, stride)
    sd = {}
    put_bottleneck(sd, "", params)
    block.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x).contiguous(
            memory_format=torch.channels_last))
    assert got.shape == (2, 4 * planes, 11 // stride, 9 // stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_attention_pool_equals_jax(impl):
    x = np.random.default_rng(4).normal(size=(2, 3, 5, 32)).astype(np.float32)
    jm = jr.AttentionPool2d(embed_dim=32, num_heads=4, output_dim=12,
                            spacial_dim=2)
    params = _randomise(jm.init(jax.random.PRNGKey(0), x)["params"], 5)
    want = np.asarray(jm.apply({"params": params}, x))
    pool = resnet.AttentionPool2d(2, 32, 4, 12, attn_impl=impl)
    sd = {"positional_embedding": torch.from_numpy(params["positional_embedding"])}
    for ours, theirs in (("q_proj", "q_proj"), ("k_proj", "k_proj"),
                         ("v_proj", "v_proj"), ("c_proj", "out_proj")):
        sd[f"{ours}.weight"] = torch.from_numpy(params["attn"][theirs]["kernel"].T.copy())
        sd[f"{ours}.bias"] = torch.from_numpy(params["attn"][theirs]["bias"])
    pool.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = pool(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 16, 12)  # the mean token and 15 grid tokens
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def net():
    jm = jr.ModifiedResNet(**TINY)
    # encode_image reaches every parameter (the dense path skips attnpool)
    params = _randomise(jax.jit(lambda k, x: jm.init(
        k, x, method=jr.ModifiedResNet.encode_image))(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)))["params"], 6)
    ours = resnet.ModifiedResNet(**TINY)
    ours.load_state_dict(rn_visual_params_from_jax(params), strict=True)
    return jm, params, ours


@pytest.mark.parametrize("h,w", [(97, 71), (64, 64), (64, 96)])
def test_modified_resnet_equals_jax(net, h, w):
    jm, params, ours = net
    x = np.random.default_rng(h * w).normal(size=(2, 3, h, w)).astype(np.float32)
    tokens, hh, ww = jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        params, jnp.asarray(x))
    hh, ww = int(hh), int(ww)
    with torch.no_grad():
        got, gh, gw = ours(torch.from_numpy(x))
    assert (gh, gw) == (hh, ww)
    assert got.shape == (2, hh * ww, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(tokens), rtol=RTOL,
                               atol=ATOL)
    grid = np.asarray(tokens).reshape(2, hh, ww, 256)
    want = _jit_method(jm, jr.ModifiedResNet.attnpool_tokens)(
        params, jnp.asarray(grid))
    with torch.no_grad():
        got = ours.attnpool_tokens(torch.from_numpy(grid))
    assert got.shape == (2, hh, ww, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    want = _jit_method(jm, jr.ModifiedResNet.encode_image)(
        params, jnp.asarray(x))
    with torch.no_grad():
        got = ours.encode_image(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _openai_rn_checkpoint(params, path):
    """The flax tree as OpenAI's RN archive lays it out: `visual.*` with
    torch BatchNorm's `num_batches_tracked` beside each BatchNorm, and a
    text tower's keys."""
    sd = {f"visual.{k}": v for k, v in rn_visual_params_from_jax(params).items()}
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key.replace("running_mean", "num_batches_tracked")] = torch.tensor(7)
    sd["token_embedding.weight"] = torch.zeros(10, 4)
    torch.save(sd, path)


def test_load_clip_visual_loads_a_resnet_checkpoint(net, tmp_path):
    """OpenAI's RN layout, loaded strictly, gives the encoder the JAX
    converter's tree: equal tensors and equal outputs."""
    jm, params, _ = net
    path = tmp_path / "RN50.pt"
    _openai_rn_checkpoint(params, path)
    converted = jw.convert_clip_rn_visual(jw.load_torch_state_dict(str(path)))
    assert len(jax.tree_util.tree_leaves(converted)) == len(
        jax.tree_util.tree_leaves(params))
    model = ZUTIS(encoder_family="rn", rn_layers=(1, 1, 1, 1), rn_width=8,
                  width=256, text_dim=16, input_resolution=64, n_queries=2,
                  n_decoder_layers=1, n_heads=2, device="cpu")
    assert factory.load_clip_visual(model, str(path)) is model
    want = rn_visual_params_from_jax(converted)
    for k, v in model.encoder.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    x = np.random.default_rng(8).normal(size=(1, 3, 64, 80)).astype(np.float32)
    with torch.no_grad():
        got = model.encoder.encode_image(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(_jit_method(
        jm, jr.ModifiedResNet.encode_image)(converted, jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)


def test_load_clip_visual_refuses_a_tower_of_the_other_family(net, tmp_path):
    _, params, _ = net
    path = tmp_path / "RN50.pt"
    _openai_rn_checkpoint(params, path)
    with torch.device("meta"):
        vit = factory.build_zutis("ViT-B/32", n_queries=2, n_decoder_layers=1,
                                  device="cpu")
    with pytest.raises(ValueError, match="rn visual tower"):
        factory.load_clip_visual(vit, str(path))


def test_encode_images_takes_the_resnet(net, tmp_path):
    from PIL import Image

    from zutis_tpu_torch.retrieval.image_embeddings import encode_images
    jm, params, ours = net
    rng = np.random.default_rng(9)
    paths = []
    for i, (h, w) in enumerate([(70, 90), (80, 64)]):
        p = tmp_path / f"im{i}.png"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(p)
        paths.append(str(p))
    got = encode_images(paths, ours, resolution=64, batch_size=3)
    from zutis_tpu_torch.retrieval.image_embeddings import clip_preprocess
    x = np.stack([clip_preprocess(p, 64) for p in paths])
    want = _jit_method(jm, jr.ModifiedResNet.encode_image)(
        params, jnp.asarray(x))
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
