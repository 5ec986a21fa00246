"""The port's models (zutis_tpu_torch.models) against the flax models, from
one flax init carried across with params_from_jax.

Forward parity runs in f32 at width 64, 2 layers, 4 heads and 64 px, at the
tolerance of tests/test_models_parity.py (rtol 2e-4, atol 2e-5): summation
order and flax's E[x^2] - E[x]^2 LayerNorm variance against torch's."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zutis_tpu.models import weights as jweights
from zutis_tpu.models.decoder import QueryDecoder as JQueryDecoder
from zutis_tpu.models.layers import LayerNorm32 as JLayerNorm32
from zutis_tpu.models.layers import quick_gelu as jquick_gelu
from zutis_tpu.models.pos_embed import sine_pos_embed as jsine_pos_embed
from zutis_tpu.models.vit import CLIPViT as JCLIPViT
from zutis_tpu.models.vit import interpolate_pos_embed as jinterp_pe
from zutis_tpu.models.zutis import ZUTIS as JZUTIS
from zutis_tpu.models.zutis import full_map_layer_norm as jfull_map_ln
from zutis_tpu_torch.models import layers as tlayers
from zutis_tpu_torch.models.decoder import QueryDecoder
from zutis_tpu_torch.models.pos_embed import sine_pos_embed
from zutis_tpu_torch.models.vit import CLIPViT, interpolate_pos_embed
from zutis_tpu_torch.models.weights import load_params, params_from_jax
from zutis_tpu_torch.models.zutis import ZUTIS, full_map_layer_norm

TOL = dict(rtol=2e-4, atol=2e-5)
CFG = dict(width=64, encoder_layers=2, encoder_heads=4, patch_size=16,
           text_dim=32, input_resolution=64, n_queries=10,
           n_decoder_layers=2, n_heads=4)


@pytest.fixture(scope="module")
def flax_zutis():
    x = np.random.RandomState(0).randn(2, 3, 64, 64).astype(np.float32)
    model = JZUTIS(**CFG)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return model, jax.tree.map(np.asarray, params), x


def _prefixed(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_params_from_jax_equals_export_zutis_key_by_key(flax_zutis):
    _, params, _ = flax_zutis
    got = params_from_jax(params)
    want = jweights.export_zutis(params)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)


def test_state_dict_layout_loads_strict(flax_zutis):
    _, params, _ = flax_zutis
    model = ZUTIS(**CFG, device="cpu")
    assert set(model.state_dict()) == set(jweights.export_zutis(params))
    load_params(model, params)  # strict=True inside


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ZUTIS(**CFG)


def test_seeded_init_is_reproducible_and_device_independent():
    a = ZUTIS(**CFG, device="cpu").init_params(torch.Generator().manual_seed(3))
    b = ZUTIS(**CFG, device="cpu").init_params(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    assert all(torch.isfinite(v).all() for v in a.state_dict().values())


def test_layer_norm_uses_flax_eps_and_quick_gelu_matches():
    x = np.random.RandomState(1).randn(3, 5, 16).astype(np.float32) * 1e-3
    jln = JLayerNorm32()
    jp = jln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jln.apply(jp, jnp.asarray(x))
    got = tlayers.LayerNorm32(16)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tlayers.quick_gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jquick_gelu(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("h,w,npf", [(7, 9, 32), (48, 48, 384)])
def test_sine_pos_embed_matches(h, w, npf):
    np.testing.assert_array_equal(sine_pos_embed(h, w, npf),
                                  jsine_pos_embed(h, w, npf))


@pytest.mark.parametrize("grid", [(4, 4), (3, 5)])
def test_interpolate_pos_embed_matches(grid):
    pe = np.random.RandomState(2).randn(17, 8).astype(np.float32)
    got = interpolate_pos_embed(torch.from_numpy(pe), grid)
    want = jinterp_pe(jnp.asarray(pe), grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_full_map_layer_norm_matches():
    x = np.random.RandomState(3).randn(2, 4, 5, 6).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(
        full_map_layer_norm(torch.from_numpy(x)).numpy(),
        np.asarray(jfull_map_ln(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_clip_vit_matches_flax(flax_zutis, hw):
    _, params, _ = flax_zutis
    jvit = JCLIPViT(width=64, layers=2, heads=4, patch_size=16, output_dim=32,
                    input_resolution=64)
    vit = CLIPViT(width=64, layers=2, heads=4, patch_size=16, output_dim=32,
                  input_resolution=64, device="cpu")
    vit.load_state_dict(_prefixed(params_from_jax(params), "encoder."),
                        strict=True)
    x = np.random.RandomState(4).randn(2, 3, *hw).astype(np.float32)
    want, wh, ww = jvit.apply({"params": params["encoder"]}, jnp.asarray(x))
    with torch.no_grad():
        got, gh, gw = vit(torch.from_numpy(x))
    assert (gh, gw) == (wh, ww)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_query_decoder_matches_flax(flax_zutis):
    _, params, _ = flax_zutis
    jdec = JQueryDecoder(d_model=64, heads=4, num_layers=2)
    dec = QueryDecoder(d_model=64, heads=4, num_layers=2, device="cpu")
    dec.load_state_dict(_prefixed(params_from_jax(params), "decoder."),
                        strict=True)
    rng = np.random.RandomState(5)
    memory, pos = (rng.randn(2, 36, 64).astype(np.float32) for _ in range(2))
    query_pos = rng.randn(2, 10, 64).astype(np.float32)
    tgt = np.zeros((2, 10, 64), np.float32)
    want = jdec.apply({"params": params["decoder"]}, *map(
        jnp.asarray, (tgt, memory, pos, query_pos)))
    with torch.no_grad():
        got = dec(*map(torch.from_numpy, (tgt, memory, pos, query_pos)))
    assert got.shape == (2, 2, 10, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("attn_impl", ["auto", "torch"])
@pytest.mark.parametrize("inference", [True, False])
def test_zutis_forward_matches_flax(flax_zutis, inference, attn_impl):
    jmodel, params, x = flax_zutis
    model = load_params(ZUTIS(**CFG, attn_impl=attn_impl, device="cpu"), params)
    want = jmodel.apply({"params": params}, jnp.asarray(x), inference=inference)
    with torch.no_grad():
        got = model(torch.from_numpy(x), inference=inference)
    n_layers = 1 if inference else CFG["n_decoder_layers"]
    assert got["mask_proposals"].shape == (2, n_layers, 10, 8, 8)
    assert got["patch_tokens"].shape == (2, 8, 8, 32)
    for key in ("mask_proposals", "patch_tokens"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("attn_impl", ["auto", "torch"])
def test_zutis_bf16_forward_matches_flax_bf16(flax_zutis, attn_impl):
    """bf16 compute with bf16 matrices and f32 1-D parameters (as bench.py
    casts its inference weights), against the flax model in bf16. The two
    frameworks round at different places; measured 4e-3 apart (proposals
    are sigmoids in [0, 1], tokens unit vectors), so atol 2e-2."""
    jmodel, params, x = flax_zutis
    jmodel = JZUTIS(**CFG, dtype=jnp.bfloat16)
    jparams = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16) if a.ndim > 1 else a, params)
    want = jmodel.apply({"params": jparams}, jnp.asarray(x), inference=True)
    model = load_params(
        ZUTIS(**CFG, dtype=torch.bfloat16, attn_impl=attn_impl, device="cpu"),
        params)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                p.data = p.data.bfloat16()
        got = model(torch.from_numpy(x), inference=True)
    for key in ("mask_proposals", "patch_tokens"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=2e-2, err_msg=key)
