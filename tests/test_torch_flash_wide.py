"""Flash attention at the head dims the model factory adds to 64, 96 and
256: 80 (the DINO arm at RN50x4's text width), 128 (ViT-L/14), 320, 384
and 512 (RN50x4, RN50x16, RN50x64), held to the JAX package on the CPU.

  * The plain version (`flash_attention_reference`, which the wrapper runs
    on CPU tensors and the card's kernels are held to in
    tests/test_torch_flash_kernel.py and test_torch_flash_bias_kernel.py)
    against the JAX `flash_attention`, its Pallas kernel in interpret mode
    as tests/test_flash_attention.py runs it: f32 at rtol 2e-4 / atol 2e-5
    (the JAX package's own flash-against-XLA tolerance widened for the
    reassociation), bf16 at 8e-3 of the largest |output| (both round P to
    bf16 before P V and the output to bf16, at different points: the JAX
    kernel rounds P before normalising it, the plain version after).
  * With a bias a key, against the JAX einsum attention given the bias
    ([b, 1, 1, sk]), as the JAX package routes a biased call, in f32.
  * One decoder layer at 8 heads of 80 and of 320 against
    zutis_tpu/models/decoder.py's QueryDecoder (f32, "auto": XLA in JAX,
    the plain flash version in the port).

Inputs are numpy-seeded; sq 20 and sk 70 give a ragged 64-key chunk and a
ragged 32-key one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zutis_tpu.models.decoder import QueryDecoder as JQueryDecoder
from zutis_tpu.ops import attention as jattn
from zutis_tpu.ops.flash_attention import flash_attention as jflash
from zutis_tpu_torch.models.decoder import QueryDecoder
from zutis_tpu_torch.models.weights import _put_decoder
from zutis_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-5)
TOL_BF16 = 8e-3  # of the largest |output|
NEW_DIMS = (80, 128, 320, 384, 512)


def _inputs(seed, d, masked, b=3, h=2, sq=20, sk=70):
    """numpy q, k, v [b, h, s, d], a key bias [b, sk] in [0, 4] and a mask
    [b, sk] whose item 1 has no valid key (masked keys of item 0 given a
    large bias), or None."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk))
    bias = (rng.rand(b, sk) * 4).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.rand(b, sk) > 0.3).astype(np.int32)
        mask[1] = 0
        bias[0, mask[0] == 0] = 60.0
    return q, k, v, bias, mask


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("d", NEW_DIMS)
def test_plain_version_matches_the_jax_flash_attention_f32(d, masked):
    q, k, v, _, mask = _inputs(0, d, masked)
    want = np.asarray(jflash(*map(jnp.asarray, (q, k, v)),
                             kv_mask=None if mask is None else jnp.asarray(mask)))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    got = fa.flash_attention(*t, m)  # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if masked:
        assert (got[1] == 0).all()


@pytest.mark.parametrize("d", NEW_DIMS)
def test_plain_version_matches_the_jax_flash_attention_bf16(d):
    q, k, v, _, mask = _inputs(1, d, masked=True)
    want = np.asarray(jflash(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        kv_mask=jnp.asarray(mask)).astype(jnp.float32))
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    got = fa.flash_attention(*t, torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=TOL_BF16 * np.abs(want).max())
    assert (got[1] == 0).all()


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("d", NEW_DIMS)
def test_biased_plain_version_matches_jax(d, masked):
    q, k, v, bias, mask = _inputs(2, d, masked)
    want = np.asarray(jattn.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias[:, None, None, :]),
        kv_mask=None if mask is None else jnp.asarray(mask), impl="xla"))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    got = fa.flash_attention(*t, m, torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("head_dim", [80, 320])
def test_decoder_layer_matches_flax_at_wide_heads(head_dim):
    """One decoder layer at 8 heads of `head_dim`: 10 queries, 3 x 5 memory
    tokens, as the DINO arm at RN50x4's width (640) and RN50x4 (2560)."""
    width = 8 * head_dim
    rng = np.random.RandomState(head_dim)
    memory, pos = (rng.randn(2, 15, width).astype(np.float32)
                   for _ in range(2))
    query_pos = rng.randn(2, 10, width).astype(np.float32)
    tgt = rng.randn(2, 10, width).astype(np.float32) * 0.1
    jdec = JQueryDecoder(d_model=width, heads=8, num_layers=1,
                         dim_feedforward=64)
    params = jdec.init(jax.random.PRNGKey(head_dim), *map(
        jnp.asarray, (tgt, memory, pos, query_pos)))["params"]
    want = jdec.apply({"params": params}, *map(
        jnp.asarray, (tgt, memory, pos, query_pos)))
    dec = QueryDecoder(d_model=width, heads=8, num_layers=1,
                       dim_feedforward=64, device="cpu")
    sd = {}
    _put_decoder(sd, jax.tree.map(np.asarray, params))  # as params_from_jax
    dec.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()},
                        strict=True)
    with torch.no_grad():
        got = dec(*map(torch.from_numpy, (tgt, memory, pos, query_pos)))
    assert got.shape == (1, 2, 10, width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
