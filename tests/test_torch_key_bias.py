"""The flash path's bias a key (zutis_tpu_torch/ops/flash_attention.py
`key_bias`, ops/attention.py's routing) against the JAX package's einsum
attention with the same bias, on the CPU, in f32 at rtol 2e-4, atol 2e-5:

  * the plain versions, unsplit (`flash_attention_reference`) and split
    (`flash_attention_split_reference`), with and without a kv_mask, an item
    with no valid key included, against `dot_product_attention(...,
    bias=[b, 1, 1, sk], impl="xla")`; masked keys take no weight whatever
    their bias;
  * autograd through `FlashAttention` with a bias against autograd through
    the plain version (gradients within 2e-5 of each tensor's largest), and
    a bias that requires grad refused;
  * the dispatcher: [b, 1, 1, sk] and [1, 1, 1, sk] go to the kernel as
    key_bias [b, sk], [sq, sk] and [b, h, sq, sk] to "torch", and "torch"
    keeps every call.

The kernels themselves are held to these plain versions on the card in
tests/test_torch_flash_bias_kernel.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zutis_tpu.ops import attention as jattn
from zutis_tpu_torch.ops import attention as tattn
from zutis_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=2e-4, atol=2e-5)
# [b, h, sq, sk, d]: ragged key chunks, d 64 and 96
SHAPES = [(3, 2, 20, 70, 64), (2, 3, 33, 130, 96), (4, 1, 5, 200, 64)]


def _inputs(seed, shape, masked):
    b, h, sq, sk, d = shape
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk))
    bias = (rng.rand(b, sk) * 4).astype(np.float32)  # log(sizes) up to ~e^4
    mask = None
    if masked:
        mask = (rng.rand(b, sk) > 0.3).astype(np.int32)
        mask[1] = 0  # no valid key
        bias[0, mask[0] == 0] = 60.0  # masked keys: no weight whatever the bias
    return q, k, v, bias, mask


def _jax(q, k, v, bias, mask):
    return np.asarray(jattn.dot_product_attention(
        *map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias[:, None, None, :]),
        kv_mask=None if mask is None else jnp.asarray(mask), impl="xla"))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_versions_match_jax(shape, masked):
    q, k, v, bias, mask = _inputs(0, shape, masked)
    want = _jax(q, k, v, bias, mask)
    t = list(map(torch.from_numpy, (q, k, v)))
    m = None if mask is None else torch.from_numpy(mask)
    b = torch.from_numpy(bias)
    got = fa.flash_attention_reference(*t, m, b)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(fa.flash_attention(*t, m, b).numpy(), want,
                               **TOL)
    for n in (2, 3):  # key ranges, one of them past the last chunk at sk 70
        split = fa.flash_attention_split_reference(*t, m, n, key_bias=b)
        np.testing.assert_allclose(split.numpy(), want, **TOL)
    if masked:
        assert (got[1] == 0).all()


def test_bias_moves_the_weights_as_log_sizes_do():
    """A key copied n times equals one key with bias log(n) (ToMe's
    proportional attention), on the plain version."""
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.randn(2, 2, 3, 64).astype(np.float32))
    uniq = torch.from_numpy(rng.randn(2, 2, 4, 64).astype(np.float32))
    vals = torch.from_numpy(rng.randn(2, 2, 4, 64).astype(np.float32))
    reps = torch.tensor([3, 1, 2, 1])
    dense = fa.flash_attention_reference(
        q, uniq.repeat_interleave(reps, 2), vals.repeat_interleave(reps, 2))
    merged = fa.flash_attention_reference(
        q, uniq, vals, key_bias=reps.float().log().expand(2, 4).contiguous())
    torch.testing.assert_close(merged, dense, rtol=2e-5, atol=2e-6)


def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_gradients_with_a_key_bias_match_the_plain_version(masked):
    shape = (3, 2, 24, 70, 64)
    q, k, v, bias, mask = _inputs(2, shape, masked)
    g = torch.from_numpy(np.random.RandomState(3).randn(
        *shape[:3], shape[4]).astype(np.float32))
    m = None if mask is None else torch.from_numpy(mask)
    b = torch.from_numpy(bias)
    mine, ref = _leaves((q, k, v)), _leaves((q, k, v))
    out = fa.flash_attention(*mine, m, b)
    out.backward(g)
    want = fa.flash_attention_reference(*ref, m, b)
    want.backward(g)
    torch.testing.assert_close(out, want, rtol=0, atol=2e-5)
    for a, r in zip(mine, ref):
        err = (a.grad - r.grad).abs().max() / r.grad.abs().max()
        assert err <= 2e-5, err


def test_a_bias_that_requires_grad_is_refused():
    q, k, v, bias, _ = _inputs(4, (1, 1, 8, 16, 64), False)
    t = _leaves((q, k, v))
    with pytest.raises(ValueError, match="no gradient"):
        fa.flash_attention(*t, None, torch.from_numpy(bias).requires_grad_())


def test_kernel_input_check_refuses_a_bias_it_does_not_take():
    q, k, v = (torch.zeros(2, 1, s, 64) for s in (4, 9, 9))
    for bad in (torch.zeros(2, 8), torch.zeros(2, 9, dtype=torch.float64),
                torch.zeros(9, 2).t(), torch.zeros(1, 9)):
        with pytest.raises(ValueError, match="key_bias must be"):
            fa.check_kernel_inputs(q, k, v, None, bad)
    fa.check_kernel_inputs(q, k, v, None, torch.zeros(2, 9))


def _routed(monkeypatch):
    calls = []

    def record(q, k, v, kv_mask=None, key_bias=None):
        calls.append(key_bias)
        return fa.flash_attention(q, k, v, kv_mask=kv_mask, key_bias=key_bias)

    monkeypatch.setattr(tattn, "flash_attention", record)
    return calls


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("bias_shape,to_kernel", [
    ((3, 1, 1, 70), True), ((1, 1, 1, 70), True), ((20, 70), False),
    ((3, 2, 20, 70), False), ((1, 1, 20, 70), False)], ids=str)
def test_dispatcher_routes_a_bias_a_key_to_the_kernel(
        monkeypatch, bias_shape, to_kernel, layout):
    q, k, v, _, mask = _inputs(5, (3, 2, 20, 70, 64), True)
    bias = np.random.RandomState(6).rand(*bias_shape).astype(np.float32)
    if layout == "bshd":
        q, k, v = (a.transpose(0, 2, 1, 3) for a in (q, k, v))
    tfn, jfn = ((tattn.dot_product_attention, jattn.dot_product_attention)
                if layout == "bhsd" else
                (tattn.dot_product_attention_bshd,
                 jattn.dot_product_attention_bshd))
    want = np.asarray(jfn(*map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias),
                          kv_mask=jnp.asarray(mask), impl="xla"))
    for impl in ("auto", "kernel", "torch"):
        calls = _routed(monkeypatch)
        got = tfn(*map(torch.from_numpy, (q, k, v)),
                  bias=torch.from_numpy(bias), kv_mask=torch.from_numpy(mask),
                  impl=impl)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert len(calls) == (to_kernel and impl != "torch"), impl
        if calls:
            assert calls[0].shape == (3, 70) and calls[0].is_contiguous()
            assert calls[0].dtype == torch.float32


def test_resolve_impl_per_key_shapes():
    assert tattn.resolve_impl("auto", torch.zeros(4, 1, 1, 9), 4, 9) == "kernel"
    assert tattn.resolve_impl("kernel", torch.zeros(1, 1, 1, 9), 4, 9) == "kernel"
    assert tattn.resolve_impl("torch", torch.zeros(4, 1, 1, 9), 4, 9) == "torch"
    assert tattn.resolve_impl("auto", torch.zeros(2, 1, 1, 9), 4, 9) == "torch"
    assert tattn.resolve_impl("auto", torch.zeros(4, 1, 1, 8), 4, 9) == "torch"
    assert tattn.resolve_impl("auto", torch.zeros(4, 2, 1, 9), 4, 9) == "torch"
