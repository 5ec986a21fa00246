"""The port's attention (zutis_tpu_torch.ops) against the JAX package.

The plain version of the flash kernel is held against the Pallas kernel (run
in interpret mode on the CPU, as tests/test_flash_attention.py runs it) and
against `_xla_reference`; the "torch" dispatcher path against the JAX "xla"
path. Tolerances: f32 at 2e-5 (the JAX kernel test's own, for
summation-order differences); bf16 at 1/64 relative and absolute, one or two
roundings of an 8-bit mantissa at the logits or the output. The CUDA kernels'
tests need the card and live in tests/test_torch_flash_kernel.py, which
imports no JAX so that it runs on the card's machine.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zutis_tpu.ops import attention as jattn
from zutis_tpu.ops import flash_attention as jflash
from zutis_tpu_torch.ops import attention as tattn
from zutis_tpu_torch.ops import flash_attention as tflash

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=1 / 64, atol=1 / 64)


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk)]


def _mask(seed, b, sk, all_masked=None):
    m = (np.random.RandomState(seed).rand(b, sk) > 0.3).astype(np.int32)
    if all_masked is not None:
        m[all_masked] = 0
    return m


@pytest.mark.parametrize("b,h,sq,sk,d", [
    (2, 2, 64, 64, 32),
    (1, 1, 130, 260, 64),   # ragged sq and sk
    (1, 3, 100, 230, 16),
])
def test_reference_matches_pallas_and_xla(b, h, sq, sk, d):
    q, k, v = _qkv(0, b, h, sq, sk, d)
    got = tflash.flash_attention_reference(*map(torch.from_numpy, (q, k, v)))
    pallas = jflash.flash_attention(*map(jnp.asarray, (q, k, v)))
    _, xla = jflash._xla_reference(*map(jnp.asarray, (q, k, v)), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **F32)


def test_reference_kv_mask_and_all_masked_item_match_pallas():
    q, k, v = _qkv(1, 3, 2, 40, 90, 32)
    mask = _mask(1, 3, 90, all_masked=1)
    got = tflash.flash_attention_reference(
        *map(torch.from_numpy, (q, k, v)), kv_mask=torch.from_numpy(mask))
    want = jflash.flash_attention(*map(jnp.asarray, (q, k, v)),
                                  kv_mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert (got[1] == 0).all()


def test_kernel_impl_on_cpu_is_the_reference_with_bool_mask():
    q, k, v = map(torch.from_numpy, _qkv(2, 2, 2, 33, 47, 16))
    mask = torch.from_numpy(_mask(2, 2, 47)).bool()
    got = tattn.dot_product_attention(q, k, v, kv_mask=mask, impl="kernel")
    want = tflash.flash_attention_reference(q, k, v, mask.int())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("biased", [False, True])
def test_torch_path_matches_xla_f32(masked, biased):
    b, h, sq, sk, d = 2, 3, 20, 37, 16
    q, k, v = _qkv(3, b, h, sq, sk, d)
    mask = _mask(3, b, sk, all_masked=1) if masked else None
    bias = (np.random.RandomState(4).randn(b, h, sq, sk).astype(np.float32)
            if biased else None)
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    got = tattn.dot_product_attention(t(q), t(k), t(v), bias=t(bias),
                                      kv_mask=t(mask), impl="torch")
    want = jattn.dot_product_attention(j(q), j(k), j(v), bias=j(bias),
                                       kv_mask=j(mask), impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("masked", [False, True])
def test_torch_path_matches_xla_bf16(masked, layout):
    b, h, sq, sk, d = 2, 2, 24, 50, 32
    q, k, v = _qkv(5, b, h, sq, sk, d)
    if layout == "bshd":
        q, k, v = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v))
    mask = _mask(5, b, sk, all_masked=0) if masked else None
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    tfn, jfn = ((tattn.dot_product_attention, jattn.dot_product_attention)
                if layout == "bhsd" else
                (tattn.dot_product_attention_bshd,
                 jattn.dot_product_attention_bshd))
    got = tfn(tq, tk, tv,
              kv_mask=None if mask is None else torch.from_numpy(mask),
              impl="torch")
    want = jfn(jq, jk, jv, kv_mask=None if mask is None else jnp.asarray(mask),
               impl="xla")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **BF16)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_bshd_layout_matches_xla(impl):
    b, h, sq, sk, d = 2, 4, 18, 29, 16
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for s in (sq, sk, sk))
    mask = _mask(6, b, sk)
    got = tattn.dot_product_attention_bshd(
        *map(torch.from_numpy, (q, k, v)), kv_mask=torch.from_numpy(mask),
        impl=impl)
    want = jattn.dot_product_attention_bshd(
        *map(jnp.asarray, (q, k, v)), kv_mask=jnp.asarray(mask), impl="xla")
    assert got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_auto_resolves_to_kernel_without_bias_and_torch_with_bias():
    assert tattn.resolve_impl("auto", None) == "kernel"
    assert tattn.resolve_impl("auto", torch.zeros(1)) == "torch"
    assert tattn.resolve_impl("kernel", torch.zeros(1)) == "torch"
    assert tattn.resolve_impl("torch", None) == "torch"
    with pytest.raises(ValueError):
        tattn.resolve_impl("xla", None)


def test_bf16_softmax_masks_exactly_and_guards_all_masked_rows():
    logits = torch.from_numpy(
        np.random.RandomState(7).randn(2, 1, 3, 6).astype(np.float32) * 5)
    mask = torch.tensor([[1, 1, 1, 0, 0, 0], [0, 0, 0, 0, 0, 0]])
    w = tattn.softmax_weights(logits, 1.0, None, mask, torch.bfloat16)
    assert (w[0, ..., 3:] == 0).all()
    torch.testing.assert_close(w[0].sum(-1), torch.ones(1, 3))
    assert (w[1] == 0).all() and torch.isfinite(w).all()


@pytest.mark.parametrize("shape,dtype,error", [
    ((1, 2, 8, 32), torch.bfloat16, ValueError),   # head dim 32
    ((1, 2, 8, 64), torch.float16, TypeError),
    ((1, 2, 8, 96), torch.float64, TypeError),
])
def test_kernel_input_check_rejects_what_the_kernel_does_not_take(
        shape, dtype, error):
    q = torch.zeros(shape, dtype=dtype)
    with pytest.raises(error):
        tflash.check_kernel_inputs(q, q, q, None)


def test_kernel_input_check_rejects_noncontiguous_head_dim_and_bad_mask():
    q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tflash.check_kernel_inputs(q.transpose(2, 3)[..., :8, :], q, q, None)
    with pytest.raises(ValueError):
        tflash.check_kernel_inputs(q, q, q, torch.ones(1, 7))
    tflash.check_kernel_inputs(q, q, q, torch.ones(1, 8))  # accepted


def test_flash_attention_refuses_other_devices():
    q = torch.zeros(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError):
        tflash.flash_attention(q, q, q)

