"""The flash-attention autograd Function (zutis_tpu_torch.ops.flash_attention.
FlashAttention) against the JAX package's custom VJP.

The same numpy-seeded q, k, v and output cotangent go through `jax.vjp` of
zutis_tpu.ops.flash_attention.flash_attention (the Pallas kernel in
interpret mode, its `_flash_bwd` recompute) and through the port's
flash_attention on the CPU (its plain forward inside the Function, the
ported backward), and through torch autograd of the plain version. Both
backwards recompute W and form every product in f32 in the same order, so
f32 gradients agree to 2e-5 of each tensor's largest |gradient| (summation
order only); bf16 inputs get their gradients rounded to bf16 once, held to
one bf16 rounding (2^-8) of the largest."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zutis_tpu.ops.flash_attention import flash_attention as jflash
from zutis_tpu_torch.models.layers import MultiHeadAttention
from zutis_tpu_torch.ops import flash_attention as fa
from zutis_tpu_torch.ops.attention import dot_product_attention_bshd

TOL_F32 = 2e-5
TOL_BF16 = 2 ** -8
# name -> ([b, h, sq, sk, d], masked, strided)
CASES = {
    "dense": ((2, 2, 72, 140, 64), False, False),
    "d96": ((1, 2, 50, 77, 96), False, False),
    "strided": ((2, 3, 40, 65, 64), False, True),
    "kv_mask": ((3, 2, 64, 130, 64), True, False),
    "strided kv_mask": ((3, 2, 33, 70, 96), True, True),
}


def _inputs(seed, shape, masked, strided):
    """numpy q, k, v [b, h, s, d], the cotangent g [b, h, sq, d] and the
    mask [b, sk] (item 1 has no valid key), or None."""
    b, h, sq, sk, d = shape
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk))
    g = rng.randn(b, h, sq, d).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.rand(b, sk) > 0.3).astype(np.int32)
        mask[1] = 0
    return q, k, v, g, mask


def _torch_leaves(arrays, strided, dtype=torch.float32):
    """Leaf tensors requiring grad and the [b, h, s, d] tensors the call
    takes: as they are, or views of [b, s, h, d] leaves."""
    leaves, views = [], []
    for a in arrays:
        t = torch.from_numpy(a).to(dtype)
        if strided:
            leaf = t.transpose(1, 2).contiguous().requires_grad_()
            view = leaf.transpose(1, 2)
        else:
            leaf = t.requires_grad_()
            view = leaf
        leaves.append(leaf)
        views.append(view)
    return leaves, views


def _port_grads(q, k, v, g, mask, strided, fn=fa.flash_attention,
                dtype=torch.float32):
    leaves, (tq, tk, tv) = _torch_leaves((q, k, v), strided, dtype)
    tmask = None if mask is None else torch.from_numpy(mask)
    out = fn(tq, tk, tv, tmask)
    out.backward(torch.from_numpy(g).to(dtype))
    grads = [leaf.grad for leaf in leaves]
    if strided:
        grads = [gr.transpose(1, 2) for gr in grads]
    return out, grads


def _jax_grads(q, k, v, g, mask, dtype=jnp.float32):
    jm = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda q, k, v: jflash(q, k, v, kv_mask=jm),
                       *(jnp.asarray(a).astype(dtype) for a in (q, k, v)))
    return out, vjp(jnp.asarray(g).astype(dtype))


def _assert_close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: {err:.3e} of the largest |value| (tol {tol})"


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_jax_custom_vjp(name):
    shape, masked, strided = CASES[name]
    q, k, v, g, mask = _inputs(7, shape, masked, strided)
    out, grads = _port_grads(q, k, v, g, mask, strided)
    jout, jgrads = _jax_grads(q, k, v, g, mask)
    _assert_close(out.detach().numpy(), jout, TOL_F32, "output")
    for label, got, want in zip("qkv", grads, jgrads):
        _assert_close(got.numpy(), want, TOL_F32, f"d{label}")
    if masked:  # the item with no valid key: zero output, zero gradients
        assert not out[1].any()
        for got in grads:
            assert not got[1].any()


@pytest.mark.parametrize("name", list(CASES))
def test_gradients_match_autograd_of_the_plain_version(name):
    shape, masked, strided = CASES[name]
    q, k, v, g, mask = _inputs(8, shape, masked, strided)
    _, grads = _port_grads(q, k, v, g, mask, strided)
    _, want = _port_grads(q, k, v, g, mask, strided,
                          fn=fa.flash_attention_reference)
    for label, got, w in zip("qkv", grads, want):
        _assert_close(got.numpy(), w.numpy(), TOL_F32, f"d{label}")


@pytest.mark.parametrize("name", ["dense", "kv_mask"])
def test_bf16_gradients_match_jax_custom_vjp(name):
    shape, masked, strided = CASES[name]
    q, k, v, g, mask = _inputs(9, shape, masked, strided)
    _, grads = _port_grads(q, k, v, g, mask, strided, dtype=torch.bfloat16)
    _, jgrads = _jax_grads(q, k, v, g, mask, dtype=jnp.bfloat16)
    for label, got, want in zip("qkv", grads, jgrads):
        assert got.dtype == torch.bfloat16
        _assert_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                      TOL_BF16, f"d{label}")


def test_strided_gradients_come_back_in_the_inputs_shape():
    shape, masked, strided = CASES["strided kv_mask"]
    q, k, v, g, mask = _inputs(10, shape, masked, strided)
    leaves, (tq, tk, tv) = _torch_leaves((q, k, v), strided=True)
    out = fa.flash_attention(tq, tk, tv, torch.from_numpy(mask))
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g))
    for leaf in leaves:
        assert leaf.grad.shape == leaf.shape and leaf.grad.dtype == leaf.dtype


def test_no_graph_without_grad():
    q, k, v, _, mask = _inputs(11, *CASES["kv_mask"][:2], False)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    with torch.no_grad():
        out = fa.flash_attention(tq, tk, tv, torch.from_numpy(mask))
    assert out.grad_fn is None
    plain = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               torch.from_numpy(mask))
    assert plain.grad_fn is None
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def test_bshd_attention_gradients_equal_the_torch_path():
    """dot_product_attention_bshd, as the model's layers call it: the
    kernel path's gradients (the Function) equal autograd through the
    "torch" path in f32."""
    rng = np.random.RandomState(12)
    b, sq, sk, h, d = 2, 30, 45, 3, 64
    arrays = [rng.randn(b, s, h, d).astype(np.float32) for s in (sq, sk, sk)]
    mask = (rng.rand(b, sk) > 0.2).astype(np.int32)
    grads = {}
    for impl in ("auto", "torch"):
        ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
        out = dot_product_attention_bshd(*ts, kv_mask=torch.from_numpy(mask),
                                         impl=impl)
        out.sin().sum().backward()
        grads[impl] = [t.grad for t in ts]
    for got, want in zip(grads["auto"], grads["torch"]):
        _assert_close(got.numpy(), want.numpy(), TOL_F32, "bshd grad")


def test_attention_layer_projections_get_their_gradient_through_the_kernel_path():
    """A MultiHeadAttention on the kernel path: every projection gets the
    gradient it gets on the "torch" path (none is cut off at the Function)."""
    torch.manual_seed(0)
    grads = {}
    x = torch.randn(2, 17, 64)
    for impl in ("auto", "torch"):
        layer = MultiHeadAttention(64, 2, attn_impl=impl, device="cpu")
        layer.init_params(torch.Generator().manual_seed(1))
        layer(x, x, x).square().sum().backward()
        grads[impl] = {n: p.grad for n, p in layer.named_parameters()}
    for name, want in grads["torch"].items():
        got = grads["auto"][name]
        assert got is not None and got.abs().max() > 0, name
        _assert_close(got.numpy(), want.numpy(), TOL_F32, name)
