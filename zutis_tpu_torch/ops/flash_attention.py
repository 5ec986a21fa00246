"""Flash-attention forward: the hand-written Hopper kernel
(csrc/flash_attention.cu) and its plain PyTorch version.

The kernel replaces the TPU kernel zutis_tpu/ops/flash_attention.py::
_flash_kernel. It computes softmax(q k^T / sqrt(d), keys masked by `kv_mask`)
v with f32 softmax statistics, keeps the [sq, sk] logits on chip, and gives
an item whose mask has no valid key an all-zero output, as the JAX wrapper
does after its kernel.

`flash_attention` takes the plain version only for tensors that lie on the
CPU. For a CUDA tensor it launches the kernel or raises: an unsupported
dtype, head dim or layout, a missing `nvcc` or a failed build is an error,
never a fallback.

The kernel is built at first use with `nvcc` for sm_90a (`_build.py`) and
bound through its plain C interface with ctypes.

The backward pass (a recomputing `torch.autograd.Function`, as the JAX
package's `_flash_bwd`) belongs to the training path and is not here yet.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from zutis_tpu_torch.ops import _build

SOURCE = _build.CSRC / "flash_attention.cu"
STEM = "libzutis_flash"
HEAD_DIMS = (64, 96)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_NEG_INF = -1e30


def build():
    """Compile the kernel library if needed; see `_build.build`."""
    return _build.build(SOURCE, STEM)


def _bind(lib: ctypes.CDLL) -> None:
    lib.zutis_flash_attention_fwd.restype = ctypes.c_int
    lib.zutis_flash_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
        ctypes.c_void_p,
    ]


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version: exact-softmax einsum attention with f32 logits and
    statistics, masked keys at -1e30, P cast to v's dtype before P V, and
    all-masked items zeroed (zutis_tpu/ops/flash_attention.py::_xla_reference
    plus the wrapper's zeroing)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if kv_mask is not None:
        valid = kv_mask > 0
        s = s.masked_fill(~valid[:, None, None, :], _NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)
    if kv_mask is not None:
        any_valid = valid.any(dim=-1)
        out = out * any_valid[:, None, None, None].to(out.dtype)
    return out.to(q.dtype)


def check_kernel_inputs(q, k, v, kv_mask) -> None:
    """Raise on anything the kernel does not take: dtype other than bf16 or
    f32, head dim outside HEAD_DIMS, mismatched shapes or devices, a head dim
    that is not contiguous, or strides and addresses not 16-byte aligned."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("the attention kernels take q, k, v of rank 4 [b, h, s, d]")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(
            f"head dim {d} not supported by the kernel (supported: {HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel takes q, k, v "
            "all bfloat16 or all float32")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the launch grid")
    vec = 16 // q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        if any(st % vec for st in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"{name}'s strides {x.stride()} and address must be 16-byte "
                "aligned")
    if kv_mask is not None:
        if kv_mask.shape != (b, sk) or kv_mask.device != q.device:
            raise ValueError(
                f"kv_mask must be [b, sk] = {(b, sk)} on {q.device}, got "
                f"{tuple(kv_mask.shape)} on {kv_mask.device}")


def flash_attention(
    q: torch.Tensor,  # [b, h, sq, d]
    k: torch.Tensor,  # [b, h, sk, d]
    v: torch.Tensor,  # [b, h, sk, d]
    kv_mask: Optional[torch.Tensor] = None,  # [b, sk] bool/int, nonzero = valid
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d), keys masked by kv_mask) v -> [b, h, sq, d].

    The kernel launch count is `flash_attention.launches`."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA, not {q.device}")
    check_kernel_inputs(q, k, v, kv_mask)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    # same memory layout as q: a transposed [b, s, h, d] view stays one
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    mask = None
    if kv_mask is not None:
        mask = (kv_mask > 0).to(torch.int32).contiguous()
    lib = _build.load(SOURCE, STEM, _bind)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.zutis_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), o.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, sq, sk, d, strides, d ** -0.5,
            stream,
        )
    _build.check_launch(lib, err, "flash attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
