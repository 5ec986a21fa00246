"""Multi-head attention core: one dispatcher, two implementations.

  - "torch":  einsum softmax attention, the port of the JAX package's "xla"
              path (zutis_tpu/ops/attention.py:54-162). f32 computes an exact
              softmax; bf16 stores the logits in bf16 and takes the max-free
              clamped softmax with f32 statistics.
  - "kernel": the flash-attention kernel (ops/flash_attention.py): the
              hand-written Hopper kernel for CUDA tensors, its plain version
              for CPU tensors.
  - "auto":   "kernel" whenever no additive `bias` is given, on either
              device; "torch" otherwise. The kernel takes key-validity masks
              only, so a bias always takes the "torch" path rather than being
              dropped.
"""
from __future__ import annotations

from typing import Optional

import torch

from zutis_tpu_torch.ops.flash_attention import flash_attention

IMPLS = ("auto", "torch", "kernel")


def resolve_impl(impl: str, bias) -> str:
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r} not in {IMPLS}")
    if impl == "auto":
        impl = "kernel"
    return "torch" if bias is not None else impl


def softmax_weights(logits, scale, bias, kv_mask, compute_dtype) -> torch.Tensor:
    """Softmax over the last axis with f32 statistics; `logits` arrive
    pre-scale in f32, shaped [b, h, sq, sk]."""
    logits = logits * scale
    if compute_dtype == torch.float32:
        if bias is not None:
            logits = logits + bias.float()
        if kv_mask is not None:
            valid = kv_mask[:, None, None, :] > 0
            logits = logits.masked_fill(~valid, -1e30)
        w = torch.softmax(logits, dim=-1)
        if kv_mask is not None:
            # all-keys-masked items get zero weights, not uniform 1/sk
            any_valid = (kv_mask > 0).any(dim=-1)
            w = w * any_valid[:, None, None, None]
        return w
    # bf16: max-free softmax, clamped from above at 80 (overflow safety
    # without a row-max pass; see zutis_tpu/ops/attention.py:71-104 for the
    # envelope this assumes); masked keys at -200 underflow to exactly 0
    if bias is not None:
        logits = logits + bias.float()
    logits = torch.clamp(logits, max=80.0)
    if kv_mask is not None:
        logits = logits.masked_fill(~(kv_mask[:, None, None, :] > 0), -200.0)
    e = torch.exp(logits)
    # the smallest normal f32 guards the all-masked row (sum 0) against NaN
    tiny = torch.finfo(torch.float32).tiny
    return e / torch.clamp(e.sum(dim=-1, keepdim=True), min=tiny)


def dot_product_attention(
    q: torch.Tensor,  # [b, h, sq, d]
    k: torch.Tensor,  # [b, h, sk, d]
    v: torch.Tensor,  # [b, h, sk, d]
    bias: Optional[torch.Tensor] = None,  # broadcastable to [b, h, sq, sk]
    kv_mask: Optional[torch.Tensor] = None,  # [b, sk] valid-key mask
    impl: str = "auto",
) -> torch.Tensor:
    if resolve_impl(impl, bias) == "kernel":
        return flash_attention(q, k, v, kv_mask=kv_mask)
    # logits stored in the compute dtype, statistics in f32
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
    w = softmax_weights(logits, q.shape[-1] ** -0.5, bias, kv_mask, q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)


def dot_product_attention_bshd(
    q: torch.Tensor,  # [b, sq, h, d]
    k: torch.Tensor,  # [b, sk, h, d]
    v: torch.Tensor,  # [b, sk, h, d]
    bias: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Attention over head-split projections in their [b, s, h, d] layout.
    The kernel reads and writes that layout in place through strides, so the
    transposes here are views. Returns [b, sq, h, d]."""
    if resolve_impl(impl, bias) == "kernel":
        out = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            kv_mask=kv_mask,
        )
        return out.transpose(1, 2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    w = softmax_weights(logits, q.shape[-1] ** -0.5, bias, kv_mask, q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)
