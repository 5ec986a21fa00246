"""Data parallelism's gradient reduction: the gradients summed over the data
group, one collective a bucket, not one a parameter. The criterion divides
by the global batch's counts (losses/criterion.py), so the sum is the
one-device gradient.

Each parameter's `.grad` is a view of a flat bucket for the model's
lifetime (DDP's gradient-as-bucket-view): autograd adds into it in place,
the bucket is all-reduced where it lies, and nothing is copied in or out.
"""
from __future__ import annotations

from typing import Iterable, List

import torch
import torch.distributed as dist

BUCKET_ELEMENTS = 1 << 25  # 128 MiB of float32 a bucket


class GradientBuckets:
    """Flat buckets that hold the gradients of `params` (in order, a new
    bucket at BUCKET_ELEMENTS or a change of dtype or device). Every rank
    of the group builds them from the same parameters, so the buckets line
    up."""

    def __init__(self, params: Iterable[torch.nn.Parameter], group,
                 bucket_elements: int = BUCKET_ELEMENTS):
        self.group = group
        self.params = [p for p in params if p.requires_grad]
        groups: List[List[torch.nn.Parameter]] = []
        size = 0
        for p in self.params:
            if (not groups or size + p.numel() > bucket_elements
                    or groups[-1][0].dtype != p.dtype
                    or groups[-1][0].device != p.device):
                groups.append([])
                size = 0
            groups[-1].append(p)
            size += p.numel()
        self.buckets = [torch.zeros(sum(p.numel() for p in g),
                                    dtype=g[0].dtype, device=g[0].device)
                        for g in groups]
        self._views = []
        for flat, g in zip(self.buckets, groups):
            offset = 0
            for p in g:
                self._views.append(
                    (p, flat[offset:offset + p.numel()].view_as(p)))
                offset += p.numel()

    def zero(self) -> None:
        """Zero the buckets and point every `.grad` at its view (in place of
        `optimizer.zero_grad`)."""
        for flat in self.buckets:
            flat.zero_()
        for p, view in self._views:
            if p.grad is not view:
                p.grad = view

    def all_reduce(self) -> None:
        """Sum every gradient over the group, in place."""
        for flat in self.buckets:
            dist.all_reduce(flat, group=self.group)
