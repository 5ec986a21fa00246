"""Tensor parallelism's two collectives, as autograd functions (what GSPMD
inserts around the JAX package's sharded matrices, written out in the
Megatron idiom):

  copy_to_model:     forward the identity, backward an all-reduce over the
                     model group. It sits where a whole activation enters a
                     column-parallel layer: each rank's layer gives only its
                     part of the input's gradient.
  reduce_from_model: forward an all-reduce over the model group, backward
                     the identity. It ends a row-parallel layer: each rank
                     holds a partial sum of the output, whose gradient is
                     whole on every rank.

`torch.distributed.nn.functional.all_reduce` does not serve for the second:
it all-reduces in backward too, which multiplies the gradients behind a
row-parallel layer by the model axis' size.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)
