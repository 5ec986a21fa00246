"""Shared building blocks: dense layers, LayerNorm32, multi-head attention,
MLPs and QuickGELU (the port of zutis_tpu/models/layers.py).

Parameters use the reference torch layout (Linear weight [out, in],
nn.MultiheadAttention's fused `in_proj_weight` [3d, d]) so that a reference
state_dict loads with `strict=True`. Parameters may be stored in any dtype;
each product casts weight, bias and input to the module's compute dtype, as
the flax modules do. LayerNorm runs in f32 with flax's eps of 1e-6 (not
torch's 1e-5) and casts back.

Under tensor parallelism (parallel/mesh.py::shard_model) a `Dense` is
"column" (its output features sliced, its input entering through
`copy_to_model`) or "row" (its input features sliced, the partial products
summed by `reduce_from_model` before the bias), and a `MultiHeadAttention`
holds this rank's heads: their rows of each of q, k and v in
`in_proj_weight`, a column-parallel projection followed by its row-parallel
`out_proj`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from zutis_tpu_torch.ops.attention import dot_product_attention_bshd
from zutis_tpu_torch.parallel.tp import copy_to_model, reduce_from_model

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's GELU approximation x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def empty_param(*shape: int, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=torch.float32, device=device))


def fill_normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill `p` from `generator` (a CPU generator, so the values do not depend
    on the device the parameter lies on)."""
    with torch.no_grad():
        p.copy_(torch.randn(p.shape, generator=generator) * std)


class Dense(nn.Module):
    """y = x W^T + b in the given compute dtype; weight [out, in]."""

    def __init__(self, features_in: int, features_out: int, device=None):
        super().__init__()
        self.weight = empty_param(features_out, features_in, device=device)
        self.bias = empty_param(features_out, device=device)
        self.tp_mode, self.tp_group = None, None  # "column" or "row"

    def set_model_parallel(self, group, mode: str) -> None:
        """Run as a `mode` ("column" or "row") layer over `group`; the
        weight (and a column layer's bias) already hold this rank's slice."""
        self.tp_mode, self.tp_group = mode, group

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.tp_mode == "row":
            y = F.linear(x.to(dtype), self.weight.to(dtype))
            return reduce_from_model(y, self.tp_group) + self.bias.to(dtype)
        if self.tp_mode == "column":
            x = copy_to_model(x, self.tp_group)
        return F.linear(x.to(dtype), self.weight.to(dtype), self.bias.to(dtype))

    def init_params(self, generator: torch.Generator) -> None:
        # lecun normal, as flax's Dense default; zero bias
        fill_normal_(self.weight, 1.0 / math.sqrt(self.weight.shape[1]), generator)
        with torch.no_grad():
            self.bias.zero_()


class LayerNorm32(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), LN_EPS)
        return y.to(x.dtype)

    def init_params(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


class MultiHeadAttention(nn.Module):
    """nn.MultiheadAttention-layout MHA with separate q/k/v inputs; q, k and
    v are projected by their own slices of `in_proj_weight`. `attend_kv`
    takes keys and values already projected by `k_proj`/`v_proj`, so the
    decoder can hoist loop-invariant work out of its layer loop."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", device=None):
        super().__init__()
        self.dim, self.heads, self.dtype, self.attn_impl = dim, heads, dtype, attn_impl
        self.in_proj_weight = empty_param(3 * dim, dim, device=device)
        self.in_proj_bias = empty_param(3 * dim, device=device)
        self.out_proj = Dense(dim, dim, device=device)
        # this rank's heads and their width (all of them without TP)
        self.local_heads, self.local_dim, self.tp_group = heads, dim, None

    def set_model_parallel(self, group, n: int) -> None:
        """Run this rank's heads / n over `group`; `in_proj_*` already hold
        their rows of q, k and v, and `out_proj` its columns."""
        self.local_heads, self.local_dim = self.heads // n, self.dim // n
        self.tp_group = group
        self.out_proj.set_model_parallel(group, "row")

    def _enter(self, x: torch.Tensor) -> torch.Tensor:
        """A whole input entering the (column-parallel) projections."""
        return x if self.tp_group is None else copy_to_model(x, self.tp_group)

    def _project(self, x: torch.Tensor, i: int) -> torch.Tensor:
        d, dt = self.local_dim, self.dtype
        w = self.in_proj_weight[i * d:(i + 1) * d]
        b = self.in_proj_bias[i * d:(i + 1) * d]
        return F.linear(x.to(dt), w.to(dt), b.to(dt))

    def q_proj(self, x: torch.Tensor) -> torch.Tensor:
        return self._project(self._enter(x), 0)

    def k_proj(self, x: torch.Tensor) -> torch.Tensor:
        return self._project(self._enter(x), 1)

    def v_proj(self, x: torch.Tensor) -> torch.Tensor:
        return self._project(self._enter(x), 2)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        return x.reshape(b, s, self.local_heads, self.dim // self.heads)

    def _attend(self, q, k, v, kv_mask, bias) -> torch.Tensor:
        out = dot_product_attention_bshd(
            self._split(q), self._split(k), self._split(v), bias=bias,
            kv_mask=kv_mask, impl=self.attn_impl)
        b, sq = out.shape[:2]
        return self.out_proj(out.reshape(b, sq, self.local_dim), self.dtype)

    def attend_kv(
        self,
        q_in: torch.Tensor,  # [b, sq, dim]
        k: torch.Tensor,  # [b, sk, dim], already projected by k_proj
        v: torch.Tensor,  # [b, sk, dim], already projected by v_proj
        kv_mask: Optional[torch.Tensor] = None,  # [b, sk], nonzero = valid key
        bias: Optional[torch.Tensor] = None,  # additive, to [b, h, sq, sk]
    ) -> torch.Tensor:
        return self._attend(self.q_proj(q_in), k, v, kv_mask, bias)

    def forward(self, q_in, k_in, v_in, kv_mask=None, bias=None,
                return_k: bool = False):
        """-> the attention's output [b, sq, dim]; with `return_k`, also
        the head-mean keys [b, sk, dim // heads] in the compute dtype (the
        similarity ToMe merges on, ops/tome.py; without gradient under TP,
        where the mean sums over the model group)."""
        entered = {}  # one copy_to_model an input object, however many use it

        def enter(x):
            if id(x) not in entered:
                entered[id(x)] = self._enter(x)
            return entered[id(x)]

        k = self._project(enter(k_in), 1)
        out = self._attend(self._project(enter(q_in), 0), k,
                           self._project(enter(v_in), 2), kv_mask, bias)
        if not return_k:
            return out
        if self.tp_group is None:
            return out, self._split(k).mean(dim=2)
        # every rank must merge the same tokens: the mean over all heads
        k_sum = self._split(k).detach().float().sum(dim=2)
        dist.all_reduce(k_sum, group=self.tp_group)
        return out, (k_sum / self.heads).to(k.dtype)

    def init_params(self, generator: torch.Generator) -> None:
        fill_normal_(self.in_proj_weight, 1.0 / math.sqrt(self.dim), generator)
        with torch.no_grad():
            self.in_proj_bias.zero_()
        self.out_proj.init_params(generator)


class MLP(nn.Module):
    """N-layer perceptron with ReLU between layers (ffn1/ffn2 are
    width -> 256 -> 256 -> width); parameters `layers.{i}.weight/bias`."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 3, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1], device=device) for i in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x, self.dtype)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x

    def init_params(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.init_params(generator)
