"""Shared building blocks: dense layers, LayerNorm32, multi-head attention,
MLPs and QuickGELU (the port of zutis_tpu/models/layers.py).

Parameters use the reference torch layout (Linear weight [out, in],
nn.MultiheadAttention's fused `in_proj_weight` [3d, d]) so that a reference
state_dict loads with `strict=True`. Parameters may be stored in any dtype;
each product casts weight, bias and input to the module's compute dtype, as
the flax modules do. LayerNorm runs in f32 with flax's eps of 1e-6 (not
torch's 1e-5) and casts back.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from zutis_tpu_torch.ops.attention import dot_product_attention_bshd

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

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
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

    def _project(self, x: torch.Tensor, i: int) -> torch.Tensor:
        d, dt = self.dim, self.dtype
        w = self.in_proj_weight[i * d:(i + 1) * d]
        b = self.in_proj_bias[i * d:(i + 1) * d]
        return F.linear(x.to(dt), w.to(dt), b.to(dt))

    def q_proj(self, x: torch.Tensor) -> torch.Tensor:
        return self._project(x, 0)

    def k_proj(self, x: torch.Tensor) -> torch.Tensor:
        return self._project(x, 1)

    def v_proj(self, x: torch.Tensor) -> torch.Tensor:
        return self._project(x, 2)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        return x.reshape(b, s, self.heads, self.dim // self.heads)

    def attend_kv(
        self,
        q_in: torch.Tensor,  # [b, sq, dim]
        k: torch.Tensor,  # [b, sk, dim], already projected by k_proj
        v: torch.Tensor,  # [b, sk, dim], already projected by v_proj
        kv_mask: Optional[torch.Tensor] = None,  # [b, sk], nonzero = valid key
        bias: Optional[torch.Tensor] = None,  # additive, to [b, h, sq, sk]
    ) -> torch.Tensor:
        q = self.q_proj(q_in)
        out = dot_product_attention_bshd(
            self._split(q), self._split(k), self._split(v), bias=bias,
            kv_mask=kv_mask, impl=self.attn_impl)
        b, sq = out.shape[:2]
        return self.out_proj(out.reshape(b, sq, self.dim), self.dtype)

    def forward(self, q_in, k_in, v_in, kv_mask=None, bias=None,
                return_k: bool = False):
        """-> the attention's output [b, sq, dim]; with `return_k`, also
        the head-mean keys [b, sk, dim // heads] in the compute dtype (the
        similarity ToMe merges on, ops/tome.py)."""
        k = self.k_proj(k_in)
        out = self.attend_kv(q_in, k, self.v_proj(v_in), kv_mask=kv_mask,
                             bias=bias)
        if return_k:
            return out, self._split(k).mean(dim=2)
        return out

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
