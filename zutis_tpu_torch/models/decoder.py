"""DETR/MaskFormer-style query transformer decoder, post-norm (the port of
zutis_tpu/models/decoder.py).

Each layer self-attends over the queries (q = k = tgt + query_pos, v = tgt),
cross-attends into the image memory (q = tgt + query_pos, k = memory + pos,
v = memory), then runs a ReLU FFN, with a LayerNorm after each residual.
`memory + pos` is the same for every layer, so it is added once outside the
layer loop. Every layer's output is stacked and passed through one shared
final norm: [n_layers, b, q, d].
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from zutis_tpu_torch.models.layers import Dense, LayerNorm32, MultiHeadAttention


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, dim_feedforward: int = 2048,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MultiHeadAttention(d_model, heads, dtype=dtype,
                                            attn_impl=attn_impl, device=device)
        self.multihead_attn = MultiHeadAttention(
            d_model, heads, dtype=dtype, attn_impl=attn_impl, device=device)
        self.linear1 = Dense(d_model, dim_feedforward, device=device)
        self.linear2 = Dense(dim_feedforward, d_model, device=device)
        self.norm1 = LayerNorm32(d_model, device=device)
        self.norm2 = LayerNorm32(d_model, device=device)
        self.norm3 = LayerNorm32(d_model, device=device)

    def forward(
        self,
        tgt: torch.Tensor,  # [b, q, d]
        mem_pos: torch.Tensor,  # [b, s, d] memory + pos (hoisted, shared)
        memory: torch.Tensor,  # [b, s, d]
        query_pos: Optional[torch.Tensor],  # [b, q, d]
        memory_mask: Optional[torch.Tensor] = None,  # [b, s] valid memory keys
        memory_bias: Optional[torch.Tensor] = None,  # additive, [b, 1, 1, s]
    ) -> torch.Tensor:
        q = tgt if query_pos is None else tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        q = tgt if query_pos is None else tgt + query_pos
        cross = self.multihead_attn
        tgt = self.norm2(tgt + cross.attend_kv(
            q, cross.k_proj(mem_pos), cross.v_proj(memory), kv_mask=memory_mask,
            bias=memory_bias))
        y = self.linear2(F.relu(self.linear1(tgt, self.dtype)), self.dtype)
        return self.norm3(tgt + y)

    def init_params(self, generator: torch.Generator) -> None:
        for m in (self.self_attn, self.multihead_attn, self.linear1,
                  self.linear2, self.norm1, self.norm2, self.norm3):
            m.init_params(generator)


class QueryDecoder(nn.Module):
    def __init__(self, d_model: int, heads: int = 8, num_layers: int = 6,
                 dim_feedforward: int = 2048,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, heads, dim_feedforward, dtype=dtype,
                         attn_impl=attn_impl, device=device)
            for _ in range(num_layers)
        )
        self.norm = LayerNorm32(d_model, device=device)

    def forward(
        self,
        tgt: torch.Tensor,
        memory: torch.Tensor,
        pos: Optional[torch.Tensor] = None,
        query_pos: Optional[torch.Tensor] = None,
        memory_mask: Optional[torch.Tensor] = None,
        memory_bias: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """-> [n_layers, b, q, d], each layer's output through the shared
        final norm. `memory_mask` [b, s] (nonzero = valid) masks the
        cross-attention's keys: the padded eval path's memory padding.
        `memory_bias` is an additive cross-attention bias broadcast to
        [b, h, q, s]: the padded pooled path's log(valid count) a pooled
        key (models/zutis.py)."""
        mem_pos = memory if pos is None else memory + pos
        outputs = []
        x = tgt
        for layer in self.layers:
            x = layer(x, mem_pos, memory, query_pos, memory_mask, memory_bias)
            outputs.append(x)
        return self.norm(torch.stack(outputs, dim=0))

    def init_params(self, generator: torch.Generator) -> None:
        for layer in self.layers:
            layer.init_params(generator)
        self.norm.init_params(generator)
