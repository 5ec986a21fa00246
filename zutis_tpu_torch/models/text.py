"""CLIP's text encoder (the port of zutis_tpu/models/text.py): run once to
turn category names and prompts into embeddings (reference
networks/clip_arch.py:534-547, `encode_text`).

Token embedding + learned positional embedding -> causal pre-LN blocks with
QuickGELU MLPs -> ln_final -> the EOT token (the argmax of the ids: EOT is
the highest id of CLIP's vocabulary) -> text_projection.

Parameters carry OpenAI's keys (`token_embedding.weight`,
`positional_embedding`, `transformer.resblocks.{i}.*`, `ln_final.*`,
`text_projection`), so the text half of an OpenAI `.pt` loads with
`strict=True` (models/factory.py::load_clip_text). The causal mask is an
additive -inf bias, which sends attention to the "torch" path
(ops/attention.py), as the JAX package sends it to XLA.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from zutis_tpu_torch.core.device import resolve_device, to_device
from zutis_tpu_torch.models.layers import (LayerNorm32, empty_param,
                                           fill_normal_)
from zutis_tpu_torch.models.vit import ResidualAttentionBlock


def causal_bias(n: int, device) -> torch.Tensor:
    """[1, 1, n, n] f32: 0 on and below the diagonal, -inf above it."""
    return torch.full((n, n), float("-inf"), device=device).triu(1)[None, None]


class CLIPTextEncoder(nn.Module):
    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, layers: int = 12, heads: int = 8,
                 embed_dim: int = 512, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.width, self.dtype = width, dtype
        self.vocab_size, self.context_length = vocab_size, context_length
        self.token_embedding = nn.Module()
        self.token_embedding.weight = empty_param(vocab_size, width,
                                                  device=device)
        self.positional_embedding = empty_param(context_length, width,
                                                device=device)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype=dtype, device=device)
            for _ in range(layers))
        self.ln_final = LayerNorm32(width, device=device)
        self.text_projection = empty_param(width, embed_dim, device=device)

    @property
    def device(self) -> torch.device:
        return self.positional_embedding.device

    def init_params(self, generator: torch.Generator | None = None
                    ) -> "CLIPTextEncoder":
        """Random parameters drawn from a CPU `generator` (seed 0 if None),
        with OpenAI's scales for the embeddings. Returns self."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        fill_normal_(self.token_embedding.weight, 0.02, generator)
        fill_normal_(self.positional_embedding, 0.01, generator)
        fill_normal_(self.text_projection, self.width ** -0.5, generator)
        self.ln_final.init_params(generator)
        for block in self.transformer.resblocks:
            for m in (block.ln_1, block.attn, block.ln_2,
                      block.mlp["c_fc"], block.mlp["c_proj"]):
                m.init_params(generator)
        return self

    def forward(self, text) -> torch.Tensor:
        """text: [b, context_length] token ids (a tensor or an int array)
        -> [b, embed_dim] in the compute dtype, unnormalised."""
        if isinstance(text, np.ndarray):
            text = torch.from_numpy(text)
        if text.shape[1] != self.context_length:
            raise ValueError(f"token ids of length {text.shape[1]}: the "
                             f"tower takes {self.context_length}")
        if int(text.max()) >= self.vocab_size or int(text.min()) < 0:
            raise ValueError(f"token ids outside [0, {self.vocab_size}): "
                             "a tokenizer with a larger vocabulary")
        text = to_device(text.to(torch.int64), self.device)
        x = F.embedding(text, self.token_embedding.weight).to(self.dtype)
        x = x + self.positional_embedding.to(self.dtype)[None]
        bias = causal_bias(self.context_length, x.device)
        for block in self.transformer.resblocks:
            x = block(x, bias=bias)
        x = self.ln_final(x)
        eot = text.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection.to(self.dtype)
