"""CLIP Vision Transformer encoder returning dense patch tokens (the dense
path of zutis_tpu/models/vit.py).

Patchify (VALID, no bias) -> prepend the class token -> add the bicubically
interpolated positional embedding (with the reference's `+0.1` scale-factor
fudge, applied even at the native grid) -> ln_pre -> pre-LN residual blocks
with QuickGELU MLPs -> drop CLS -> ln_post over the patch tokens. `proj` is a
parameter here but is applied by ZUTIS, not in `forward`.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from zutis_tpu_torch.models.layers import (
    Dense,
    LayerNorm32,
    MultiHeadAttention,
    empty_param,
    fill_normal_,
    quick_gelu,
)
from zutis_tpu_torch.ops.resize import resize_2d


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", device=None):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = LayerNorm32(width, device=device)
        self.attn = MultiHeadAttention(width, heads, dtype=dtype,
                                       attn_impl=attn_impl, device=device)
        self.ln_2 = LayerNorm32(width, device=device)
        self.mlp = nn.ModuleDict({
            "c_fc": Dense(width, width * 4, device=device),
            "c_proj": Dense(width * 4, width, device=device),
        })

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ln_1(x)
        x = x + self.attn(y, y, y)
        y = self.ln_2(x)
        y = quick_gelu(self.mlp["c_fc"](y, self.dtype))
        return x + self.mlp["c_proj"](y, self.dtype)


def interpolate_pos_embed(
    pos_embed: torch.Tensor,  # [1 + g*g, width]
    size: Tuple[int, int],
) -> torch.Tensor:
    """Bicubic interpolation of the patch positional embedding to an (h, w)
    grid under torch's scale_factor path with the reference's +0.1 fudge;
    no identity shortcut at the native grid."""
    h, w = size
    cls_pe, patch_pe = pos_embed[:1], pos_embed[1:]
    hw, n_dims = patch_pe.shape
    g = int(math.sqrt(hw))
    grid = patch_pe.reshape(g, g, n_dims).permute(2, 0, 1)  # [d, g, g]
    scale_h = (h + 0.1) / g
    scale_w = (w + 0.1) / g
    grid = resize_2d(grid, (h, w), mode="cubic",
                     scales=(1.0 / scale_h, 1.0 / scale_w))
    patch_pe = grid.permute(1, 2, 0).reshape(h * w, n_dims)
    return torch.cat([cls_pe, patch_pe], dim=0)


class CLIPViT(nn.Module):
    def __init__(self, width: int = 768, layers: int = 12, heads: int = 12,
                 patch_size: int = 16, output_dim: int = 512,
                 input_resolution: int = 224,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 device=None):
        super().__init__()
        self.width, self.patch_size, self.dtype = width, patch_size, dtype
        grid = input_resolution // patch_size
        self.conv1 = nn.Module()
        self.conv1.weight = empty_param(width, 3, patch_size, patch_size,
                                        device=device)
        self.class_embedding = empty_param(width, device=device)
        self.positional_embedding = empty_param(grid * grid + 1, width,
                                                device=device)
        self.ln_pre = LayerNorm32(width, device=device)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, dtype=dtype,
                                   attn_impl=attn_impl, device=device)
            for _ in range(layers)
        )
        self.ln_post = LayerNorm32(width, device=device)
        self.proj = empty_param(width, output_dim, device=device)

    def init_params(self, generator: torch.Generator) -> None:
        scale = self.width ** -0.5
        fan_in = 3 * self.patch_size * self.patch_size
        fill_normal_(self.conv1.weight, fan_in ** -0.5, generator)
        fill_normal_(self.class_embedding, scale, generator)
        fill_normal_(self.positional_embedding, scale, generator)
        fill_normal_(self.proj, scale, generator)
        self.ln_pre.init_params(generator)
        self.ln_post.init_params(generator)
        for block in self.transformer.resblocks:
            for m in (block.ln_1, block.attn, block.ln_2,
                      block.mlp["c_fc"], block.mlp["c_proj"]):
                m.init_params(generator)

    def _patchify(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """VALID stride-p convolution as one product: partial trailing
        patches are dropped, as torch's unpadded conv does."""
        b, c, hh, ww = x.shape
        p = self.patch_size
        h, w = hh // p, ww // p
        x = x[:, :, :h * p, :w * p].to(self.dtype)
        x = x.reshape(b, c, h, p, w, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(b, h * w, c * p * p)
        kernel = self.conv1.weight.to(self.dtype).reshape(self.width, -1)
        return x @ kernel.t(), h, w

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """x [b, 3, H, W] -> (patch tokens [b, h*w, width] after ln_post, h, w)."""
        tokens, h, w = self._patchify(x)
        b = tokens.shape[0]
        cls_tok = self.class_embedding.to(self.dtype)[None, None].expand(
            b, 1, self.width)
        tokens = torch.cat([cls_tok, tokens], dim=1)
        pe = interpolate_pos_embed(self.positional_embedding, (h, w))
        tokens = self.ln_pre(tokens + pe.to(self.dtype)[None])
        for block in self.transformer.resblocks:
            tokens = block(tokens)
        return self.ln_post(tokens[:, 1:, :]), h, w
