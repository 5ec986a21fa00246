"""SelfMask, the pseudo-labeller (the port of zutis_tpu/models/selfmask.py):
a frozen DINO DeiT-S/8 encoder, a 20-query DETR decoder and an objectness
MLP; `best_masks` keeps the highest-objectness mask of each image.

  encoder: patchify (stride-p convolution with bias), CLS token, the stored
      positional embedding resized exact-size bicubic (the identity at the
      stored grid, no +0.1 fudge), pre-norm blocks with exact-GELU MLPs,
      final LayerNorm. Inputs are zero-padded right and bottom to a patch
      multiple by the caller (`pad_to_patch_multiple`); the padded tokens
      are attended to, as the reference attends to them.
  decoder: 6 post-norm layers (FFN 4 x width) over tgt = 0 with the learned
      queries as query_pos and no memory positional embedding; the last
      layer through the shared final norm.
  heads: masks = sigmoid(queries . patch tokens upsampled x2 bilinear);
      objectness = MLP(width, width, 1) with 3 layers.

Parameters carry the reference checkpoint's names and shapes
(`encoder.patch_embed.proj`, `encoder.pos_embed` [1, 1 + g*g, d],
`encoder.blocks.N.mlp.fc1`, `decoder.layers.N.*`, `query_embed`, `ffn.*`),
except that each block's fused `attn.qkv` / `attn.proj` are the port's
`attn.in_proj_*` / `attn.out_proj`, in the same q, k, v order
(`models/weights.py::selfmask_state_dict` maps them). Attention goes through
`MultiHeadAttention`: on a card, the flash kernel, 24 launches an image
(12 encoder self, 6 decoder self, 6 cross).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from zutis_tpu_torch.core.device import resolve_device
from zutis_tpu_torch.data.transforms import pad_to_multiple
from zutis_tpu_torch.models.decoder import QueryDecoder
from zutis_tpu_torch.models.layers import (
    MLP,
    Dense,
    LayerNorm32,
    MultiHeadAttention,
    empty_param,
    fill_normal_,
)
from zutis_tpu_torch.models.vit import interpolate_pos_embed_exact
from zutis_tpu_torch.ops.resize import interpolate


class DeiTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm32(dim, device=device)
        self.attn = MultiHeadAttention(dim, heads, dtype=dtype,
                                       attn_impl=attn_impl, device=device)
        self.norm2 = LayerNorm32(dim, device=device)
        self.mlp = nn.ModuleDict({
            "fc1": Dense(dim, dim * mlp_ratio, device=device),
            "fc2": Dense(dim * mlp_ratio, dim, device=device),
        })

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        x = x + self.attn(y, y, y)
        y = F.gelu(self.mlp["fc1"](self.norm2(x), self.dtype))
        return x + self.mlp["fc2"](y, self.dtype)

    def init_params(self, generator: torch.Generator) -> None:
        for m in (self.norm1, self.attn, self.norm2, self.mlp["fc1"],
                  self.mlp["fc2"]):
            m.init_params(generator)


class DeiTEncoder(nn.Module):
    """DINO DeiT returning every token after the final norm."""

    def __init__(self, embed_dim: int = 384, depth: int = 12, heads: int = 6,
                 patch_size: int = 8, base_grid: int = 28,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 device=None):
        super().__init__()
        self.embed_dim, self.patch_size = embed_dim, patch_size
        self.dtype = dtype
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Module()
        self.patch_embed.proj.weight = empty_param(
            embed_dim, 3, patch_size, patch_size, device=device)
        self.patch_embed.proj.bias = empty_param(embed_dim, device=device)
        self.cls_token = empty_param(1, 1, embed_dim, device=device)
        self.pos_embed = empty_param(1, base_grid * base_grid + 1, embed_dim,
                                     device=device)
        self.blocks = nn.ModuleList(
            DeiTBlock(embed_dim, heads, dtype=dtype, attn_impl=attn_impl,
                      device=device)
            for _ in range(depth))
        self.norm = LayerNorm32(embed_dim, device=device)

    def init_params(self, generator: torch.Generator) -> None:
        fan_in = 3 * self.patch_size * self.patch_size
        fill_normal_(self.patch_embed.proj.weight, fan_in ** -0.5, generator)
        fill_normal_(self.pos_embed, 0.02, generator)
        with torch.no_grad():
            self.patch_embed.proj.bias.zero_()
            self.cls_token.zero_()
        for block in self.blocks:
            block.init_params(generator)
        self.norm.init_params(generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """x [b, 3, H, W] -> (tokens with CLS [b, 1 + h*w, d] after the
        final norm, h = H // p, w = W // p): the rows and columns past the
        last whole patch are dropped, as flax's VALID convolution drops
        them (SelfMask pads its inputs to patch multiples first)."""
        b, c, hh, ww = x.shape
        p, d, dt = self.patch_size, self.embed_dim, self.dtype
        h, w = hh // p, ww // p
        # the stride-p convolution as one product over the patches
        x = x[..., :h * p, :w * p]
        patches = x.to(dt).reshape(b, c, h, p, w, p).permute(0, 2, 4, 1, 3, 5)
        proj = self.patch_embed.proj
        tokens = F.linear(patches.reshape(b, h * w, c * p * p),
                          proj.weight.to(dt).reshape(d, -1), proj.bias.to(dt))
        cls_tok = self.cls_token.to(dt).expand(b, 1, d)
        tokens = torch.cat([cls_tok, tokens], dim=1)
        pe = interpolate_pos_embed_exact(self.pos_embed[0], (h, w))
        tokens = tokens + pe.to(dt)[None]
        for block in self.blocks:
            tokens = block(tokens)
        return self.norm(tokens), h, w


class SelfMask(nn.Module):
    def __init__(self, n_queries: int = 20, patch_size: int = 8,
                 n_decoder_layers: int = 6, embed_dim: int = 384,
                 heads: int = 6, scale_factor: int = 2, base_grid: int = 28,
                 depth: int = 12, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.n_queries, self.patch_size = n_queries, patch_size
        self.embed_dim, self.scale_factor = embed_dim, scale_factor
        self.dtype = dtype
        self.encoder = DeiTEncoder(
            embed_dim=embed_dim, depth=depth, heads=heads,
            patch_size=patch_size, base_grid=base_grid, dtype=dtype,
            attn_impl=attn_impl, device=device)
        self.decoder = QueryDecoder(
            d_model=embed_dim, heads=heads, num_layers=n_decoder_layers,
            dim_feedforward=embed_dim * 4, dtype=dtype, attn_impl=attn_impl,
            device=device)
        self.query_embed = empty_param(n_queries, embed_dim, device=device)
        self.ffn = MLP(embed_dim, embed_dim, 1, 3, dtype=dtype, device=device)

    def init_params(self, generator: torch.Generator = None) -> "SelfMask":
        """Random parameters drawn from a CPU `generator` (seed 0 if None):
        the same values on every device. Returns self."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.encoder.init_params(generator)
        self.decoder.init_params(generator)
        fill_normal_(self.query_embed, 1.0, generator)
        self.ffn.init_params(generator)
        return self

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [b, 3, H, W], H and W patch multiples -> mask_pred
        [b, Q, 2h, 2w] in [0, 1] and objectness [b, Q], both f32."""
        b, d = x.shape[0], self.embed_dim
        tokens, h, w = self.encoder(x)
        patch_tokens = tokens[:, 1:, :]  # [b, hw, d]
        query_pos = self.query_embed.to(self.dtype)[None].expand(
            b, self.n_queries, d)
        # the last layer through the shared norm (the decoder stacks all)
        queries = self.decoder(torch.zeros_like(query_pos), patch_tokens,
                               query_pos=query_pos)[-1]  # [b, Q, d]
        grid = patch_tokens.reshape(b, h, w, d).permute(0, 3, 1, 2)
        grid = interpolate(grid, scale_factor=self.scale_factor,
                           mode="bilinear")  # [b, d, 2h, 2w]
        logits = torch.einsum("bqd,bdhw->bqhw", queries, grid).float()
        return {"mask_pred": torch.sigmoid(logits),
                "objectness": self.ffn(queries)[..., 0].float()}

    def best_masks(self, x: torch.Tensor) -> torch.Tensor:
        """Masks upsampled x4 bilinear and cropped to x's H x W, the
        argmax-objectness query's, thresholded at 0.5 -> [b, H, W] uint8."""
        H, W = x.shape[-2:]
        out = self(x)
        up = interpolate(out["mask_pred"], scale_factor=4, mode="bilinear")
        up = up[..., :H, :W]
        best = torch.argmax(out["objectness"], dim=1)
        sel = torch.take_along_dim(up, best[:, None, None, None], dim=1)[:, 0]
        return (sel > 0.5).to(torch.uint8)


def pad_to_patch_multiple(x: np.ndarray, patch: int = 8) -> np.ndarray:
    """Zero-pad [..., H, W] right and bottom to patch multiples."""
    return pad_to_multiple(x, patch)[0]
