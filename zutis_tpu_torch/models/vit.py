"""CLIP Vision Transformer encoder returning dense patch tokens (the dense
path of zutis_tpu/models/vit.py).

Patchify (VALID, no bias) -> prepend the class token -> add the bicubically
interpolated positional embedding (with the reference's `+0.1` scale-factor
fudge, applied even at the native grid) -> ln_pre -> pre-LN residual blocks
with QuickGELU MLPs -> drop CLS -> ln_post over the patch tokens. `proj` is a
parameter here but is applied by ZUTIS, not in `forward`; `encode_image`
gives CLIP's pooled embedding, ln_post(CLS) @ proj, for retrieval.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from zutis_tpu_torch.core.device import to_device
from zutis_tpu_torch.models.layers import (
    Dense,
    LayerNorm32,
    MultiHeadAttention,
    empty_param,
    fill_normal_,
    quick_gelu,
)
from zutis_tpu_torch.ops.dynamic_shapes import (
    interpolate_pos_embed_batched,
    token_valid_mask,
)
from zutis_tpu_torch.ops.resize import resize_2d
from zutis_tpu_torch.ops.tome import (
    merge_schedule,
    proportional_attn_bias,
    tome_merge,
)


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

    def forward(self, x: torch.Tensor,
                kv_mask: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None,
                tome_r: int = 0, size: Optional[torch.Tensor] = None):
        """Pre-LN block; an additive attention `bias` that is not per key
        (the text tower's causal mask) takes the "torch" attention path.
        With tome_r > 0 and `size` the [b, s] token sizes, r tokens merge
        between the attention and the MLP (ops/tome.py), the attention
        taking the proportional bias log(size), and the block returns (x
        [b, s - r, d], size [b, s - r], mapping [b, s]); tome_r = 0 is the
        program without merging."""
        y = self.ln_1(x)
        mapping = None
        if tome_r <= 0:
            x = x + self.attn(y, y, y, kv_mask=kv_mask, bias=bias)
        else:
            prop = proportional_attn_bias(size)
            out, k_mean = self.attn(
                y, y, y, kv_mask=kv_mask,
                bias=prop if bias is None else prop + bias, return_k=True)
            x, size, mapping = tome_merge(x + out, k_mean, size, tome_r)
        y = self.ln_2(x)
        y = quick_gelu(self.mlp["c_fc"](y, self.dtype))
        x = x + self.mlp["c_proj"](y, self.dtype)
        if mapping is not None:
            return x, size, mapping
        return x


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


def interpolate_pos_embed_exact(
    pos_embed: torch.Tensor,  # [1 + g*g, width]
    size: Tuple[int, int],
) -> torch.Tensor:
    """The SelfMask ViT's variant: the identity at the stored grid, else an
    exact-size bicubic resize (F.interpolate's size path) with no +0.1
    fudge, which belongs to the CLIP tower only."""
    h, w = size
    cls_pe, patch_pe = pos_embed[:1], pos_embed[1:]
    hw, n_dims = patch_pe.shape
    g = int(math.sqrt(hw))
    if (h, w) == (g, g):
        return pos_embed
    grid = patch_pe.reshape(g, g, n_dims).permute(2, 0, 1)  # [d, g, g]
    grid = resize_2d(grid, (h, w), mode="cubic")
    patch_pe = grid.permute(1, 2, 0).reshape(h * w, n_dims)
    return torch.cat([cls_pe, patch_pe], dim=0)


class CLIPViT(nn.Module):
    def __init__(self, width: int = 768, layers: int = 12, heads: int = 12,
                 patch_size: int = 16, output_dim: int = 512,
                 input_resolution: int = 224,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 tome_r: int = 0, device=None):
        super().__init__()
        self.width, self.patch_size, self.dtype = width, patch_size, dtype
        # opt-in token merging: up to tome_r tokens a block (ops/tome.py);
        # 0 is the program without merging, and it adds no parameter
        self.tome_r = tome_r
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

    def _with_cls(self, tokens: torch.Tensor) -> torch.Tensor:
        cls_tok = self.class_embedding.to(self.dtype)[None, None].expand(
            tokens.shape[0], 1, self.width)
        return torch.cat([cls_tok, tokens], dim=1)

    def _forward_tokens(self, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, int, int]:
        """x [b, 3, H, W] -> (tokens with CLS [b, 1 + h*w, width], h, w)."""
        tokens, h, w = self._patchify(x)
        tokens = self._with_cls(tokens)
        pe = interpolate_pos_embed(self.positional_embedding, (h, w))
        tokens = self.ln_pre(tokens + pe.to(self.dtype)[None])
        if self.tome_r > 0:
            return self._run_blocks_tome(tokens), h, w
        for block in self.transformer.resblocks:
            tokens = block(tokens)
        return tokens, h, w

    def _run_blocks_tome(self, tokens: torch.Tensor,
                         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The blocks with token merging -> dense tokens [b, s0, width]: the
        merged stream gathered back to every original position through the
        composed per-block mappings, CLS at 0.

        With `valid` ([b, s0] f32, the padded path), padding tokens start
        at size 0: they merge with zero weight, first, and each block's key
        mask is size > 0. A padding slot may also take a merge of two valid
        tokens' content, as the JAX package's padded path does (ROADMAP.md
        §3)."""
        b, s0, _ = tokens.shape
        if valid is None:
            size = torch.ones((b, s0), dtype=torch.float32, device=tokens.device)
        else:
            size = valid.float()
        assign = torch.arange(s0, device=tokens.device).expand(b, s0)
        blocks = self.transformer.resblocks
        for block, r_eff in zip(blocks, merge_schedule(s0, self.tome_r,
                                                       len(blocks))):
            kv_mask = None if valid is None else size > 0
            if r_eff <= 0:
                tokens = block(tokens, kv_mask=kv_mask)
                continue
            tokens, size, mapping = block(tokens, kv_mask=kv_mask,
                                          tome_r=r_eff, size=size)
            assign = torch.gather(mapping, 1, assign).long()
        return torch.gather(tokens, 1,
                            assign[..., None].expand(-1, -1, self.width))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """x [b, 3, H, W] -> (patch tokens [b, h*w, width] after ln_post, h, w)."""
        tokens, h, w = self._forward_tokens(x)
        return self.ln_post(tokens[:, 1:, :]), h, w

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        """CLIP's pooled embedding: ln_post(CLS) @ proj -> [b, output_dim],
        on the same token path as `forward` (the retrieval bank's encoder)."""
        tokens, _, _ = self._forward_tokens(x)
        pooled = self.ln_post(tokens[:, 0, :])
        return pooled @ self.proj.to(self.dtype)

    def forward_padded(
        self,
        x: torch.Tensor,  # [b, 3, H_pad, W_pad], padded bottom/right
        native_grid: torch.Tensor,  # [b, 2] native token grids, on the host
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Variable-resolution forward under one padded shape: each sample's
        positional embedding is interpolated to its native grid, and every
        attention layer masks the keys to the sample's CLS and valid patch
        tokens, so valid tokens never see padding. -> (patch tokens
        [b, hp*wp, width], of which each sample's top-left [h_i, w_i] window
        is meaningful; the [b, hp*wp] int32 validity mask). With tome_r > 0
        the padding tokens start at size 0 (`_run_blocks_tome`)."""
        tokens, hp, wp = self._patchify(x)
        b = tokens.shape[0]
        tokens = self._with_cls(tokens)
        pe = interpolate_pos_embed_batched(
            self.positional_embedding, native_grid, (hp, wp))
        tokens = self.ln_pre(tokens + pe.to(self.dtype))
        patch_valid = token_valid_mask(to_device(native_grid, x.device), hp, wp)
        # one int32 mask, CLS always valid, shared by every layer's launch
        kv_mask = torch.cat([torch.ones(b, 1, dtype=torch.int32,
                                        device=x.device), patch_valid], dim=1)
        if self.tome_r > 0:
            tokens = self._run_blocks_tome(tokens, valid=kv_mask)
        else:
            for block in self.transformer.resblocks:
                tokens = block(tokens, kv_mask=kv_mask)
        return self.ln_post(tokens[:, 1:, :]), patch_valid
