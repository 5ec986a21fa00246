"""The ZUTIS network, CLIP ViT family (the port of
zutis_tpu/models/zutis.py `ZUTIS` with encoder_family="vit"), with its two
opt-in levers: `tome_r` (token merging in the encoder, ops/tome.py) and
`decoder_pool` (the cross-attention reads a pooled memory).

  1. encoder -> patch tokens [b, hw, width]
  2. bilinear x2 upsample of the token grid
  3. ffn1(tokens) -> decoder memory; with `stop_gradient` (the default)
     the tokens are detached, so the mask loss trains no encoder weight
  4. sine positional embedding over the upsampled grid
  5. query decoder, tgt = 0, query_pos = the learned queries, all layers
     (`inference=True` keeps only the last layer after the decoder); with
     decoder_pool p > 1 the cross-attention reads the p x p cell means of
     memory and position, and the proposals of step 7 keep the dense memory
  6. ffn2(queries), L2-normalised (a zero query maps to zero)
  7. mask_proposals = sigmoid(queries . memory) in f32
  8. text-space tokens: tokens @ proj, a parameter-free LayerNorm over the
     whole (h, w, c) map, L2-normalised with eps 1e-7

Returns {"mask_proposals": [b, L, Q, h, w], "patch_tokens": [b, h, w, text_dim]},
both f32.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from zutis_tpu_torch.core.device import resolve_device, to_device
from zutis_tpu_torch.models.decoder import QueryDecoder
from zutis_tpu_torch.models.layers import MLP, fill_normal_
from zutis_tpu_torch.models.pos_embed import sine_pos_embed
from zutis_tpu_torch.models.vit import CLIPViT
from zutis_tpu_torch.ops.dynamic_shapes import (
    replicate_edges,
    sine_pos_embed_dynamic,
    token_valid_mask,
)
from zutis_tpu_torch.ops.resize import interpolate


def full_map_layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free LayerNorm over all non-batch axes (population variance)."""
    dims = tuple(range(1, x.dim()))
    x32 = x.float()
    mean = x32.mean(dim=dims, keepdim=True)
    var = x32.var(dim=dims, keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def masked_full_map_layer_norm(
    x: torch.Tensor,  # [b, h, w, c]
    valid: torch.Tensor,  # [b, h, w], 1 inside each sample's native window
    eps: float = 1e-5,
) -> torch.Tensor:
    """`full_map_layer_norm` with statistics over each sample's valid window
    only, so that the padded program equals the per-image one there. Values
    outside the window are meaningless."""
    x32 = x.float()
    m = valid.float()[..., None]
    dims = (1, 2, 3)
    count = m.sum(dim=dims, keepdim=True) * x.shape[-1]
    mean = (x32 * m).sum(dim=dims, keepdim=True) / count
    var = ((x32 - mean) ** 2 * m).sum(dim=dims, keepdim=True) / count
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _l2_normalize_queries(queries: torch.Tensor) -> torch.Tensor:
    """Divide by the f32 norm with no eps; an exact-zero query maps to zero
    rather than NaN."""
    q32 = queries.float()
    norm = torch.linalg.vector_norm(q32, dim=-1, keepdim=True)
    return (q32 / torch.clamp(norm, min=1e-30)).to(queries.dtype)


def _cell_mean(t: torch.Tensor, h: int, w: int, p: int, weight=None,
               count=None) -> torch.Tensor:
    """[n, h*w, c] -> [n, (h/p)*(w/p), c]: the f32 mean over each p x p
    cell, or with `weight` [n, h/p, p, w/p, p] and its cell sums `count`
    the weighted sum over max(count, 1); cast back to t's dtype."""
    n, c = t.shape[0], t.shape[-1]
    g = t.reshape(n, h // p, p, w // p, p, c).float()
    if weight is None:
        g = g.mean(dim=(2, 4))
    else:
        g = (g * weight[..., None]).sum(dim=(2, 4)) / torch.clamp(
            count, min=1.0)[..., None]
    return g.to(t.dtype).reshape(n, -1, c)


class ZUTIS(nn.Module):
    def __init__(
        self,
        width: int = 768,
        encoder_layers: int = 12,
        encoder_heads: int = 12,
        patch_size: int = 16,
        text_dim: int = 512,
        input_resolution: int = 224,
        n_queries: int = 100,
        n_decoder_layers: int = 6,
        n_heads: int = 8,
        stop_gradient: bool = True,
        dtype: torch.dtype = torch.float32,
        attn_impl: str = "auto",
        tome_r: int = 0,
        decoder_pool: int = 1,
        device="cuda",
    ):
        super().__init__()
        device = resolve_device(device)
        if decoder_pool < 1:
            raise ValueError(f"decoder_pool must be >= 1, got {decoder_pool}")
        self.width, self.n_queries, self.dtype = width, n_queries, dtype
        self.stop_gradient = stop_gradient
        # the levers add no parameter: one checkpoint serves every setting
        self.tome_r, self.decoder_pool = tome_r, decoder_pool
        self.encoder = CLIPViT(
            width=width, layers=encoder_layers, heads=encoder_heads,
            patch_size=patch_size, output_dim=text_dim,
            input_resolution=input_resolution, dtype=dtype,
            attn_impl=attn_impl, tome_r=tome_r, device=device,
        )
        self.ffn1 = MLP(width, 256, width, 3, dtype=dtype, device=device)
        self.ffn2 = MLP(width, 256, width, 3, dtype=dtype, device=device)
        self.decoder = QueryDecoder(
            d_model=width, heads=n_heads, num_layers=n_decoder_layers,
            dtype=dtype, attn_impl=attn_impl, device=device,
        )
        self.query_embed = nn.Parameter(
            torch.empty(n_queries, width, dtype=torch.float32, device=device))

    def init_params(self, generator: Optional[torch.Generator] = None) -> "ZUTIS":
        """Random parameters drawn from a CPU `generator` (seed 0 if None):
        the same values on every device. Returns self."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.encoder.init_params(generator)
        self.ffn1.init_params(generator)
        self.ffn2.init_params(generator)
        self.decoder.init_params(generator)
        fill_normal_(self.query_embed, 1.0, generator)  # nn.Embedding's N(0, 1)
        return self

    def forward(self, x: torch.Tensor, inference: bool = False
                ) -> Dict[str, torch.Tensor]:
        b = x.shape[0]
        dt, width = self.dtype, self.width
        patch_tokens, h, w = self.encoder(x)

        grid = patch_tokens.reshape(b, h, w, width).permute(0, 3, 1, 2)
        grid = interpolate(grid, scale_factor=2, mode="bilinear")
        h, w = h * 2, w * 2
        patch_tokens = grid.permute(0, 2, 3, 1).reshape(b, h * w, width)

        memory = self.ffn1(self._tokens_in(patch_tokens))  # [b, hw, width]
        pos = sine_pos_embed(h, w, width // 2).reshape(width, -1).T
        # pinned and non-blocking: a pageable copy would wait for the card
        pos = to_device(torch.from_numpy(np.ascontiguousarray(pos)), x.device).to(dt)[None]

        tgt, query_pos = self._queries(b)
        mem_att, pos_att = memory, pos
        if self.decoder_pool > 1:
            p = self._pool_factor(h, w, "(post-upsample) token grid")
            mem_att = _cell_mean(memory, h, w, p)
            pos_att = _cell_mean(pos, h, w, p)
        queries = self.decoder(tgt, mem_att, pos=pos_att, query_pos=query_pos)
        return self._heads(queries, memory, patch_tokens, h, w, inference,
                           full_map_layer_norm)

    def _pool_factor(self, h: int, w: int, what: str) -> int:
        p = self.decoder_pool
        if h % p or w % p:
            raise ValueError(f"decoder_pool={p} must divide the {what} {h}x{w}")
        return p

    def _tokens_in(self, patch_tokens: torch.Tensor) -> torch.Tensor:
        """ffn1's input: the tokens, detached under `stop_gradient`."""
        return patch_tokens.detach() if self.stop_gradient else patch_tokens

    def _queries(self, b: int):
        """(tgt, query_pos) for the decoder: zeros and the learned queries."""
        query_pos = self.query_embed.to(self.dtype)[None].expand(
            b, self.n_queries, self.width)
        return torch.zeros_like(query_pos), query_pos

    def _heads(self, queries, memory, patch_tokens, h, w, inference, norm):
        """Steps 6-8: the mask proposals and the text-space tokens; `norm` is
        the full-map LayerNorm (masked on the padded path)."""
        b, width = memory.shape[0], self.width
        if inference:
            queries = queries[-1:]  # last decoder layer only
        queries = self.ffn2(queries.permute(1, 0, 2, 3))  # [b, L, Q, d]
        queries = _l2_normalize_queries(queries)

        memory_grid = memory.reshape(b, h, w, width)
        # bf16 operands are exact in f32; the products accumulate in f32
        logits = torch.einsum("blqc,bhwc->blqhw", queries.float(),
                              memory_grid.float())
        mask_proposals = torch.sigmoid(logits)

        token_grid = patch_tokens.reshape(b, h, w, width)
        text_tokens = torch.einsum("bhwn,nc->bhwc", token_grid.float(),
                                   self.encoder.proj.to(self.dtype).float())
        text_tokens = norm(text_tokens)
        text_tokens = text_tokens / (
            torch.linalg.vector_norm(text_tokens, dim=-1, keepdim=True) + 1e-7)
        return {"mask_proposals": mask_proposals.float(),
                "patch_tokens": text_tokens.float()}

    def forward_padded(
        self,
        x: torch.Tensor,  # [b, 3, H_pad, W_pad], padded bottom/right
        native_grid,  # [b, 2] native token grids (H // p, W // p), on the host
        inference: bool = True,
    ) -> Dict[str, torch.Tensor]:
        """Batched variable-resolution forward for the bucketed evaluator.
        Without the levers, each sample's valid window equals, up to
        summation order, what `forward` computes at its native size:
          - encoder: per-sample positional embedding and key-masked
            attention (`CLIPViT.forward_padded`; with tome_r, padding
            merges first at zero weight);
          - the x2 upsample reads an edge-replicated grid, which reproduces
            the native program's clamped border taps;
          - decoder: the sine embedding normalised by the native extent, and
            the memory's padding masked out of the cross-attention (with
            decoder_pool, pooled by validity with a log(count) key bias);
          - text-space tokens: the full-map LayerNorm over the valid window.
        Returns the forward's outputs plus "valid" [b, h, w] int32 on the
        device and "native_grid" [b, 2], the upsampled native grids on the
        host."""
        b, width = x.shape[0], self.width
        native_grid = torch.as_tensor(native_grid).to("cpu", torch.int64)
        patch_tokens, _ = self.encoder.forward_padded(x, native_grid)
        p = self.encoder.patch_size
        hp, wp = x.shape[-2] // p, x.shape[-1] // p

        grid_d = to_device(native_grid, x.device)
        grid = replicate_edges(patch_tokens.reshape(b, hp, wp, width), grid_d)
        grid = interpolate(grid.permute(0, 3, 1, 2), scale_factor=2,
                           mode="bilinear")
        hp, wp = hp * 2, wp * 2
        native_grid, grid_d = native_grid * 2, grid_d * 2
        patch_tokens = grid.permute(0, 2, 3, 1).reshape(b, hp * wp, width)
        valid = token_valid_mask(grid_d, hp, wp)  # [b, hp*wp] int32

        memory = self.ffn1(self._tokens_in(patch_tokens))
        pos = sine_pos_embed_dynamic(hp, wp, width // 2, native_grid,
                                     device=x.device).to(self.dtype)
        tgt, query_pos = self._queries(b)
        if self.decoder_pool > 1:
            # each pooled key averages the valid tokens of its p x p cell
            # (cells follow the padded grid's origin) and carries a
            # +log(count) bias, so a cell of c identical valid tokens draws
            # c dense tokens' softmax mass; cells with no valid token are
            # masked out
            p = self._pool_factor(hp, wp, "bucket token grid")
            v32 = valid.reshape(b, hp // p, p, wp // p, p).float()
            count = v32.sum(dim=(2, 4))  # [b, hp / p, wp / p]
            queries = self.decoder(
                tgt, _cell_mean(memory, hp, wp, p, v32, count),
                pos=_cell_mean(pos, hp, wp, p, v32, count),
                query_pos=query_pos,
                # int32 once, as the kernel reads it, for all six layers
                memory_mask=(count > 0).reshape(b, -1).int(),
                memory_bias=torch.log(torch.clamp(count, min=1.0)).reshape(
                    b, 1, 1, -1))
        else:
            queries = self.decoder(tgt, memory, pos=pos, query_pos=query_pos,
                                   memory_mask=valid)
        valid_grid = valid.reshape(b, hp, wp)
        out = self._heads(
            queries, memory, patch_tokens, hp, wp, inference,
            lambda t: masked_full_map_layer_norm(t, valid_grid))
        return dict(out, valid=valid_grid, native_grid=native_grid)
