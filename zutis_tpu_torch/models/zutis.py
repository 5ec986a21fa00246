"""The ZUTIS network, CLIP ViT family, dense forward (the port of
zutis_tpu/models/zutis.py `ZUTIS.__call__` with encoder_family="vit",
decoder_pool=1 and tome_r=0).

  1. encoder -> patch tokens [b, hw, width]
  2. bilinear x2 upsample of the token grid
  3. ffn1(detached tokens) -> decoder memory
  4. sine positional embedding over the upsampled grid
  5. query decoder, tgt = 0, query_pos = the learned queries, all layers
     (`inference=True` keeps only the last layer after the decoder)
  6. ffn2(queries), L2-normalised (a zero query maps to zero)
  7. mask_proposals = sigmoid(queries . memory) in f32
  8. text-space tokens: tokens @ proj, a parameter-free LayerNorm over the
     whole (h, w, c) map, L2-normalised with eps 1e-7

Returns {"mask_proposals": [b, L, Q, h, w], "patch_tokens": [b, h, w, text_dim]},
both f32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from zutis_tpu_torch.core.device import resolve_device
from zutis_tpu_torch.models.decoder import QueryDecoder
from zutis_tpu_torch.models.layers import MLP, fill_normal_
from zutis_tpu_torch.models.pos_embed import sine_pos_embed
from zutis_tpu_torch.models.vit import CLIPViT
from zutis_tpu_torch.ops.resize import interpolate


def full_map_layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Parameter-free LayerNorm over all non-batch axes (population variance)."""
    dims = tuple(range(1, x.dim()))
    x32 = x.float()
    mean = x32.mean(dim=dims, keepdim=True)
    var = x32.var(dim=dims, keepdim=True, unbiased=False)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _l2_normalize_queries(queries: torch.Tensor) -> torch.Tensor:
    """Divide by the f32 norm with no eps; an exact-zero query maps to zero
    rather than NaN."""
    q32 = queries.float()
    norm = torch.linalg.vector_norm(q32, dim=-1, keepdim=True)
    return (q32 / torch.clamp(norm, min=1e-30)).to(queries.dtype)


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
        dtype: torch.dtype = torch.float32,
        attn_impl: str = "auto",
        device="cuda",
    ):
        super().__init__()
        device = resolve_device(device)
        self.width, self.n_queries, self.dtype = width, n_queries, dtype
        self.encoder = CLIPViT(
            width=width, layers=encoder_layers, heads=encoder_heads,
            patch_size=patch_size, output_dim=text_dim,
            input_resolution=input_resolution, dtype=dtype,
            attn_impl=attn_impl, device=device,
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

        memory = self.ffn1(patch_tokens.detach())  # [b, hw, width]
        pos = sine_pos_embed(h, w, width // 2).reshape(width, -1).T
        pos = torch.from_numpy(pos).to(device=x.device, dtype=dt)[None]

        query_pos = self.query_embed.to(dt)[None].expand(b, self.n_queries, width)
        tgt = torch.zeros_like(query_pos)
        queries = self.decoder(tgt, memory, pos=pos, query_pos=query_pos)
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
                                   self.encoder.proj.to(dt).float())
        text_tokens = full_map_layer_norm(text_tokens)
        text_tokens = text_tokens / (
            torch.linalg.vector_norm(text_tokens, dim=-1, keepdim=True) + 1e-7)
        return {"mask_proposals": mask_proposals.float(),
                "patch_tokens": text_tokens.float()}
