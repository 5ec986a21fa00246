"""Token merging (ToMe) for the CLIP ViT encoder, the opt-in throughput
lever (the port of zutis_tpu/ops/tome.py).

Between the attention and the MLP of an encoder block, the r most similar
token pairs merge by bipartite soft matching on the block's head-averaged
keys; each token carries a size (the patches merged into it) for
size-weighted merging and for the proportional attention bias log(size).
ZUTIS needs dense patch tokens, so the model composes every block's
old -> new `mapping` and gathers the merged stream back to the full grid
after the last block (models/vit.py).

Plain torch: gathers, one [b, sa, sb] product, a stable sort and
scatter-adds a block. The JAX package wrote no Pallas kernel here either;
the merge is small beside the encoder products it removes.

Exact ties decide the padded path's schedule (padding rows score 2.0,
valid -> empty 1.5, CLS -inf), so the order is JAX's to the index: a
stable argsort of -node_max (JAX's argsort is stable) and argmax's first
maximum. On a card, `scatter_add` is atomic, so the sizes' and tokens'
sums may differ between runs in their last bit.
"""
from __future__ import annotations

from typing import Tuple

import torch


def merge_schedule(s0: int, r: int, n_layers: int) -> list:
    """Per-layer merge counts for a stream of s0 tokens (CLS included,
    never merged): r clamped to what each layer's A/B split allows."""
    out = []
    s = s0
    for _ in range(n_layers):
        sa, sb = (s + 1) // 2, s // 2
        r_eff = max(0, min(r, sa - 1, sb))
        out.append(r_eff)
        s -= r_eff
    return out


def tome_merge(
    x: torch.Tensor,       # [b, s, d] residual stream after the attention add
    metric: torch.Tensor,  # [b, s, dm] similarity features (head-mean keys)
    size: torch.Tensor,    # [b, s] f32 token sizes
    r: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge r tokens by bipartite soft matching: even positions form set
    A (position 0, CLS, never merges), odd positions set B; each A token's
    best B match is scored by the cosine of `metric`, and the r best A
    tokens merge into their B targets by size-weighted average. Size-0
    tokens (padding on the padded path) score 2.0, a valid token into a
    size-0 slot 1.5, so padding merges first and the schedule does not
    depend on the padding's content.

    -> (x [b, s - r, d], sizes [b, s - r], mapping [b, s] int32: old token
    index -> new token index)."""
    b, s, d = x.shape
    sa, sb = (s + 1) // 2, s // 2
    if not 0 < r <= min(sa - 1, sb):
        raise ValueError(f"cannot merge {r} of {s} tokens")

    m32 = metric.detach().float()  # the scores pick indices: no gradient
    m32 = m32 / torch.clamp(torch.linalg.vector_norm(m32, dim=-1, keepdim=True),
                            min=1e-6)
    scores = torch.einsum("bad,bnd->ban", m32[:, ::2], m32[:, 1::2])
    pad_a, pad_b = size[:, ::2] <= 0, size[:, 1::2] <= 0
    scores = torch.where(pad_a[:, :, None], 2.0, scores)
    scores = torch.where(~pad_a[:, :, None] & pad_b[:, None, :], 1.5, scores)
    scores[:, 0, :] = float("-inf")  # CLS never merges

    node_max, node_idx = scores.max(dim=-1)  # the first maximum, as argmax
    order = torch.argsort(-node_max, dim=-1, stable=True)
    src_idx, unm_idx = order[:, :r], order[:, r:]
    dst_idx = torch.gather(node_idx, 1, src_idx)  # [b, r]
    n_unm = sa - r

    # size-weighted tokens, divided once the merges are summed
    w = x.float() * size[..., None]
    w_a, w_b = w[:, ::2], w[:, 1::2]
    sz_a, sz_b = size[:, ::2], size[:, 1::2]
    unm_w = torch.gather(w_a, 1, unm_idx[..., None].expand(-1, -1, d))
    unm_sz = torch.gather(sz_a, 1, unm_idx)
    src_w = torch.gather(w_a, 1, src_idx[..., None].expand(-1, -1, d))
    src_sz = torch.gather(sz_a, 1, src_idx)
    dst_w = w_b.scatter_add(1, dst_idx[..., None].expand(-1, -1, d), src_w)
    dst_sz = sz_b.scatter_add(1, dst_idx, src_sz)

    new_w = torch.cat([unm_w, dst_w], dim=1)
    new_sz = torch.cat([unm_sz, dst_sz], dim=1)
    # size-0 slots come out as zero vectors; positive sizes are unchanged
    x_new = (new_w / torch.clamp(new_sz, min=1e-6)[..., None]).to(x.dtype)

    dev = x.device
    map_a = torch.zeros((b, sa), dtype=torch.int32, device=dev)
    map_a.scatter_(1, unm_idx, torch.arange(n_unm, dtype=torch.int32,
                                            device=dev).expand(b, n_unm))
    map_a.scatter_(1, src_idx, (n_unm + dst_idx).to(torch.int32))
    mapping = torch.empty((b, s), dtype=torch.int32, device=dev)
    mapping[:, ::2] = map_a
    mapping[:, 1::2] = n_unm + torch.arange(sb, dtype=torch.int32, device=dev)
    return x_new, new_sz, mapping


def proportional_attn_bias(size: torch.Tensor) -> torch.Tensor:
    """log(max(size, 1)) as an additive attention bias [b, 1, 1, s] in f32:
    a key standing for n merged patches draws n patches' softmax mass.
    Size-0 slots get 0, not -inf: the key mask excludes them."""
    return torch.log(torch.clamp(size, min=1.0))[:, None, None, :].float()
