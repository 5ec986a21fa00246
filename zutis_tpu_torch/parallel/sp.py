"""Sequence parallelism over the mesh's model axis: ring attention and
Ulysses' head scatter (the port of zutis_tpu/parallel/sp.py), for dense
inference at high resolution, where the token count grows with the square
of the image side. Both are exact: the same function as dense attention.

  - `ring_attention`: each rank keeps its query block; the key / value
    blocks travel round the ring (`batch_isend_irecv` to the next rank),
    and each block folds into a running (max, sum, acc) online softmax in
    float32. n - 1 rotations: the last block folds with no exchange after
    it. The block statistics are plain float32 products, as JAX computes
    them outside any Pallas kernel.
  - `ulysses_attention`: `all_to_all_single` from sequence-sharded
    [b, h, s/P, d] to head-sharded [b, h/P, s, d], dense attention through
    ops/attention.py (the flash kernel on a card, its plain version on the
    CPU; no other path on a CUDA tensor), and back. P must divide the
    heads.

The per-shard functions take this rank's [b, h, s/P, d] blocks;
`make_ring_attention` / `make_ulysses_attention` give functions of the
full [b, h, s, d] tensors, which every rank of the mesh passes alike and
gets back alike, as the JAX wrappers' global arrays. Forward only: no
gradient flows through the exchanges.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from zutis_tpu_torch.ops.attention import dot_product_attention

_NEG_INF = -1e30


def _block_stats(q, k, v, scale):
    """Unnormalised attention of q over one key / value block -> (acc, m,
    l) in float32 for the online-softmax merge."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return acc, m, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group) -> torch.Tensor:
    """Exact attention of this rank's query block [b, h, s_local, d] over
    the whole key sequence, whose blocks [b, h, s_local, d] the ranks of
    `group` hold in sequence order."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    scale = q.shape[-1] ** -0.5
    b, h, sq, d = q.shape
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k.contiguous(), v.contiguous()
    for i in range(n):
        if i < n - 1:
            k_next, v_next = torch.empty_like(k_blk), torch.empty_like(v_blk)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, k_blk, nxt, group),
                dist.P2POp(dist.isend, v_blk, nxt, group),
                dist.P2POp(dist.irecv, k_next, prv, group),
                dist.P2POp(dist.irecv, v_next, prv, group)])
        a_i, m_i, l_i = _block_stats(q, k_blk, v_blk, scale)
        m_new = torch.maximum(m, m_i)
        alpha, beta = torch.exp(m - m_new), torch.exp(m_i - m_new)
        acc, m, l = acc * alpha + a_i * beta, m_new, l * alpha + l_i * beta
        if i < n - 1:
            for r in reqs:
                r.wait()
            k_blk, v_blk = k_next, v_next
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Exchange x's leading-axis pieces: piece j goes to rank j, and rank
    j's piece for this rank comes back in its place."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group) -> torch.Tensor:
    """All-to-all to head-sharded [b, h/P, s, d], dense attention, and
    back to this rank's [b, h, s_local, d]."""
    n = dist.get_world_size(group)
    b, h, s_loc, d = q.shape
    if h % n:
        raise ValueError(f"heads {h} not divisible by the axis size {n}")

    def scatter_heads(x):
        # [b, h, s/P, d] -> [b, h/P, s, d]: head tile j to rank j, the
        # sequence blocks arriving in rank (= sequence) order
        x = x.reshape(b, n, h // n, s_loc, d).transpose(0, 1)
        x = _all_to_all(x, group)  # [P (sequence block), b, h/P, s/P, d]
        return x.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s_loc, d)

    def gather_heads(x):
        # [b, h/P, s, d] -> [b, h, s/P, d]
        x = x.reshape(b, h // n, n, s_loc, d).permute(2, 0, 1, 3, 4)
        x = _all_to_all(x, group)  # [P (head tile), b, h/P, s/P, d]
        return x.transpose(0, 1).reshape(b, h, s_loc, d)

    out = dot_product_attention(scatter_heads(q), scatter_heads(k),
                                scatter_heads(v))
    return gather_heads(out)


def _sequence_parallel(fn, mesh, axis: str):
    group, n, r = mesh.axis_group(axis), mesh.shape[axis], mesh.axis_rank(axis)

    def run(q, k, v):
        s = q.shape[2]
        if s % n:
            raise ValueError(f"a sequence of {s} over a {axis} axis of {n}")
        step = s // n
        with torch.no_grad():
            out = fn(*(x[:, :, r * step:(r + 1) * step] for x in (q, k, v)),
                     group).contiguous()
            parts = [torch.empty_like(out) for _ in range(n)]
            dist.all_gather(parts, out, group=group)
        return torch.cat(parts, dim=2)

    return run


def make_ring_attention(mesh, axis: str = "model"):
    """[b, h, s, d] attention with the sequence split over `axis`."""
    return _sequence_parallel(ring_attention, mesh, axis)


def make_ulysses_attention(mesh, axis: str = "model"):
    return _sequence_parallel(ulysses_attention, mesh, axis)
