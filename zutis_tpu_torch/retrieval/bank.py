"""Retrieval over large CLIP image-embedding banks, on one device or
sharded over a mesh (the port of zutis_tpu/retrieval/bank.py).

Behavioural contract (reference datasets/index_dataset.py:94-175): the
concatenated ImageNet2012 + PASS embedding banks (unit-norm ViT-L/14@336px
embeddings keyed by filename) are scored against per-category
prompt-engineered text embeddings; the top `n_images` filenames per
category become the training set (cached as a category -> paths JSON).

The scores are one float32 product on the bank's device (`torch.matmul`,
as the JAX package leaves it to XLA). Ties keep `jax.lax.top_k`'s order:
equal scores come lowest index first, at the k-th boundary too, since real
banks hold duplicate images. `topk_sharded` splits the bank's rows over
a mesh axis (parallel/mesh.py): each rank scores its rows and keeps its
top k, the candidates are gathered over the axis and merged by one more
top-k, with the same values and indices as `topk_local`.
"""
from __future__ import annotations

import json
import math
import pickle
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from zutis_tpu_torch.core.device import resolve_device, to_device


def load_bank_pkl(paths: Sequence[str]) -> Tuple[np.ndarray, List[str]]:
    """Load one or more reference-format {filename: embedding} pickles into
    a single [N, D] float32 matrix + filename list (reference
    index_dataset.py:142-158 concatenates the banks). The pickles are the
    user's own bank files."""
    mats, names = [], []
    for p in paths:
        with open(p, "rb") as f:
            d: Dict[str, np.ndarray] = pickle.load(f)
        names.extend(d.keys())
        mats.append(np.stack(list(d.values())).astype(np.float32))
    return np.concatenate(mats, axis=0), names


def _top_k_lowest_ties(sims: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch.topk of [C, N] scores (k <= N) in `jax.lax.top_k`'s order:
    descending, equal values lowest index first, the lowest indices kept
    at the k-th value."""
    vals, idx = torch.topk(sims, k, dim=1)
    if k:
        # torch.topk promises no order among equal values, nor which of
        # them it keeps at the k-th value: keep the lowest indices there
        kth = vals[:, -1:]
        taken = (vals == kth).sum(dim=1)
        cut = torch.nonzero((sims == kth).sum(dim=1) > taken).flatten()
        for r in cut.tolist():
            ties = torch.nonzero(sims[r] == kth[r]).flatten()
            t = int(taken[r])
            idx[r, k - t:] = ties[:t]
        # then order by value, equal values by index
        order = idx.argsort(dim=1)
        vals, idx = vals.gather(1, order), idx.gather(1, order)
        order = vals.argsort(dim=1, descending=True, stable=True)
        vals, idx = vals.gather(1, order), idx.gather(1, order)
    return vals, idx


def _pad_k(vals, idx, k):
    """Entries past the candidates: -inf and -1."""
    c, have = vals.shape
    if k <= have:
        return vals, idx
    return (torch.cat([vals, vals.new_full((c, k - have), -math.inf)], 1),
            torch.cat([idx, idx.new_full((c, k - have), -1)], 1))


def topk_local(text_emb: torch.Tensor, bank: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[C, D] x [N, D]^T -> (values [C, k] f32, indices [C, k] int64) in
    descending order, equal values lowest index first, on the bank's
    device. Entries past the bank's N rows hold -inf and -1."""
    sims = torch.matmul(text_emb.float(), bank.float().t())  # [C, N]
    vals, idx = _top_k_lowest_ties(sims, min(k, sims.shape[1]))
    return _pad_k(vals, idx, k)


def topk_sharded(text_emb, bank, k: int, mesh, axis: str = "data"
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The top k of the [N, D] `bank` (numpy or a tensor, whole on every
    rank) for each of the [C, D] `text_emb`, its rows split over the mesh's
    `axis`: rank r scores its ceil(N / shards) rows on its device (the
    last shard's pad rows score -inf, as JAX pads them), keeps
    min(k, shard rows) candidates, and the candidates, gathered in shard
    order, merge by a stable top-k. -> (values [C, k] f32, indices [C, k]
    int64) on the host, every rank alike, equal to `topk_local`'s; past N
    real rows -inf and -1."""
    n_shards, shard = mesh.shape[axis], mesh.axis_rank(axis)
    n = bank.shape[0]
    shard_rows = -(-n // n_shards)
    lo, hi = min(n, shard * shard_rows), min(n, (shard + 1) * shard_rows)
    rows = bank[lo:hi]
    rows = (torch.from_numpy(np.ascontiguousarray(rows))
            if isinstance(rows, np.ndarray) else rows).to(mesh.device)
    text = torch.as_tensor(np.asarray(text_emb) if not torch.is_tensor(
        text_emb) else text_emb).to(mesh.device)
    sims = torch.matmul(text.float(), rows.float().t())
    if hi - lo < shard_rows:
        sims = torch.cat([sims, sims.new_full(
            (sims.shape[0], shard_rows - (hi - lo)), -math.inf)], 1)
    k_loc = min(k, shard_rows)
    vals, idx = _top_k_lowest_ties(sims, k_loc)
    idx = idx + shard * shard_rows  # into the bank's row space
    group = mesh.axis_group(axis)
    cand_v = [torch.empty_like(vals) for _ in range(n_shards)]
    cand_i = [torch.empty_like(idx) for _ in range(n_shards)]
    dist.all_gather(cand_v, vals.contiguous(), group=group)
    dist.all_gather(cand_i, idx.contiguous(), group=group)
    # shard order keeps equal values in index order: a stable sort merges
    vals, idx = torch.cat(cand_v, 1), torch.cat(cand_i, 1)
    order = vals.argsort(dim=1, descending=True, stable=True)[:, :k]
    vals, idx = _pad_k(vals.gather(1, order), idx.gather(1, order), k)
    idx = torch.where(torch.isfinite(vals), idx, -1)
    return vals.cpu().numpy(), idx.cpu().numpy()


def retrieve_category_paths(
    cat_to_text_embedding: Dict[str, np.ndarray],
    bank: np.ndarray,
    filenames: List[str],
    n_images: int,
    mesh=None,
    cache_fp: Optional[str] = None,
    device="cuda",
) -> Dict[str, List[str]]:
    """Top-`n_images` filenames per category (reference
    index_dataset.py:160-174) from the [N, D] `bank`, scored on `device`;
    optionally cached to JSON. `mesh`, a `parallel.Mesh` or axis sizes as a
    config's `mesh_axes`, over more than one rank shards the bank's rows
    over its data axis (`topk_sharded`); axis sizes make the mesh of this
    process group, which must have as many ranks."""
    cats = list(cat_to_text_embedding)
    text = torch.from_numpy(np.stack(
        [cat_to_text_embedding[c] for c in cats]).astype(np.float32))
    if isinstance(mesh, Mapping):
        from zutis_tpu_torch.parallel.mesh import create_mesh, mesh_size

        mesh = create_mesh(mesh, device=device) if mesh_size(mesh) > 1 else None
    if mesh is not None and mesh.size > 1:
        _, idx = topk_sharded(text, bank, n_images, mesh)
    else:
        device = resolve_device(device)
        _, idx = topk_local(to_device(text, device),
                            to_device(torch.from_numpy(bank), device), n_images)
        idx = idx.cpu().numpy()
    out = {
        c: [filenames[j] for j in idx[i] if j >= 0]
        for i, c in enumerate(cats)
    }
    if cache_fp and (mesh is None or mesh.is_writer):
        with open(cache_fp, "w") as f:
            json.dump(out, f)
    return out
