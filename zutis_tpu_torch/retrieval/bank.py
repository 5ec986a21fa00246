"""Retrieval over large CLIP image-embedding banks (the port of
zutis_tpu/retrieval/bank.py, one device).

Behavioural contract (reference datasets/index_dataset.py:94-175): the
concatenated ImageNet2012 + PASS embedding banks (unit-norm ViT-L/14@336px
embeddings keyed by filename) are scored against per-category
prompt-engineered text embeddings; the top `n_images` filenames per
category become the training set (cached as a category -> paths JSON).

The scores are one float32 product on the bank's device (`torch.matmul`,
as the JAX package leaves it to XLA). Ties keep `jax.lax.top_k`'s order:
equal scores come lowest index first, at the k-th boundary too, since real
banks hold duplicate images. The mesh-sharded top-k (`topk_sharded`) is
not ported yet (ROADMAP.md, queue 1, item 6): a mesh over more than one
device raises.
"""
from __future__ import annotations

import json
import math
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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


def topk_local(text_emb: torch.Tensor, bank: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[C, D] x [N, D]^T -> (values [C, k] f32, indices [C, k] int64) in
    descending order, equal values lowest index first, on the bank's
    device. Entries past the bank's N rows hold -inf and -1."""
    sims = torch.matmul(text_emb.float(), bank.float().t())  # [C, N]
    n = sims.shape[1]
    k_in = min(k, n)
    vals, idx = torch.topk(sims, k_in, dim=1)
    if k_in:
        # torch.topk promises no order among equal values, nor which of
        # them it keeps at the k-th value: keep the lowest indices there
        kth = vals[:, -1:]
        taken = (vals == kth).sum(dim=1)
        cut = torch.nonzero((sims == kth).sum(dim=1) > taken).flatten()
        for r in cut.tolist():
            ties = torch.nonzero(sims[r] == kth[r]).flatten()
            t = int(taken[r])
            idx[r, k_in - t:] = ties[:t]
        # then order by value, equal values by index
        order = idx.argsort(dim=1)
        vals, idx = vals.gather(1, order), idx.gather(1, order)
        order = vals.argsort(dim=1, descending=True, stable=True)
        vals, idx = vals.gather(1, order), idx.gather(1, order)
    if k > n:
        c = sims.shape[0]
        vals = torch.cat([vals, vals.new_full((c, k - n), -math.inf)], 1)
        idx = torch.cat([idx, idx.new_full((c, k - n), -1)], 1)
    return vals, idx


def retrieve_category_paths(
    cat_to_text_embedding: Dict[str, np.ndarray],
    bank: np.ndarray,
    filenames: List[str],
    n_images: int,
    mesh: Optional[Dict[str, int]] = None,
    cache_fp: Optional[str] = None,
    device="cuda",
) -> Dict[str, List[str]]:
    """Top-`n_images` filenames per category (reference
    index_dataset.py:160-174) from the [N, D] `bank`, scored on `device`;
    optionally cached to JSON. `mesh` (axis sizes, as a config's
    `mesh_axes`) must span one device."""
    if math.prod(int(n) for n in (mesh or {}).values()) > 1:
        raise NotImplementedError(
            f"a mesh of {mesh}: the sharded top-k is not ported yet "
            "(ROADMAP.md, queue 1, item 6)")
    device = resolve_device(device)
    cats = list(cat_to_text_embedding)
    text = torch.from_numpy(np.stack(
        [cat_to_text_embedding[c] for c in cats]).astype(np.float32))
    _, idx = topk_local(to_device(text, device),
                        to_device(torch.from_numpy(bank), device), n_images)
    idx = idx.cpu().numpy()
    out = {
        c: [filenames[j] for j in idx[i] if j >= 0]
        for i, c in enumerate(cats)
    }
    if cache_fp:
        with open(cache_fp, "w") as f:
            json.dump(out, f)
    return out
