"""Per-category greedy mask NMS over a batch (the port of
zutis_tpu/ops/nms.py::mask_nms; the batch is written out where JAX vmaps,
and Q rounds of a Python loop stand for its fori_loop).

Per category (background id 0 excluded) the highest live score is selected,
and the other candidates of its category are re-weighted by their IoU with
it: hard zeroes them beyond `nms_threshold`, linear scales by (1 - IoU)
beyond it, gaussian by exp(-IoU^2 / sigma). A candidate re-weighted to or
below `score_floor` drops out. Kept masks carry their selection-time score;
empty masks are never kept.
"""
from __future__ import annotations

import torch

NMS_TYPES = ("hard", "linear", "gaussian")


def pairwise_iou(masks: torch.Tensor):
    """[b, Q, H, W] bool -> (iou [b, Q, Q] f32, areas [b, Q] f32).

    The intersection counts must be exact: they are summed in float64, which
    holds every count below 2^53 exactly and is never rounded to TF32 (a f32
    product on the card may be, and TF32's 10-bit mantissa rounds any count
    above 1024). The IoU arithmetic then runs in f32, as in JAX."""
    b, q = masks.shape[:2]
    m = masks.reshape(b, q, -1).to(torch.float64)
    inter = torch.bmm(m, m.transpose(1, 2)).float()
    areas = torch.diagonal(inter, dim1=1, dim2=2)
    union = areas[:, :, None] + areas[:, None, :] - inter
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-12),
                      torch.zeros_like(inter))
    return iou, areas


def mask_nms(
    masks: torch.Tensor,  # [b, Q, H, W] bool / 0-1
    scores: torch.Tensor,  # [b, Q]
    category_ids: torch.Tensor,  # [b, Q] int
    nms_threshold: float = 0.3,
    score_floor: float = 0.001,
    sigma: float = 0.5,
    nms_type: str = "hard",
):
    """-> (keep [b, Q] bool, out_scores [b, Q] f32)."""
    if nms_type not in NMS_TYPES:
        raise ValueError(f"nms_type {nms_type!r} not in {NMS_TYPES}")
    b, q = masks.shape[:2]
    iou, areas = pairwise_iou(masks.bool())
    same_cat = category_ids[:, :, None] == category_ids[:, None, :]
    eligible = (category_ids != 0) & (areas > 0)
    rows = torch.arange(b, device=masks.device)
    keep = torch.zeros(b, q, dtype=torch.bool, device=masks.device)
    cur = scores.float().clone()
    candidate = eligible.clone()
    for _ in range(q):
        live = torch.where(candidate & eligible, cur, -float("inf"))
        i = live.argmax(dim=1)  # the first maximum, as jnp.argmax
        selected = live[rows, i] > -float("inf")  # False once none remain
        keep[rows, i] |= selected
        candidate[rows, i] &= ~selected

        iou_i = iou[rows, i]  # [b, Q]
        if nms_type == "hard":
            w = torch.where(iou_i > nms_threshold, 0.0, 1.0)
        elif nms_type == "linear":
            w = torch.where(iou_i > nms_threshold, 1.0 - iou_i, 1.0)
        else:
            w = torch.exp(-(iou_i ** 2) / sigma)
        apply_w = selected[:, None] & same_cat[rows, i] & candidate
        cur = cur * torch.where(apply_w, w, 1.0)
        # the floor applies only to candidates re-weighted this round
        candidate = candidate & (~apply_w | (cur > score_floor))
    return keep, cur
