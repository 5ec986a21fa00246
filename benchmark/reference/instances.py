"""Plain instance decode of ZUTIS's outputs and the comparison of a
program's instances with it.

The decode (networks/zutis.py's inference in NoelShin/zutis): a query's
binary mask is its proposal above `threshold`; its mask confidence the
mean proposal inside it; its category the text embedding most similar to
the L2-normalised mean token inside it, through sigmoid(similarity x
temperature); its score the confidence times that probability. Masks at
pixel size are the proposals resized bilinearly (half-pixel centres) and
thresholded. Hard NMS: in descending score, a query keeps unless a kept
query of its category overlaps it by IoU above `nms_threshold`; category
0 (background) and empty masks never keep.

COCO's compressed RLE strings are decoded here too, so that the program's
answers are read without its codec.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def decode(proposals: torch.Tensor, tokens: torch.Tensor,
           text: torch.Tensor, threshold: float, temperature: float,
           out_hw=None) -> Dict[str, torch.Tensor]:
    """proposals [Q, h, w], tokens [h, w, c], text [n, c] -> masks [Q, H,
    W] bool (at out_hw, else the token grid), confidence [Q], probs [Q, n],
    category [Q], score [Q]."""
    p = proposals.double()
    binary = p > threshold
    m = binary.double()
    size = m.sum((-2, -1))
    confidence = (p * m).sum((-2, -1)) / (size + 1e-7)
    mean = torch.einsum("hwc,qhw->qc", tokens.double(), m) / (size[:, None]
                                                              + 1e-7)
    mean = mean / (mean.norm(dim=-1, keepdim=True) + 1e-7)
    probs = torch.sigmoid(mean @ text.double().t() * temperature)
    best, category = probs.max(dim=-1)
    up = proposals.float()
    if out_hw is not None:
        up = F.interpolate(up[None], size=tuple(out_hw), mode="bilinear",
                           align_corners=False)[0]
    return {"masks": up > threshold, "proposals": up,
            "token_proposals": p, "tokens": tokens.double(),
            "text": text.double(), "temperature": temperature,
            "confidence": confidence, "probs": probs, "category": category,
            "score": confidence * best, "threshold": threshold}


def nms(masks: torch.Tensor, score: torch.Tensor, category: torch.Tensor,
        nms_threshold: float) -> List[int]:
    """Hard NMS -> the kept queries, in descending score."""
    flat = masks.reshape(masks.shape[0], -1).double()
    inter = flat @ flat.t()
    area = inter.diagonal()
    union = area[:, None] + area[None, :] - inter
    iou = torch.where(union > 0, inter / union.clamp(min=1e-12), 0.0)
    order = sorted(range(len(score)), key=lambda q: -float(score[q]))
    kept: List[int] = []
    for q in order:
        if int(category[q]) == 0 or float(area[q]) == 0:
            continue
        if all(int(category[k]) != int(category[q]) or
               float(iou[q, k]) <= nms_threshold for k in kept):
            kept.append(q)
    return kept


def margins(mask: torch.Tensor, ref: Dict[str, torch.Tensor]) -> torch.Tensor:
    """For each reference query: the widest margin by which its proposal
    lies past the threshold at a pixel where `mask` [H, W] says otherwise
    (0 where they agree everywhere) -> [Q]."""
    p, thr = ref["proposals"], ref["threshold"]
    disagree = (p > thr) != mask[None]
    return torch.where(disagree, (p - thr).abs(), 0.0).flatten(1).amax(1)


NEAR = 0.02  # a token this close to the threshold may fall either side
MAX_NEAR = 6  # every subset of up to this many such tokens; else one by one


def rescore(ref: Dict[str, torch.Tensor], q: int, c: int) -> torch.Tensor:
    """The reference's scores of query q for category c over q's mask with
    the tokens near the threshold taken either way -> [candidates]."""
    p = ref["token_proposals"][q]
    base = (p > ref["threshold"]).flatten()
    near = ((p - ref["threshold"]).abs() <= NEAR).flatten().nonzero()[:, 0]
    n = len(near)
    if n <= MAX_NEAR:
        flips = (torch.arange(2 ** n, device=p.device)[:, None]
                 >> torch.arange(n, device=p.device)) & 1
    else:
        flips = torch.cat([torch.zeros(1, n, dtype=torch.long,
                                       device=p.device),
                           torch.eye(n, dtype=torch.long, device=p.device)])
    masks = base.expand(len(flips), -1).clone()
    masks[:, near] ^= flips.bool()
    m = masks.double()
    size = m.sum(1)
    conf = (m * p.flatten()).sum(1) / (size + 1e-7)
    mean = m @ ref["tokens"].reshape(-1, ref["tokens"].shape[-1])
    mean = mean / (size[:, None] + 1e-7)
    mean = mean / (mean.norm(dim=-1, keepdim=True) + 1e-7)
    prob = torch.sigmoid(mean @ ref["text"][c] * ref["temperature"])
    return conf * prob


def clearly_kept(ref: Dict[str, torch.Tensor], kept: List[int],
                 nms_threshold: float) -> List[int]:
    """The reference's kept queries that any rounding keeps, or answers
    with a mask that matches theirs: a query whose strongest pixel clears
    the threshold by more than NEAR (its mask is never empty), whose best
    category leads the background's by more than NEAR (it is never
    background), and which no rival could suppress. A rival is another
    query that scores within NEAR of it or above, whose near-best
    categories (within NEAR of its best) meet the query's, whose mask
    could overlap the query's above `nms_threshold` with the pixels within
    NEAR of the threshold taken either way (the loose masks' intersection
    over the tight masks' union), and whose mask could differ from the
    query's at a pixel where the query's proposal is not within NEAR of the
    threshold (a rival kept in its place would not stand in for it)."""
    if not kept:
        return []
    p, thr = ref["proposals"].flatten(1), ref["threshold"]
    loose = (p > thr - NEAR).double()
    tight = (p > thr + NEAR).double()
    inter_hi = loose @ loose.t()
    t_inter = tight @ tight.t()
    t_area = t_inter.diagonal()
    union_lo = t_area[:, None] + t_area[None, :] - t_inter
    iou_hi = torch.where(union_lo > 0, inter_hi / union_lo.clamp(min=1),
                         torch.where(inter_hi > 0, 1.0, 0.0))
    probs, score = ref["probs"], ref["score"]
    near = probs >= probs.max(dim=1, keepdim=True).values - NEAR  # [Q, n]
    shares = (near.double() @ near.double().t()) > 0  # a category in common
    side = p > thr
    sure = (p - thr).abs() > NEAR
    out = []
    for q in kept:
        if float(p[q].max()) - thr <= NEAR or bool(near[q, 0]):
            continue
        stands_in = (~sure[q] | (sure & (side == side[q]))).all(1)
        rival = (shares[q] & (iou_hi[q] > nms_threshold)
                 & (score >= score[q] - NEAR) & ~stands_in)
        rival[q] = False
        if not bool(rival.any()):
            out.append(q)
    return out


def overlap(got: List[dict]) -> float:
    """The largest IoU between two of one image's instances of one
    category (hard NMS keeps no pair above its threshold); 0 where no two
    share a category."""
    masks = [torch.as_tensor(inst["mask"]).bool().flatten() for inst in got]
    worst = 0.0
    for a in range(len(got)):
        for b in range(a + 1, len(got)):
            if got[a]["category"] != got[b]["category"]:
                continue
            union = int((masks[a] | masks[b]).sum())
            if union:
                worst = max(worst, int((masks[a] & masks[b]).sum()) / union)
    return worst


def compare(got: List[dict], ref: Dict[str, torch.Tensor], kept: List[int],
            nms_threshold: float) -> Dict[str, float]:
    """The program's instances of one image (dicts of "category", "score",
    "mask" [H, W] bool) judged by the reference's decode of it, and the
    reference's kept queries looked for among them. Random weights give
    many queries of like masks, masks of a few tokens and near-tied
    categories, so an instance is judged by the reference query that
    explains it best, with the benefit of rounding at the tokens that sit
    within NEAR of the threshold:

      mask_gap:     for each instance, the least, over the queries, of the
                    widest margin by which a query's proposal lies past the
                    threshold at a pixel where the instance's mask says
                    otherwise (rounding moves only pixels near it);
      instance_gap: for each instance, the least over the queries of the
                    larger of that margin and the gap between its score and
                    the query's reference score for its category (rescore:
                    a wrong category scores below the reference's best);
                    and where the program answers nothing for an image in
                    which the reference keeps queries, the widest, over
                    them, of how far each is from being nothing in the
                    reference too: the lesser of its score's lead over the
                    background category's (0, never kept) and its
                    strongest token's lead over the threshold (an answer
                    missing reads far; rounding empties only near ties);
      nms_overlap:  the largest IoU of two instances of one category
                    (overlap()): the configuration's NMS keeps none above
                    `nms_threshold`, so an NMS that fails to suppress
                    reads above it;
      kept_missed:  the number of the reference's clearly kept queries
                    (clearly_kept()) whose mask no instance matches to
                    within NEAR: an answer short of instances that any
                    rounding keeps reads 1 or more. Which of near-tied,
                    overlapping queries NMS keeps is rounding's to decide,
                    so those are not looked for one by one;
      kept_clear:   the number of those clearly kept queries (printed,
                    not compared: how much kept_missed had to look for).

    Each the widest over the image (kept_missed and kept_clear the image's
    counts); 0 where there is nothing to judge."""
    dev = ref["proposals"].device
    probs = ref["probs"]
    out = {"mask_gap": 0.0, "instance_gap": 0.0,
           "nms_overlap": overlap(got), "kept_missed": 0.0}
    masks = []
    for inst in got:
        m = torch.as_tensor(inst["mask"], device=dev)
        masks.append(m)
        gap = margins(m, ref)
        out["mask_gap"] = max(out["mask_gap"], float(gap.min()))
        c = inst["category"]
        fit = 1.0
        for q in gap.argsort().tolist():
            if float(gap[q]) >= fit:
                break
            if c < probs.shape[1]:
                score = float((rescore(ref, q, c) - inst["score"]).abs().min())
                fit = min(fit, max(float(gap[q]), score))
        out["instance_gap"] = max(out["instance_gap"], fit)
    if not got and kept:  # the program answered nothing here
        conf, thr = ref["confidence"], ref["threshold"]
        out["instance_gap"] = max(
            min(float(ref["score"][q] - conf[q] * probs[q, 0]),
                float(ref["token_proposals"][q].max()) - thr)
            for q in kept)
    matched = torch.zeros(len(probs), dtype=torch.bool, device=dev)
    for m in masks:
        matched |= margins(m, ref) <= NEAR
    clear = clearly_kept(ref, kept, nms_threshold)
    out["kept_missed"] = float(sum(1 for q in clear if not bool(matched[q])))
    out["kept_clear"] = float(len(clear))
    return out


def explain(got: List[dict], ref: Dict[str, torch.Tensor]) -> List[dict]:
    """For each instance, the three queries that fit its mask best: their
    margin, reference category and score, and their reference score for
    the instance's category (a diagnosis of compare())."""
    dev = ref["proposals"].device
    conf, probs = ref["confidence"].float(), ref["probs"].float()
    out = []
    for inst in got:
        m = torch.as_tensor(inst["mask"], device=dev)
        gap = margins(m, ref)
        c = inst["category"]
        rows = []
        for q in gap.argsort()[:3].tolist():
            rows.append({"q": q, "margin": float(gap[q]),
                         "category": int(ref["category"][q]),
                         "score": float(ref["score"][q]),
                         "score_for_c": float(conf[q] * probs[q, c]),
                         "area": int(ref["masks"][q].sum())})
        out.append({"category": c, "score": inst["score"],
                    "area": int(m.sum()), "queries": rows})
    return out


def rle_decode(counts: str, h: int, w: int) -> np.ndarray:
    """COCO's compressed RLE string -> [h, w] bool (runs over the
    column-major pixels, zeros first)."""
    runs: List[int] = []
    p = 0
    while p < len(counts):
        x, k, more = 0, 0, True
        while more:
            c = ord(counts[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(runs) > 2:
            x += runs[-2]
        runs.append(x)
    flat = np.zeros(h * w, bool)
    pos = 0
    for i, n in enumerate(runs):
        if i % 2:
            flat[pos:pos + n] = True
        pos += n
    return flat.reshape(w, h).T
