"""COCO-style mask AP/AR evaluation from the published COCOeval protocol
(the port's copy of zutis_tpu/engine/coco_eval.py, on the port's numpy
`ops/rle`).

  * IoU thresholds 0.50:0.05:0.95, recall thresholds 0:0.01:1.
  * Per (image, category): detections sorted by descending score (stable),
    capped at maxDet; each detection greedily matches the not-yet-matched
    GT of highest IoU >= threshold; crowd GTs may be matched repeatedly and
    use intersection / detection area as IoU; once a non-ignored candidate
    exists an ignored GT cannot take over. Unmatched detections whose area
    falls outside the area range are ignored rather than counted as FPs.
    Matching is redone per area range, out-of-range GTs ignored.
  * Accumulation: detections pooled over images per category, re-sorted by
    score; precision made monotonically non-increasing, then sampled at the
    101 recall points; AP averages over categories and thresholds with
    valid GT; AR is the maximum recall.
  * stats: the standard 12-number summary.

Segmentations are COCO RLE dicts or polygons; IoUs are computed on run
lengths (`rle.counts_iou`), never on dense masks.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from zutis_tpu_torch.ops import rle as rle_ops

AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


class COCOEvaluator:
    def __init__(
        self,
        gt: Dict,
        max_dets: Sequence[int] = (1, 10, 100),
        iou_thrs: Optional[np.ndarray] = None,
        cat_ids: Optional[Sequence[int]] = None,
    ):
        """gt: COCO-format dict with images/annotations/categories."""
        self.iou_thrs = (
            np.linspace(0.5, 0.95, 10) if iou_thrs is None else iou_thrs
        )
        self.rec_thrs = np.linspace(0.0, 1.0, 101)
        self.max_dets = sorted(max_dets)
        self.area_labels = list(AREA_RNG)
        self.imgs = {im["id"]: im for im in gt["images"]}
        self.cat_ids = sorted(
            cat_ids if cat_ids is not None
            else [c["id"] for c in gt["categories"]]
        )
        self.gts = defaultdict(list)
        for ann in gt["annotations"]:
            self.gts[(ann["image_id"], ann["category_id"])].append(ann)
        self.img_ids = sorted(self.imgs)

    def _ann_counts(self, ann: Dict, img: Dict) -> np.ndarray:
        """Run-length sequence of an annotation's mask. RLE segmentations
        (the common case — everything our pipeline emits) decompress without
        ever densifying; polygons rasterise once, then re-encode."""
        seg = ann["segmentation"]
        if isinstance(seg, dict):
            return rle_ops.counts_of(seg)
        mask = rle_ops.polygons_to_mask(seg, img["height"], img["width"])
        return rle_ops._counts_from_mask(mask)

    def evaluate(self, predictions: List[Dict]) -> Dict[str, float]:
        dts = defaultdict(list)
        for i, p in enumerate(predictions):
            p = dict(p)
            p.setdefault("id", i + 1)
            if "area" not in p:
                p["area"] = rle_ops.area(p["segmentation"])
            dts[(p["image_id"], p["category_id"])].append(p)

        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        K = len(self.cat_ids)
        A = len(self.area_labels)
        M = len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        max_det_cap = self.max_dets[-1]
        for k, cat_id in enumerate(self.cat_ids):
            # per-image match results at cap maxDet, matched PER AREA RANGE
            # (the protocol redoes matching with out-of-range GTs ignored —
            # sorted last, matchable but avoidable); IoUs computed once
            per_img = []
            for img_id in self.img_ids:
                g = self.gts.get((img_id, cat_id), [])
                d = dts.get((img_id, cat_id), [])
                if not g and not d:
                    continue
                per_img.append(self._evaluate_img(
                    g, d, self.imgs[img_id], max_det_cap))
            if not per_img:
                continue
            # concatenate the category's per-image match results once; every
            # (area, maxDet) cell then reduces over flat arrays with no
            # Python per-image loop
            cat = self._concat_cat(per_img)
            for a, area in enumerate(self.area_labels):
                rng = AREA_RNG[area]
                for m, max_det in enumerate(self.max_dets):
                    self._accumulate(
                        cat, a, rng, max_det, precision[:, :, k, a, m],
                        recall[:, k, a, m],
                    )

        self.precision = precision
        self.recall = recall
        return self._summarize()

    def _evaluate_img(self, gts: List[Dict], dts: List[Dict], img: Dict,
                      max_det: int) -> Dict:
        """Greedy detection-GT matching, once per area range (pycocotools
        evaluateImg semantics: a GT is ignored for a range when it is crowd,
        carries the annotation-level `ignore` flag, or its area falls
        outside the range; ignored GTs sort last so a detection prefers any
        in-range GT and only falls back to an ignored one)."""
        T = len(self.iou_thrs)
        A = len(self.area_labels)
        dts = sorted(dts, key=lambda d: -d["score"])[:max_det]
        g_crowd = np.array([bool(g.get("iscrowd", 0)) for g in gts],
                           dtype=bool)
        g_flag = np.array(
            [bool(g.get("ignore", 0)) or bool(g.get("iscrowd", 0))
             for g in gts], dtype=bool)
        g_area = np.array([g["area"] for g in gts], dtype=np.float64)

        if gts and dts:
            # IoU on run lengths, no dense decode. Computed once, in the
            # original GT order; per-range matching permutes columns.
            gc = [self._ann_counts(g, img) for g in gts]
            dc = [rle_ops.counts_of(d["segmentation"]) for d in dts]
            ious = rle_ops.counts_iou(dc, gc, iscrowd=g_crowd.tolist())
        else:
            ious = np.zeros((len(dts), len(gts)))

        G, D = len(gts), len(dts)
        dt_area = np.array([d["area"] for d in dts], dtype=np.float64)
        dt_score = np.array([d["score"] for d in dts], dtype=np.float64)

        dtm = np.zeros((A, T, D), dtype=np.int64)  # matched (any gt) flag+1
        dt_ig_match = np.zeros((A, T, D), dtype=bool)
        gt_ig = np.zeros((A, G), dtype=bool)

        for a, area in enumerate(self.area_labels):
            rng = AREA_RNG[area]
            ig = g_flag | (g_area < rng[0]) | (g_area > rng[1])
            gt_ig[a] = ig
            if not (G and D):
                continue
            order = np.argsort(ig, kind="stable")  # ignored GTs last
            ig_s = ig[order]
            crowd_s = g_crowd[order]
            ious_s = ious[:, order]
            gtm = np.zeros((T, G), dtype=np.int64)
            for t, thr in enumerate(self.iou_thrs):
                for di in range(D):
                    best_iou = min(thr, 1 - 1e-10)
                    best = -1
                    for gi in range(G):
                        if gtm[t, gi] > 0 and not crowd_s[gi]:
                            continue
                        # ignored GTs come last; stop once we hold a real
                        # match and reach the ignored tail
                        if best > -1 and not ig_s[best] and ig_s[gi]:
                            break
                        if ious_s[di, gi] < best_iou:
                            continue
                        best_iou = ious_s[di, gi]
                        best = gi
                    if best == -1:
                        continue
                    dtm[a, t, di] = best + 1
                    dt_ig_match[a, t, di] = ig_s[best]
                    gtm[t, best] = di + 1

        return {
            "gt_ig": gt_ig,
            "dt_area": dt_area,
            "dt_score": dt_score,
            "dtm": dtm,
            "dt_ig_match": dt_ig_match,
        }

    @staticmethod
    def _concat_cat(per_img):
        """Flatten one category's per-image match results. `dt_rank` is each
        detection's 0-based score rank WITHIN its image (detections arrive
        already score-sorted per image), so capping at maxDet m later is just
        `dt_rank < m` — no per-image slicing."""
        dt_score = np.concatenate([r["dt_score"] for r in per_img])
        dt_rank = np.concatenate(
            [np.arange(len(r["dt_score"])) for r in per_img])
        dtm = np.concatenate([r["dtm"] for r in per_img], axis=2)
        dt_ig_match = np.concatenate(
            [r["dt_ig_match"] for r in per_img], axis=2)
        dt_area = np.concatenate([r["dt_area"] for r in per_img])
        gt_ig = np.concatenate([r["gt_ig"] for r in per_img], axis=1)
        # one stable global sort by descending score, shared by all
        # (area, maxDet) cells
        order = np.argsort(-dt_score, kind="mergesort")
        return {
            "dt_score": dt_score[order],
            "dt_rank": dt_rank[order],
            "dtm": dtm[:, :, order],
            "dt_ig_match": dt_ig_match[:, :, order],
            "dt_area": dt_area[order],
            "gt_ig": gt_ig,
        }

    def _accumulate(self, cat, a_idx, rng, max_det, precision_out,
                    recall_out):
        T = len(self.iou_thrs)
        npig = int((~cat["gt_ig"][a_idx]).sum())
        if npig == 0:
            return
        sel = cat["dt_rank"] < max_det  # per-image maxDet cap, score order
        dtm = cat["dtm"][a_idx][:, sel]
        nd = dtm.shape[1]
        if nd:
            m_ig = cat["dt_ig_match"][a_idx][:, sel]
            dt_area = cat["dt_area"][sel]
            # dt ignored: matched to an ignored gt, or unmatched with
            # out-of-range area
            a_out = (dt_area < rng[0]) | (dt_area > rng[1])
            dt_ig = m_ig | ((dtm == 0) & a_out[None, :])
            tp_cum = np.cumsum((dtm > 0) & ~dt_ig, axis=1, dtype=np.float64)
            fp_cum = np.cumsum((dtm == 0) & ~dt_ig, axis=1, dtype=np.float64)
        else:
            tp_cum = np.zeros((T, 0))
            fp_cum = np.zeros((T, 0))

        R = len(self.rec_thrs)
        rc = tp_cum / npig
        pr = tp_cum / np.maximum(tp_cum + fp_cum, np.finfo(np.float64).eps)
        recall_out[:] = rc[:, -1] if nd else 0.0
        if not nd:
            precision_out[:] = np.zeros((T, R))
            return
        # monotone non-increasing precision envelope (vectorised suffix max)
        pr = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
        q = np.zeros((T, R))
        for t in range(T):
            inds = np.searchsorted(rc[t], self.rec_thrs, side="left")
            valid = inds < nd
            q[t, valid] = pr[t, inds[valid]]
        precision_out[:] = q

    def _summarize(self) -> Dict[str, float]:
        def ap(iou=None, area="all", max_det=None):
            max_det = self.max_dets[-1] if max_det is None else max_det
            a = self.area_labels.index(area)
            m = self.max_dets.index(max_det)
            p = self.precision[:, :, :, a, m]
            if iou is not None:
                t = np.flatnonzero(np.isclose(self.iou_thrs, iou))[0]
                p = p[t:t + 1]
            p = p[p > -1]
            return float(p.mean()) if p.size else -1.0

        def ar(area="all", max_det=None):
            max_det = self.max_dets[-1] if max_det is None else max_det
            a = self.area_labels.index(area)
            m = self.max_dets.index(max_det)
            r = self.recall[:, :, a, m]
            r = r[r > -1]
            return float(r.mean()) if r.size else -1.0

        md = self.max_dets
        return {
            "AP": ap(),
            "AP50": ap(iou=0.5),
            "AP75": ap(iou=0.75),
            "AP_small": ap(area="small"),
            "AP_medium": ap(area="medium"),
            "AP_large": ap(area="large"),
            f"AR_maxDets_{md[0]}": ar(max_det=md[0]),
            f"AR_maxDets_{md[1] if len(md) > 1 else md[0]}":
                ar(max_det=md[1] if len(md) > 1 else md[0]),
            f"AR_maxDets_{md[-1]}": ar(max_det=md[-1]),
            "AR_small": ar(area="small"),
            "AR_medium": ar(area="medium"),
            "AR_large": ar(area="large"),
        }
