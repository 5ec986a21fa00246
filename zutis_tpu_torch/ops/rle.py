"""COCO run-length-encoding codec, byte-compatible with the pycocotools JSON
format, and the host helpers of COCO JSON I/O (the port's copy of
zutis_tpu/ops/rle.py). The numpy codec here is the plain version of the C++
one in `native/`: `counts_iou` and `counts_of` run on the C++ codec, as the
JAX package's do, and `counts_iou_reference` and `_decompress_counts` are
what the tests hold it against.

Masks are flattened in Fortran (column-major) order; counts alternate runs
of 0s and 1s starting with zeros. The compressed string packs each count
(delta-coded against count[i-2] for i > 2) as little-endian 5-bit groups with
a continuation bit, offset by chr(48).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from zutis_tpu_torch.native import native_rle_iou, native_string_to_counts

RLE = Dict[str, Union[List[int], str]]


def _counts_from_mask(mask: np.ndarray) -> np.ndarray:
    """mask: [h, w] {0,1} -> run lengths (column-major, zeros first)."""
    flat = np.asfortranarray(mask.astype(np.uint8)).flatten(order="F")
    n = flat.size
    if n == 0:
        return np.zeros(0, np.int64)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    boundaries = np.concatenate([[0], change, [n]])
    counts = np.diff(boundaries)
    if flat[0] == 1:  # must start with a zero-run
        counts = np.concatenate([[0], counts])
    return counts.astype(np.int64)


def _compress_counts(counts: Sequence[int]) -> str:
    out = []
    counts = list(map(int, counts))
    for i, c in enumerate(counts):
        x = c - counts[i - 2] if i > 2 else c
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            more = (x != -1) if (chunk & 0x10) else (x != 0)
            if more:
                chunk |= 0x20
            out.append(chr(chunk + 48))
    return "".join(out)


def _decompress_counts(s: str) -> np.ndarray:
    counts: List[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        while True:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            i += 1
            k += 1
            if not (c & 0x20):
                if c & 0x10:  # sign-extend
                    x |= -1 << (5 * k)
                break
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.int64)


def encode(mask: np.ndarray) -> RLE:
    """mask: [h, w] binary -> COCO compressed RLE dict."""
    h, w = mask.shape
    return {"size": [int(h), int(w)],
            "counts": _compress_counts(_counts_from_mask(mask))}


def decode(rle: RLE) -> np.ndarray:
    """COCO RLE dict (compressed str or uncompressed list counts) -> [h, w]
    uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, bytes):
            counts = counts.decode("ascii")
        counts = _decompress_counts(counts)
    else:
        counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total != h * w:
        raise ValueError(f"RLE length {total} != {h}*{w}")
    flat = np.zeros(h * w, np.uint8)
    ends = np.cumsum(counts)
    starts = ends - counts
    for i in range(1, len(counts), 2):
        flat[starts[i]:ends[i]] = 1
    return flat.reshape((w, h)).T  # undo Fortran order


def counts_of(rle: RLE) -> np.ndarray:
    """The run-length sequence of a COCO RLE dict (compressed or not); a
    string is parsed by the C++ codec."""
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, bytes):
            counts = counts.decode("ascii")
        return native_string_to_counts(counts)
    return np.asarray(counts, np.int64)


def area(rle: RLE) -> int:
    return int(np.asarray(counts_of(rle)[1::2]).sum())


def to_bbox(mask: np.ndarray) -> List[float]:
    """Tight xyxy box of a binary mask (torchvision masks_to_boxes
    semantics); an empty mask gives zeros."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return [0.0, 0.0, 0.0, 0.0]
    return [float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max())]


def mask_iou(
    dts: np.ndarray,  # [n_dt, h, w]
    gts: np.ndarray,  # [n_gt, h, w]
    iscrowd: Sequence[bool] | None = None,
) -> np.ndarray:
    """Pairwise mask IoU [n_dt, n_gt]; for a crowd GT the denominator is the
    detection's area (COCO convention)."""
    d = dts.reshape(len(dts), -1).astype(np.float64)
    g = gts.reshape(len(gts), -1).astype(np.float64)
    inter = d @ g.T
    da = d.sum(-1)[:, None]
    ga = g.sum(-1)[None, :]
    union = da + ga - inter
    if iscrowd is not None and any(iscrowd):
        crowd = np.asarray(iscrowd, bool)[None, :]
        union = np.where(crowd, da + 0 * ga, union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def counts_iou(
    dt_counts: List[np.ndarray],
    gt_counts: List[np.ndarray],
    iscrowd: Sequence[bool] | None = None,
) -> np.ndarray:
    """Pairwise mask IoU [n_dt, n_gt] on run-length sequences, never
    densifying a mask: the C++ codec's two-pointer merge of the runs.
    Integer arithmetic up to the one division, so the result equals
    `mask_iou` of the decoded masks bit for bit."""
    crowd = (np.zeros(len(gt_counts), bool) if iscrowd is None
             else np.asarray(iscrowd, bool))
    return native_rle_iou(list(dt_counts), list(gt_counts), list(crowd))


def counts_iou_reference(
    dt_counts: List[np.ndarray],
    gt_counts: List[np.ndarray],
    iscrowd: Sequence[bool] | None = None,
) -> np.ndarray:
    """Plain version of `counts_iou` in numpy: each detection's runs are
    measured against the GT's cumulative coverage (O(n_dt_runs *
    log n_gt_runs) per pair)."""
    nd, ng = len(dt_counts), len(gt_counts)
    crowd = (np.zeros(ng, bool) if iscrowd is None
             else np.asarray(iscrowd, bool))

    def one_intervals(counts):
        ends = np.cumsum(counts)
        starts = ends - counts
        return starts[1::2].astype(np.int64), ends[1::2].astype(np.int64)

    d_iv = [one_intervals(np.asarray(c)) for c in dt_counts]
    g_iv = [one_intervals(np.asarray(c)) for c in gt_counts]
    d_area = np.array([int((e - s).sum()) for s, e in d_iv], np.int64)
    g_area = np.array([int((e - s).sum()) for s, e in g_iv], np.int64)

    out = np.zeros((nd, ng), np.float64)
    for gi, (gs, ge) in enumerate(g_iv):
        if len(gs) == 0:
            continue
        cum = np.concatenate([[0], np.cumsum(ge - gs)])

        def coverage_below(x):
            # the GT-covered length in [0, x)
            j = np.searchsorted(gs, x, side="right") - 1
            jc = np.maximum(j, 0)
            val = cum[jc] + np.clip(x - gs[jc], 0, ge[jc] - gs[jc])
            return np.where(j >= 0, val, 0)

        for di, (ds, de) in enumerate(d_iv):
            if len(ds) == 0:
                continue
            inter = int((coverage_below(de) - coverage_below(ds)).sum())
            union = (d_area[di] if crowd[gi]
                     else d_area[di] + g_area[gi] - inter)
            out[di, gi] = inter / union if union > 0 else 0.0
    return out


# ------------------------------------------------------------ polygons
#
# COCO polygons are rasterised as OpenCV's cv2.fillPoly does (which the JAX
# package calls): 16-bit fixed-point edges through the vertices, filled on
# each row from the ceiling of one crossing to the floor of the next, plus
# every side drawn as an 8-connected Bresenham line. The card's machine has
# no OpenCV, so this is a copy of that algorithm (imgproc/drawing.cpp:
# CollectPolyEdges, FillEdgeCollection, Line, clipLine), held against cv2 in
# the tests.

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _trunc_div(a: int, b: int) -> int:
    """C's integer division, which truncates toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """cv::clipLine: -> (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _draw_line(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """cv::Line with 8-connectivity, drawn left to right, clipped."""
    h, w = mask.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        mask[y, x] = 1
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += minor
        else:
            x += 1
            y += sy * minor


def _poly_edges(mask: np.ndarray, pts: np.ndarray, edges: list) -> None:
    """CollectPolyEdges for one polygon (shift 0): draws its outline and
    appends (y0, y1, x at y0, dx) fixed-point edges of its non-horizontal
    sides. A side that leaves the image takes its x from clipLine's end
    points: the clipped segment itself where they lie on two rows, else the
    side's own rows at the clipped x, so that a side which only grazes the
    image fills the border column it is clipped to."""
    h, w = mask.shape
    n = len(pts)
    for i in range(n):
        (ax, ay), (bx, by) = pts[i - 1], pts[i]
        x0, y0, x1, y1 = int(ax) << _XY_SHIFT, int(ay), int(bx) << _XY_SHIFT, int(by)
        t0x = (x0 + (_XY_ONE >> 1)) >> _XY_SHIFT
        t1x = (x1 + (_XY_ONE >> 1)) >> _XY_SHIFT
        _draw_line(mask, t0x, y0, t1x, y1)
        c0x, c0y, c1x, c1y = x0, y0, x1, y1
        if not (0 <= t0x < w and 0 <= t1x < w and 0 <= y0 < h and 0 <= y1 < h):
            _, t0x, t0y, t1x, t1y = _clip_line(w, h, t0x, y0, t1x, y1)
            c0x, c1x = t0x << _XY_SHIFT, t1x << _XY_SHIFT
            if t0y != t1y:
                c0y, c1y = t0y, t1y
        if y0 == y1:
            continue
        dx = _trunc_div(c1x - c0x, c1y - c0y)
        if y0 < y1:
            edges.append((y0, y1, c0x + (y0 - c0y) * dx, dx))
        else:
            edges.append((y1, y0, c1x + (y1 - c1y) * dx, dx))


def _fill_edges(mask: np.ndarray, edges: list) -> None:
    """FillEdgeCollection: on each row, fill between successive pairs of
    the active edges' crossings, in order of x."""
    h, w = mask.shape
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [x for y0, y1, x, dx in edges for x in (x, x + (y1 - y0) * dx)]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << _XY_SHIFT):
        return
    for y in range(max(y_min, 0), min(y_max, h)):
        cross = sorted(x + (y - y0) * dx for y0, y1, x, dx in edges
                       if y0 <= y < y1)
        for left, right in zip(cross[0::2], cross[1::2]):
            x1 = (left + _XY_ONE - 1) >> _XY_SHIFT
            x2 = right >> _XY_SHIFT
            if x1 < w and x2 >= 0:
                mask[y, max(x1, 0):min(x2, w - 1) + 1] = 1


def polygons_to_mask(polygons: List[Sequence[float]], h: int, w: int) -> np.ndarray:
    """COCO polygon segmentation -> [h, w] uint8 mask, as cv2.fillPoly
    fills the rounded vertices of all polygons in one call (even-odd across
    polygons, outlines included). Polygons of fewer than 3 points are
    dropped. Equal to OpenCV 5.0's mask, also where sides leave the
    image."""
    mask = np.zeros((h, w), np.uint8)
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
           for p in polygons if len(p) >= 6]
    edges: list = []
    for poly in pts:
        _poly_edges(mask, poly, edges)
    _fill_edges(mask, edges)
    return mask


def segmentation_to_mask(seg, h: int, w: int) -> np.ndarray:
    """Any COCO 'segmentation' field (polygon list or RLE dict) -> mask."""
    if isinstance(seg, dict):
        return decode(seg)
    return polygons_to_mask(seg, h, w)
