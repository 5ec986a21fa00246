"""COCO run-length-encoding codec, byte-compatible with the pycocotools JSON
format (the port's copy of the numpy codec in zutis_tpu/ops/rle.py that the
server uses).

Masks are flattened in Fortran (column-major) order; counts alternate runs
of 0s and 1s starting with zeros. The compressed string packs each count
(delta-coded against count[i-2] for i > 2) as little-endian 5-bit groups with
a continuation bit, offset by chr(48).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

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
