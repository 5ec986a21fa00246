"""The C++ COCO RLE codec (native/rle.cc), bound with ctypes: the port's
copy of zutis_tpu/native/__init__.py, with the JAX wrapper's names.

The library is built with g++ at first use by `ops/_build.py` (into
`build/zutis_tpu_torch/`, keyed by the source and the flags, renamed into
place, so that processes loading it at once never see half a library).
Unlike the JAX wrapper, nothing here returns None for "no toolchain": a
missing g++ or a failed build raises. The numpy codec in `ops/rle.py` is
the plain version the tests hold this one against; the server, the eval's
COCO assembly and the COCO scorer run on this one.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from zutis_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parent / "rle.cc"
STEM = "librle"

_c_int_p = ctypes.POINTER(ctypes.c_int)
_c_int64_p = ctypes.POINTER(ctypes.c_int64)
_c_uint8_p = ctypes.POINTER(ctypes.c_uint8)


def build():
    """Compile the codec if needed; see `_build.build`."""
    return _build.build(SOURCE, STEM)


def _bind(lib: ctypes.CDLL) -> None:
    lib.rle_encode.restype = ctypes.c_int
    lib.rle_encode.argtypes = [_c_uint8_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_char_p, ctypes.c_int]
    lib.rle_decode.restype = ctypes.c_int
    lib.rle_decode.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, _c_uint8_p]
    lib.rle_encode_batch.restype = ctypes.c_int
    lib.rle_encode_batch.argtypes = [_c_uint8_p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_int, _c_int_p]
    lib.rle_counts_to_string_batch.restype = ctypes.c_int
    lib.rle_counts_to_string_batch.argtypes = [
        _c_int64_p, _c_int_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, _c_int_p]
    lib.rle_string_to_counts.restype = ctypes.c_int
    lib.rle_string_to_counts.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         _c_int64_p, ctypes.c_int]
    lib.rle_iou_batch.restype = None
    lib.rle_iou_batch.argtypes = [
        _c_int64_p, _c_int_p, ctypes.c_int, ctypes.c_int,
        _c_int64_p, _c_int_p, ctypes.c_int, ctypes.c_int,
        _c_uint8_p, ctypes.POINTER(ctypes.c_double)]
    lib.rle_encode_packed_batch.restype = ctypes.c_int
    lib.rle_encode_packed_batch.argtypes = [
        _c_uint8_p, ctypes.c_int64, _c_int_p, ctypes.c_int, ctypes.c_int,
        _c_int_p, _c_int_p, ctypes.c_char_p, ctypes.c_int, _c_int_p,
        _c_int_p, _c_int64_p]


def load_rle_lib() -> ctypes.CDLL:
    """The codec library, built on first use and loaded once per process."""
    return _build.load(SOURCE, STEM, _bind)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _split(raw: bytes, offsets, total: int) -> List[str]:
    bounds = list(offsets) + [total]
    return [raw[bounds[i]:bounds[i + 1]].decode("ascii")
            for i in range(len(bounds) - 1)]


def _masks_u8(masks: np.ndarray, ndim: int) -> np.ndarray:
    m = np.ascontiguousarray(np.asarray(masks).astype(np.uint8, copy=False))
    if m.ndim != ndim or m.shape[-1] * m.shape[-2] == 0:
        raise ValueError(f"expected non-empty {ndim}-d masks, got {m.shape}")
    return m


def native_encode(mask: np.ndarray) -> str:
    """One [h, w] binary mask -> its COCO counts string."""
    lib = load_rle_lib()
    m = _masks_u8(mask, 2)
    h, w = m.shape
    cap = 2 * h * w + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.rle_encode(_ptr(m, ctypes.c_uint8), h, w, out, cap)
    if n < 0:
        raise RuntimeError("rle_encode overflowed its buffer")
    return out.raw[:n].decode("ascii")


def native_encode_batch(masks: np.ndarray) -> List[str]:
    """[n, h, w] binary masks -> their counts strings."""
    lib = load_rle_lib()
    m = _masks_u8(masks, 3)
    n, h, w = m.shape
    if n == 0:
        return []
    cap = 2 * n * h * w + 64 * n
    out = ctypes.create_string_buffer(cap)
    offsets = (ctypes.c_int * n)()
    total = lib.rle_encode_batch(_ptr(m, ctypes.c_uint8), n, h, w, out, cap,
                                 offsets)
    if total < 0:
        raise RuntimeError("rle_encode_batch overflowed its buffer")
    return _split(out.raw, offsets, total)


def native_decode(counts: str, h: int, w: int) -> np.ndarray:
    """A counts string -> its [h, w] uint8 mask; raises on a malformed
    string or one whose runs do not cover h * w pixels."""
    lib = load_rle_lib()
    out = np.zeros((h, w), np.uint8)
    raw = counts.encode("ascii")
    if lib.rle_decode(raw, len(raw), h, w, _ptr(out, ctypes.c_uint8)) != 0:
        raise ValueError(f"malformed RLE for a {h} x {w} mask")
    return out


def native_encode_packed(
    packed: np.ndarray,  # [n_masks, stride_bytes] uint8, F-order packed bits
    sel: np.ndarray,  # [n_sel] indices into the mask axis
    col_stride_bits: int,  # padded rows per column (a multiple of 8)
    hs: np.ndarray,  # [n_sel] native rows per selected mask
    ws: np.ndarray,  # [n_sel] native columns per selected mask
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Encode packed-bit masks (postproc.instance.pack_masks_fortran's
    layout) over their native windows -> (counts strings, bboxes [n_sel, 4]
    xyxy int32, areas [n_sel] int64)."""
    lib = load_rle_lib()
    packed = np.ascontiguousarray(packed.reshape(packed.shape[0], -1),
                                  dtype=np.uint8)
    sel = np.ascontiguousarray(sel, dtype=np.int32)
    hs = np.ascontiguousarray(hs, dtype=np.int32)
    ws = np.ascontiguousarray(ws, dtype=np.int32)
    n_sel = len(sel)
    if n_sel == 0:
        return [], np.zeros((0, 4), np.int32), np.zeros((0,), np.int64)
    if col_stride_bits % 8 or (hs > col_stride_bits).any() or (
            ws.astype(np.int64) * col_stride_bits // 8 > packed.shape[1]).any() or (
            (sel < 0) | (sel >= packed.shape[0])).any():
        raise ValueError("native_encode_packed: windows or indices outside "
                         "the packed masks")
    bboxes = np.zeros((n_sel, 4), np.int32)
    areas = np.zeros((n_sel,), np.int64)
    offsets = (ctypes.c_int * n_sel)()
    # the worst case is ~1 char a pixel: start smaller, grow on overflow
    cap = int(hs.astype(np.int64) @ ws.astype(np.int64) // 4 + 4096 * n_sel)
    while True:
        out = ctypes.create_string_buffer(cap)
        total = lib.rle_encode_packed_batch(
            _ptr(packed, ctypes.c_uint8), packed.strides[0],
            _ptr(sel, ctypes.c_int), n_sel, col_stride_bits,
            _ptr(hs, ctypes.c_int), _ptr(ws, ctypes.c_int), out, cap,
            offsets, _ptr(bboxes, ctypes.c_int), _ptr(areas, ctypes.c_int64))
        if total >= 0:
            break
        cap *= 4
    return _split(out.raw, offsets, total), bboxes, areas


def counts_to_strings(
    counts: np.ndarray,  # [n, stride] run-length sequences
    n_counts: np.ndarray,  # [n] valid prefix lengths
) -> List[str]:
    """Run-length sequences (ops/rle_device.py's) -> COCO counts strings."""
    lib = load_rle_lib()
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    n_counts = np.ascontiguousarray(n_counts, dtype=np.int32)
    n, stride = counts.shape
    if n == 0:
        return []
    if len(n_counts) != n or ((n_counts < 0) | (n_counts > stride)).any():
        raise ValueError("counts_to_strings: n_counts outside [0, stride]")
    offsets = (ctypes.c_int * n)()
    # a 64-bit count takes at most 13 five-bit groups: 16 a count is slack,
    # and an overflow retries with a larger arena
    cap = int(16 * n_counts.sum() + 64 * n)
    while True:
        out = ctypes.create_string_buffer(cap)
        total = lib.rle_counts_to_string_batch(
            _ptr(counts, ctypes.c_int64), _ptr(n_counts, ctypes.c_int), n,
            stride, out, cap, offsets)
        if total >= 0:
            break
        cap *= 4
    return _split(out.raw, offsets, total)


def native_string_to_counts(s: str) -> np.ndarray:
    """One COCO counts string -> its int64 run-length sequence; raises on
    a malformed string."""
    lib = load_rle_lib()
    raw = s.encode("ascii")
    out = np.empty(len(raw) + 1, np.int64)
    n = lib.rle_string_to_counts(raw, len(raw), _ptr(out, ctypes.c_int64),
                                 len(out))
    if n < 0:
        raise ValueError("malformed RLE counts string")
    return out[:n]


def native_rle_iou(
    dt_counts: Sequence[np.ndarray],  # per detection, int64 run lengths
    gt_counts: Sequence[np.ndarray],  # per ground truth, int64 run lengths
    iscrowd: Sequence[bool],
) -> np.ndarray:
    """Pairwise mask IoU [n_dt, n_gt] float64 straight from run lengths (a
    two-pointer merge of the runs, never densifying); for a crowd GT the
    denominator is the detection's area."""
    lib = load_rle_lib()
    nd, ng = len(dt_counts), len(gt_counts)
    if len(iscrowd) != ng:
        raise ValueError(f"{len(iscrowd)} crowd flags for {ng} ground truths")
    if nd == 0 or ng == 0:
        return np.zeros((nd, ng), np.float64)

    def pad(seqs):
        rows = np.zeros((len(seqs), max(1, max(len(c) for c in seqs))),
                        np.int64)
        for i, c in enumerate(seqs):
            rows[i, :len(c)] = c
        return rows, np.asarray([len(c) for c in seqs], np.int32)

    dpad, n_dt = pad(dt_counts)
    gpad, n_gt = pad(gt_counts)
    crowd = np.asarray(iscrowd, np.uint8)
    out = np.zeros((nd, ng), np.float64)
    lib.rle_iou_batch(
        _ptr(dpad, ctypes.c_int64), _ptr(n_dt, ctypes.c_int), nd,
        dpad.shape[1], _ptr(gpad, ctypes.c_int64), _ptr(n_gt, ctypes.c_int),
        ng, gpad.shape[1], _ptr(crowd, ctypes.c_uint8),
        _ptr(out, ctypes.c_double))
    return out
