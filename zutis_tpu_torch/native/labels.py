"""Hole filling and 4-connected labelling on the host (native/labels.cc),
bound with ctypes: scipy.ndimage's `binary_fill_holes` and `label` at their
default cross structure, bit for bit, for the bilateral solver's final mask
(ops/bilateral.py). The port does not use scipy.

Built with g++ at first use by `ops/_build.py` (into `build/zutis_tpu_torch/`,
keyed by the source and the flags, renamed into place), as the RLE codec
and the image library are. A missing g++ or a failed build raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np

from zutis_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parent / "labels.cc"
STEM = "liblabels"

_u8_p = ctypes.POINTER(ctypes.c_uint8)
_i32_p = ctypes.POINTER(ctypes.c_int32)


def build():
    """Compile the library if needed; see `_build.build`."""
    return _build.build(SOURCE, STEM)


def _bind(lib: ctypes.CDLL) -> None:
    lib.fill_holes.restype = ctypes.c_int
    lib.fill_holes.argtypes = [_u8_p, _u8_p, ctypes.c_int, ctypes.c_int]
    lib.label4.restype = ctypes.c_int
    lib.label4.argtypes = [_u8_p, _i32_p, ctypes.c_int, ctypes.c_int]


def _mask(mask: np.ndarray) -> np.ndarray:
    if mask.ndim != 2:
        raise ValueError(f"a 2-D mask, got shape {mask.shape}")
    return np.ascontiguousarray(mask != 0, np.uint8)


def fill_holes(mask: np.ndarray) -> np.ndarray:
    """`scipy.ndimage.binary_fill_holes(mask)` for a 2-D mask -> bool."""
    src = _mask(mask)
    out = np.empty_like(src)
    h, w = src.shape
    _build.load(SOURCE, STEM, _bind).fill_holes(
        src.ctypes.data_as(_u8_p), out.ctypes.data_as(_u8_p), h, w)
    return out.view(bool)


def label(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """`scipy.ndimage.label(mask)` for a 2-D mask -> (int32 labels, number
    of components)."""
    src = _mask(mask)
    out = np.empty(src.shape, np.int32)
    h, w = src.shape
    n = _build.load(SOURCE, STEM, _bind).label4(
        src.ctypes.data_as(_u8_p), out.ctypes.data_as(_i32_p), h, w)
    return out, n
