"""Host-side image transforms on numpy arrays (the port's copy of
zutis_tpu/data/transforms.py, without Pillow).

`resize` reproduces Pillow's `Image.resize` bit for bit on the modes the
loaders use: images are HWC uint8 arrays ([H, W] for mode "L", [H, W, 3]
for "RGB"), float32 [H, W] arrays for mode "F" and int32 [H, W] arrays for
mode "I".
  BILINEAR, BICUBIC, LANCZOS (ImagingResample): each output pixel weighs
    the input pixels within the filter's support, scaled by the downscale
    factor, with coefficients normalised in double; for uint8 they are
    fixed point with 22 fractional bits and each pass rounds once, the
    horizontal pass before the vertical one; for float32 each pass sums in
    double and stores float32.
  NEAREST (ImagingScaleAffine): the source pixel at the running sum of the
    scale from half a step, truncated.
The taps are gathered with numpy, one tap at a time in Pillow's order.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit resampling


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x):
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x):
    flat = [(_sinc(v) * _sinc(v / 3) if -3.0 <= v < 3.0 else 0.0)
            for v in np.asarray(x, np.float64).ravel().tolist()]
    return np.asarray(flat, np.float64).reshape(np.shape(x))


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0),
            "lanczos": (_lanczos, 3.0)}


def _coefficients(in_size: int, out_size: int, filt, support: float):
    """Pillow's precompute_coeffs: -> (xmin [out], taps [out, k] in double,
    zero past each pixel's xmax)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.trunc(center - support + 0.5).astype(np.int64)
    xmin = np.maximum(xmin, 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize)
    live = x[None, :] < xmax[:, None]
    arg = ((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (
        1.0 / filterscale)
    w = np.where(live, filt(arg), 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):  # in Pillow's order
        ww = ww + w[:, t]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    return xmin, w


def _fixed(k: np.ndarray) -> np.ndarray:
    """normalize_coeffs_8bpc: double taps -> int32 with 22 fractional bits."""
    scaled = k * float(1 << PRECISION_BITS)
    return np.where(k < 0, np.trunc(-0.5 + scaled),
                    np.trunc(0.5 + scaled)).astype(np.int64)


def _pass(arr: np.ndarray, axis: int, out_size: int, filt, support: float):
    """One resampling pass of `arr` (uint8 or float32) along `axis`."""
    in_size = arr.shape[axis]
    xmin, k = _coefficients(in_size, out_size, filt, support)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :],
                     in_size - 1)
    moved = np.moveaxis(arr, axis, 0)
    shape = (out_size,) + (1,) * (moved.ndim - 1)
    if arr.dtype == np.uint8:
        kk = _fixed(k)
        acc = np.full((out_size,) + moved.shape[1:], 1 << (PRECISION_BITS - 1),
                      np.int64)
        for t in range(k.shape[1]):
            acc += moved[idx[:, t]].astype(np.int64) * kk[:, t].reshape(shape)
        out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    else:
        acc = np.zeros((out_size,) + moved.shape[1:], np.float64)
        for t in range(k.shape[1]):
            acc = acc + moved[idx[:, t]].astype(np.float64) * k[:, t].reshape(
                shape)
        out = acc.astype(np.float32)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    step = float(in_size) / out_size
    pos, idx = step * 0.5, []
    for _ in range(out_size):  # the running sum, as ImagingScaleAffine
        idx.append(-1 if pos < 0.0 else int(pos))
        pos += step
    return np.clip(np.asarray(idx, np.int64), 0, in_size - 1)


def resize(arr: np.ndarray, size: Tuple[int, int],
           resample: str = "bilinear") -> np.ndarray:
    """`Image.resize(size, resample)` on an array: `size` is (width,
    height), as Pillow takes it. uint8 [H, W] or [H, W, C] (modes L, RGB)
    with every filter; float32 [H, W] (mode F) with every filter; int32
    [H, W] (mode I) with "nearest"."""
    out_w, out_h = int(size[0]), int(size[1])
    if out_w < 1 or out_h < 1:
        raise ValueError(f"resize to {size}: sizes must be positive")
    h, w = arr.shape[:2]
    if (out_h, out_w) == (h, w):
        return arr.copy()
    if resample == "nearest":
        return np.ascontiguousarray(
            arr[_nearest_index(h, out_h)][:, _nearest_index(w, out_w)])
    if arr.dtype not in (np.uint8, np.float32):
        raise ValueError(f"{resample} resampling of {arr.dtype} arrays: "
                         "uint8 (L, RGB) and float32 (F) only")
    filt, support = _FILTERS[resample]
    out = arr
    if out_w != w:
        out = _pass(out, 1, out_w, filt, support)
    if out_h != h:
        out = _pass(out, 0, out_h, filt, support)
    return out


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 HWC (or HW) -> normalised float32 CHW."""
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


def resize_edge(
    img: np.ndarray,
    size: Union[int, Sequence[int]],
    edge: str = "shorter",
    interpolation: str = "bilinear",
) -> np.ndarray:
    """Resize by shorter/longer edge preserving aspect ratio, or to an exact
    (h, w) when `edge`="both" (reference geometric_transforms.py:85-171)."""
    h, w = img.shape[:2]
    if edge == "both":
        th, tw = size if not isinstance(size, int) else (size, size)
        return resize(img, (int(tw), int(th)), interpolation)
    assert isinstance(size, int)
    if edge == "shorter":
        scale = size / min(h, w)
    elif edge == "longer":
        scale = size / max(h, w)
    else:
        raise ValueError(edge)
    return resize(img, (round(w * scale), round(h * scale)), interpolation)


def pad_to_multiple(
    arr: np.ndarray, multiple: int, fill: float = 0.0
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Pad the trailing H, W axes up to a multiple; returns (padded, (H, W))."""
    h, w = arr.shape[-2:]
    ph = (-h) % multiple
    pw = (-w) % multiple
    if ph == 0 and pw == 0:
        return arr, (h, w)
    pad = [(0, 0)] * (arr.ndim - 2) + [(0, ph), (0, pw)]
    return np.pad(arr, pad, constant_values=fill), (h, w)
