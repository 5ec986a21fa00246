"""Torch-`F.interpolate`-compatible resizing as per-axis weight matmuls.

The port's copy of zutis_tpu/ops/resize.py. Each axis resize is a dense
[out_size, in_size] matrix (2 or 4 non-zeros per row) built in float64 numpy
from static shapes and applied as an einsum in float32, so the port computes
exactly what the JAX package computes: half-pixel source centres
`src = (dst + 0.5) * scale - 0.5` with clamped borders, Keys cubic a = -0.75,
and `scale_factor` mapping coordinates by 1 / scale_factor (torch's
recompute_scale_factor=False path, which the CLIP positional-embedding `+0.1`
fudge depends on).
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=256)
def _resize_matrix(
    in_size: int, out_size: int, mode: str, scale: float | None = None
) -> np.ndarray:
    """[out_size, in_size] row-stochastic interpolation matrix (float32).
    `scale` overrides the src/dst ratio (torch's scale_factor path)."""
    if in_size == out_size and scale is None:
        return np.eye(in_size, dtype=np.float32)
    if scale is None:
        scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    f = np.floor(src)
    t = src - f
    if mode == "linear":
        taps = ((0, 1.0 - t), (1, t))
    elif mode == "cubic":
        taps = tuple((tap, _cubic_kernel(t - tap)) for tap in (-1, 0, 1, 2))
    else:
        raise ValueError(f"unknown resize mode: {mode}")
    for tap, w in taps:
        idx = np.clip(f + tap, 0, in_size - 1).astype(np.int64)
        np.add.at(mat, (dst.astype(np.int64), idx), w)
    return mat.astype(np.float32)


def resize_2d(
    x: torch.Tensor,
    size: Sequence[int],
    mode: str = "linear",
    scales: Sequence[float] | None = None,
) -> torch.Tensor:
    """Resize the last two axes of `x` to `size` = (H, W) in float32 and cast
    back. `mode` is "linear" or "cubic"; `scales` pins the per-axis
    (src/dst) coordinate scales."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    h_out, w_out = int(size[0]), int(size[1])
    if (h_in, w_in) == (h_out, w_out) and scales is None:
        return x
    sh, sw = (None, None) if scales is None else scales
    wh = torch.from_numpy(_resize_matrix(h_in, h_out, mode, sh)).to(x.device)
    ww = torch.from_numpy(_resize_matrix(w_in, w_out, mode, sw)).to(x.device)
    y = torch.einsum("oh,...hw->...ow", wh, x.float())
    y = torch.einsum("ow,...hw->...ho", ww, y)
    return y.to(x.dtype)


def interpolate(
    x: torch.Tensor,
    size: Sequence[int] | None = None,
    scale_factor: float | Sequence[float] | None = None,
    mode: str = "bilinear",
) -> torch.Tensor:
    """`F.interpolate` analogue for NCHW inputs (align_corners=False), mode in
    {"bilinear", "bicubic"}."""
    mode = {"bilinear": "linear", "bicubic": "cubic"}.get(mode, mode)
    scales = None
    if size is None:
        if scale_factor is None:
            raise ValueError("interpolate needs size or scale_factor")
        if isinstance(scale_factor, (int, float)):
            scale_factor = (scale_factor, scale_factor)
        size = (
            int(np.floor(x.shape[-2] * scale_factor[0])),
            int(np.floor(x.shape[-1] * scale_factor[1])),
        )
        scales = (1.0 / scale_factor[0], 1.0 / scale_factor[1])
    return resize_2d(x, size, mode=mode, scales=scales)
