"""Per-sample geometry under one padded batch shape (the port of
zutis_tpu/ops/dynamic_shapes.py).

The bucketed evaluator pads images of different native sizes into one
bucket shape and keeps each sample's native geometry as data. These
functions reproduce, on each sample's valid window, what the per-image
program computes at its native size:

  - `dynamic_resize_matrix`: [b, out, in_pad] interpolation matrices whose
    rows touch only the sample's native source extent. The native sizes are
    known on the host, so the matrices are built there, in float32 tensor
    ops in the JAX package's order: `scale = f32(n_in) / f32(n_out)`, then
    `(dst + 0.5) * scale - 0.5`, then `floor`. A float64 scale would move
    `floor` at some boundaries and flip mask pixels.
  - `batched_resize_native`: the per-sample resize as two matrix products.
  - `replicate_edges`: clamps a token grid to its native window, so that a
    x2 upsample of the padded grid equals the native upsample there.
  - `sine_pos_embed_dynamic`: the sine embedding normalised by each
    sample's native extent.
  - `interpolate_pos_embed_batched`: per-sample bicubic interpolation of the
    CLIP positional embedding (with the reference's +0.1 scale fudge) to the
    native grid, placed top-left in the padded grid.
  - `token_valid_mask`: [b, hp * wp] int32 validity of each padded token.

`native_hw` arguments are [b, 2] integer tensors: on the host where a
function builds matrices or embeddings (on the CPU, then moved to the
device without blocking), on the data's device for `replicate_edges` and
`token_valid_mask`.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from zutis_tpu_torch.core.device import to_device


def _as_long(native_hw) -> torch.Tensor:
    return torch.as_tensor(native_hw).to("cpu", torch.int64)


def _cubic_kernel(x: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    ax = x.abs()
    ax2, ax3 = ax * ax, ax * ax * ax
    near = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    far = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    return torch.where(ax <= 1.0, near, torch.where(ax < 2.0, far, 0.0))


def dynamic_resize_matrix(
    out_size: int,
    in_pad: int,
    in_native: torch.Tensor,  # [b] source extents
    mode: str = "linear",
    scale: torch.Tensor | None = None,  # [b] src/dst ratios, float32
) -> torch.Tensor:
    """[b, out_size, in_pad] float32 interpolation matrices on the CPU;
    torch `F.interpolate` semantics (half-pixel centres, clamped taps) with
    a per-sample source extent."""
    in_native = torch.as_tensor(in_native).to("cpu", torch.float32)[:, None]
    dst = torch.arange(out_size, dtype=torch.float32)[None, :]
    if scale is None:
        scale = in_native / out_size
    else:
        scale = torch.as_tensor(scale, dtype=torch.float32).reshape(-1, 1)
    src = (dst + 0.5) * scale - 0.5  # [b, out]
    f = torch.floor(src)
    t = src - f
    cols = torch.arange(in_pad, dtype=torch.float32)[None, None, :]
    taps = (0, 1) if mode == "linear" else (-1, 0, 1, 2)
    mat = torch.zeros(src.shape[0], out_size, in_pad, dtype=torch.float32)
    for tap in taps:
        if mode == "linear":
            w = 1.0 - t if tap == 0 else t
        else:
            w = _cubic_kernel(t - tap)
        idx = torch.minimum(torch.clamp(f + tap, min=0.0), in_native - 1.0)
        mat = mat + (cols == idx[:, :, None]).float() * w[:, :, None]
    return mat


def batched_resize_native(
    x: torch.Tensor,  # [b, c, hp, wp]
    native_hw,  # [b, 2] source extents (<= hp, wp)
    out_hw: Tuple[int, int],
    mode: str = "linear",
) -> torch.Tensor:
    """Per-sample resize of each valid [h_i, w_i] window to (H_out, W_out);
    values outside the window never contribute."""
    _, _, hp, wp = x.shape
    nhw = _as_long(native_hw)
    wh = to_device(dynamic_resize_matrix(out_hw[0], hp, nhw[:, 0], mode), x.device)
    ww = to_device(dynamic_resize_matrix(out_hw[1], wp, nhw[:, 1], mode), x.device)
    y = torch.einsum("boh,bchw->bcow", wh, x.float())
    y = torch.einsum("bow,bchw->bcho", ww, y)
    return y.to(x.dtype)


def replicate_edges(
    grid: torch.Tensor,  # [b, hp, wp, c]
    native_hw: torch.Tensor,  # [b, 2] on grid's device
) -> torch.Tensor:
    """out[b, i, j] = grid[b, min(i, h_b - 1), min(j, w_b - 1)]."""
    b, hp, wp, _ = grid.shape
    dev = grid.device
    rows = torch.minimum(torch.arange(hp, device=dev)[None, :],
                         native_hw[:, 0:1] - 1)  # [b, hp]
    cols = torch.minimum(torch.arange(wp, device=dev)[None, :],
                         native_hw[:, 1:2] - 1)  # [b, wp]
    bi = torch.arange(b, device=dev)[:, None, None]
    return grid[bi, rows[:, :, None], cols[:, None, :]]


def sine_pos_embed_dynamic(
    hp: int,
    wp: int,
    num_pos_feats: int,
    native_hw,  # [b, 2]
    temperature: float = 10000.0,
    device=None,
) -> torch.Tensor:
    """[b, hp * wp, 2 * num_pos_feats] float32: the normalised sine
    embedding with each sample's native extent as the normaliser. The
    per-row and per-column features are computed on the CPU and broadcast on
    `device`."""
    eps = 1e-6
    scale = 2 * math.pi
    nhw = _as_long(native_hw).float()
    b = nhw.shape[0]
    ys = torch.arange(1, hp + 1, dtype=torch.float32)
    xs = torch.arange(1, wp + 1, dtype=torch.float32)
    y = ys[None, :] / (nhw[:, 0:1] + eps) * scale
    x = xs[None, :] / (nhw[:, 1:2] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    def interleave(p):
        return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                           dim=-1).reshape(*p.shape[:-1], -1)

    device = torch.device("cpu" if device is None else device)
    py = to_device(interleave(y[:, :, None] / dim_t), device)  # [b, hp, npf]
    px = to_device(interleave(x[:, :, None] / dim_t), device)  # [b, wp, npf]
    pos = torch.cat([py[:, :, None, :].expand(b, hp, wp, num_pos_feats),
                     px[:, None, :, :].expand(b, hp, wp, num_pos_feats)], dim=-1)
    return pos.reshape(b, hp * wp, 2 * num_pos_feats)


def interpolate_pos_embed_batched(
    pos_embed: torch.Tensor,  # [1 + g*g, d] CLIP positional embedding
    native_hw,  # [b, 2] native token grids
    pad_hw: Tuple[int, int],
) -> torch.Tensor:
    """[b, 1 + hp * wp, d] float32 on pos_embed's device: per-sample bicubic
    interpolation of the patch embedding to each native grid (torch's
    scale_factor path: coordinate scale g / (n + 0.1)), placed top-left in
    the padded grid. Padded positions hold values that the attention mask
    excludes."""
    hp, wp = pad_hw
    cls_pe, patch_pe = pos_embed[:1], pos_embed[1:]
    hw, d = patch_pe.shape
    g = int(math.sqrt(hw))
    grid = patch_pe.reshape(g, g, d).float()
    nhw = _as_long(native_hw).float()
    b = nhw.shape[0]
    g_vec = torch.full((b,), float(g))
    wh = dynamic_resize_matrix(hp, g, g_vec, "cubic", scale=g / (nhw[:, 0] + 0.1))
    ww = dynamic_resize_matrix(wp, g, g_vec, "cubic", scale=g / (nhw[:, 1] + 0.1))
    dev = pos_embed.device
    pe = torch.einsum("bhg,gkd,bwk->bhwd", to_device(wh, dev), grid,
                      to_device(ww, dev))
    cls = cls_pe.float()[None].expand(b, 1, d)
    return torch.cat([cls, pe.reshape(b, hp * wp, d)], dim=1)


def token_valid_mask(native_hw: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """[b, hp * wp] int32 on native_hw's device: 1 where the padded token
    lies inside the sample's native grid."""
    dev = native_hw.device
    rows = torch.arange(hp, device=dev)[None, :, None]
    cols = torch.arange(wp, device=dev)[None, None, :]
    valid = (rows < native_hw[:, 0:1, None]) & (cols < native_hw[:, 1:2, None])
    return valid.reshape(native_hw.shape[0], hp * wp).to(torch.int32)
