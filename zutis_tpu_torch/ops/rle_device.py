"""Device-side COCO RLE of the kept masks (the port of
zutis_tpu/ops/rle_device.py::rle_encode_masks_device).

After NMS, on the device:
  1. compact: the <= k_cap kept masks of each image are gathered to the
     front (a stable sort of the keep flags), so that later stages and the
     host see only kept data;
  2. runs: each mask's column-major run boundaries: a shifted compare marks
     transitions, the `col_cap` smallest transition rows of each column
     (`topk`) become flat positions, and one sort over the [col_cap * W]
     candidates gives the boundary list;
  3. sidecars: the tight box and the area of each kept mask.

The host gets counts, indices and boxes, kilobytes per image, and takes
the dense fallback only for a mask that overflows a cap (`overflow`, or
`n_kept` > k_cap). Every output equals the JAX function's bit for bit: they
decide which masks take that fallback. No step reads a value back to the
host.

The JAX package also packs these outputs into one int32 blob for a single
fetch (`pack_host_blob`), because its TPU runtime charged ~30 ms per
fetch; the port fetches the arrays as they are.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def _counts(m: torch.Tensor, native_hw: torch.Tensor, col_cap: int,
            max_runs: int):
    """Masks [B, K, H, W] bool -> (counts [B, K, R + 1] int32 with R =
    min(max_runs, col_cap * W), n_trans, overflow, bbox xyxy, area), each
    mask cut to its image's (h, w) window first. counts[:n_trans + 1] is the
    COCO run-length sequence of the window's Fortran-order flatten, leading
    zero-run included."""
    B, K, H, W = m.shape
    dev = m.device
    h_i = native_hw[:, 0].to(torch.int32)[:, None, None, None]  # [B,1,1,1]
    w_i = native_hw[:, 1].to(torch.int32)[:, None, None, None]
    rows = torch.arange(H, dtype=torch.int32, device=dev)[:, None]  # [H, 1]
    cols = torch.arange(W, dtype=torch.int32, device=dev)[None, :]  # [1, W]
    inside = (rows < h_i) & (cols < w_i)  # [B, 1, H, W]
    m = m & inside

    # Fortran-order predecessor: (r - 1, c) for r > 0, (h - 1, c - 1) for
    # r = 0 and 0 before the first pixel, so runs continue across columns
    last = torch.clamp(h_i - 1, min=0).long().expand(B, K, 1, W)
    lastrow = torch.gather(m, 2, last)  # [B, K, 1, W]
    prev_row0 = torch.cat([torch.zeros_like(lastrow[..., :1]),
                           lastrow[..., :-1]], dim=-1)
    prev = torch.cat([prev_row0, m[:, :, :-1, :]], dim=2)
    trans = (m != prev) & inside
    colcnt = trans.sum(dim=2, dtype=torch.int32)  # [B, K, W]

    # the col_cap smallest transition rows of each column, ascending; H
    # marks none (as col_cap min-extractions do in the JAX function)
    key = torch.where(trans, rows, H)
    take = min(col_cap, H)
    colpos = torch.topk(key, take, dim=2, largest=False, sorted=True).values
    if take < col_cap:
        colpos = torch.cat([colpos, torch.full(
            (B, K, col_cap - take, W), H, dtype=colpos.dtype, device=dev)], 2)
    n = (h_i * w_i)[..., 0]  # [B, 1, 1]
    pos = torch.where(colpos < H, cols * h_i + colpos, n[..., None])
    pos = torch.sort(pos.reshape(B, K, -1), dim=-1).values[..., :max_runs]
    zero = torch.zeros(B, K, 1, dtype=torch.int32, device=dev)
    boundaries = torch.cat([zero, pos.to(torch.int32),
                            n.expand(B, K, 1).to(torch.int32)], dim=-1)
    counts = torch.diff(boundaries, dim=-1)
    n_trans = colcnt.sum(dim=-1, dtype=torch.int32)
    overflow = (n_trans > max_runs) | (colcnt > col_cap).any(dim=-1)

    col_any = m.any(dim=2)  # [B, K, W]
    row_any = m.any(dim=3)  # [B, K, H]
    area = m.sum(dim=(2, 3), dtype=torch.int32)
    big = 1 << 30
    xmin = torch.where(col_any, cols, big).amin(dim=-1)
    xmax = torch.where(col_any, cols, -1).amax(dim=-1)
    ymin = torch.where(row_any, rows[:, 0], big).amin(dim=-1)
    ymax = torch.where(row_any, rows[:, 0], -1).amax(dim=-1)
    bbox = torch.stack([xmin, ymin, xmax, ymax], dim=-1).to(torch.int32)
    bbox = torch.where(area[..., None] > 0, bbox, 0)
    return counts, n_trans, overflow, bbox, area


def rle_encode_masks_device(
    masks: torch.Tensor,  # [B, Q, H, W] bool, zero outside native windows
    keep: torch.Tensor,  # [B, Q] bool (NMS output)
    native_hw: Optional[torch.Tensor] = None,  # [B, 2] on masks' device
    k_cap: int = 16,
    col_cap: int = 8,
    max_runs: int = 2048,
) -> Dict[str, torch.Tensor]:
    """Compact the kept masks and extract their RLE counts on the device.
    Returns, with K = min(k_cap, Q):
      q_index [B, K] int32  query of each compacted slot (kept first)
      valid   [B, K] bool   the slot holds a kept mask
      n_kept  [B] int32     kept in all (> k_cap: the host falls back)
      counts  [B, K, R + 1] int32, n_runs [B, K] int32
      overflow[B, K] bool   a cap overflowed: the host falls back
      bbox    [B, K, 4] int32 xyxy, area [B, K] int32
    """
    B, Q, H, W = masks.shape
    if native_hw is None:
        native_hw = torch.tensor([[H, W]], device=masks.device).expand(B, 2)
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    q_index = order[:, :k_cap]
    valid = torch.gather(keep, 1, q_index)
    n_kept = keep.sum(dim=1, dtype=torch.int32)
    index = q_index[:, :, None, None].expand(-1, -1, H, W)
    sel = torch.gather(masks.bool(), 1, index)  # [B, K, H, W]
    counts, n_runs, overflow, bbox, area = _counts(sel, native_hw, col_cap,
                                                   max_runs)
    return {
        "q_index": q_index.to(torch.int32),
        "valid": valid,
        "n_kept": n_kept,
        "counts": counts,
        "n_runs": n_runs,
        "overflow": overflow,
        "bbox": bbox,
        "area": area,
    }
