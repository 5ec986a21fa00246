"""Per-category greedy mask NMS over a batch (the port of
zutis_tpu/ops/nms.py::mask_nms; the batch is written out where JAX vmaps).

Per category (background id 0 excluded) the highest live score is selected,
and the other candidates of its category are re-weighted by their IoU with
it: hard zeroes them beyond `nms_threshold`, linear scales by (1 - IoU)
beyond it, gaussian by exp(-IoU^2 / sigma). A candidate re-weighted to or
below `score_floor` drops out. Kept masks carry their selection-time score;
empty masks are never kept.

The pairwise IoU is a product (`pairwise_iou`), as in JAX. The Q rounds of
selection, which JAX runs as one fori_loop, run on a card as one kernel
(csrc/nms.cu, one warp an image); `nms_rounds_reference` is their plain
version, a Python loop of Q rounds. `nms_rounds` takes the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from zutis_tpu_torch.ops import _build

NMS_TYPES = ("hard", "linear", "gaussian")
SOURCE = _build.CSRC / "nms.cu"
STEM = "libzutis_nms"
MAX_Q = 1024  # 32 candidates a lane, in registers


def build():
    """Compile the kernel library if needed; see `_build.build`."""
    return _build.build(SOURCE, STEM)


def _bind(lib: ctypes.CDLL) -> None:
    lib.zutis_nms_rounds.restype = ctypes.c_int
    lib.zutis_nms_rounds.argtypes = [
        *[ctypes.c_void_p] * 6,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.zutis_nms_iou_in_smem.restype = ctypes.c_int
    lib.zutis_nms_iou_in_smem.argtypes = [ctypes.c_int]


def pairwise_iou(masks: torch.Tensor):
    """[b, Q, H, W] bool -> (iou [b, Q, Q] f32, areas [b, Q] f32).

    The intersection counts must be exact: they are summed in float64, which
    holds every count below 2^53 exactly and is never rounded to TF32 (a f32
    product on the card may be, and TF32's 10-bit mantissa rounds any count
    above 1024). The IoU arithmetic then runs in f32, as in JAX."""
    b, q = masks.shape[:2]
    m = masks.reshape(b, q, -1).to(torch.float64)
    inter = torch.bmm(m, m.transpose(1, 2)).float()
    areas = torch.diagonal(inter, dim1=1, dim2=2)
    union = areas[:, :, None] + areas[:, None, :] - inter
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-12),
                      torch.zeros_like(inter))
    return iou, areas


def _check_type(nms_type: str) -> None:
    if nms_type not in NMS_TYPES:
        raise ValueError(f"nms_type {nms_type!r} not in {NMS_TYPES}")


def nms_rounds_reference(iou, areas, scores, category_ids,
                         nms_threshold: float = 0.3, score_floor: float = 0.001,
                         sigma: float = 0.5, nms_type: str = "hard"):
    """Plain version: iou [b, Q, Q] f32, areas, scores, category_ids [b, Q]
    -> (keep [b, Q] bool, out_scores [b, Q] f32), Q rounds of the JAX
    fori_loop with the same f32 operations in the same order."""
    _check_type(nms_type)
    b, q = scores.shape
    dev = scores.device
    same_cat = category_ids[:, :, None] == category_ids[:, None, :]
    eligible = (category_ids != 0) & (areas > 0)
    rows = torch.arange(b, device=dev)
    keep = torch.zeros(b, q, dtype=torch.bool, device=dev)
    cur = scores.float().clone()
    candidate = eligible.clone()
    for _ in range(q):
        live = torch.where(candidate & eligible, cur, -float("inf"))
        i = live.argmax(dim=1)  # the first maximum, as jnp.argmax
        selected = live[rows, i] > -float("inf")  # False once none remain
        keep[rows, i] |= selected
        candidate[rows, i] &= ~selected

        iou_i = iou[rows, i]  # [b, Q]
        if nms_type == "hard":
            w = torch.where(iou_i > nms_threshold, 0.0, 1.0)
        elif nms_type == "linear":
            w = torch.where(iou_i > nms_threshold, 1.0 - iou_i, 1.0)
        else:
            w = torch.exp(-(iou_i ** 2) / sigma)
        apply_w = selected[:, None] & same_cat[rows, i] & candidate
        cur = cur * torch.where(apply_w, w, 1.0)
        # the floor applies only to candidates re-weighted this round
        candidate = candidate & (~apply_w | (cur > score_floor))
    return keep, cur


def iou_in_shared_memory(q: int) -> bool:
    """Whether the kernel holds an image's [Q, Q] IoU block in shared
    memory (else it reads each round's row from device memory); the
    source's own rule, asked of the built library."""
    return bool(_build.load(SOURCE, STEM, _bind).zutis_nms_iou_in_smem(q))


def nms_rounds(iou, areas, scores, category_ids, nms_threshold: float = 0.3,
               score_floor: float = 0.001, sigma: float = 0.5,
               nms_type: str = "hard"):
    """The selection rounds: (keep [b, Q] bool, out_scores [b, Q] f32). CPU
    tensors take `nms_rounds_reference`; CUDA tensors the kernel, counted in
    `mask_nms.launches`."""
    _check_type(nms_type)
    tensors = (iou, areas, scores, category_ids)
    if all(t.device.type == "cpu" for t in tensors):
        return nms_rounds_reference(iou, areas, scores, category_ids,
                                    nms_threshold, score_floor, sigma, nms_type)
    if iou.dim() != 3 or iou.shape[1] != iou.shape[2]:
        raise ValueError(f"iou must be [b, Q, Q], got {tuple(iou.shape)}")
    b, q = iou.shape[:2]
    for name, t in (("areas", areas), ("scores", scores),
                    ("category_ids", category_ids)):
        if tuple(t.shape) != (b, q):
            raise ValueError(f"{name} must be [{b}, {q}], got {tuple(t.shape)}")
    if iou.dtype != torch.float32 or areas.dtype != torch.float32:
        raise TypeError("the NMS kernel takes float32 iou and areas, not "
                        f"{iou.dtype} and {areas.dtype}")
    if not scores.dtype.is_floating_point:
        raise TypeError(f"scores must be floating point, not {scores.dtype}")
    if category_ids.dtype.is_floating_point or category_ids.dtype == torch.bool:
        raise TypeError(f"category_ids must be integers, not {category_ids.dtype}")
    if q > MAX_Q:
        raise ValueError(f"the NMS kernel takes at most {MAX_Q} candidates an "
                         f"image, got {q}")
    dev = iou.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("nms_rounds runs on CPU or CUDA tensors, all on one "
                         f"device, not {[str(t.device) for t in tensors]}")
    keep = torch.empty(b, q, dtype=torch.bool, device=dev)
    out = torch.empty(b, q, dtype=torch.float32, device=dev)
    if b == 0 or q == 0:
        return keep.zero_(), scores.float().clone()
    iou = iou.contiguous()
    areas = areas.contiguous()
    scores = scores.float().contiguous()
    cats = category_ids.to(torch.int64).contiguous()
    # PyTorch on the card divides a tensor by a host scalar as a product
    # with the f32 reciprocal; the kernel takes that reciprocal
    inv_sigma = float(np.float32(1.0) / np.float32(sigma))
    lib = _build.load(SOURCE, STEM, _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zutis_nms_rounds(
            iou.data_ptr(), areas.data_ptr(), scores.data_ptr(),
            cats.data_ptr(), keep.data_ptr(), out.data_ptr(), b, q,
            NMS_TYPES.index(nms_type), nms_threshold, score_floor, inv_sigma,
            stream)
    _build.check_launch(lib, err, "nms")
    mask_nms.launches += 1
    return keep, out


def mask_nms(
    masks: torch.Tensor,  # [b, Q, H, W] bool / 0-1
    scores: torch.Tensor,  # [b, Q]
    category_ids: torch.Tensor,  # [b, Q] int
    nms_threshold: float = 0.3,
    score_floor: float = 0.001,
    sigma: float = 0.5,
    nms_type: str = "hard",
):
    """-> (keep [b, Q] bool, out_scores [b, Q] f32). The kernel launch count
    is `mask_nms.launches`."""
    iou, areas = pairwise_iou(masks.bool())
    return nms_rounds(iou, areas, scores, category_ids,
                      nms_threshold=nms_threshold, score_floor=score_floor,
                      sigma=sigma, nms_type=nms_type)


mask_nms.launches = 0
