"""Per-category greedy mask NMS over a batch (the port of
zutis_tpu/ops/nms.py::mask_nms; the batch is written out where JAX vmaps).

Per category (background id 0 excluded) the highest live score is selected,
and the other candidates of its category are re-weighted by their IoU with
it: hard zeroes them beyond `nms_threshold`, linear scales by (1 - IoU)
beyond it, gaussian by exp(-IoU^2 / sigma). A candidate re-weighted to or
below `score_floor` drops out. Kept masks carry their selection-time score;
empty masks are never kept.

The pairwise IoU (`pairwise_iou`) counts the intersections exactly, as the
JAX package's int8 product into int32 does: on a card by one kernel
(csrc/mask_iou.cu, s8 x s8 -> s32 on wgmma over the masks' bytes), whose
plain version `pairwise_iou_reference` sums the counts in a float64 bmm.
The Q rounds of selection, which JAX runs as one fori_loop, run on a card
as one kernel (csrc/nms.cu, one warp an image); `nms_rounds_reference` is
their plain version, a Python loop of Q rounds. `pairwise_iou` and
`nms_rounds` take the plain versions only for CPU tensors; for CUDA
tensors they launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from zutis_tpu_torch.ops import _build

NMS_TYPES = ("hard", "linear", "gaussian")
SOURCE = _build.CSRC / "nms.cu"
STEM = "libzutis_nms"
IOU_SOURCE = _build.CSRC / "mask_iou.cu"
IOU_STEM = "libzutis_mask_iou"
MAX_Q = 1024  # 32 candidates a lane, in registers; the IoU kernel's too
MAX_PIXELS = 2**31 - 1  # the int32 counts are exact up to here


def build():
    """Compile the rounds' kernel library if needed; see `_build.build`."""
    return _build.build(SOURCE, STEM)


def build_iou():
    """Compile the IoU kernel library if needed; see `_build.build`."""
    return _build.build(IOU_SOURCE, IOU_STEM)


def _bind(lib: ctypes.CDLL) -> None:
    lib.zutis_nms_rounds.restype = ctypes.c_int
    lib.zutis_nms_rounds.argtypes = [
        *[ctypes.c_void_p] * 6,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.zutis_nms_iou_in_smem.restype = ctypes.c_int
    lib.zutis_nms_iou_in_smem.argtypes = [ctypes.c_int]


def _bind_iou(lib: ctypes.CDLL) -> None:
    lib.zutis_mask_iou.restype = ctypes.c_int
    lib.zutis_mask_iou.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        *[ctypes.c_void_p] * 4,
    ]


def intersection_counts_reference(masks: torch.Tensor) -> torch.Tensor:
    """[b, Q, H, W] 0 / 1 -> the intersection counts [b, Q, Q] float64, exact
    (a float64 bmm: every count below 2^53 is held exactly)."""
    b, q = masks.shape[:2]
    m = masks.reshape(b, q, -1).to(torch.float64)
    return torch.bmm(m, m.transpose(1, 2))


def pairwise_iou_reference(masks: torch.Tensor):
    """Plain version: [b, Q, H, W] 0 / 1 -> (iou [b, Q, Q] f32, areas [b, Q]
    f32).

    The intersection counts must be exact: they are summed in float64, which
    holds every count below 2^53 exactly and is never rounded to TF32 (a f32
    product on the card may be, and TF32's 10-bit mantissa rounds any count
    above 1024); converted to f32 they are JAX's int32 counts converted. The
    IoU arithmetic then runs in f32, as in JAX."""
    inter = intersection_counts_reference(masks).float()
    areas = torch.diagonal(inter, dim1=1, dim2=2)
    union = areas[:, :, None] + areas[:, None, :] - inter
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-12),
                      torch.zeros_like(inter))
    return iou, areas


def pairwise_iou_kernel(masks: torch.Tensor):
    """The IoU kernel on [b, Q, H, W] (or [b, Q, K]) bool CUDA masks,
    contiguous, Q <= 1024, at most 2^31 - 1 pixels a mask: (iou [b, Q, Q]
    f32, areas [b, Q] f32, the intersection counts [b, Q, Q] int32). It
    reads the masks in place as bytes; each call counts one in
    `pairwise_iou.launches` (a call is three launches: the fill that zeroes
    the counts, the counting kernel and its IoU pass). Raises on anything
    else, before any launch."""
    if masks.dim() < 2:
        raise ValueError(f"masks must be [b, Q, ...], got {tuple(masks.shape)}")
    if masks.dtype != torch.bool:
        raise TypeError(f"the IoU kernel takes bool masks, not {masks.dtype}")
    if not masks.is_contiguous():
        raise ValueError("the IoU kernel reads the masks in place: they must "
                         "be contiguous")
    b, q = masks.shape[:2]
    k = math.prod(masks.shape[2:])
    if q > MAX_Q:
        raise ValueError(f"the IoU kernel takes at most {MAX_Q} masks an "
                         f"image, got {q}")
    if k > MAX_PIXELS:
        raise ValueError(f"the IoU kernel counts at most {MAX_PIXELS} pixels "
                         f"a mask exactly, got {k}")
    dev = masks.device
    if dev.type != "cuda":
        raise ValueError(f"the IoU kernel runs on CUDA tensors, not {dev}")
    # the kernel sums into the counts: zeroed by a fill
    counts = torch.zeros(b, q, q, dtype=torch.int32, device=dev)
    iou = torch.empty(b, q, q, dtype=torch.float32, device=dev)
    areas = torch.empty(b, q, dtype=torch.float32, device=dev)
    if b == 0 or q == 0 or k == 0:  # nothing to count: no launch
        return iou.zero_(), areas.zero_(), counts
    lib = _build.load(IOU_SOURCE, IOU_STEM, _bind_iou)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zutis_mask_iou(masks.data_ptr(), b, q, k, counts.data_ptr(),
                                 iou.data_ptr(), areas.data_ptr(), stream)
    _build.check_launch(lib, err, "mask IoU")
    pairwise_iou.launches += 1
    return iou, areas, counts


def pairwise_iou(masks: torch.Tensor):
    """[b, Q, H, W] bool -> (iou [b, Q, Q] f32, areas [b, Q] f32): CPU
    tensors take `pairwise_iou_reference`; CUDA tensors the kernel
    (`pairwise_iou_kernel`), counted in `pairwise_iou.launches`."""
    if masks.device.type == "cpu":
        return pairwise_iou_reference(masks)
    iou, areas, _ = pairwise_iou_kernel(masks)
    return iou, areas


pairwise_iou.launches = 0


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
    """-> (keep [b, Q] bool, out_scores [b, Q] f32). On a card a call
    launches the IoU kernel (`pairwise_iou.launches`) and the rounds'
    (`mask_nms.launches`) once each."""
    _check_type(nms_type)
    devices = [str(t.device) for t in (masks, scores, category_ids)]
    if len(set(devices)) > 1:
        raise ValueError(f"mask_nms runs on tensors all on one device, not "
                         f"{devices}")
    # bool, contiguous masks (the paths' own) are read in place
    iou, areas = pairwise_iou(masks.bool().contiguous())
    return nms_rounds(iou, areas, scores, category_ids,
                      nms_threshold=nms_threshold, score_floor=score_floor,
                      sigma=sigma, nms_type=nms_type)


mask_nms.launches = 0
