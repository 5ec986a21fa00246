"""Inference post-processing: semantic maps, instance decode and the COCO
prediction list (the port of zutis_tpu/postproc/instance.py).

  semantic: logits = text embeddings . patch tokens, optionally resized,
    argmax over categories.
  instance: the last decoder layer's proposals binarised at `threshold`;
    mask confidence = mean in-mask proposal probability; each query
    classified by its L2-normalised masked-average patch token against the
    text embeddings through sigmoid(sim * temperature); final confidence =
    mask confidence * max category probability; proposals upsampled to the
    image size and binarised again; per-category NMS.

Everything up to NMS, and the device RLE, runs on the tensors' device; the
COCO assembly (`instances_to_coco*`) runs on the host. Its strings come from
the C++ codec (`native/`) where the JAX package calls its own: the device
RLE's counts, the masks of cap overflows and packed masks; the dense
`instances_to_coco` encodes with the numpy codec, as JAX's does. Both codecs
give the same bytes.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from zutis_tpu_torch.native import (
    counts_to_strings,
    native_encode,
    native_encode_packed,
)
from zutis_tpu_torch.ops import rle as rle_ops
from zutis_tpu_torch.ops.nms import mask_nms
from zutis_tpu_torch.ops.resize import resize_2d
from zutis_tpu_torch.ops.rle_device import rle_encode_masks_device


def predict_semantic(
    patch_tokens: torch.Tensor,  # [b, h, w, text_dim]
    text_embeddings: torch.Tensor,  # [n_cat, text_dim]
    size: Optional[tuple] = None,
    return_logits: bool = False,
) -> torch.Tensor:
    """-> [b, H, W] argmax category ids (int64), or with `return_logits`
    the [b, n_cat, H, W] f32 logits; H, W = `size` (bilinear) or the token
    grid."""
    logits = torch.einsum("nc,bhwc->bnhw", text_embeddings.float(),
                          patch_tokens.float())
    if size is not None:
        logits = resize_2d(logits, size, mode="linear")
    if return_logits:
        return logits
    return logits.argmax(dim=1)


def classify_proposals(
    proposals: torch.Tensor,  # [b, Q, h, w] in [0, 1]
    binary: torch.Tensor,  # [b, Q, h, w] bool
    patch_tokens: torch.Tensor,  # [b, h, w, text_dim]
    text_embeddings: torch.Tensor,  # [n_cat, text_dim]
    temperature: float = 5.0,
):
    """Mask confidence = mean in-mask proposal probability; each query is
    classified by its L2-normalised masked-average patch token against the
    text embeddings through sigmoid(sim * temperature); final confidence =
    mask confidence * max category probability.
    -> (confidence [b, Q] f32, category_ids [b, Q] int64).

    The statistics run in float64 and are rounded to float32 once, at the
    end: f32 sums taken in another order on the card and on the CPU would
    differ in their last bits, and the scores of the COCO list with them."""
    p, m = proposals.double(), binary.double()
    sizes = m.sum(dim=(-2, -1))
    confidence = (p * m).sum(dim=(-2, -1)) / (sizes + 1e-7)
    avg_tokens = torch.einsum("bhwc,bqhw->bqc", patch_tokens.double(), m
                              ) / (sizes[..., None] + 1e-7)
    avg_tokens = avg_tokens / (
        torch.linalg.vector_norm(avg_tokens, dim=-1, keepdim=True) + 1e-7)
    cat_probs = torch.sigmoid(
        torch.einsum("nc,bqc->bqn", text_embeddings.double(), avg_tokens)
        * temperature)
    category_ids = cat_probs.argmax(dim=-1)
    confidence = confidence * cat_probs.max(dim=-1).values
    return confidence.float(), category_ids


def col_stride_bits(h: int) -> int:
    """Rows per packed column after pack_masks_fortran's padding."""
    return -(-h // 8) * 8


def pack_masks_fortran(masks: torch.Tensor) -> torch.Tensor:
    """[..., H, W] bool -> [..., W * H8 / 8] uint8: np.packbits(bitorder=
    'big') of the Fortran-order flatten, each column padded with zeros to
    H8 = ceil(H / 8) * 8 rows so that every column starts on a byte."""
    H, W = masks.shape[-2:]
    h8 = col_stride_bits(H)
    m = masks.transpose(-1, -2)  # [..., W, H]: C order == Fortran order
    if h8 != H:
        m = torch.nn.functional.pad(m, (0, h8 - H))
    bits = m.reshape(*m.shape[:-2], W * h8 // 8, 8).to(torch.int32)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=masks.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def _unpack_mask_fortran(
    packed_row: np.ndarray, col_stride_bits: int, h: int, w: int
) -> np.ndarray:
    """Host inverse of pack_masks_fortran for one mask."""
    bits = np.unpackbits(np.asarray(packed_row, np.uint8))
    cols = bits[: w * col_stride_bits].reshape(w, col_stride_bits)
    return cols[:, :h].T  # [h, w] row-major


def predict_instances_device(
    mask_proposals: torch.Tensor,  # [b, L, Q, h, w] or [b, Q, h, w], in [0, 1]
    patch_tokens: torch.Tensor,  # [b, h, w, text_dim]
    text_embeddings: torch.Tensor,  # [n_cat, text_dim]
    size: Optional[tuple] = None,  # (H, W) output size
    threshold: float = 0.5,
    temperature: float = 5.0,
    nms_type: str = "hard",
    nms_threshold: float = 0.3,
    pack: bool = False,
    rle: bool = False,
) -> Dict[str, torch.Tensor]:
    """Instance decode and NMS on the tensors' device: masks [b, Q, H, W]
    bool, scores [b, Q], category_ids [b, Q], keep [b, Q] bool. `pack` adds
    masks_packed [b, Q, nbytes] uint8 and col_stride_bits; `rle` adds the
    kept masks' device RLE under "rle" (ops/rle_device.py), whose cap
    overflows instances_to_coco_counts recovers from `masks`."""
    if mask_proposals.dim() == 5:
        mask_proposals = mask_proposals[:, -1]
    binary = mask_proposals > threshold
    confidence, category_ids = classify_proposals(
        mask_proposals, binary, patch_tokens, text_embeddings, temperature)
    binary_out = binary
    if size is not None:
        binary_out = resize_2d(mask_proposals, size, mode="linear") > threshold
    keep, scores = mask_nms(binary_out, confidence, category_ids,
                            nms_threshold=nms_threshold, nms_type=nms_type)
    out = {"masks": binary_out, "scores": scores,
           "category_ids": category_ids, "keep": keep}
    if pack:
        out["masks_packed"] = pack_masks_fortran(binary_out)
        out["col_stride_bits"] = col_stride_bits(binary_out.shape[-2])
    if rle:
        out["rle"] = rle_encode_masks_device(binary_out, keep)
    return out


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pred(cid, seg, score, image_id, hw, box, label_id_to_category,
          new_label_id_to_old_label_id) -> dict:
    label_id = (new_label_id_to_old_label_id[cid]
                if new_label_id_to_old_label_id is not None else cid)
    pred = {"category_id": label_id, "segmentation": seg,
            "score": float(score), "image_id": image_id, "image_size": hw,
            "bbox": box}
    if label_id_to_category is not None:
        pred["pred_class"] = label_id_to_category[label_id]
    return pred


def instances_to_coco_counts(
    res: Dict[str, np.ndarray],
    image_ids: List[int],
    sizes: List[tuple],  # native (H, W) per image
    label_id_to_category: Optional[Dict[int, str]] = None,
    new_label_id_to_old_label_id: Optional[Dict[int, int]] = None,
    dev_packed=None,  # [b, Q, nbytes] packed bits, for cap overflows
    col_stride_bits_packed: Optional[int] = None,
    dev_masks=None,  # [b, Q, H, W] bool masks, the other overflow source
) -> List[dict]:
    """COCO prediction dicts from device RLE counts (`res` holds scores,
    category_ids, keep and the rle_encode_masks_device outputs, on the
    host). The counts of every kept mask go to the C++ codec in one call. A
    kept mask that overflowed a device cap (more than k_cap kept, or more
    runs than max_runs) is recovered exactly from one mask of `dev_packed`
    or `dev_masks`, which may stay on the device. Same order and contents
    as instances_to_coco."""
    scores, cats, keep = (_host(res[k]) for k in ("scores", "category_ids",
                                                   "keep"))
    q_index, valid, counts, n_runs, overflow, bbox, area = (
        _host(res[k]) for k in ("q_index", "valid", "counts", "n_runs",
                                "overflow", "bbox", "area"))
    entries = []  # (bi, qi, image_id, hw, slot or None for a cap overflow)
    for bi, image_id in enumerate(image_ids):
        hw = (int(sizes[bi][0]), int(sizes[bi][1]))
        slot_of = {int(q): si for si, q in enumerate(q_index[bi])
                   if valid[bi, si]}
        for qi in np.flatnonzero(keep[bi]):
            qi = int(qi)
            si = slot_of.get(qi)
            if si is not None and not overflow[bi, si]:
                if area[bi, si] == 0:
                    continue
                entries.append((bi, qi, image_id, hw, si))
            else:
                entries.append((bi, qi, image_id, hw, None))

    slots = [(bi, si) for bi, _, _, _, si in entries if si is not None]
    strings = iter(counts_to_strings(
        np.stack([counts[bi, si] for bi, si in slots]),
        np.asarray([n_runs[bi, si] + 1 for bi, si in slots]))
        if slots else [])
    preds: List[dict] = []
    for bi, qi, image_id, hw, si in entries:
        if si is not None:
            seg = {"size": [hw[0], hw[1]], "counts": next(strings)}
            box = [float(v) for v in bbox[bi, si]]
        elif dev_packed is not None:  # a cap overflowed: one mask's bits
            (s,), boxes, areas = native_encode_packed(
                _host(dev_packed[bi, qi])[None], np.zeros(1),
                col_stride_bits_packed, np.asarray([hw[0]]),
                np.asarray([hw[1]]))
            if areas[0] == 0:
                continue
            seg = {"size": [hw[0], hw[1]], "counts": s}
            box = [float(v) for v in boxes[0]]
        else:  # a cap overflowed: one dense mask crosses to the host
            if dev_masks is None:
                raise ValueError("a device RLE cap overflowed: pass "
                                 "dev_packed or dev_masks")
            m = _host(dev_masks[bi, qi])[: hw[0], : hw[1]].astype(np.uint8)
            if m.sum() == 0:
                continue
            seg = {"size": [hw[0], hw[1]], "counts": native_encode(m)}
            box = rle_ops.to_bbox(m)
        preds.append(_pred(int(cats[bi, qi]), seg, scores[bi, qi],
                           image_id, hw, box, label_id_to_category,
                           new_label_id_to_old_label_id))
    return preds


def instances_to_coco_packed(
    device_out: Dict[str, np.ndarray],
    image_ids: List[int],
    sizes: List[tuple],  # native (H, W) per image
    label_id_to_category: Optional[Dict[int, str]] = None,
    new_label_id_to_old_label_id: Optional[Dict[int, int]] = None,
) -> List[dict]:
    """COCO prediction dicts from packed-bit masks (`masks_packed`
    [b, Q, nbytes] uint8, `col_stride_bits`): every kept mask's native
    (H, W) window encoded by the C++ codec in one call. Same contract as
    instances_to_coco."""
    packed = _host(device_out["masks_packed"])
    scores, cats, keep = (_host(device_out[k]) for k in (
        "scores", "category_ids", "keep"))
    b, q = keep.shape
    meta = [(bi, int(qi), image_id, (int(sizes[bi][0]), int(sizes[bi][1])))
            for bi, image_id in enumerate(image_ids)
            for qi in np.flatnonzero(keep[bi])]
    if not meta:
        return []
    strings, boxes, areas = native_encode_packed(
        packed.reshape(b * q, -1), np.asarray([bi * q + qi for bi, qi, _, _
                                               in meta]),
        int(device_out["col_stride_bits"]),
        np.asarray([hw[0] for *_, hw in meta]),
        np.asarray([hw[1] for *_, hw in meta]))
    preds: List[dict] = []
    for i, (bi, qi, image_id, hw) in enumerate(meta):
        if areas[i] == 0:
            continue
        preds.append(_pred(int(cats[bi, qi]),
                           {"size": [hw[0], hw[1]], "counts": strings[i]},
                           scores[bi, qi], image_id, hw,
                           [float(v) for v in boxes[i]], label_id_to_category,
                           new_label_id_to_old_label_id))
    return preds


def instances_to_coco(
    device_out: Dict[str, np.ndarray],
    image_ids: List[int],
    label_id_to_category: Optional[Dict[int, str]] = None,
    new_label_id_to_old_label_id: Optional[Dict[int, int]] = None,
) -> List[dict]:
    """COCO prediction dicts (RLE and xyxy box) from dense masks, one per
    kept non-empty mask, in image then query order."""
    masks = _host(device_out["masks"])
    scores, cats, keep = (_host(device_out[k]) for k in (
        "scores", "category_ids", "keep"))
    hw = tuple(masks.shape[-2:])
    preds: List[dict] = []
    for bi, image_id in enumerate(image_ids):
        for qi in np.flatnonzero(keep[bi]):
            m = masks[bi, qi].astype(np.uint8)
            if m.sum() == 0:
                continue
            preds.append(_pred(int(cats[bi, qi]), rle_ops.encode(m),
                               scores[bi, qi], image_id, hw, rle_ops.to_bbox(m),
                               label_id_to_category,
                               new_label_id_to_old_label_id))
    return preds
