"""Bucketed batched evaluation at variable resolution (the port of
zutis_tpu/engine/batched_eval.py, and of the batched loop of
zutis_tpu/cli/coco20k_eval.py as `evaluate_instances`).

Images are padded bottom/right into a few bucket shapes (multiples of
`quantum` pixels), run through `ZUTIS.forward_padded` in batches, and
decoded with per-sample geometry (ops/dynamic_shapes.py), so that each
sample's valid window equals the per-image program's output:
  - semantic: text logits at the token grid, resized to the bucket's pixel
    extent with each sample's native scale (feature extent / pixel extent),
    argmax; rows and columns past the native size are meaningless;
  - instance: proposal statistics over the valid token window; proposals
    upsampled with the same per-sample geometry; masks zeroed outside the
    native pixel window, so that NMS sees the native program's masks.

The per-sample upsample is a two-tap gather per axis with the weights of
the JAX package's resize matrices (bilinear rows have at most two non-zero
taps): elementwise products and one sum, which round alike on the card and
the CPU, where a matrix product would sum in an order of its own.

`pipelined` keeps `depth` batches in flight. On a card, `fetch_to_host`
copies a step's outputs on a side stream into pinned memory once the step's
kernels are done, and `SideStreamView` reads the masks of cap overflows the
same way, so that the host assembles batch N while the card runs batch
N + 1: a `.cpu()` on the compute stream would queue behind N + 1's kernels
instead. Inputs go up without blocking (`core.device.to_device`).
"""
from __future__ import annotations

import math
from collections import deque
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from zutis_tpu_torch.core.device import resolve_device, to_device
from zutis_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from zutis_tpu_torch.engine.metrics import confusion_update
from zutis_tpu_torch.ops.dynamic_shapes import dynamic_resize_matrix
from zutis_tpu_torch.ops.nms import mask_nms
from zutis_tpu_torch.ops.rle_device import rle_encode_masks_device
from zutis_tpu_torch.postproc.instance import (
    classify_proposals,
    instances_to_coco_counts,
)

SEMANTIC_MODES = ("map", "confusion", "none")
# what the host reads of an instance step on the counts path
HOST_KEYS = ("scores", "category_ids", "keep")


def pipelined(dispatch, collect, work, depth: int = 2):
    """Yield collect(dispatch(item), item) for each item of `work`, in
    order, with up to `depth` dispatches in flight: item N + 1 is dispatched
    before item N is collected. depth 1 is the synchronous loop."""
    q: deque = deque()
    for item in work:
        q.append((dispatch(item), item))
        if len(q) >= max(1, depth):
            handles, it = q.popleft()
            yield collect(handles, it)
    while q:
        handles, it = q.popleft()
        yield collect(handles, it)


def bucket_shape(h: int, w: int, quantum: int = 128,
                 min_size: int = 128) -> Tuple[int, int]:
    """A native pixel shape rounded up to its bucket shape."""
    bh = max(min_size, int(math.ceil(h / quantum)) * quantum)
    bw = max(min_size, int(math.ceil(w / quantum)) * quantum)
    return bh, bw


def group_into_buckets(sizes: Sequence[Tuple[int, int]], quantum: int = 128
                       ) -> Dict[Tuple[int, int], List[int]]:
    """{bucket shape: [indices]}, each bucket in input order."""
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i, (h, w) in enumerate(sizes):
        buckets.setdefault(bucket_shape(h, w, quantum), []).append(i)
    return buckets


def iter_bucketed_batches(buckets: Dict[Tuple[int, int], List[int]],
                          batch_size: int
                          ) -> Iterator[Tuple[Tuple[int, int], List[int]]]:
    for shape, idxs in buckets.items():
        for s in range(0, len(idxs), batch_size):
            yield shape, idxs[s:s + batch_size]


def pad_batch(images: List[np.ndarray], shape: Tuple[int, int],
              batch_size: int, patch_size: int, dtype=np.float32):
    """-> (padded [B, 3, Hb, Wb], native_grid [B, 2], native_pixels
    [B, 2]) as numpy. A short batch is filled with copies of its first image
    (dropped after). dtype=np.uint8 pairs with make_instance_step(
    uint8_input=True): raw RGB crosses to the device, which normalises."""
    Hb, Wb = shape
    out = np.zeros((batch_size, 3, Hb, Wb), dtype)
    native_grid = np.ones((batch_size, 2), np.int32)
    native_pixels = np.ones((batch_size, 2), np.int32)
    for i in range(batch_size):
        img = images[i] if i < len(images) else images[0]
        _, h, w = img.shape
        out[i, :, :h, :w] = img
        native_grid[i] = (h // patch_size, w // patch_size)
        native_pixels[i] = (h, w)
    return out, native_grid, native_pixels


def pixel_valid_mask(native_pixels: torch.Tensor, Hb: int, Wb: int
                     ) -> torch.Tensor:
    """[B, Hb, Wb] bool on native_pixels' device: inside each native size."""
    dev = native_pixels.device
    rows = torch.arange(Hb, device=dev)[None, :, None] < native_pixels[:, 0:1, None]
    cols = torch.arange(Wb, device=dev)[None, None, :] < native_pixels[:, 1:2, None]
    return rows & cols


def _native_resize_mats(feat_pad: Tuple[int, int], native_feat, native_pixels,
                        out_hw: Tuple[int, int]):
    """Per-sample bilinear matrices [B, H, hp] and [B, W, wp] (host, f32)
    from each native feature window to the bucket's pixel extent at the
    native scale (f32(feature extent) / f32(pixel extent)), so that rows
    inside each native pixel window equal the per-image resize."""
    nf = torch.as_tensor(native_feat).to("cpu", torch.int64)
    npx = torch.as_tensor(native_pixels).to("cpu", torch.int64)
    return tuple(
        dynamic_resize_matrix(out_hw[a], feat_pad[a], nf[:, a], "linear",
                              scale=nf[:, a].float() / npx[:, a].float())
        for a in (0, 1))


def _taps(mat: torch.Tensor, device) -> Tuple[torch.Tensor, ...]:
    """A bilinear matrix [B, out, in] -> its two taps per row: (first
    column, its weight, second column, its weight) on `device`, the second
    weight 0 where both taps clamp to one column (the matrix holds their
    sum there)."""
    nz = mat != 0
    first = nz.float().argmax(dim=-1)  # the first non-zero column
    n_in = mat.shape[-1]
    second = torch.clamp(first + 1, max=n_in - 1)
    w0 = torch.gather(mat, -1, first[..., None])[..., 0]
    w1 = torch.gather(mat, -1, second[..., None])[..., 0]
    w1 = torch.where(second == first, 0.0, w1)
    return tuple(to_device(t, device) for t in (first, w0, second, w1))


def resize_per_sample(x: torch.Tensor, taps_h, taps_w) -> torch.Tensor:
    """x [B, C, h, w] f32 -> [B, C, H, W] with each sample's own two-tap
    rows (`_taps` of its matrices), axis h then axis w."""
    def axis(y, taps, dim):
        i0, w0, i1, w1 = taps
        shape = [y.shape[0]] + [1] * (y.dim() - 1)
        shape[dim] = -1
        idx0, idx1 = i0.reshape(shape), i1.reshape(shape)
        out = torch.take_along_dim(y, idx0, dim=dim)
        out.mul_(w0.reshape(shape))
        out.add_(torch.take_along_dim(y, idx1, dim=dim).mul_(w1.reshape(shape)))
        return out
    return axis(axis(x.float(), taps_h, 2), taps_w, 3)


def decode_instances(
    out: Dict[str, torch.Tensor],  # forward_padded outputs
    text_embeddings: torch.Tensor,
    native_pixels,  # [B, 2] on the host
    out_hw: Tuple[int, int],
    threshold: float = 0.5,
    temperature: float = 5.0,
    nms_type: str = "hard",
    nms_threshold: float = 0.3,
) -> Dict[str, torch.Tensor]:
    """The instance step's decode on the forward's device: masks
    [B, Q, Hb, Wb] bool (zero outside each native window), scores,
    category_ids, keep [B, Q] and the device RLE under "rle"."""
    proposals = out["mask_proposals"][:, -1]  # [B, Q, h, w]
    dev = proposals.device
    valid = out["valid"]
    tokens = out["patch_tokens"]
    binary = (proposals > threshold) & (valid[:, None] > 0)
    confidence, category_ids = classify_proposals(
        proposals, binary, tokens, text_embeddings.to(dev), temperature)
    wh, ww = _native_resize_mats(proposals.shape[-2:], out["native_grid"],
                                 native_pixels, out_hw)
    up = resize_per_sample(proposals, _taps(wh, dev), _taps(ww, dev))
    pix = to_device(torch.as_tensor(native_pixels).to(torch.int64), dev)
    masks = (up > threshold) & pixel_valid_mask(pix, *out_hw)[:, None]
    del up
    keep, scores = mask_nms(masks, confidence, category_ids,
                            nms_threshold=nms_threshold, nms_type=nms_type)
    return {"masks": masks, "scores": scores, "category_ids": category_ids,
            "keep": keep, "rle": rle_encode_masks_device(masks, keep, pix)}


def _semantic_argmax(out, text_embeddings, native_pixels, out_hw):
    tokens = out["patch_tokens"]
    logits = torch.einsum("nc,bhwc->bnhw", text_embeddings.to(tokens.device),
                          tokens)
    wh, ww = _native_resize_mats(logits.shape[-2:], out["native_grid"],
                                 native_pixels, out_hw)
    up = torch.einsum("boh,bchw->bcow", to_device(wh, tokens.device), logits)
    up = torch.einsum("bow,bchw->bcho", to_device(ww, tokens.device), up)
    return up.argmax(dim=1).to(torch.int32)


def _normalise_u8(images: torch.Tensor) -> torch.Tensor:
    mean, std = (to_device(torch.from_numpy(c), images.device)[None, :, None, None]
                 for c in (IMAGENET_MEAN, IMAGENET_STD))
    return (images.float() / 255.0 - mean) / std


def _inputs(images, device):
    return to_device(torch.as_tensor(images), device)


def _prepare(model, text_embeddings, device):
    """The device after checking it holds the model, and the text
    embeddings moved there once."""
    device = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != device.type:
        raise ValueError(f"the model lies on {param.device}, not on {device}")
    text = torch.as_tensor(np.asarray(text_embeddings), dtype=torch.float32)
    return device, to_device(text, device)


def make_semantic_step(model, text_embeddings, out_hw: Tuple[int, int],
                       device="cuda"):
    """-> step(images, native_grid, native_pixels): the semantic argmax
    [B, Hb, Wb] int32 on the device (each native window meaningful).
    Inputs are host arrays or tensors; `device` must be the model's."""
    device, text = _prepare(model, text_embeddings, device)

    def step(images, native_grid, native_pixels):
        with torch.inference_mode():
            out = model.forward_padded(_inputs(images, device), native_grid)
            return _semantic_argmax(out, text, native_pixels, out_hw)

    return step


def make_semantic_confusion_step(model, text_embeddings,
                                 out_hw: Tuple[int, int], n_classes: int,
                                 device="cuda"):
    """-> step(images, native_grid, native_pixels, gt): the [n_classes,
    n_classes] confusion histogram of the semantic argmax against gt
    [B, Hb, Wb] (-1 outside each sample's target window and in filler
    slots), on the device, so that the dense map never reaches the host."""
    device, text = _prepare(model, text_embeddings, device)

    def step(images, native_grid, native_pixels, gt):
        with torch.inference_mode():
            out = model.forward_padded(_inputs(images, device), native_grid)
            sem = _semantic_argmax(out, text, native_pixels, out_hw)
            return confusion_update(_inputs(gt, device), sem, n_classes)

    return step


def make_instance_step(
    model, text_embeddings, out_hw: Tuple[int, int],
    threshold: float = 0.5, temperature: float = 5.0,
    nms_type: str = "hard", nms_threshold: float = 0.3,
    uint8_input: bool = False,
    semantic_mode: str = "map",  # "map" | "confusion" | "none"
    n_classes: int = 0,  # required for semantic_mode="confusion"
    device="cuda",
):
    """-> step(images, native_grid, native_pixels, gt=None): forward_padded
    plus the instance decode (decode_instances) on `device` (the model's).
    semantic_mode="map" adds the semantic argmax under "semantic";
    "confusion" takes gt [B, Hb, Wb] (-1 outside each target window) and
    adds the [n_classes, n_classes] histogram under "confusion"; "none"
    skips the semantic decode. Outputs stay on the device; `fetch_to_host`
    brings back what the COCO assembly reads. uint8_input=True takes raw
    [B, 3, Hb, Wb] uint8 RGB and normalises on the device (a quarter of the
    f32 transfer). Raises on a host without a card unless device="cpu"."""
    if semantic_mode not in SEMANTIC_MODES:
        raise ValueError(f"semantic_mode {semantic_mode!r} not in {SEMANTIC_MODES}")
    if semantic_mode == "confusion" and n_classes <= 0:
        raise ValueError('semantic_mode="confusion" needs n_classes')
    device, text = _prepare(model, text_embeddings, device)

    def step(images, native_grid, native_pixels, gt=None):
        with torch.inference_mode():
            x = _inputs(images, device)
            if uint8_input:
                x = _normalise_u8(x)
            out = model.forward_padded(x, native_grid)
            res = decode_instances(out, text, native_pixels, out_hw,
                                   threshold, temperature, nms_type,
                                   nms_threshold)
            if semantic_mode != "none":
                sem = _semantic_argmax(out, text, native_pixels, out_hw)
                if semantic_mode == "confusion":
                    res["confusion"] = confusion_update(
                        _inputs(gt, device), sem, n_classes)
                else:
                    res["semantic"] = sem
        return res

    return step


class HostFetch:
    """A step's small outputs on their way to the host. On a card the
    copies run on `stream` (the current stream if None), after an event
    recorded behind the step's kernels, into pinned buffers; `result()`
    waits for those copies only. On the CPU the arrays are read at once."""

    def __init__(self, tensors: Dict[str, torch.Tensor], stream=None):
        first = next(iter(tensors.values()))
        self._done = None
        if first.device.type != "cuda":
            self._host = {k: v.numpy() for k, v in tensors.items()}
            return
        if stream is None:
            stream = torch.cuda.current_stream(first.device)
        ready = torch.cuda.Event()
        ready.record()
        self._host = {}
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            for k, v in tensors.items():
                buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v, non_blocking=True)
                v.record_stream(stream)  # kept until the copy is done
                self._host[k] = buf
            self._done = torch.cuda.Event()
            self._done.record(stream)

    def result(self) -> Dict[str, np.ndarray]:
        if self._done is not None:
            self._done.synchronize()
        return {k: (v.numpy() if torch.is_tensor(v) else v)
                for k, v in self._host.items()}


class SideStreamView:
    """Index a step's device tensor and read the slice on the host through
    `stream`: the cap-overflow fallback reads single masks while the next
    batch's kernels hold the compute stream, where a `.cpu()` would wait for
    them. Reads after a HostFetch of the same step has completed on
    `stream`, so the step's kernels are done."""

    def __init__(self, tensor: torch.Tensor, stream=None):
        self.tensor, self.stream = tensor, stream

    def __getitem__(self, index) -> np.ndarray:
        view = self.tensor[index]
        if self.stream is None:
            return view.cpu().numpy()
        with torch.cuda.stream(self.stream):
            buf = torch.empty(view.shape, dtype=view.dtype, pin_memory=True)
            buf.copy_(view, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return buf.numpy()


def fetch_to_host(res: Dict[str, torch.Tensor], stream=None) -> HostFetch:
    """Start copying what instances_to_coco_counts reads of an instance
    step (scores, category ids, keep flags and the device RLE) to the host;
    `stream` is the side stream on a card."""
    small = {k: res[k] for k in HOST_KEYS}
    small.update(res["rle"])
    return HostFetch(small, stream)


def evaluate_instances(
    model,
    text_embeddings,  # [n_cat, text_dim]
    images: Sequence[np.ndarray],  # each [3, H_i, W_i] uint8 RGB
    image_ids: Sequence[int],
    label_map=None,  # model category id -> dataset category id, e.g.
    # data.label_maps.new_label_id_to_old_label_id for COCO
    batch_images: int = 16,
    depth: int = 2,
    threshold: float = 0.5,
    nms_type: str = "hard",
    device="cuda",
    on_image=None,
) -> List[dict]:
    """The COCO prediction list of `images`: the batched loop of the
    COCO-20k evaluation (zutis_tpu/cli/coco20k_eval.py). Images are grouped
    by bucket in arrival order; a bucket's batch runs once it holds
    `batch_images` images, and the partial batches run at the end. Each
    batch is padded (uint8), runs the instance step without the semantic
    decode, and its device RLE is assembled into COCO dicts on the host,
    `depth` batches in flight. `on_image(image_id, image, result, masks,
    slot)` is called for each image as its batch is collected, with the
    batch's fetched host arrays (`result`) and its device masks (`masks`, a
    SideStreamView) at the image's `slot` (the JAX CLI draws its overlays
    there). `model` must already be on `device`; raises on a host without a
    card unless device="cpu"."""
    device = resolve_device(device)
    steps: Dict[Tuple[int, int], object] = {}
    pending: Dict[Tuple[int, int], list] = {}
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def batches():
        for image_id, img in zip(image_ids, images):
            shape = bucket_shape(*img.shape[-2:])
            pending.setdefault(shape, []).append((image_id, img))
            if len(pending[shape]) == batch_images:
                yield shape, pending.pop(shape)
        for shape, items in pending.items():
            yield shape, items

    def dispatch(batch):
        shape, items = batch
        padded, native_grid, native_pixels = pad_batch(
            [img for _, img in items], shape, batch_images,
            model.encoder.patch_size, dtype=np.uint8)
        if shape not in steps:
            steps[shape] = make_instance_step(
                model, text_embeddings, shape, threshold=threshold,
                nms_type=nms_type, uint8_input=True, semantic_mode="none",
                device=device)
        res = steps[shape](padded, native_grid, native_pixels)
        return res, fetch_to_host(res, stream)

    def collect(handles, batch):
        res, fetch = handles
        _, items = batch
        host, masks = fetch.result(), SideStreamView(res["masks"], stream)
        if on_image is not None:
            for slot, (image_id, img) in enumerate(items):
                on_image(image_id, img, host, masks, slot)
        return instances_to_coco_counts(
            host, image_ids=[iid for iid, _ in items],
            sizes=[tuple(img.shape[-2:]) for _, img in items],
            new_label_id_to_old_label_id=label_map, dev_masks=masks)

    predictions: List[dict] = []
    for preds in pipelined(dispatch, collect, batches(), depth=depth):
        predictions.extend(preds)
    return predictions
