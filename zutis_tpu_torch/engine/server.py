"""Batched dense-inference server (the port of zutis_tpu/engine/server.py,
without the mesh).

Requests are single images at the service resolution. A worker thread
drains them into fixed-size batches, padding the tail with the first
request (the padded outputs are dropped). The step runs on the device under
`torch.inference_mode()`: the ZUTIS forward, the semantic argmax map, and the
instance decode (threshold -> classify -> per-category NMS). Only the
semantic map, scores, categories, keep flags and binary masks come back to
the host, where the kept masks are RLE-encoded.

`infer(images)` is synchronous; `start()` / `submit(image)` / `stop()` is the
queued API, returning a Future per request.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from zutis_tpu_torch.core.device import resolve_device
from zutis_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from zutis_tpu_torch.ops import rle as rle_ops
from zutis_tpu_torch.ops.nms import mask_nms
from zutis_tpu_torch.postproc.instance import classify_proposals, predict_semantic


class InferenceServer:
    def __init__(
        self,
        model: torch.nn.Module,
        text_embeddings,  # [n_cat, text_dim]
        image_size: int = 384,
        batch_size: int = 16,
        threshold: float = 0.5,
        temperature: float = 5.0,
        nms_type: str = "hard",
        nms_threshold: float = 0.3,
        max_wait_ms: float = 5.0,
        uint8_transport: bool = False,
        device="cuda",
    ):
        """`model` is moved to `device`. `uint8_transport=True`: requests are
        raw [3, S, S] uint8 RGB and ImageNet normalisation runs on the
        device (4x less host-to-device traffic than f32 requests)."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.image_size = image_size
        self.batch_size = batch_size
        self.threshold = threshold
        self.temperature = temperature
        self.nms_type = nms_type
        self.nms_threshold = nms_threshold
        self.uint8_transport = uint8_transport
        self.batches = 0  # batch forwards run, padded ones included
        self._text = torch.as_tensor(
            np.asarray(text_embeddings), dtype=torch.float32, device=self.device)
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device).reshape(1, 3, 1, 1)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device).reshape(1, 3, 1, 1)
        self._max_wait = max_wait_ms / 1000.0
        self._queue: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # serialises submit() against stop(): without it a submit that passes
        # the worker check can enqueue after stop()'s drain, leaving its
        # Future unresolved forever
        self._lifecycle = threading.Lock()

    def step(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One device batch [B, 3, S, S] -> semantic [B, h, w] int32, masks
        [B, Q, h, w] bool, keep [B, Q] bool, scores [B, Q], category_ids [B, Q]."""
        with torch.inference_mode():
            if self.uint8_transport:
                images = (images.float() / 255.0 - self._mean) / self._std
            out = self.model(images, inference=True)
            tokens = out["patch_tokens"]
            semantic = predict_semantic(tokens, self._text).to(torch.int32)
            proposals = out["mask_proposals"][:, -1]
            binary = proposals > self.threshold
            confidence, category_ids = classify_proposals(
                proposals, binary, tokens, self._text, self.temperature)
            keep, scores = mask_nms(
                binary, confidence, category_ids,
                nms_threshold=self.nms_threshold, nms_type=self.nms_type)
        return {"semantic": semantic, "masks": binary, "keep": keep,
                "scores": scores, "category_ids": category_ids}

    # ---------------- synchronous API ----------------

    def infer(self, images: Sequence[np.ndarray]) -> List[Dict]:
        """images: [3, S, S] arrays (normalised f32, or uint8 with
        uint8_transport) -> one result dict each."""
        shape = (3, self.image_size, self.image_size)
        for im in images:
            if np.shape(im) != shape:
                raise ValueError(f"request of shape {np.shape(im)}, the server "
                                 f"takes {shape}")
        results: List[Dict] = []
        B = self.batch_size
        for s in range(0, len(images), B):
            chunk = list(images[s:s + B])
            n = len(chunk)
            while len(chunk) < B:
                chunk.append(chunk[0])
            batch = torch.from_numpy(np.stack(chunk)).to(self.device)
            out = {k: v.cpu().numpy() for k, v in self.step(batch).items()}
            self.batches += 1
            for j in range(n):
                results.append(self._finish(out, j))
        return results

    def _finish(self, out: Dict[str, np.ndarray], j: int) -> Dict:
        instances = []
        masks = out["masks"][j]
        for qi in np.flatnonzero(out["keep"][j]):
            m = masks[qi].astype(np.uint8)
            if m.sum() == 0:
                continue
            instances.append({
                "category_id": int(out["category_ids"][j, qi]),
                "score": float(out["scores"][j, qi]),
                "segmentation": rle_ops.encode(m),
            })
        return {"semantic": out["semantic"][j], "instances": instances}

    # ---------------- async (queued) API ----------------

    def start(self) -> None:
        if self._worker is not None:
            raise RuntimeError("server already started")
        self._stop.clear()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def stop(self) -> None:
        with self._lifecycle:
            if self._worker is None:
                return
            self._stop.set()
            self._queue.put(None)  # wake the worker
            self._worker.join()
            self._worker = None
            # cancel anything still queued so no Future is left unresolved
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[1].cancel()

    def submit(self, image: np.ndarray) -> "Future":
        with self._lifecycle:
            if self._worker is None:
                raise RuntimeError("call start() first")
            fut: Future = Future()
            self._queue.put((image, fut))
            return fut

    def _run(self) -> None:
        while not self._stop.is_set():
            item = self._queue.get()
            if item is None:
                continue
            pending = [item]
            # fill the batch within the wait budget
            while len(pending) < self.batch_size:
                try:
                    nxt = self._queue.get(timeout=self._max_wait)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                pending.append(nxt)
            try:
                results = self.infer([p[0] for p in pending])
            except Exception as exc:  # the worker must outlive a failed batch
                for _, fut in pending:
                    fut.set_exception(exc)
                continue
            for (_, fut), res in zip(pending, results):
                fut.set_result(res)
