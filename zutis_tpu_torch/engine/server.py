"""Batched dense-inference server (the port of zutis_tpu/engine/server.py).

Requests are single images at the service resolution. A worker thread
drains them into fixed-size batches, padding the tail with the first
request (the padded outputs are dropped). The step runs on the device under
`torch.inference_mode()`: the ZUTIS forward, the semantic argmax map, and the
instance decode (threshold -> classify -> per-category NMS). Only the
semantic map, scores, categories, keep flags and binary masks come back to
the host, where the kept masks are RLE-encoded (the C++ codec), or, with
`encode_rle=False`, returned as boolean [h, w] arrays.

`infer(images)` is synchronous; `start()` / `submit(image)` / `stop()` is the
queued API, returning a Future per request. A request whose Future the
client cancels while it is queued is dropped from its batch; a batch whose
every request was cancelled runs no step. (The JAX server instead hands the
batch-mates of a cancelled request an `InvalidStateError`.)

With `mesh=` (parallel/mesh.py) the server runs on every rank of the mesh,
each stepping its data rank's slice of the padded batch (the batch size
must divide by the data axis; the model is whole or sharded over the model
axis alike on the ranks of a data index); the outputs are gathered over
the data group, so every rank returns what the one-device server returns.
`infer` is called on every rank with the same requests. Of the queued API,
the mesh's first rank owns the queue and the worker: each batch it forms
goes to the other ranks by broadcast, behind a header with its count and
a stop flag; their `start()` runs a follower thread that steps what
arrives, and `stop()` on the first rank broadcasts the stop (every rank
calls `start()` and `stop()`; only the first takes `submit`).

Spans (core/profiling.py): `server.queue`, one a request, from `submit`
(with the `rid` the server numbers it by) to when the worker takes it into
a batch (with that batch's `bid`), or to its drop, marked `cancelled`;
`server.batch`, one a chunk of `infer` (with its `bid`), from the chunk's
stack to its last result, around `server.upload` (the stack and the copy
to the device) and `server.finish` (the read-back, which waits for the
step, and the host finish).
"""
from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from zutis_tpu_torch.core import profiling
from zutis_tpu_torch.core.device import resolve_device
from zutis_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from zutis_tpu_torch.native import native_encode
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
        encode_rle: bool = True,
        uint8_transport: bool = False,
        device="cuda",
        mesh=None,
    ):
        """`model` is moved to `device` (to the rank's device on a `mesh`).
        `encode_rle=False`: each instance carries its boolean [h, w]
        `"mask"` instead of an RLE `"segmentation"`. `uint8_transport=True`:
        requests are raw [3, S, S] uint8 RGB and ImageNet normalisation runs
        on the device (4x less host-to-device traffic than f32 requests)."""
        if mesh is not None and batch_size % mesh.data_size:
            raise ValueError(f"batch_size {batch_size} must divide by the "
                             f"data axis ({mesh.data_size})")
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.model = model.to(self.device)
        self.image_size = image_size
        self.batch_size = batch_size
        self.threshold = threshold
        self.temperature = temperature
        self.nms_type = nms_type
        self.nms_threshold = nms_threshold
        self.encode_rle = encode_rle
        self.uint8_transport = uint8_transport
        self.batches = 0  # batch forwards run, padded ones included
        self._rids = itertools.count()  # request ids, for the spans
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
            # a batch's id is its number among the batch forwards
            with profiling.span("server.batch", bid=self.batches):
                with profiling.span("server.upload"):
                    chunk = list(images[s:s + B])
                    n = len(chunk)
                    while len(chunk) < B:
                        chunk.append(chunk[0])
                    batch = torch.from_numpy(np.stack(chunk)).to(self.device)
                if self.mesh is None:
                    out = self.step(batch)
                else:
                    out = self._gather(self.step(
                        batch.chunk(self.mesh.data_size)[self.mesh.data_rank]))
                with profiling.span("server.finish"):
                    out = {k: v.cpu().numpy() for k, v in out.items()}
                    self.batches += 1
                    for j in range(n):
                        results.append(self._finish(out, j))
        return results

    def _gather(self, out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The data ranks' step outputs, concatenated in rank order."""
        full = {}
        for k, v in out.items():
            v = v.contiguous()
            wire = v.to(torch.uint8) if v.dtype == torch.bool else v
            parts = [torch.empty_like(wire) for _ in range(self.mesh.data_size)]
            dist.all_gather(parts, wire, group=self.mesh.data_group)
            full[k] = torch.cat(parts).to(v.dtype)
        return full

    def _finish(self, out: Dict[str, np.ndarray], j: int) -> Dict:
        instances = []
        masks = out["masks"][j]
        for qi in np.flatnonzero(out["keep"][j]):
            m = masks[qi].astype(np.uint8)
            if m.sum() == 0:
                continue
            inst = {"category_id": int(out["category_ids"][j, qi]),
                    "score": float(out["scores"][j, qi])}
            if self.encode_rle:
                inst["segmentation"] = {"size": list(m.shape),
                                        "counts": native_encode(m)}
            else:
                inst["mask"] = m.astype(bool)
            instances.append(inst)
        return {"semantic": out["semantic"][j], "instances": instances}

    # ---------------- async (queued) API ----------------

    def _leads(self) -> bool:
        """Whether this rank owns the queue (always, without a mesh)."""
        return self.mesh is None or self.mesh.is_writer

    def start(self) -> None:
        if self._worker is not None:
            raise RuntimeError("server already started")
        self._stop.clear()
        self._worker = threading.Thread(
            target=self._run if self._leads() else self._follow, daemon=True)
        self._worker.start()

    def stop(self) -> None:
        with self._lifecycle:
            if self._worker is None:
                return
            if self._leads():
                self._stop.set()
                self._queue.put(None)  # wake the worker
                self._worker.join()
                if self.mesh is not None:
                    self._broadcast_header(0, stop=True)
            else:
                self._worker.join()  # the first rank's stop ends it
            self._worker = None
            # cancel anything still queued so no Future is left unresolved
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    item[1].cancel()
                    profiling.close_span(item[2], cancelled=True)

    def submit(self, image: np.ndarray) -> "Future":
        with self._lifecycle:
            if self._worker is None:
                raise RuntimeError("call start() first")
            if not self._leads():
                raise RuntimeError("on a mesh the first rank takes the "
                                   "requests")
            fut: Future = Future()
            self._queue.put((image, fut, profiling.open_span(
                "server.queue", rid=next(self._rids))))
            return fut

    # ---------------- the mesh's batches ----------------

    def _broadcast(self, t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, src=self.mesh.ranks[0], group=self.mesh.group)
        return t

    def _broadcast_header(self, n: int, stop: bool = False) -> int:
        header = torch.tensor([n, int(stop)], dtype=torch.int64)
        header = self._broadcast(header.to(self.mesh.device)).tolist()
        return -1 if header[1] else header[0]

    def _wire(self) -> tuple:
        dtype = torch.uint8 if self.uint8_transport else torch.float32
        return (3, self.image_size, self.image_size), dtype

    def _send(self, images: List[np.ndarray]) -> List[np.ndarray]:
        """Broadcast a batch the first rank formed; -> the requests as the
        other ranks receive them."""
        shape, dtype = self._wire()
        batch = torch.from_numpy(np.stack(images)).to(dtype)
        if tuple(batch.shape[1:]) != shape:
            raise ValueError(f"requests of shape {tuple(batch.shape[1:])}, "
                             f"the server takes {shape}")
        self._broadcast_header(len(images))
        self._broadcast(batch.to(self.mesh.device))
        return list(batch.numpy())

    def _follow(self) -> None:
        """A rank's part in the first rank's batches, until its stop."""
        shape, dtype = self._wire()
        while True:
            n = self._broadcast_header(0)
            if n < 0:
                return
            batch = self._broadcast(
                torch.empty((n, *shape), dtype=dtype, device=self.device))
            self.infer(list(batch.cpu().numpy()))

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
            # a Future cancelled while queued drops out here; the rest can no
            # longer be cancelled, so setting their results cannot raise
            taken = []
            for p in pending:
                if p[1].set_running_or_notify_cancel():
                    taken.append(p)
                else:
                    profiling.close_span(p[2], cancelled=True)
            if not taken:
                continue
            for p in taken:  # `infer` steps them as batch `self.batches`
                profiling.close_span(p[2], bid=self.batches)
            try:
                images = [p[0] for p in taken]
                if self.mesh is not None:
                    images = self._send(images)
                results = self.infer(images)
            except Exception as exc:  # the worker must outlive a failed batch
                for _, fut, _ in taken:
                    if not fut.done():
                        fut.set_exception(exc)
                continue
            for (_, fut, _), res in zip(taken, results):
                fut.set_result(res)
