"""Training and evaluation loops with the reference's artifacts (the port of
zutis_tpu/engine/trainer.py).

  fit: one training step an iteration (engine/train_step.py), a running
    loss meter, the in-training semantic mIoU, `training_metrics.json` as
    JSON lines every `iter_log`, an evaluation with `latest_model.npz` and
    `best_model.npz` every `iter_eval`, full-state checkpoints every
    `checkpoint_every` (core/checkpoint.py), `final_model.npz` at the end.
  evaluate: the semantic argmax (and, for coco2017, the instance decode and
    COCO mask AP), bucketed through `ZUTIS.forward_padded`
    (engine/batched_eval.py) for the ViT family, in batches of one exact
    (input, target) shape for the RN and DINO families (no padding, so
    every number is the per-image program's), or per image;
    `eval_metrics.json`, `instance_predictions_<iter>.json` and
    `eval_coco_style_metrics.json`.

Between log points a step waits for nothing on a card: each step's loss is
copied to pinned host memory behind the step's kernels and read two steps
later (the finiteness guard still names the step that produced a NaN), and
the confusion histogram accumulates on the device until a log, evaluation
or checkpoint reads it.

Not carried by this port (raises NotImplementedError): `visualise=True`
(engine/visualiser.py needs matplotlib, queue 1, item 4); `debug` writes no
images.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from datetime import datetime
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from zutis_tpu_torch.core import profiling
from zutis_tpu_torch.core.checkpoint import save_train_state
from zutis_tpu_torch.core.device import resolve_device, to_device
from zutis_tpu_torch.data.label_maps import new_label_id_to_old_label_id
from zutis_tpu_torch.engine import batched_eval as BE
from zutis_tpu_torch.engine.coco_eval import COCOEvaluator
from zutis_tpu_torch.engine.metrics import (
    AverageMeter,
    RunningScore,
    confusion_update,
)
from zutis_tpu_torch.engine.train_step import TrainState, make_train_step
from zutis_tpu_torch.models.weights import export_params
from zutis_tpu_torch.postproc.instance import (
    instances_to_coco_counts,
    predict_instances_device,
    predict_semantic,
)

FETCH_LAG = 2  # steps between a step and the read of its loss


def _append_jsonl(path: str, record: dict, first: bool) -> None:
    mode = "w" if first else "a"
    with open(path, mode) as f:
        if not first and os.path.getsize(path) > 0:
            f.write("\n")
        json.dump(record, f)


class _LossFetch:
    """A step's loss on its way to the host: on a card, copied into pinned
    memory behind the step's kernels, so that neither the copy nor a later
    read of a finished step stalls the dispatch."""

    def __init__(self, loss: torch.Tensor):
        self._event = None
        if loss.device.type != "cuda":
            self._value = loss
            return
        self._value = torch.empty((), dtype=loss.dtype, pin_memory=True)
        self._value.copy_(loss, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def result(self) -> float:
        if self._event is not None:
            self._event.synchronize()
        return float(self._value)


class Trainer:
    def __init__(self, model: torch.nn.Module, text_embeddings,
                 dir_ckpt: Optional[str] = None, debug: bool = False,
                 device="cuda"):
        """`model` must lie on `device`; raises on a host without a card
        unless device="cpu"."""
        self.device = resolve_device(device)
        param = next(model.parameters())
        if param.device.type != self.device.type:
            raise ValueError(f"the model lies on {param.device}, not on "
                             f"{self.device}")
        self.model = model
        self.text_embeddings = np.asarray(text_embeddings, np.float32)
        self._text = to_device(torch.from_numpy(self.text_embeddings),
                               self.device)
        self.dir_ckpt = dir_ckpt
        self.debug = debug
        self.best_miou = 0.0
        # the artifact files this Trainer has (re)started: the first write
        # of a run that is not resumed truncates, every later one appends
        self._fresh_artifacts: set = set()
        self._resumed = False
        # built once for the Trainer's lifetime: the train step, and one
        # bucketed eval step per (regime, bucket, output bucket)
        self._train_step_key = None
        self._train_step_fn = None
        self._bucket_steps: Dict = {}
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def _write_artifact(self, name: str, record: dict,
                        resumed: bool = False) -> None:
        first = name not in self._fresh_artifacts and not resumed
        self._fresh_artifacts.add(name)
        _append_jsonl(f"{self.dir_ckpt}/{name}", record, first=first)

    def save_checkpoint(self, state: TrainState, name: str) -> None:
        """The model's reference-layout weights to `<dir_ckpt>/<name>.npz`."""
        if self.dir_ckpt is None:
            return
        np.savez(f"{self.dir_ckpt}/{name}.npz", **export_params(state.model))

    # ---------------- training ----------------

    def fit(
        self,
        state: TrainState,
        batches: Iterable[Dict],
        n_iters: int,
        n_categories: int,
        ignore_index: int = 255,
        weight_ce_loss: float = 1.0,
        iter_eval: Optional[int] = None,
        iter_log: Optional[int] = None,
        val_dataset=None,
        eval_every_cb=None,
        checkpoint_every: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        visualise: bool = False,
        profile_dir: Optional[str] = None,
        profile_steps: tuple = (10, 20),
    ) -> TrainState:
        """Train `state` (whose model is this Trainer's) from `state.step`
        up to `n_iters`, in place; returns it. `checkpoint_every` > 0 saves
        the whole TrainState to `checkpoint_dir`/step_<N>; resumed from one
        with a batch stream that is a function of the step, a run continues
        as the uninterrupted one (on the CPU bit for bit). `batches` must
        already be positioned at `state.step` when resuming.
        `eval_every_cb(num_iter, state)` runs at the end of each iteration;
        `profile_dir` traces steps `profile_steps[0]` to `[1]`."""
        if visualise:
            raise NotImplementedError(
                "visualise=True: engine/visualiser.py needs matplotlib, which "
                "the port does not use (ROADMAP.md, queue 1, item 4)")
        if state.model is not self.model:
            raise ValueError("the TrainState's model is not this Trainer's")
        step_key = (n_categories, ignore_index, weight_ce_loss)
        if self._train_step_key != step_key:
            self._train_step_fn = make_train_step(
                self.model, self.text_embeddings, n_categories,
                ignore_index=ignore_index, weight_ce_loss=weight_ce_loss,
                device=self.device)
            self._train_step_key = step_key
        step_fn = self._train_step_fn
        loss_meter = AverageMeter()
        metric_meter = RunningScore(n_categories)
        it = iter(batches)
        t_start = time.time()
        start_iter = int(state.step)
        self._resumed = start_iter > 0
        pending: deque = deque()  # (num_iter, _LossFetch)
        confusion = None  # the device-side [C, C] accumulator
        tracer = None

        def drain_one():
            num_iter, fetch = pending.popleft()
            loss = fetch.result()
            if not np.isfinite(loss):
                raise profiling.NonFiniteError(
                    f"non-finite training loss {loss} at step {num_iter}")
            loss_meter.update(loss, 1)

        def drain_all():
            nonlocal confusion
            while pending:
                drain_one()
            if confusion is not None:
                metric_meter.confusion_matrix += confusion.cpu().numpy()
                confusion = None

        try:
            for num_iter in range(start_iter + 1, n_iters + 1):
                if profile_dir and num_iter == profile_steps[0]:
                    tracer = profiling.trace(profile_dir)
                    tracer.__enter__()
                batch = next(it)
                metrics = step_fn(state, batch, confusion)
                confusion = metrics["confusion"]
                pending.append((num_iter, _LossFetch(metrics["loss"])))
                while len(pending) > FETCH_LAG:
                    drain_one()
                if tracer is not None and num_iter >= profile_steps[1]:
                    tracer.__exit__(None, None, None)
                    tracer = None

                if self.debug or (iter_log and num_iter % iter_log == 0):
                    drain_all()
                    scores, cls_iu = metric_meter.get_scores()
                    record = {
                        "num_iter": num_iter,
                        "timestamp": str(datetime.now()),
                        "loss": loss_meter.avg,
                        "ce_loss": float(metrics["ce_loss"]),
                        "mask_loss": float(metrics["mask_loss"]),
                        # from this call's start: a resumed run's rate
                        "iters_per_sec": (num_iter - start_iter)
                        / (time.time() - t_start),
                        **scores,
                        **{str(k): v for k, v in cls_iu.items()},
                    }
                    if self.dir_ckpt is not None:
                        self._write_artifact("training_metrics.json", record,
                                             resumed=start_iter > 0)
                    print(f"({num_iter}/{n_iters}) loss {loss_meter.avg:.3f} "
                          f"mIoU {scores['Mean IoU']:.3f} "
                          f"pix-acc {scores['Pixel Acc']:.3f}", flush=True)

                if ((self.debug or (iter_eval and num_iter % iter_eval == 0))
                        and val_dataset is not None
                        and getattr(val_dataset, "name", "") != "imagenet-s919"):
                    drain_all()  # surface a NaN before the evaluation
                    scores = self.evaluate(state, val_dataset,
                                           num_iter=num_iter)
                    self.save_checkpoint(state, "latest_model")
                    miou = scores.get("Mean IoU", float("nan"))
                    if np.isfinite(miou) and miou >= self.best_miou:
                        self.save_checkpoint(state, "best_model")
                if checkpoint_every and checkpoint_dir and (
                        num_iter % checkpoint_every == 0):
                    drain_all()  # never checkpoint a state a NaN poisoned
                    save_train_state(
                        os.path.join(checkpoint_dir, f"step_{num_iter}"),
                        state)
                if eval_every_cb is not None:
                    eval_every_cb(num_iter, state)
                if self.debug:
                    break
            drain_all()
        finally:
            if tracer is not None:
                tracer.__exit__(None, None, None)
        self.save_checkpoint(state, "final_model")
        return state

    # ---------------- evaluation ----------------

    def evaluate(
        self,
        state,
        dataset,
        num_iter: Optional[int] = None,
        max_images: Optional[int] = None,
        batch_images: int = 16,
    ) -> Dict[str, float]:
        """Evaluate this Trainer's model (`state` is its TrainState, the
        model itself, or None) on `dataset` (`name`, `n_categories`, items
        with "image" [3, H, W] normalised f32, optional "semantic_mask",
        "image_id", and "original_size" for ImageNet-S; `p_annotations` for
        coco2017). ViT models pad images into resolution buckets and run
        `batch_images` at a time through `ZUTIS.forward_padded`; RN and DINO
        models (overlapping convolutions, no padded path) batch up to
        `batch_images` images of one exact (input, target) shape through
        the dense forward; `batch_images <= 1` or `debug` runs the
        reference's per-image regime (trainer.py:294-375)."""
        model = getattr(state, "model", state)
        if model is not None and model is not self.model:
            raise ValueError("evaluate runs this Trainer's model")
        dataset_name = dataset.name
        metric_meter = RunningScore(dataset.n_categories)
        instance_predictions: list = []
        n = len(dataset) if max_images is None else min(max_images,
                                                        len(dataset))
        t_eval = time.time()
        if batch_images <= 1 or self.debug:
            n_images = self._evaluate_exact_batched(
                dataset, 1 if self.debug else n, dataset_name, metric_meter,
                instance_predictions, 1)
        elif self.model.encoder_family == "vit":
            n_images = self._evaluate_batched(
                dataset, n, dataset_name, metric_meter, instance_predictions,
                batch_images)
        else:
            n_images = self._evaluate_exact_batched(
                dataset, n, dataset_name, metric_meter, instance_predictions,
                batch_images)
        eval_seconds = time.time() - t_eval
        scores, cls_iu = metric_meter.get_scores()
        scores["eval_images_per_sec"] = (
            n_images / eval_seconds if eval_seconds > 0 else 0.0)
        return self._finish_evaluate(scores, cls_iu, dataset, dataset_name,
                                     instance_predictions, num_iter)

    def _evaluate_exact_batched(self, dataset, n, dataset_name, metric_meter,
                                instance_predictions, batch_images) -> int:
        """The dense forward over groups of up to `batch_images` samples of
        one exact (input shape, target shape), no padding; with
        batch_images 1 the reference's per-image regime. A group runs when
        it is full, the partial ones at the end, each in order of its
        first sample (the port of the JAX Trainer's
        `_evaluate_exact_batched` and `_evaluate_per_image`)."""
        n_classes = metric_meter.n_classes
        confusion = [None]  # the device-side [C, C] accumulator
        pending: Dict = {}

        def dispatch(batch):
            (_, _, H, W), items = batch
            images = to_device(torch.from_numpy(np.stack(
                [np.asarray(s["image"], np.float32) for s in items])),
                self.device)
            res = fetch = None
            with torch.inference_mode():
                out = self.model(images, inference=True)
                sem = predict_semantic(out["patch_tokens"], self._text,
                                       size=(H, W))
                # items without a semantic GT add rows of -1, which the
                # confusion's validity mask drops
                if any("semantic_mask" in s for s in items):
                    gt = to_device(torch.from_numpy(np.stack([
                        np.asarray(s["semantic_mask"], np.int32)
                        if "semantic_mask" in s
                        else np.full((H, W), -1, np.int32) for s in items])),
                        self.device)
                    c = confusion_update(gt, sem, n_classes)
                    confusion[0] = c if confusion[0] is None else confusion[0] + c
                if dataset_name == "coco2017":
                    res = predict_instances_device(
                        out["mask_proposals"], out["patch_tokens"], self._text,
                        size=(H, W), rle=True)
                    fetch = BE.fetch_to_host(res, self._stream)
            return res, fetch

        def collect(handles, batch):
            res, fetch = handles
            (_, _, H, W), items = batch
            if res is not None:
                instance_predictions.extend(instances_to_coco_counts(
                    fetch.result(), image_ids=[s["image_id"] for s in items],
                    sizes=[(H, W)] * len(items),
                    new_label_id_to_old_label_id=new_label_id_to_old_label_id,
                    dev_masks=BE.SideStreamView(res["masks"], self._stream)))

        def batches():
            for i in range(n):
                sample = dataset[i]
                key = (*sample["image"].shape[-2:],
                       *self._target_hw(sample, dataset_name))
                pending.setdefault(key, []).append(sample)
                if len(pending[key]) == batch_images:
                    yield key, pending.pop(key)
            yield from pending.items()

        # depth 2: batch N's fetch and host assembly overlap batch N + 1's
        # load and device work
        for _ in BE.pipelined(dispatch, collect, batches(), depth=2):
            pass
        if confusion[0] is not None:
            metric_meter.confusion_matrix += confusion[0].cpu().numpy()
        return n

    def _evaluate_batched(self, dataset, n, dataset_name, metric_meter,
                          instance_predictions, batch_images) -> int:
        """Single-pass greedy bucketing: samples gather per (input bucket,
        output bucket) and run as full batches, the partial ones at the
        end; each key builds its step once for the Trainer's lifetime."""
        patch = self.model.encoder.patch_size
        want_instances = dataset_name == "coco2017"
        n_classes = metric_meter.n_classes
        pending: Dict = {}
        confusion = [None]  # the device-side [C, C] accumulator

        def dispatch(batch):
            key, items = batch
            in_shape, out_shape = key
            padded, native_grid, _ = BE.pad_batch(
                [s["image"] for s in items], in_shape, batch_images, patch)
            # the output extent: the original size for ImageNet-S
            out_pixels = np.ones((batch_images, 2), np.int32)
            for j in range(batch_images):
                out_pixels[j] = self._target_hw(
                    items[j] if j < len(items) else items[0], dataset_name)
            skey = (want_instances, n_classes) + key
            if skey not in self._bucket_steps:
                if want_instances:
                    step = BE.make_instance_step(
                        self.model, self.text_embeddings, out_shape,
                        semantic_mode="confusion", n_classes=n_classes,
                        device=self.device)
                else:
                    step = BE.make_semantic_confusion_step(
                        self.model, self.text_embeddings, out_shape,
                        n_classes, device=self.device)
                self._bucket_steps[skey] = step
            # the dense semantic map stays on the device: the GT goes up
            # padded with -1 and only the histogram comes back
            gt_pad = np.full((batch_images, *out_shape), -1, np.int32)
            for j, s in enumerate(items):
                if "semantic_mask" in s:
                    H, W = self._target_hw(s, dataset_name)
                    gt_pad[j, :H, :W] = s["semantic_mask"]
            res = self._bucket_steps[skey](padded, native_grid, out_pixels,
                                           gt_pad)
            return res, (BE.fetch_to_host(res, self._stream)
                         if want_instances else None)

        def collect(handles, batch):
            res, fetch = handles
            _, items = batch
            if want_instances:
                c = res["confusion"]
                instance_predictions.extend(instances_to_coco_counts(
                    fetch.result(), image_ids=[s["image_id"] for s in items],
                    sizes=[self._target_hw(s, dataset_name) for s in items],
                    new_label_id_to_old_label_id=new_label_id_to_old_label_id,
                    dev_masks=BE.SideStreamView(res["masks"], self._stream)))
            else:
                c = res
            confusion[0] = c if confusion[0] is None else confusion[0] + c

        def batches():
            for i in range(n):
                sample = dataset[i]
                h, w = sample["image"].shape[-2:]
                key = (BE.bucket_shape(h, w), BE.bucket_shape(
                    *self._target_hw(sample, dataset_name)))
                pending.setdefault(key, []).append(sample)
                if len(pending[key]) == batch_images:
                    yield key, pending.pop(key)
            yield from pending.items()

        # depth 2: batch N's fetch and host assembly overlap batch N + 1's
        # padding, upload and device work
        for _ in BE.pipelined(dispatch, collect, batches(), depth=2):
            pass
        if confusion[0] is not None:
            metric_meter.confusion_matrix += confusion[0].cpu().numpy()
        return n

    @staticmethod
    def _target_hw(sample, dataset_name):
        if "imagenet-s" in dataset_name:
            return (int(sample["original_size"][0]),
                    int(sample["original_size"][1]))
        return int(sample["image"].shape[-2]), int(sample["image"].shape[-1])

    def _finish_evaluate(self, scores, cls_iu, dataset, dataset_name,
                         instance_predictions, num_iter) -> Dict[str, float]:
        if self.dir_ckpt is not None:
            record = {"num_iter": num_iter, "timestamp": str(datetime.now())}
            record.update(scores)
            record.update({str(k): v for k, v in cls_iu.items()})
            self._write_artifact("eval_metrics.json", record,
                                 resumed=self._resumed)
            if dataset_name == "coco2017":
                serializable = []
                for p in instance_predictions:
                    q = dict(p)
                    q.pop("bbox", None)
                    q["image_size"] = list(q.get("image_size", ()))
                    serializable.append(q)
                with open(f"{self.dir_ckpt}/instance_predictions_"
                          f"{(num_iter or 0):05d}.json", "w") as f:
                    json.dump(serializable, f)
                try:
                    with open(dataset.p_annotations) as f:
                        gt = json.load(f)
                    coco_metrics = COCOEvaluator(gt).evaluate(
                        instance_predictions)
                except (IndexError, KeyError):
                    coco_metrics = {"index error": -1.0}
                self._write_artifact("eval_coco_style_metrics.json",
                                     coco_metrics, resumed=self._resumed)
        miou = scores["Mean IoU"]
        if np.isfinite(miou) and miou > self.best_miou and num_iter != -1:
            self.best_miou = miou
        return scores
