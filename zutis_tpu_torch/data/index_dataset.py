"""The index (training) dataset: CLIP-retrieved images + pseudo-masks ->
copy-paste synthesised multi-instance training samples (the port of
zutis_tpu/data/index_dataset.py).

Behavioural contract (reference datasets/index_dataset.py):
  __getitem__ (:301-385) — sample n ~ U{1..10} objects (with `random_duplicate`
      a single random category supplies all objects half the time); for each:
      load image + RLE pseudo-mask, random scale/crop(384)/hflip with
      mean-fill, photometric jitter/grayscale/blur, assign the category's
      label id; overlay with copy-paste; emit image, semantic mask (with
      ignore_index from padding), one-hot instance masks.

As in the JAX package, samples are deterministic functions of (seed, epoch,
index), drawn from the same `SeedSequence`s, so the port's sample equals
the JAX one (tests/test_torch_index_dataset.py); instance masks are padded
to `max_n_masks` with a validity vector. Images are decoded by the port's
own JPEG/PNG decoder (data/image_io.py) and augmented on HWC uint8 arrays
(data/augment.py); no Pillow or OpenCV. `batch_iterator` synthesises
batches on threads (the native decoder and blur release the GIL) and yields
dicts of CPU torch tensors, in pinned memory when the target is a card.
The category -> image paths JSON comes from retrieval
(data/imagenet_index.py, retrieval/); the pseudo-mask JSONs must exist (the
training CLI makes the missing ones first, data/pseudo_masks.py).
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from zutis_tpu_torch.core.device import resolve_device
from zutis_tpu_torch.data import augment
from zutis_tpu_torch.data.advanced_copy_paste import AdvancedCopyPaste
from zutis_tpu_torch.data.image_io import read_rgb
from zutis_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from zutis_tpu_torch.ops import rle as rle_ops


class IndexDataset:
    name = "index"

    def __init__(
        self,
        categories: List[str],
        category_to_p_images: Dict[str, List[str]],
        p_image_to_p_pseudo_mask: Dict[str, str],
        image_size: int = 384,
        ignore_index: int = 255,
        scale_range=(0.1, 1.0),
        max_n_masks: int = 10,
        random_duplicate: bool = False,
        seed: int = 0,
        use_advanced_copy_paste: bool = False,
        max_n_partitions: int = 4,
        min_distance: int = 48,
    ):
        """categories: background-first list; label id = position in list.
        category_to_p_images: retrieval output (retrieval/bank.py or the
        reference's JSON cache). p_image_to_p_pseudo_mask: path of the RLE
        JSON per image (data/pseudo_masks.py generates these)."""
        assert categories[0] == "background"
        self.categories = categories
        self.category_to_p_images = {
            c: v for c, v in category_to_p_images.items() if c != "background"
        }
        self.p_image_to_label_id = {}
        for label_id, category in enumerate(categories):
            for p in category_to_p_images.get(category, []):
                self.p_image_to_label_id[p] = label_id
        self.p_images = [
            p for c in sorted(self.category_to_p_images)
            for p in self.category_to_p_images[c]
        ]
        self.p_image_to_p_pseudo_mask = p_image_to_p_pseudo_mask
        self.image_size = image_size
        self.ignore_index = ignore_index
        self.scale_range = tuple(scale_range)
        self.max_n_masks = max_n_masks
        self.random_duplicate = random_duplicate
        self.seed = seed
        self.use_advanced_copy_paste = use_advanced_copy_paste
        if use_advanced_copy_paste:
            self.acp = AdvancedCopyPaste(
                grid_size=image_size, max_n_partitions=max_n_partitions,
                min_distance=min_distance)

    def __len__(self) -> int:
        return len(self.p_images)

    def _load_object(self, rng, p_image: str):
        with open(self.p_image_to_p_pseudo_mask[p_image]) as f:
            binary_mask = rle_ops.decode(json.load(f)).astype(np.int32)
        image = read_rgb(p_image)
        image, binary_mask = augment.random_scale(
            rng, image, self.scale_range, binary_mask)
        image, binary_mask = augment.random_crop(
            rng, image, self.image_size, binary_mask,
            ignore_index=self.ignore_index)
        image, binary_mask = augment.random_hflip(rng, image, 0.5,
                                                  binary_mask)
        image = augment.photometric_augmentations(rng, image)
        arr = np.asarray(image, np.float32) / 255.0
        arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
        return arr.transpose(2, 0, 1), binary_mask

    def _load_photometric(self, rng, p_image: str):
        """Photometric-only object load (advanced copy-paste mode keeps the
        original geometry; reference datasets/imagenet.py:285-292)."""
        with open(self.p_image_to_p_pseudo_mask[p_image]) as f:
            binary = rle_ops.decode(json.load(f)).astype(np.int64)
        image = read_rgb(p_image)
        image = augment.photometric_augmentations(rng, image)
        arr = np.asarray(image, np.float32) / 255.0
        arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
        return arr.transpose(2, 0, 1), binary

    def _sample_advanced(self, index: int, epoch: int) -> Dict[str, np.ndarray]:
        """Grid-partition synthesis (reference imagenet.py:276-313)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, index, 7]))
        n_images, patch_info, patch_indices = self.acp.generate_grid(
            rng, max_instances=self.max_n_masks)
        images, masks, cat_ids = [], [], []
        for _ in range(n_images):
            p_image = self.p_images[int(rng.integers(0, len(self.p_images)))]
            img, binary = self._load_photometric(rng, p_image)
            images.append(img)
            masks.append(binary)
            cat_ids.append(self.p_image_to_label_id[p_image])
        out = self.acp.copy_paste(
            rng, images, masks, cat_ids, patch_info, patch_indices)

        S = self.image_size
        onehot = np.zeros((self.max_n_masks, S, S), np.float32)
        valid = np.zeros(self.max_n_masks, bool)
        out_cat = np.zeros(self.max_n_masks, np.int32)
        n_inst = min(out["n_instances"], self.max_n_masks)
        onehot[:n_inst] = out["instance_mask"][:n_inst]
        valid[:n_inst] = True
        # copy_paste reports the category of each instance it ACTUALLY pasted
        # (slot-aligned even when objects are skipped mid-paste; ADVICE r2 —
        # the reference reconstructs these positionally and misaligns,
        # imagenet.py:294-307, a quirk we fix rather than reproduce)
        out_cat[:n_inst] = out["instance_category_ids"][:n_inst]
        return {
            "image": out["image"].astype(np.float32),
            "semantic_mask": out["semantic_mask"].astype(np.int32),
            "instance_masks": onehot,
            "instance_valid": valid,
            "category_ids": out_cat,
        }

    def sample(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        """Deterministic synthesis for (seed, epoch, index)."""
        if self.use_advanced_copy_paste:
            return self._sample_advanced(index, epoch)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, index]))
        n_masks = int(rng.integers(1, self.max_n_masks + 1))

        random_category: Optional[str] = None
        if self.random_duplicate and rng.random() > 0.5:
            random_category = str(
                rng.choice(sorted(self.category_to_p_images)))

        images, semantic_masks, instance_masks, category_ids = [], [], [], []
        for instance_id in range(1, n_masks + 1):
            if random_category is not None:
                pool = self.category_to_p_images[random_category]
            else:
                pool = self.p_images
            p_image = pool[int(rng.integers(0, len(pool)))]
            img, binary = self._load_object(rng, p_image)
            label_id = self.p_image_to_label_id[p_image]
            sem = binary.copy()
            sem[sem == 1] = label_id
            inst = binary.copy()
            inst[inst == 1] = instance_id
            images.append(img)
            semantic_masks.append(sem)
            instance_masks.append(inst)
            category_ids.append(label_id)

        img, sem, inst = augment.copy_paste(
            rng, images, semantic_masks, instance_masks,
            background_index=0, ignore_index=self.ignore_index)

        # one-hot instance masks padded to max_n_masks (static shapes)
        S = self.image_size
        onehot = np.zeros((self.max_n_masks, S, S), np.float32)
        valid = np.zeros(self.max_n_masks, bool)
        cat_ids = np.zeros(self.max_n_masks, np.int32)
        for i in range(n_masks):
            onehot[i] = inst == (i + 1)
            valid[i] = True
            cat_ids[i] = category_ids[i]
        return {
            "image": img.astype(np.float32),
            "semantic_mask": sem.astype(np.int32),
            "instance_masks": onehot,
            "instance_valid": valid,
            "category_ids": cat_ids,
        }

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.sample(index)


def batch_iterator(
    dataset: IndexDataset,
    batch_size: int,
    seed: int = 0,
    start_step: int = 0,
    num_threads: int = 2,
    device="cuda",
    process_index: int = 0,
    process_count: int = 1,
):
    """Infinite deterministic batch stream with thread prefetch. Batch `t` is
    a pure function of (seed, t) — resuming from a checkpointed step replays
    the exact remaining stream (SURVEY.md section 5, failure-recovery row).

    Multi-host DP (SURVEY.md section 2.4 per-host pipeline): pass the
    process's rank and the process count, and each process synthesises ONLY
    its contiguous slice of the global batch — the per-process streams tile
    the exact single-process stream, so the process count never changes the
    data. `batch_size` is the GLOBAL batch and must divide by
    process_count.

    Each batch is a dict of CPU torch tensors, in pinned memory when
    `device` is a card (which the training step then uploads without a
    stall); `device="cuda"` raises on a host without one. An exception in
    a producer thread is raised in the consumer. Closing the generator
    stops the producer: the batches in progress finish, no other starts,
    and `close()` returns once the producer has ended."""
    import queue as queue_mod
    import threading

    pin = resolve_device(device).type == "cuda"

    assert batch_size % process_count == 0, (batch_size, process_count)
    per_host = batch_size // process_count
    lo = process_index * per_host

    def make_batch(step: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        idxs = rng.integers(0, len(dataset), size=batch_size)
        idxs = idxs[lo:lo + per_host]
        samples = [dataset.sample(int(i), epoch=step) for i in idxs]
        batch = {}
        for k in samples[0]:
            # stacked straight into (pinned) tensors: one copy, made on
            # the producer's thread
            out = torch.empty((len(samples),) + samples[0][k].shape,
                              dtype=torch.from_numpy(samples[0][k]).dtype,
                              pin_memory=pin)
            view = out.numpy()
            for j, s in enumerate(samples):
                view[j] = s[k]
            batch[k] = out
        return batch

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=num_threads * 2)
    stop = threading.Event()

    def producer():
        step = start_step
        try:
            with ThreadPoolExecutor(num_threads) as pool:
                futures = {}
                next_submit = start_step
                try:
                    while not stop.is_set():
                        while next_submit < step + num_threads * 2:
                            futures[next_submit] = pool.submit(make_batch,
                                                               next_submit)
                            next_submit += 1
                        batch = futures.pop(step).result()
                        # bounded put that re-checks stop: a closed consumer
                        # must not leave the producer blocked in q.put
                        while not stop.is_set():
                            try:
                                q.put(batch, timeout=1.0)
                                break
                            except queue_mod.Full:
                                continue
                        step += 1
                finally:
                    for future in futures.values():  # those not started
                        future.cancel()
        except BaseException as exc:  # surface in the consumer: a silently
            # dead producer would deadlock the training loop in q.get()
            try:
                q.put_nowait(exc)
            except queue_mod.Full:
                try:
                    q.get_nowait()
                except queue_mod.Empty:
                    pass
                q.put_nowait(exc)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            batch = q.get()
            if isinstance(batch, BaseException):
                raise batch
            yield batch
    finally:
        stop.set()
        # the batches in progress finish; none starts after this returns
        thread.join()


def load_category_to_p_images(
    fp: str,
    dir_datasets: Optional[List[str]] = None,
) -> Dict[str, List[str]]:
    """Load the reference's category->paths JSON cache
    (index_dataset.py:105-127)."""
    assert os.path.exists(fp), fp
    with open(fp) as f:
        return json.load(f)
