"""Training and evaluation steps (the port of
zutis_tpu/engine/train_step.py).

One training iteration: forward, criterion (with the batched matcher on the
device), backward, AdamW, PolyLR, and the in-training semantic confusion
histogram. Nothing in a step's dispatch waits for the card: the losses and
the histogram stay on the device, and only reading them waits.

Batches are dicts of host arrays or tensors:
  image:          [b, 3, H, W] float32 (normalised)
  instance_masks: [b, N_max, H, W] float {0, 1} (padded)
  instance_valid: [b, N_max] bool
  semantic_mask:  [b, H, W] int32 (ignore_index outside labels)

A model that `parallel.shard_model` placed on a mesh trains data-parallel
over its data axis (and tensor-parallel over its model axis, inside the
model): each data rank passes its slice of the global batch, the
gradients, views of a few flat buckets, are summed over the data group
where they lie (parallel/dp.py), and the metrics returned are the global
batch's, summed over the data group on the device. The matcher runs on
each rank's slice.

A step is a `train.step` span around `train.upload`, `train.forward`,
`train.criterion` (holding the criterion's `train.matcher`),
`train.backward` (the all-reduce included) and `train.optimizer` (zeroing
the gradients, then AdamW and PolyLR: two spans a step); on a card all but
the upload carry device events (core/profiling.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from zutis_tpu_torch.core.device import resolve_device, to_device
from zutis_tpu_torch.core.profiling import span
from zutis_tpu_torch.engine.metrics import confusion_update
from zutis_tpu_torch.engine.optim import make_optimizer
from zutis_tpu_torch.losses.criterion import criterion_loss
from zutis_tpu_torch.parallel.dp import GradientBuckets
from zutis_tpu_torch.parallel.mesh import mesh_of

BATCH_KEYS = ("image", "instance_masks", "instance_valid", "semantic_mask")
LOSS_KEYS = ("loss", "ce_loss", "mask_loss")


@dataclass
class TrainState:
    """The model, its optimiser and schedule, and the steps taken."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, **optimizer_kw) -> "TrainState":
        """A fresh state; `optimizer_kw` go to `make_optimizer`."""
        optimizer, scheduler = make_optimizer(model, **optimizer_kw)
        return cls(model=model, optimizer=optimizer, scheduler=scheduler)


def upload_batch(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's four arrays as tensors on `device` (pinned, non-blocking
    copies from the host; a tensor already there stays as it is)."""
    return {k: to_device(torch.as_tensor(np.asarray(batch[k]))
                         if not torch.is_tensor(batch[k]) else batch[k], device)
            for k in BATCH_KEYS}


def make_train_step(
    model: torch.nn.Module,
    text_embeddings,  # [n_cat, text_dim]
    n_categories: int,
    ignore_index: int = 255,
    weight_ce_loss: float = 1.0,
    weight_mask_loss: float = 1.0,
    weight_dice_loss: float = 1.0,
    weight_bce_loss: float = 1.0,
    device="cuda",
):
    """-> step(state, batch, confusion_acc=None) -> metrics, which trains
    `state.model` (which must lie on `device`) one iteration in place.
    metrics: "loss", "ce_loss", "mask_loss" (device scalars, no gradient)
    and "confusion", this step's [n_cat, n_cat] histogram, added to
    `confusion_acc` when one is given. Raises on a host without a card
    unless device="cpu"."""
    device = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != device.type:
        raise ValueError(f"the model lies on {param.device}, not on {device}")
    text = to_device(torch.as_tensor(np.asarray(text_embeddings),
                                     dtype=torch.float32), device)
    mesh = mesh_of(model)
    buckets = None if mesh is None else GradientBuckets(model.parameters(),
                                                        mesh.data_group)

    on_card = device.type == "cuda"

    def step(state: TrainState, batch: Dict,
             confusion_acc: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        with span("train.step"):
            return run(state, batch, confusion_acc)

    def run(state, batch, confusion_acc):
        with span("train.upload"):
            b = upload_batch(batch, device)
        with span("train.forward", device=on_card):
            out = state.model(b["image"])
        with span("train.criterion", device=on_card):
            losses = criterion_loss(
                out["mask_proposals"], b["instance_masks"],
                b["instance_valid"], out["patch_tokens"], b["semantic_mask"],
                text, weight_ce_loss=weight_ce_loss,
                weight_mask_loss=weight_mask_loss,
                weight_dice_loss=weight_dice_loss,
                weight_bce_loss=weight_bce_loss, ignore_index=ignore_index,
                mesh=mesh)
        del out
        with span("train.optimizer", device=on_card):
            if buckets is None:
                state.optimizer.zero_grad(set_to_none=True)
            else:
                buckets.zero()
        with span("train.backward", device=on_card):
            losses["loss"].backward()
            if buckets is not None:
                buckets.all_reduce()
        with span("train.optimizer", device=on_card):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        # the criterion's logits give the semantic prediction (no second
        # full-resolution resize)
        confusion = confusion_update(b["semantic_mask"], losses["sem_pred"],
                                     n_categories)
        scalars = torch.stack([losses[k].detach() for k in LOSS_KEYS])
        if mesh is not None:
            dist.all_reduce(confusion, group=mesh.data_group)
            dist.all_reduce(scalars, group=mesh.data_group)
        if confusion_acc is not None:
            confusion = confusion_acc + confusion
        return {**dict(zip(LOSS_KEYS, scalars.unbind())),
                "confusion": confusion}

    return step


def make_eval_step(model: torch.nn.Module, text_embeddings, device="cuda"):
    """-> eval_step(image) -> (forward outputs, text logits [b, n_cat, h, w]
    at the token grid); the resize to each image's size is the caller's."""
    device = resolve_device(device)
    text = to_device(torch.as_tensor(np.asarray(text_embeddings),
                                     dtype=torch.float32), device)

    def eval_step(image):
        with torch.inference_mode():
            out = model(to_device(torch.as_tensor(image), device))
            logits = torch.einsum("nc,bhwc->bnhw", text, out["patch_tokens"])
        return out, logits

    return eval_step
