"""Full train-state checkpoints with resume (the port of
zutis_tpu/core/checkpoint.py, on torch.save in place of orbax).

The reference saves bare model weights only (`torch.save(state_dict)`,
trainer.py:246,252), so its training cannot resume mid-run. Here the whole
TrainState (the model, the AdamW moments, the PolyLR scheduler and the
step) goes to `<checkpoint_dir>/step_<N>/state.pt`, written under a
temporary name and renamed into place, so that a run killed while writing
leaves the previous checkpoint as the newest. With a batch stream that is a
function of the step, a run restored from it continues as the
uninterrupted run would have.

`load_params_any` reads the reference-layout weights: the `.npz` that
`export_params` (and the JAX package's `export_zutis`) writes, or a
reference torch `.pt`.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"
_FLAX_RAW_PREFIX = "__flax_raw__/"  # the JAX export of RN/DINO encoders


def save_train_state(path: str, state) -> None:
    """Write `state` (engine.train_step.TrainState) to `path`/state.pt."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, STATE_FILE)
    tmp = f"{final}.{os.getpid()}.tmp"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(),
                "step": int(state.step)}, tmp)
    os.replace(tmp, final)


def restore_train_state(path: str, target):
    """Load the checkpoint at `path` into `target` (a TrainState whose model
    and optimiser have the checkpoint's structure), onto the device its
    model lies on; returns `target`, or None when `path` holds no
    checkpoint."""
    final = os.path.join(path, STATE_FILE)
    if not os.path.exists(final):
        return None
    # read to the host: the model's and the moments' tensors are copied to
    # the parameters' device by load_state_dict, while AdamW's step counts
    # stay host scalars, as in a fresh optimiser (one on the card would be
    # read back to the host, a sync, at every step)
    saved = torch.load(final, map_location="cpu", weights_only=True)
    target.model.load_state_dict(saved["model"], strict=True)
    target.optimizer.load_state_dict(saved["optimizer"])
    target.scheduler.load_state_dict(saved["scheduler"])
    target.step = int(saved["step"])
    return target


def latest_step_dir(base: str) -> Optional[str]:
    """The newest `step_<N>` directory under `base` that holds a complete
    checkpoint, or None."""
    if not os.path.isdir(base):
        return None
    steps = []
    for name in os.listdir(base):
        if name.startswith("step_") and os.path.exists(
                os.path.join(base, name, STATE_FILE)):
            try:
                steps.append((int(name.split("_")[1]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(base, max(steps)[1])


def load_params_any(path: str) -> Dict[str, torch.Tensor]:
    """A reference-layout state dict (float32 tensors on the CPU) from a
    `.npz` export or a reference torch `.pt`; load it into the port's ZUTIS
    with `load_state_dict(strict=True)`."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            sd = {k: f[k] for k in f.files}
        if any(k.startswith(_FLAX_RAW_PREFIX) for k in sd):
            raise NotImplementedError(
                f"{path} holds an RN or DINO encoder's raw tree; the port "
                "carries the CLIP ViT encoder only (ROADMAP.md, queue 1, "
                "item 7)")
        return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return {k: v.detach().float() for k, v in sd.items() if torch.is_tensor(v)}
