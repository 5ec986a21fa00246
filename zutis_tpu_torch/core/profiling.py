"""Tracing and numeric guards (the port of zutis_tpu/core/profiling.py).

  - `trace(log_dir)`: a context manager around `torch.profiler` (host and,
    on a card, device activity) that writes a Chrome trace,
    `<log_dir>/trace.json`, when it exits; `Trainer.fit(profile_dir=...)`
    traces a window of training steps with it.
  - `annotate(name)`: `torch.profiler.record_function`, a labelled span of
    host work inside a trace.
  - `enable_debug_nans()`: autograd's anomaly detection, which raises at
    the first backward op that produces NaN.
  - `check_finite(tree, where)`: a guard over a module's parameters or a
    nested dict, list or tuple of tensors and arrays (bf16 included);
    raises NonFiniteError with the offending leaf's path. It reads the
    values, so on a card it waits for them. The training loop's per-step
    loss guard raises NonFiniteError itself (engine/trainer.py).
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Iterator, Tuple

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str) -> torch.profiler.record_function:
    return torch.profiler.record_function(name)


def enable_debug_nans(on: bool = True) -> None:
    torch.autograd.set_detect_anomaly(on)


class NonFiniteError(RuntimeError):
    pass


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, torch.nn.Module):
        for name, p in tree.named_parameters():
            yield f"{path}{name}", p
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}{i}/")
    else:
        yield path.rstrip("/"), tree


def check_finite(tree: Any, where: str = "") -> None:
    for path, leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf.detach()).all()):
                raise NonFiniteError(
                    f"non-finite value at {where or 'unknown'}: leaf {path!r}")
            continue
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.all(np.isfinite(arr)):
            raise NonFiniteError(
                f"non-finite value at {where or 'unknown'}: leaf {path!r}")
