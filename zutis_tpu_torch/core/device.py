"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; a request
for CUDA on a host without a usable card raises instead of falling back."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev


def to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Copy a host tensor to `device`. To a card the copy goes through pinned
    memory and does not block: a plain copy from pageable memory waits for
    every kernel queued on the stream, which would stall a pipelined loop."""
    device = torch.device(device)
    if device.type != "cuda" or x.device.type != "cpu":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)
