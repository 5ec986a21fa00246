"""Optimiser factory: AdamW with encoder learning-rate scaling and PolyLR
(the port of zutis_tpu/engine/optim.py).

AdamW (betas 0.9 / 0.999, eps 1e-8) over two parameter groups: the CLIP
encoder's parameters (names under `encoder.`) at lr x `encoder_lr_scale`,
the rest at lr, weight decay on both. torch's AdamW decays each parameter
by its group's lr, as the JAX package's optax chain does by scaling the
decayed update after the weight-decay add. PolyLR multiplies the base lr by
(1 - step / n_iters)^power with a floor of 1e-6, stepped once an iteration;
the encoder's scale applies after the floor, as in the chain.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR


def poly_lr_schedule(base_lr: float, n_iters: int, power: float = 0.9,
                     floor: float = 1e-6) -> Callable[[int], float]:
    """step -> max(base_lr * (1 - min(step, n_iters) / n_iters)^power, floor)."""
    def schedule(step: int) -> float:
        frac = 1.0 - min(step, n_iters) / n_iters
        return max(base_lr * frac ** power, floor)

    return schedule


def make_optimizer(
    model: torch.nn.Module,
    base_lr: float = 5e-5,
    n_iters: int = 20000,
    weight_decay: float = 0.05,
    encoder_lr_scale: float = 0.1,
    power: float = 0.9,
    floor: float = 1e-6,
) -> Tuple[torch.optim.AdamW, LambdaLR]:
    """-> (AdamW over `model`'s parameters, its PolyLR LambdaLR)."""
    encoder, rest = [], []
    for name, p in model.named_parameters():
        (encoder if name.startswith("encoder.") else rest).append(p)
    optimizer = torch.optim.AdamW(
        [{"params": encoder, "lr": base_lr * encoder_lr_scale},
         {"params": rest, "lr": base_lr}],
        lr=base_lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    schedule = poly_lr_schedule(base_lr, n_iters, power, floor)
    scheduler = LambdaLR(optimizer, lambda step: schedule(step) / base_lr)
    return optimizer, scheduler
