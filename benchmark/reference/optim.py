"""Plain AdamW (Loshchilov and Hutter; torch.optim.AdamW's arithmetic) with
ZUTIS's poly learning-rate schedule: lr(t) = max(base_lr (1 - t / n_iters)
^ power, floor), the CLIP encoder's parameters (names under `encoder.`) at
lr x encoder_lr_scale, the decay decoupled and scaled by each lr."""
from __future__ import annotations

from typing import Dict

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], base_lr: float,
                 n_iters: int, weight_decay: float, encoder_lr_scale: float,
                 power: float = 0.9, floor: float = 1e-6):
        self.params = params
        self.base_lr, self.n_iters, self.power = base_lr, n_iters, power
        self.floor, self.wd, self.enc = floor, weight_decay, encoder_lr_scale
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    def lr(self, name: str) -> float:
        frac = 1.0 - min(self.t, self.n_iters) / self.n_iters
        lr = max(self.base_lr * frac ** self.power, self.floor)
        return lr * self.enc if name.startswith("encoder.") else lr

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = BETAS
        n = self.t + 1
        for k, p in self.params.items():
            g, lr = grads[k], self.lr(k)
            p.mul_(1.0 - lr * self.wd)
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (self.v[k] / (1.0 - b2 ** n)).sqrt_().add_(EPS)
            p.addcdiv_(self.m[k], denom, value=-lr / (1.0 - b1 ** n))
        self.t = n
