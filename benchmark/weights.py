"""Seeded random inputs made on the device: ZUTIS's weights in the layout
of `reference.model.param_specs`, and unit-norm text embeddings.

Weights are drawn by one generator on the device, one `randn` for all the
leaves, then cut into leaves, scaled or filled, and the matrices cast to
the served type: the same seed gives the same weights on every run, and
making ViT-L/14's 0.4 billion parameters takes milliseconds. Both the program and
the reference are handed these values (the program's own `init_params`
draws on a CPU generator, leaf by leaf)."""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.model import param_specs


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % 2**63)


def make_weights(cfg: dict, seed: int, device, matrix_dtype=torch.float32
                 ) -> Dict[str, torch.Tensor]:
    """name -> tensor: one float32 draw for every leaf, in the layout's
    order; leaves of two or more dims are then stored in `matrix_dtype`
    (the served type: the same values, rounded), the rest in float32."""
    specs = param_specs(cfg)
    sizes = [torch.Size(shape).numel() for _, shape, _, _ in specs]
    flat = torch.randn(sum(sizes), generator=_generator(seed, device),
                       device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    for (name, shape, init, scale), piece in zip(specs, flat.split(sizes)):
        if init == "normal":
            piece.mul_(scale)
        else:
            piece.fill_(1.0 if init == "ones" else 0.0)
        leaf = piece.view(shape)
        out[name] = leaf.to(matrix_dtype) if len(shape) > 1 else leaf
    return out


def served_weights(cfg: dict, seed: int, device, matrix_dtype
                   ) -> Dict[str, torch.Tensor]:
    """The weights the program is handed, in float32 for the reference."""
    return {k: v.float() for k, v in
            make_weights(cfg, seed, device, matrix_dtype).items()}


def text_embeddings(n: int, dim: int, seed: int, device) -> torch.Tensor:
    """[n, dim] float32 rows of unit norm, drawn after the weights' stream
    (a generator of its own, seeded from `seed` + 1)."""
    gen = _generator(seed + 1, device)
    t = torch.randn(n, dim, generator=gen, device=device)
    return t / t.norm(dim=1, keepdim=True)


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Make `weights` the parameters of `model` (no copy): the names and
    shapes must be the model's own, all of them."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        missing = sorted(set(params) - set(weights))[:5]
        extra = sorted(set(weights) - set(params))[:5]
        raise ValueError(f"weight layout differs: missing {missing}, "
                         f"unknown {extra}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: {tuple(weights[name].shape)} for "
                                 f"{tuple(p.shape)}")
            p.data = weights[name]
