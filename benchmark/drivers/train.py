"""Training traffic: the program's training step (`make_train_step` on a
`TrainState`: forward, criterion with the matcher, backward, AdamW,
PolyLR) on a pool of seeded batches held pinned on the host and uploaded
each step, the losses read two steps late as `Trainer.fit` reads them.

Set-up builds one state from the seed's weights and drives it through the
mix's first `warm_steps` steps by the window's own call and feed, on
batches that all differ; the window goes on from there with the same
state. Those first steps are what the check holds against the plain
reference, which follows them from the same weights and batches in
float32: each step's loss, the first gradient as AdamW got it (its first
moment after one step over 1 - beta1), and each parameter's change after
the steps.

Mix parameters: batch, image_size, n_categories, ignore_index, n_max,
valid_counts [lo, hi] (each image's instances; every seed gets the same
multiset of counts, in its own order), pool, warm_steps, base_lr,
n_iters, weight_decay, encoder_lr_scale, ignore_border (the share of each
side that is labelled ignore_index).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List

import numpy as np
import torch

from benchmark import counts, weights
from benchmark.harness import Comparison, Outcome
from benchmark.reference import criterion as ref_criterion
from benchmark.reference import model as ref_model
from benchmark.reference.optim import AdamW
from benchmark.reference.precision import Precision

BETA1 = 0.9


def _patch(module, name: str, value):
    """Set `module.name` to `value`; -> the undo."""
    old = getattr(module, name)
    setattr(module, name, value)
    return lambda: setattr(module, name, old)


def _wrap_step(wrap):
    """A fault: the program's make_train_step hands back `wrap(step)`."""
    from zutis_tpu_torch.engine import train_step as ts
    make = ts.make_train_step
    return _patch(ts, "make_train_step",
                  lambda *a, **k: wrap(make(*a, **k)))


def half_batch(step):
    """The step sees the first half of each batch only."""
    return lambda state, batch: step(
        state, {k: v[: len(v) // 2] for k, v in batch.items()})


def frozen_state(step):
    """The step computes but leaves the state as it was."""
    def frozen(state, batch):
        opt_step = state.optimizer.step
        state.optimizer.step = lambda *a, **k: None
        try:
            return step(state, batch)
        finally:
            state.optimizer.step = opt_step
    return frozen


# faults the check has to catch, planted in the program; each -> its undo
FAULTS = {"half_batch": lambda: _wrap_step(half_batch),
          "frozen_state": lambda: _wrap_step(frozen_state)}


def make_pool(t: dict, seed: int) -> List[Dict[str, torch.Tensor]]:
    """`pool` batches of host tensors (pinned where a card is present)."""
    rng = np.random.default_rng(seed)
    b, S, n_max, P = t["batch"], t["image_size"], t["n_max"], t["pool"]
    lo, hi = t["valid_counts"]
    n_valid = np.resize(np.arange(lo, hi + 1), P * b)
    rng.shuffle(n_valid)
    border = int(round(t.get("ignore_border", 0.0) * S))
    coords = np.arange(S)
    pool = []
    for k in range(P):
        image = rng.standard_normal((b, 3, S, S), dtype=np.float32)
        masks = np.zeros((b, n_max, S, S), np.float32)
        sem = rng.integers(0, t["n_categories"], (b, 1, 1)).repeat(S, 1).repeat(S, 2)
        valid = np.zeros((b, n_max), bool)
        for i in range(b):
            nv = int(n_valid[k * b + i])
            valid[i, :nv] = True
            for j in range(nv):  # a rectangle of 10-60% a side
                hh, ww = rng.integers(S // 10, S * 6 // 10, 2)
                y0, x0 = rng.integers(0, S - hh), rng.integers(0, S - ww)
                m = (((coords >= y0) & (coords < y0 + hh))[:, None]
                     & ((coords >= x0) & (coords < x0 + ww))[None, :])
                masks[i, j] = m
                sem[i][m] = rng.integers(0, t["n_categories"])
            if border:
                sem[i, :border] = t["ignore_index"]
                sem[i, :, :border] = t["ignore_index"]
        batch = {"image": image, "instance_masks": masks,
                 "instance_valid": valid, "semantic_mask": sem.astype(np.int32)}
        batch = {key: torch.from_numpy(v) for key, v in batch.items()}
        if torch.cuda.is_available():
            batch = {key: v.pin_memory() for key, v in batch.items()}
        pool.append(batch)
    return pool


def pieces(names: List[str]) -> List[tuple]:
    """(piece, parameter, rows) for each parameter, with the packed
    in_proj tensors of nn.MultiheadAttention's layout cut into the q, k and
    v projections they hold (a key's bias gets no gradient under softmax,
    and it is one third of its tensor)."""
    out = []
    for n in names:
        if n.endswith(("in_proj_weight", "in_proj_bias")):
            out += [(f"{n}[{p}]", n, i) for i, p in enumerate("qkv")]
        else:
            out.append((n, n, None))
    return out


def leaf_norms(tensors: Dict[str, torch.Tensor], cut: List[tuple]) -> np.ndarray:
    """The norm of each piece of `cut` (pieces())."""
    norms = []
    for _, n, i in cut:
        t = tensors[n]
        if i is not None:
            t = t.chunk(3)[i]
        norms.append(t.float().norm())
    return torch.stack(norms).cpu().numpy()


def gap(prog: np.ndarray, ref: np.ndarray, kept: np.ndarray) -> float:
    """The widest gap between two sets of leaf norms, over the kept leaves,
    each against the larger of its reference norm and the median leaf's."""
    floor = np.median(ref[kept])
    return float(np.max(np.abs(prog[kept] - ref[kept])
                        / np.maximum(ref[kept], floor)))


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.config["model"]
        self.t = cell.traffic
        self.device = cell.device
        self.names = [n for n, _, _, _ in ref_model.param_specs(self.cfg)]
        self.cut = pieces(self.names)
        t = self.t
        g = t["image_size"] // self.cfg["patch_size"]
        self.step_flops = sum(counts.train_step_flops(
            self.cfg, t["batch"], t["image_size"], t["n_categories"],
            t["n_max"]).values())
        self.attention_bound_s = counts.forward_attention_bound_s(
            self.cfg, t["batch"], (g, g))
        self.steps = 0

    # ---------------- the program ----------------

    def setup(self) -> None:
        from zutis_tpu_torch.engine import train_step as ts
        from zutis_tpu_torch.models.zutis import ZUTIS

        t, cfg, dev = self.t, self.cfg, self.device
        dtype = getattr(torch, self.cell.config["compute_dtype"])
        self.pool = make_pool(t, self.cell.seed)
        model = ZUTIS(**cfg, dtype=dtype, device=dev)
        weights.load_into(model, weights.make_weights(cfg, self.cell.seed, dev))
        text = weights.text_embeddings(t["n_categories"], cfg["text_dim"],
                                       self.cell.seed, dev)
        self.state = ts.TrainState.create(
            model, base_lr=t["base_lr"], n_iters=t["n_iters"],
            weight_decay=t["weight_decay"],
            encoder_lr_scale=t["encoder_lr_scale"])
        self.step = ts.make_train_step(model, text.cpu().numpy(),
                                       t["n_categories"],
                                       ignore_index=t["ignore_index"],
                                       device=dev)
        self.readings = self._first_steps()

    def _first_steps(self) -> dict:
        """The mix's first steps through the window's call, with what the
        check compares."""
        params = dict(self.state.model.named_parameters())
        losses, grads = [], None
        for k in range(self.t["warm_steps"]):
            m = self.step(self.state, self.pool[k])
            losses.append([m[key].item() for key in ("loss", "ce_loss",
                                                     "mask_loss")])
            if k == 0:
                # a moment the optimizer never made: it got no gradient
                moments = {n: self.state.optimizer.state.get(p, {}).get(
                    "exp_avg", torch.zeros_like(p)) for n, p in params.items()}
                grads = leaf_norms(moments, self.cut) / (1.0 - BETA1)
        start = weights.make_weights(self.cfg, self.cell.seed, self.device)
        change = leaf_norms({n: params[n].detach() - start[n]
                             for n in self.names}, self.cut)
        return {"losses": np.asarray(losses), "grads": grads,
                "change": change}

    def counters(self) -> Dict[str, float]:
        """The program's launch counters and the work of the steps
        dispatched so far (steps x a step's bound and products)."""
        from zutis_tpu_torch.ops.flash_attention import flash_attention
        from zutis_tpu_torch.ops.hungarian import batched_hungarian
        return {"flash_launches": flash_attention.launches,
                "matcher_launches": batched_hungarian.launches,
                "attention_bound_s": self.steps * self.attention_bound_s,
                "flops": self.steps * self.step_flops}

    def run_window(self, window) -> Outcome:
        t = self.t
        k = [t["warm_steps"]]
        pending: deque = deque()

        def one():
            m = self.step(self.state, self.pool[k[0] % t["pool"]])
            k[0] += 1
            self.steps += 1
            pending.append(m["loss"])
            if len(pending) > 2:  # read two steps late, as Trainer.fit
                pending.popleft().item()

        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        window.start()
        while window.measuring():
            one()
        sync()
        window.close()
        steps, secs = self.steps, window.window_s()
        while window.tracing():
            window.tick()
            one()
        sync()
        window.finish()
        return Outcome(
            end_to_end={"train_img_per_s": steps * t["batch"] / secs},
            attempted=steps, failed=0,
            layer={"flops": steps * self.step_flops, "window_s": secs})

    # ---------------- the check ----------------

    def reference_readings(self, precision: Precision) -> dict:
        """The plain reference's first steps from the same weights and
        batches, in float32 or in the control's precision."""
        t, cfg, dev = self.t, self.cfg, self.device
        if not hasattr(self, "pool"):  # the control runs without set-up
            self.pool = make_pool(t, self.cell.seed)
        P = weights.make_weights(cfg, self.cell.seed, dev)
        for p in P.values():
            p.requires_grad_(True)
        text = weights.text_embeddings(t["n_categories"], cfg["text_dim"],
                                       self.cell.seed, dev)
        opt = AdamW(P, t["base_lr"], t["n_iters"], t["weight_decay"],
                    t["encoder_lr_scale"])
        losses, grads = [], None
        for k in range(t["warm_steps"]):
            batch = {key: v.to(dev) for key, v in self.pool[k].items()}
            out = ref_model.forward(batch["image"], P, cfg, precision)
            loss, _ = ref_criterion.losses(out, batch, text,
                                           t["ignore_index"])
            g = torch.autograd.grad(loss["loss"], [P[n] for n in self.names])
            g = dict(zip(self.names, g))
            losses.append([loss[key].item() for key in ("loss", "ce_loss",
                                                        "mask_loss")])
            if k == 0:
                grads = leaf_norms(g, self.cut)
            del out, loss, batch
            opt.step(g)
            del g
        start = weights.make_weights(cfg, self.cell.seed, dev)
        change = leaf_norms({n: P[n].detach() - start[n] for n in self.names},
                            self.cut)
        return {"losses": np.asarray(losses), "grads": grads,
                "change": change}

    def free(self) -> None:
        for name in ("state", "step"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def numbers(self, got: dict, ref: dict) -> Dict[str, float]:
        """loss_gap, ce_gap, mask_loss_gap: the widest relative gap of a
        step's loss, of its cross-entropy and of its mask loss;
        grad_gap, update_gap: the widest gap of a leaf's norm (a piece of
        pieces()), over the leaves whose reference gradient is not nought
        to rounding (at least a thousandth of the median leaf's)."""
        kept = ref["grads"] >= 1e-3 * np.median(ref["grads"])
        rel = np.abs(got["losses"] - ref["losses"]) / np.abs(ref["losses"])
        return {"loss_gap": float(rel[:, 0].max()),
                "ce_gap": float(rel[:, 1].max()),
                "mask_loss_gap": float(rel[:, 2].max()),
                "grad_gap": gap(got["grads"], ref["grads"], kept),
                "update_gap": gap(got["change"], ref["change"], kept)}

    def detail(self) -> dict:
        """The losses side by side and the three widest leaves of each gap."""
        got, ref = self.readings, self.ref
        kept = ref["grads"] >= 1e-3 * np.median(ref["grads"])
        out = {"losses": got["losses"].tolist(),
               "ref_losses": ref["losses"].tolist(),
               "left_out": [c[0] for c, k in zip(self.cut, kept) if not k]}
        for key in ("grads", "change"):
            floor = np.median(ref[key][kept])
            rel = np.where(kept, np.abs(got[key] - ref[key])
                           / np.maximum(ref[key], floor), 0.0)
            out[key] = [[self.cut[i][0], float(rel[i]), float(got[key][i]),
                         float(ref[key][i])] for i in np.argsort(-rel)[:3]]
        return out

    def control_numbers(self) -> Dict[str, float]:
        """The reference in the control's precision, in the program's place."""
        ref = self.reference_readings(Precision())
        return self.numbers(self.reference_readings(Precision("fp8")), ref)

    def check(self) -> List[Comparison]:
        self.free()
        self.ref = self.reference_readings(Precision())
        nums = self.numbers(self.readings, self.ref)
        return [Comparison(k, v, float(self.cell.limits[k]))
                for k, v in nums.items() if k in self.cell.limits]
