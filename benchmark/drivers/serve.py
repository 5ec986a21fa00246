"""Serving traffic: the program's `InferenceServer` behind its queued API
(`start` / `submit` -> Future), seeded uint8 [3, S, S] requests.

  mode "open":   independent users. Requests arrive at `rate` a second by
                 a Poisson process: every seed has the same inter-arrival
                 gaps (the exponential's quantiles), in its own order. A
                 request is timed from when it was due to when its Future
                 resolved; one that never resolves counts as beyond every
                 latency. The generator's lag behind the schedule is
                 reported.
  mode "closed": `clients` callers, each resubmitting on its reply, so
                 that the backlog stays full; the rate is the requests
                 completed in the window over the window.

Requests due in the window are waited for after it, up to `grace`
seconds; with `--trace 1` the same traffic goes on through the traced
tail after the window, and its requests are served but not counted. The
window's server counters (batches, `infer` seconds) are read at its
close. Set-up warms one full batch through the same server.

The check draws `sample` completed requests from the seed, the longest
kept among them, and holds each request's semantic map and instances
against the plain reference run on its image (reference/instances.py):
semantic_gap, the widest margin by which the served category's text
logit lies below the reference's best at a pixel, and the instance gaps.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import counts, weights
from benchmark.harness import Comparison, Outcome
from benchmark.reference import instances as ref_instances
from benchmark.reference import model as ref_model
from benchmark.reference.precision import Precision

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _patch_finish(wrap):
    """A fault: the server's host finish of request j hands back wrap(its
    result, j). -> the undo."""
    from zutis_tpu_torch.engine.server import InferenceServer
    finish = InferenceServer._finish

    def faulty(self, out, j):
        return wrap(finish(self, out, j), j)
    InferenceServer._finish = faulty
    return lambda: setattr(InferenceServer, "_finish", finish)


def _drop_odd(res: dict, j: int) -> dict:
    if j % 2 == 0:
        return res
    return {"semantic": res["semantic"] * 0, "instances": []}


def _other(c):
    """Another category id than c, never the background's 0."""
    return np.where(c > 1, c - 1, c + 1)


def _alter(res: dict, j: int) -> dict:
    return {"semantic": _other(res["semantic"]),
            "instances": [dict(i, category_id=int(_other(i["category_id"])))
                          for i in res["instances"]]}


def _no_nms():
    """A fault: the server's NMS keeps every query that is not background
    and not empty. -> the undo."""
    from zutis_tpu_torch.engine import server
    nms = server.mask_nms

    def keep_all(masks, scores, category_ids, **kw):
        keep = (category_ids != 0) & masks.flatten(2).any(-1)
        return keep, scores.float()
    server.mask_nms = keep_all
    return lambda: setattr(server, "mask_nms", nms)


# faults the check has to catch, planted in the program; each -> its undo
FAULTS = {"half_batch": lambda: _patch_finish(_drop_odd),
          "altered": lambda: _patch_finish(_alter),
          "no_nms": _no_nms,
          # each answer cut to its first instance
          "keep_one": lambda: _patch_finish(
              lambda res, j: dict(res, instances=res["instances"][:1]))}


def arrival_gaps(n: int, rate: float, seed: int) -> np.ndarray:
    """n exponential inter-arrival gaps of mean 1 / rate: the same quantiles
    for every seed, in the seed's order."""
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    np.random.default_rng(seed + 4).shuffle(gaps)
    return gaps


def normalise(images: np.ndarray, device) -> torch.Tensor:
    x = torch.from_numpy(images).to(device).float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=device)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=device)[None, :, None, None]
    return (x - mean) / std


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.config["model"]
        self.t = cell.traffic
        self.device = cell.device
        t, S = self.t, self.t["image_size"]
        rng = np.random.default_rng(cell.seed + 2)
        self.pool = rng.integers(0, 256, (t["pool"], 3, S, S), dtype=np.uint8)
        g = S // self.cfg["patch_size"]
        self.forward_flops = sum(counts.forward_flops(
            self.cfg, t["batch"], (g, g), 1).values())
        self.forward_attention_s = counts.forward_attention_bound_s(
            self.cfg, t["batch"], (g, g))
        self.lock = threading.Lock()
        self.forwards = 0
        self.infer_s = 0.0
        self.results: Dict[int, dict] = {}
        self.last = None  # (id, answer) of the last request answered
        self.keep_every = 1

    def setup(self) -> None:
        from zutis_tpu_torch.engine.server import InferenceServer
        from zutis_tpu_torch.models.zutis import ZUTIS
        cfg, dev, t = self.cfg, self.device, self.t
        dtype = getattr(torch, self.cell.config["compute_dtype"])
        model = ZUTIS(**cfg, dtype=dtype, device=dev)
        weights.load_into(model, weights.make_weights(
            cfg, self.cell.seed, dev, matrix_dtype=dtype))
        text = weights.text_embeddings(t["n_categories"], cfg["text_dim"],
                                       self.cell.seed, dev).cpu().numpy()
        self.server = InferenceServer(
            model.eval(), text, image_size=t["image_size"],
            batch_size=t["batch"], threshold=t["threshold"],
            temperature=t["temperature"], nms_type=t["nms_type"],
            nms_threshold=t["nms_threshold"], max_wait_ms=t["max_wait_ms"],
            encode_rle=True, uint8_transport=True, device=dev)
        self._instrument()
        self.server.infer(list(self.pool[:t["batch"]]))
        self.forwards, self.infer_s = 0, 0.0

    def _instrument(self) -> None:
        """Spans on this server instance: each batch step's dispatch under
        the lock the traces open and close behind (so that a trace holds
        whole batches), each `infer` call timed."""
        server, step, infer = self.server, self.server.step, self.server.infer

        def locked_step(images):
            with self.lock:
                out = step(images)
                self.forwards += 1
            return out

        def timed_infer(images):
            t0 = time.perf_counter()
            out = infer(images)
            self.infer_s += time.perf_counter() - t0
            return out

        server.step, server.infer = locked_step, timed_infer

    def counters(self) -> Dict[str, float]:
        from zutis_tpu_torch.ops.flash_attention import flash_attention
        return {"flash_launches": flash_attention.launches,
                "server_batches": self.server.batches,
                "attention_bound_s": self.forwards * self.forward_attention_s,
                "flops": self.forwards * self.forward_flops}

    def run_window(self, window) -> Outcome:
        t = self.t
        server = self.server
        done: Dict[int, float] = {}
        futures: Dict[int, object] = {}  # the requests not yet answered
        due: Dict[int, float] = {}  # the window's requests
        # answers are kept for a seeded share of the requests only, as a
        # client would not hold them all
        expected = int(t.get("rate", 600.0) * window.seconds)
        self.keep_every = max(1, expected // (4 * t["sample"]))
        server.start()
        batches0 = server.batches
        window.start()
        t0 = window.t0
        end = t0 + window.seconds
        lag = 0.0
        if t["mode"] == "open":
            gaps = arrival_gaps(int(t["rate"] * window.seconds * 1.5) + 16,
                                t["rate"], self.cell.seed)
            i = 0
            for at in np.cumsum(gaps):
                if at >= window.seconds:
                    break
                wait = t0 + at - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                lag = max(lag, -wait)
                due[i] = t0 + at
                self._submit(i, done, futures)
                i += 1
            time.sleep(max(0.0, end - time.perf_counter()))
            window.close()
            at_close = (len(done), server.batches, self.infer_s)
            # the traced tail: arrivals go on at the same rate
            tail = np.cumsum(arrival_gaps(
                int(t["rate"] * (window.trace_seconds + window.gap_seconds)
                    * 4) + 16, t["rate"], self.cell.seed + 5))
            t1 = time.perf_counter()
            for at in tail:
                if not window.tracing():
                    break
                time.sleep(max(0.0, t1 + at - time.perf_counter()))
                self._submit(i, done, futures)
                i += 1
                window.tick()
        else:
            stop = threading.Event()
            nxt = [0]
            guard = threading.Lock()

            def launch():
                with guard:
                    i = nxt[0]
                    nxt[0] += 1
                now = time.perf_counter()
                if now < end:
                    due[i] = now
                self._submit(i, done, futures).add_done_callback(
                    lambda f: None if stop.is_set() else launch())

            for _ in range(t["clients"]):
                launch()
            while window.measuring():
                time.sleep(0.005)
            window.close()
            at_close = (len(done), server.batches, self.infer_s)
            while window.tracing():  # the traced tail
                time.sleep(0.005)
                window.tick()
            stop.set()
        deadline = end + t["grace"]
        for fut in list(futures.values()):
            try:
                fut.result(timeout=max(0.0, deadline - time.perf_counter()))
            except Exception:  # noqa: BLE001 - late past the grace, or the
                pass  # batch failed: either way the request counts failed
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        window.finish()
        server.stop()
        if t["mode"] == "open":
            print(f"serve: the generator ran {lag * 1e3:.3f} ms late at most",
                  file=sys.stderr)
        lat = np.array([(done[i] - due[i]) * 1e3 if i in done else np.inf
                        for i in sorted(due)])
        self.last_latencies = lat
        in_window = sum(1 for i in due if i in done and done[i] <= end)
        per_image = self.forward_flops / t["batch"]
        e2e = {"serve_img_per_s": in_window / window.seconds}
        if t["mode"] == "open":
            e2e["serve_p95_ms"] = float(np.percentile(lat, 95))
        served, batches, infer_s = at_close
        return Outcome(
            end_to_end=e2e, attempted=len(due),
            failed=sum(1 for i in due if i not in done),
            layer={"p50_ms": float(np.percentile(lat, 50)),
                   "batch_fill": served / max(1, batches - batches0)
                   / t["batch"],
                   "flops": in_window * per_image,
                   "window_s": window.seconds,
                   "served_flops": served * per_image,
                   "infer_s": infer_s, "generator_lag_s": lag})

    def _submit(self, i: int, done: Dict[int, float], futures: dict):
        fut = self.server.submit(self.pool[i % len(self.pool)])
        futures[i] = fut

        def finish(f):
            futures.pop(i, None)
            if not f.cancelled() and f.exception() is None:
                done[i] = time.perf_counter()
                if i % self.keep_every == self.cell.seed % self.keep_every:
                    self.results[i] = f.result()
                self.last = (i, f.result())
        fut.add_done_callback(finish)
        return fut

    # ---------------- the check ----------------

    def free(self) -> None:
        if hasattr(self, "server"):
            del self.server
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> List[int]:
        """`sample` of the kept answers, drawn from the seed, and the last
        request answered (the one that waited longest for the close)."""
        if self.last is not None:
            self.results[self.last[0]] = self.last[1]
        ids = sorted(self.results)
        rng = np.random.default_rng(self.cell.seed + 3)
        n = min(self.t["sample"], len(ids))
        pick = set(rng.choice(len(ids), n, replace=False).tolist())
        if ids:
            pick.add(len(ids) - 1)
        return [ids[j] for j in sorted(pick)]

    def program_answers(self, ids: List[int]) -> Dict[int, dict]:
        out = {}
        for i in ids:
            r = self.results[i]
            insts = []
            for inst in r["instances"]:
                h, w = inst["segmentation"]["size"]
                insts.append({"category": int(inst["category_id"]),
                              "score": float(inst["score"]),
                              "mask": ref_instances.rle_decode(
                                  inst["segmentation"]["counts"], h, w)})
            out[i] = {"semantic": np.asarray(r["semantic"]),
                      "instances": insts}
        return out

    def reference_decodes(self, ids: List[int], precision: Precision
                          ) -> Dict[int, tuple]:
        """request -> (text logits [n, h, w], the decode, its kept
        queries), in chunks of a batch."""
        t, cfg, dev = self.t, self.cfg, self.device
        P = weights.served_weights(
            cfg, self.cell.seed, dev,
            getattr(torch, self.cell.config["compute_dtype"]))
        text = weights.text_embeddings(t["n_categories"], cfg["text_dim"],
                                       self.cell.seed, dev)
        out: Dict[int, tuple] = {}
        with torch.no_grad():
            for s in range(0, len(ids), t["batch"]):
                chunk = ids[s:s + t["batch"]]
                x = normalise(self.pool[[i % len(self.pool) for i in chunk]],
                              dev)
                fwd = ref_model.forward(x, P, cfg, precision,
                                        last_layer_only=True)
                for j, i in enumerate(chunk):
                    tokens = fwd["patch_tokens"][j]
                    logits = torch.einsum("nc,hwc->nhw", text, tokens)
                    ref = ref_instances.decode(
                        fwd["mask_proposals"][j, -1], tokens, text,
                        t["threshold"], t["temperature"])
                    out[i] = (logits.cpu().numpy(), ref, ref_instances.nms(
                        ref["masks"], ref["score"], ref["category"],
                        t["nms_threshold"]))
        return out

    @staticmethod
    def kept_answers(decodes: Dict[int, tuple]) -> Dict[int, dict]:
        """A decode's semantic map and kept instances as answers (the
        control's, put in the program's place)."""
        return {i: {"semantic": logits.argmax(0),
                    "instances": [{"category": int(ref["category"][q]),
                                   "score": float(ref["score"][q]),
                                   "mask": ref["masks"][q]}
                                  for q in kept]}
                for i, (logits, ref, kept) in decodes.items()}

    def numbers(self, answers: Dict[int, dict], decodes: Dict[int, tuple]
                ) -> Dict[str, float]:
        """The widest of each image's numbers (the kept counts: their
        sums)."""
        worst = {"semantic_gap": 0.0, "mask_gap": 0.0, "instance_gap": 0.0,
                 "nms_overlap": 0.0, "kept_missed": 0.0, "kept_clear": 0.0}
        for i, got in answers.items():
            logits, ref, kept = decodes[i]
            sem = got["semantic"].astype(np.int64)
            inside = (sem >= 0) & (sem < len(logits))
            served = np.take_along_axis(logits, np.where(inside, sem, 0)[None],
                                        0)[0]
            # a category that does not exist reads as the widest gap that
            # cosines allow
            gap = np.where(inside, logits.max(0) - served, 2.0)
            worst["semantic_gap"] = max(worst["semantic_gap"],
                                        float(gap.max()))
            gaps = ref_instances.compare(got["instances"], ref, kept,
                                         self.t["nms_threshold"])
            counts = {k: worst[k] + gaps.pop(k)
                      for k in ("kept_missed", "kept_clear")}
            worst.update({k: max(worst[k], v) for k, v in gaps.items()})
            worst.update(counts)
        return worst

    def control_numbers(self) -> Dict[str, float]:
        """The reference in the control's precision, in the program's place,
        on `sample` requests of the pool drawn from the seed."""
        rng = np.random.default_rng(self.cell.seed + 3)
        ids = sorted(rng.choice(len(self.pool), self.t["sample"],
                                replace=False).tolist())
        ref = self.reference_decodes(ids, Precision())
        return self.numbers(
            self.kept_answers(self.reference_decodes(ids, Precision("fp8"))),
            ref)

    def detail(self) -> dict:
        """The instance of the widest score gap, explained."""
        worst = (-1.0, None)
        for i, got in self.answers.items():
            insts = got["instances"] if isinstance(got, dict) else got
            ref = self.decodes[i][-2]
            for inst in insts:
                gap = ref_instances.compare([inst], ref, [], 1.0)[
                    "instance_gap"]
                if gap > worst[0]:
                    worst = (gap, {"id": i, "gap": gap,
                                   **ref_instances.explain([inst], ref)[0]})
        return worst[1] or {}

    def check(self) -> List[Comparison]:
        ids = self.sample()
        answers = self.program_answers(ids)
        self.results = {}
        self.free()
        self.answers = answers
        self.decodes = self.reference_decodes(ids, Precision())
        nums = self.read = self.numbers(answers, self.decodes)
        return [Comparison(k, v, float(self.cell.limits[k]))
                for k, v in nums.items() if k in self.cell.limits]
