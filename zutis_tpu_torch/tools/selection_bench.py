"""The two selection loops on the card: the NMS rounds (csrc/nms.cu) and
the matcher (csrc/hungarian.cu) against another checkout's, in turns, with
the serving and eval steps around NMS; and copies of the sources with one
design choice undone.

    python -m zutis_tpu_torch.tools.selection_bench [--against DIR] \\
        [--ablations nms_shuffle_max,matcher_shuffle_min,nms_warp_loads]

- `--against DIR`: a checkout of another commit (`git archive` of it,
  unpacked into a directory git ignores). Each checkout is measured in a
  process of its own, in the order other, this, this, other:
  - the matcher on seeded `[48, 10, 100]` f32 costs (the training step's
    shape), uniform and with one column profile shared by every row: device
    ms;
  - `mask_nms` on seeded rectangles at serving's `[8, 100]` over the 24 x 24
    token grid (919 categories) and eval's `[32, 100]` over the 512 x 640
    bucket (81 categories): device ms in a CUDA graph (the IoU product and
    the rounds), host ms with a sync, `pairwise_iou`'s device ms, and the
    rounds alone where the checkout has `nms_rounds`;
  - serving: ZUTIS ViT-B/16 (seeded, bf16 matrices), 384 px, batch 8, 919
    classes, as `chip_smoke.py` serves it: sync `infer` ms a batch, the
    step's device busy and its kernels (torch.profiler);
  - the bucketed eval (batch 32, 512 x 640, 81 classes): img/s at depth 1
    and 2 (`instance_eval_bench.run`), the step's, decode's and mask_nms's
    host ms, the step's device busy and its kernels.
- `--ablations`: this checkout's two kernels built from copies of csrc/
  with one edit each (ABLATIONS), timed in turns with the unedited source
  at the kernel shapes, twice.

Device times: 20 calls captured in a CUDA graph, the median of 21 replays
(3 calls and 5 replays for calls that hold the plain loop). Every record
carries nvidia-smi's SM clock, power draw and power limit. Prints one JSON
line per measurement. Needs a card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence
from unittest import mock

from zutis_tpu_torch.tools.flash_f32_bench import device_ms, nvcc

# a 5-level butterfly of shuffles over (key, index) in place of the two
# redux.sync reductions of a warp's first maximum / minimum
SHUFFLE_MAX = """  uint32_t top = key;
  int idx = index;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const uint32_t k2 = __shfl_xor_sync(0xffffffffu, top, offset);
    const int i2 = __shfl_xor_sync(0xffffffffu, idx, offset);
    if (k2 > top || (k2 == top && i2 < idx)) {
      top = k2;
      idx = i2;
    }
  }
  *first = idx;
  return top;
"""
SHUFFLE_MIN = """  uint32_t least = key;
  int col = column;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const uint32_t k2 = __shfl_xor_sync(0xffffffffu, least, offset);
    const int c2 = __shfl_xor_sync(0xffffffffu, col, offset);
    if (k2 < least || (k2 == least && c2 < col)) {
      least = k2;
      col = c2;
    }
  }
  return col;
"""
# one design choice undone each: the warps' reductions as shuffles; the IoU
# block loaded by the warp's own loads instead of one bulk copy; each
# round's IoU row read from device memory at Q <= 128; and the serial
# loops taken out (no NMS round, no matcher row), which leaves each
# kernel's launch, loads and stores
ABLATIONS = {
    "nms_shuffle_max": ("nms.cu", [(
        """  const uint32_t top = __reduce_max_sync(0xffffffffu, key);
  *first = static_cast<int>(__reduce_min_sync(0xffffffffu, key == top ? static_cast<uint32_t>(index) : 0xffffffffu));
  return top;
""", SHUFFLE_MAX)]),
    "matcher_shuffle_min": ("hungarian.cu", [(
        """  const uint32_t least = __reduce_min_sync(0xffffffffu, key);
  return static_cast<int>(__reduce_min_sync(0xffffffffu, key == least ? static_cast<uint32_t>(column) : 0xffffffffu));
""", SHUFFLE_MIN)]),
    "nms_warp_loads": ("nms.cu", [(
        "if ((reinterpret_cast<uintptr_t>(iou_g) & 15) == 0 && (bytes & 15) == 0) {",
        "if (false) {")]),
    "nms_device_rows": ("nms.cu", [(
        "if (q <= 128) return launch<4, true>(p, b, s);",
        "if (q <= 128) return launch<4, false>(p, b, s);")]),
    "nms_no_rounds": ("nms.cu", [(
        "for (int round = 0; round < q; ++round) {",
        "for (int round = 0; round < 0; ++round) {")]),
    "matcher_no_rows": ("hungarian.cu", [(
        "for (int cur = 0; cur < R; ++cur) {",
        "for (int cur = 0; cur < 0; ++cur) {")]),
}
# NMS shapes: label -> (images, candidates, mask height, width, categories)
NMS_SHAPES = {
    "serving [8,100]": (8, 100, 24, 24, 919),
    "eval [32,100]": (32, 100, 512, 640, 81),
}
MATCHER_SHAPE = (48, 10, 100)


def host_ms(fn, reps=5):
    """Median host-clock ms of `fn` ending in a synchronise, after one
    warm-up call."""
    import statistics
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def smi() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def nms_inputs(b, q, h, w, n_categories, seed=0):
    """Seeded rectangles on the card: masks [b, q, h, w] bool, scores
    [b, q] f32, category_ids [b, q] int64 (0 the background)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    y0, x0 = rng.randint(0, h - 2, (b, q)), rng.randint(0, w - 2, (b, q))
    hs = rng.randint(2, max(3, h // 3), (b, q))
    ws = rng.randint(2, max(3, w // 3), (b, q))
    t = {k: torch.from_numpy(v).cuda()[..., None, None]
         for k, v in dict(y0=y0, x0=x0, y1=y0 + hs, x1=x0 + ws).items()}
    ys = torch.arange(h, device="cuda")[:, None]
    xs = torch.arange(w, device="cuda")[None, :]
    masks = (ys >= t["y0"]) & (ys < t["y1"]) & (xs >= t["x0"]) & (xs < t["x1"])
    scores = torch.from_numpy(rng.rand(b, q).astype(np.float32)).cuda()
    cats = torch.from_numpy(rng.randint(0, n_categories, (b, q))).cuda()
    return masks, scores, cats


def kernel_times(shapes) -> dict:
    """The matcher's and NMS's times (see the module's note)."""
    import numpy as np
    import torch

    from zutis_tpu_torch.ops import hungarian as hg
    from zutis_tpu_torch.ops import nms

    out = {}
    rng = np.random.RandomState(0)
    p, r, c = MATCHER_SHAPE
    # uniform in [0, 3); one column profile that every row shares, plus a
    # tenth of it in noise (every row wants the same columns: the longest
    # augmenting chains)
    costs = {"random": rng.rand(p, r, c) * 3,
             "one column profile": rng.rand(1, 1, c) * 3
             + rng.rand(p, r, c) * 0.3}
    for name, cost in costs.items():
        cost = torch.from_numpy(cost.astype(np.float32)).cuda()
        out[f"matcher {name} {list(MATCHER_SHAPE)}"] = device_ms(
            lambda: hg.batched_hungarian(cost))
    for label, (b, q, h, w, n_cat) in shapes.items():
        masks, scores, cats = nms_inputs(b, q, h, w, n_cat)
        with torch.inference_mode():
            keep, _ = nms.mask_nms(masks, scores, cats)
            out[f"kept {label}"] = int(keep.sum())
            out[f"mask_nms {label}"] = device_ms(
                lambda: nms.mask_nms(masks, scores, cats), calls=3, reps=5)
            out[f"mask_nms host {label}"] = host_ms(
                lambda: nms.mask_nms(masks, scores, cats))
            out[f"pairwise_iou {label}"] = device_ms(
                lambda: nms.pairwise_iou(masks), calls=3, reps=5)
            if hasattr(nms, "nms_rounds"):
                iou, areas = nms.pairwise_iou(masks)
                out[f"rounds {label}"] = device_ms(
                    lambda: nms.nms_rounds(iou, areas, scores, cats))
        del masks
        torch.cuda.empty_cache()
    return out


def step_profile(fn) -> tuple:
    """(device busy ms, device events) of one call of `fn` as
    torch.profiler sees them, after a warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    return sum(e.time_range.elapsed_us() for e in events) / 1e3, len(events)


def path_times() -> dict:
    """Serving's and the bucketed eval's times (see the module's note)."""
    import numpy as np
    import torch

    from zutis_tpu_torch.engine import batched_eval as BE
    from zutis_tpu_torch.engine.server import InferenceServer
    from zutis_tpu_torch.ops import nms
    from zutis_tpu_torch.tools import instance_eval_bench as eb

    out = {}
    model = eb.build_model(eb.VIT_B16, torch.device("cuda"))
    rng = np.random.RandomState(0)
    text = rng.randn(919, 512).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    images = [rng.randn(3, 384, 384).astype(np.float32) for _ in range(16)]
    x = torch.from_numpy(np.stack(images[:8])).cuda()
    with torch.inference_mode():
        proposals = model(x, inference=True)["mask_proposals"][:, -1]
    thr = float(torch.quantile(proposals.flatten()[::7].float(), 0.9))
    server = InferenceServer(model, text, image_size=384, batch_size=8,
                             threshold=thr, max_wait_ms=50,
                             device=torch.device("cuda"))
    out["serving infer ms a batch"] = host_ms(lambda: server.infer(images)) / 2
    with torch.inference_mode():
        busy, n = step_profile(lambda: server.step(x))
    out["serving step busy ms"], out["serving step kernels"] = busy, n

    text = eb.text_embeddings(eb.N_CATEGORIES, 512)
    text_d = torch.from_numpy(text).cuda()
    sizes = eb.bench_sizes(32)
    rng = np.random.RandomState(4)
    u8 = [rng.randint(0, 256, (3, h, w)).astype(np.uint8) for h, w in sizes]
    padded, grid, pix = BE.pad_batch(u8, eb.SHAPE, 32, 16, np.uint8)
    with torch.inference_mode():
        xe = BE._normalise_u8(torch.from_numpy(padded).cuda())
        fwd = model.forward_padded(xe, grid)
        thr = float(torch.quantile(
            fwd["mask_proposals"][:, -1].flatten()[::97].float(), 0.9))
        res = BE.decode_instances(fwd, text_d, pix, eb.SHAPE, thr)
        out["eval decode ms"] = host_ms(lambda: BE.decode_instances(
            fwd, text_d, pix, eb.SHAPE, thr))
        out["eval nms ms"] = host_ms(lambda: nms.mask_nms(
            res["masks"], res["scores"], res["category_ids"]))
    del fwd, res
    step = BE.make_instance_step(model, text, eb.SHAPE, threshold=thr,
                                 uint8_input=True, semantic_mode="none",
                                 device=torch.device("cuda"))
    out["eval step ms"] = host_ms(lambda: step(padded, grid, pix))
    with torch.inference_mode():
        busy, n = step_profile(lambda: step(padded, grid, pix))
    out["eval step busy ms"], out["eval step kernels"] = busy, n
    for depth in (1, 2):
        out[f"eval img/s depth {depth}"] = eb.run(
            32, "counts", 12, depth, "cuda", model=model,
            threshold=thr)["value"]
    return out


def measure(plan: dict) -> dict:
    """The plan's measurements in this process's checkout."""
    out = kernel_times(plan["nms_shapes"])
    out.update(path_times())
    out["nvidia-smi"] = smi()
    return out


def timer_script() -> str:
    """`measure` as a `python -c` script: run from a checkout's root, it
    imports that checkout's package; argv[1] holds the plan as JSON."""
    return "\n\n".join(
        ["import json, sys", f"MATCHER_SHAPE = {MATCHER_SHAPE!r}",
         *(inspect.getsource(f) for f in (
             device_ms, host_ms, smi, nms_inputs, kernel_times,
             step_profile, path_times, measure)),
         "print(json.dumps(measure(json.loads(sys.argv[1]))))"])


def _emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def time_checkout(root: Path, plan: dict) -> dict:
    """`measure(plan)` in a process of its own, run from `root`."""
    proc = subprocess.run(
        [sys.executable, "-c", timer_script(), json.dumps(plan)],
        cwd=root, capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {root} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def ablated_source(name: str, csrc: Path, into: Path) -> Path:
    """A copy of csrc/ in `into` with ablation `name` applied; the copy's
    edited source. Raises if an edit no longer matches the source."""
    file, edits = ABLATIONS[name]
    shutil.rmtree(into, ignore_errors=True)
    shutil.copytree(csrc, into)
    path = into / file
    text = path.read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"ablation {name}: the source no longer holds "
                             f"{old.strip()[:60]!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return path


def run_ablations(names: Sequence[str], rounds: int = 2) -> None:
    """Each ablation's library and the unedited ones, timed in turns at
    the kernel shapes within this process, `rounds` times."""
    from zutis_tpu_torch.ops import _build
    from zutis_tpu_torch.ops import hungarian as hg
    from zutis_tpu_torch.ops import nms

    modules = {"nms.cu": nms, "hungarian.cu": hg}
    work = _build.BUILD_DIR / "selection_ablations"
    work.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in ["none", *names]:
        libs[name] = {}
        for file, module in modules.items():
            if name == "none" or ABLATIONS[name][0] == file:
                source = (module.SOURCE if name == "none" else
                          ablated_source(name, _build.CSRC, work / name))
                lib = ctypes.CDLL(str(nvcc(source, work / f"lib_{name}_{file}.so")))
                lib.zutis_cuda_error_string.restype = ctypes.c_char_p
                lib.zutis_cuda_error_string.argtypes = [ctypes.c_int]
                module._bind(lib)
                libs[name][module.SOURCE] = lib
            else:
                libs[name][module.SOURCE] = None
    order = list(libs)
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            chosen = {src: lib or libs["none"][src]
                      for src, lib in libs[name].items()}
            with mock.patch.object(_build, "load",
                                   lambda source, *a: chosen[source]):
                _emit({"ablation": name, "round": r,
                       "ms": kernel_times(NMS_SHAPES), "nvidia-smi": smi()})


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path,
                        help="another checkout to time in turns with this one")
    parser.add_argument("--ablations", default="",
                        help=f"comma-separated, of {', '.join(ABLATIONS)}")
    args = parser.parse_args(argv)
    names = [n for n in args.ablations.split(",") if n]
    unknown = set(names) - set(ABLATIONS)
    if unknown:
        parser.error(f"unknown ablations {sorted(unknown)}")
    here = Path(__file__).resolve().parents[2]
    if args.against is not None:
        other = args.against.resolve()
        plan = {"nms_shapes": NMS_SHAPES}
        for who in ("other", "this", "this", "other"):
            root = other if who == "other" else here
            _emit({"checkout": who, "ms": time_checkout(root, plan)})
    if names:
        run_ablations(names)


if __name__ == "__main__":
    main()
