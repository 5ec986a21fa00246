"""Smoke run of the PyTorch/CUDA port (zutis_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, `nvcc` and
PyTorch built for CUDA. It imports torch, numpy and zutis_tpu_torch only.

  1. Card and build: requires CUDA, prints the card's name and power limit,
     builds the flash-attention and attention-probe kernels from
     zutis_tpu_torch/csrc with nvcc for sm_90a (one nvcc per source, started
     together), prints ptxas's registers and spills, and turns TF32 off for
     matmuls and cuDNN.
  2. Flash kernel against its plain version on the card, at the three
     attention shapes of the serving path (batch 8, bf16), a ragged case and
     a kv_mask case with an all-masked item (plus f32 inputs); times the
     kernel, the plain version and F.scaled_dot_product_attention (a
     yardstick only: the port never calls it) with CUDA events.
  3. Probe kernels against their plain versions on the card in bf16: every
     family, layout, sum mode, exp mode and the dots-only kt, at the tuning
     tool's shape [64,12,577,577,64], the serving encoder shape, a ragged
     shape and a d = 96 shape; the three `single` layouts must come out bit
     for bit alike. Times each kernel at the two 577 shapes beside its plain
     version, its bound, SDPA and flash_attention.
  4. The tuning path: zutis_tpu_torch.tools.kernel_tune.run for every
     variant at the tool's shape, with every launch count set to 0 before and
     read after; each variant must print RESULT_OK, and the exact ones must
     stay within 2e-2 of an f32 softmax.
  5. Serving at full width: ZUTIS ViT-B/16 (seeded random weights, bf16
     matrices) behind InferenceServer(image_size=384, batch_size=8), 20
     requests through start/submit/stop plus one synchronous infer; checks
     the outputs, that every batch forward launched the flash kernel 24
     times and no probe kernel, the kernel path against the "torch"
     attention path, and the instance decode against a CPU rerun; reports
     the serving rate.

Prints the kernel record and the card on lines of their own, then, as the
last line, {"ok": true, "device": {...}}. Exits non-zero, with no result
line, on any failure or without a card.
"""
from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from zutis_tpu_torch.engine.server import InferenceServer
from zutis_tpu_torch.models.layers import MultiHeadAttention
from zutis_tpu_torch.models.zutis import ZUTIS
from zutis_tpu_torch.ops import attention_probes as ap
from zutis_tpu_torch.ops import flash_attention as fa
from zutis_tpu_torch.ops import rle
from zutis_tpu_torch.ops.nms import mask_nms
from zutis_tpu_torch.postproc.instance import classify_proposals
from zutis_tpu_torch.tools import kernel_tune
from zutis_tpu_torch.tools.kernel_tune import bound

BATCH = 8
IMAGE_SIZE = 384
N_CATEGORIES = 919
VIT_B16 = dict(width=768, encoder_layers=12, encoder_heads=12, patch_size=16,
               text_dim=512, input_resolution=224, n_queries=100,
               n_decoder_layers=6, n_heads=8)
# (name, [b, h, sq, sk, d], launches per batch forward) at 384 px, batch 8
MAIN_SHAPES = [
    ("encoder self", (BATCH, 12, 577, 577, 64), 12),
    ("decoder self", (BATCH, 8, 100, 100, 96), 6),
    ("decoder cross", (BATCH, 8, 100, 2304, 96), 6),
]
LAUNCHES_PER_FORWARD = sum(n for _, _, n in MAIN_SHAPES)
PROBES = {  # kernel name -> (wrapper, plain version, TPU kernel body)
    "single_attention": (ap.single_attention, ap.single_attention_reference,
                         "tools/pallas_tune.py:54"),
    "fastsm_attention": (ap.fastsm_attention, ap.fastsm_attention_reference,
                         "tools/pallas_tune.py:173"),
    "kt_attention": (ap.kt_attention, ap.kt_attention_reference,
                     "tools/pallas_tune.py:252"),
}
# (kernel, label, options): every family, layout, sum mode and exp mode
PROBE_CONFIGS = (
    [("single_attention", f"single {hp}", dict(heads_per_cell=hp))
     for hp in ap.HEADS_PER_CELL]
    + [("single_attention", f"single {hp} {m}", dict(heads_per_cell=hp, exp_mode=m))
       for hp in ("unroll", "grid") for m in ("bf16", "mul")]
    + [("fastsm_attention", f"fastsm {sm}" + ("" if m == "exp" else f" {m}"),
        dict(sum_mode=sm, exp_mode=m))
       for sm in ap.SUM_MODES for m in ap.EXP_MODES]
    + [("kt_attention", "kt" + ("" if m == "exp" else f" {m}"),
        dict(exp_mode=m, dots_only=False)) for m in ap.EXP_MODES]
    + [("kt_attention", "kt dots-only", dict(exp_mode="exp", dots_only=True))]
)
PROBE_SHAPES = [
    ("tool", kernel_tune.SHAPE),
    ("encoder", (BATCH, 12, 577, 577, 64)),
    ("ragged", (2, 3, 130, 260, 64)),
    ("d96", (2, 4, 100, 300, 96)),
]
PROBE_TIMED_SHAPES = ("tool", "encoder")
# kernel_tune runs of the tuning path: every variant, plus probe modes
TUNE_RUNS = ([(v, "exp", False) for v in kernel_tune.VARIANTS]
             + [("kt", "exp", True), ("single", "mul", False),
                ("fastsm-mxu", "bf16", False)])
TOL_BF16 = 2e-2  # bf16 outputs (8-bit mantissa) against the f32 plain version
TOL_F32 = 1e-4   # f32 inputs take hi/lo bf16 splits (~16 mantissa bits)
MIN_SEMANTIC_AGREEMENT = 0.985
SEMANTIC_SLACK = 0.002  # 0.2 points: ~37 of the 18,432 pixels of a batch


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, calls: int = 20, reps: int = 21, warmup: int = 3) -> float:
    """Device ms per call of `fn`: `calls` back-to-back calls captured in a
    CUDA graph, the graph replayed `reps` times between CUDA events; the
    median replay over `calls`. The graph keeps the host's per-call Python
    overhead out of the device time. Inputs stay L2-warm."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def host_ms(fn, device: torch.device, reps: int = 10, warmup: int = 2) -> float:
    """Median host-clock time of `fn` ending in a device synchronise."""
    def synced():
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
    for _ in range(warmup):
        synced()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        synced()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_card() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, together
        builds = [pool.submit(m.build) for m in (fa, ap)]
        results = [b.result() for b in builds]
    print(f"build: both libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for path, seconds, log in results:
        print(f"build: {path.name} in {seconds:.1f} s", flush=True)
        for line in log.splitlines():  # registers and spills of each kernel
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"build: {line.strip()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    return card


def _inputs(gen, b, h, sq, sk, d, dtype):
    return [torch.randn(b, h, s, d, generator=gen, device="cuda").to(dtype)
            for s in (sq, sk, sk)]


def phase_kernel():
    """Kernel against its plain version; per-shape times and bounds."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = 0.0
    cases = [(name, shape, None, torch.bfloat16) for name, shape, _ in MAIN_SHAPES]
    cases += [("ragged", (1, 1, 130, 260, 64), None, torch.bfloat16),
              ("kv_mask", (3, 8, 64, 200, 96), "mask", torch.bfloat16),
              ("kv_mask f32", (3, 8, 64, 200, 96), "mask", torch.float32),
              ("ragged f32", (2, 12, 77, 333, 64), None, torch.float32)]
    for name, (b, h, sq, sk, d), masked, dtype in cases:
        q, k, v = _inputs(gen, b, h, sq, sk, d, dtype)
        mask = None
        if masked:
            mask = (torch.rand(b, sk, generator=gen, device="cuda") > 0.3).int()
            mask[1] = 0  # an item with no valid key
        got = fa.flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        want = fa.flash_attention_reference(q.float(), k.float(), v.float(), mask)
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        err = (got.float() - want).abs().max().item()
        rel = err / max(want.abs().max().item(), 1e-30)
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        print(f"kernel check {name} {[b, h, sq, sk, d]} {str(dtype)[6:]}: "
              f"max_abs_err {err:.3e} max_rel_err {rel:.3e} (tol {tol})",
              flush=True)
        check(err <= tol, f"{name}: kernel disagrees with its plain version")
        if masked:
            check(bool((got[1] == 0).all()), f"{name}: all-masked item not zero")
        max_err = max(max_err, err)

    rows = []
    for name, (b, h, sq, sk, d), per_forward in MAIN_SHAPES:
        q, k, v = _inputs(gen, b, h, sq, sk, d, torch.bfloat16)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v))
        plain_ms = cuda_ms(lambda: fa.flash_attention_reference(q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by = bound(b, h, sq, sk, d)
        rows.append(dict(name=name, shape=[b, h, sq, sk, d],
                         per_forward=per_forward, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        print(f"kernel time {name} {[b, h, sq, sk, d]}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound",
              flush=True)
    return max_err, rows


def _probe_kernel_only(label, kw, q, k, v):
    """The call that `label` times: the probe wrapper, or for kt the kernel
    alone on a K^T made beforehand."""
    if label.startswith("kt"):
        kt = ap.transpose_keys(k)
        return lambda: ap.kt_attention_kernel(q, kt, v, 128, **kw)
    wrapper = PROBES[next(n for n, lab, _ in PROBE_CONFIGS if lab == label)][0]
    return lambda: wrapper(q, k, v, 128, **kw)


def phase_probes():
    """Each probe kernel, layout and mode against its plain version in bf16;
    the `single` layouts bit for bit against each other; times at the two
    577-token shapes."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = {name: 0.0 for name in PROBES}
    max_rel = {name: 0.0 for name in PROBES}
    timings = []
    for shape_name, (b, h, sq, sk, d) in PROBE_SHAPES:
        q, k, v = _inputs(gen, b, h, sq, sk, d, torch.bfloat16)
        outs = {}
        for kernel, label, kw in PROBE_CONFIGS:
            wrapper, reference, _ = PROBES[kernel]
            before = wrapper.launches
            got = wrapper(q, k, v, 128, **kw)
            torch.cuda.synchronize()
            check(wrapper.launches == before + 1, f"{label}: no kernel launch")
            want = reference(q, k, v, **kw).float()
            check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
            err = (got.float() - want).abs().max().item()
            # relative to the largest |output|: "mul" drives single's output
            # to ~1e-30 and the dots-only probe's reaches ~100, where one
            # flipped bf16 rounding of p moves a sum of 577 products
            rel = err / want.abs().max().item()
            print(f"probe check {shape_name} {[b, h, sq, sk, d]} {label}: "
                  f"max_abs_err {err:.3e} max_rel_err {rel:.3e} (tol "
                  f"{TOL_BF16})", flush=True)
            check(rel <= TOL_BF16,
                  f"{label} at {shape_name}: kernel disagrees with its plain version")
            max_err[kernel] = max(max_err[kernel], err)
            max_rel[kernel] = max(max_rel[kernel], rel)
            outs[label] = got
            del want
        same = (torch.equal(outs["single unroll"], outs["single batched"])
                and torch.equal(outs["single unroll"], outs["single grid"]))
        print(f"probe check {shape_name}: single unroll/batched/grid "
              f"bit-identical: {same}", flush=True)
        check(same, f"single layouts differ at {shape_name}")
        del outs
        if shape_name in PROBE_TIMED_SHAPES:
            timings.append(_time_probes(shape_name, q, k, v))
        del q, k, v
        torch.cuda.empty_cache()
    return max_err, max_rel, timings


def _time_probes(shape_name, q, k, v):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bound_ms, bound_by = bound(b, h, sq, sk, d)
    # the plain versions hold [b, h, sq, 640] f32 logits: fewer calls at b 64
    plain_calls = dict(calls=3, reps=5, warmup=1) if b > BATCH else {}
    row = dict(name=shape_name, shape=[b, h, sq, sk, d], bound_ms=bound_ms,
               bound_by=bound_by,
               library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
               flash_ms=cuda_ms(lambda: fa.flash_attention(q, k, v)),
               transpose_ms=cuda_ms(lambda: ap.transpose_keys(k)),
               plain_ms={name: cuda_ms(lambda: ref(q, k, v), **plain_calls)
                         for name, (_, ref, _) in PROBES.items()},
               ms={})
    for _, label, kw in PROBE_CONFIGS:
        if kw.get("exp_mode", "exp") == "exp":
            row["ms"][label] = cuda_ms(_probe_kernel_only(label, kw, q, k, v))
    row["ms"]["kt with transpose"] = cuda_ms(lambda: ap.kt_attention(q, k, v, 128))
    for label, ms in row["ms"].items():
        print(f"probe time {shape_name} {row['shape']} {label}: kernel "
              f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms:.1%} of bound", flush=True)
    print(f"probe time {shape_name} {row['shape']}: plain "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in row["plain_ms"].items())
          + f"; sdpa {row['library_ms']:.4f} ms; flash_attention "
          f"{row['flash_ms']:.4f} ms; K transpose {row['transpose_ms']:.4f} ms",
          flush=True)
    return row


def phase_tune():
    """The tuning path: kernel_tune.run for every variant at the tool's
    shape, with every launch count set to 0 before and read after."""
    inputs = kernel_tune.make_inputs(kernel_tune.SHAPE, "cuda")
    counted = {"flash_attention": fa.flash_attention,
               **{name: w for name, (w, _, _) in PROBES.items()}}
    for w in counted.values():
        w.launches = 0
    results = []
    for variant, exp_mode, dots_only in TUNE_RUNS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = kernel_tune.run(variant, 128, exp_mode, dots_only,
                                  inputs=inputs)
        sys.stdout.write(buf.getvalue())
        check(any(line.startswith(f"RESULT_OK variant={variant} block_q=128 ms=")
                  for line in buf.getvalue().splitlines()),
              f"kernel_tune {variant}: no RESULT_OK line")
        if res["exact"]:
            check(res["max_err"] <= kernel_tune.TOL_BF16,
                  f"kernel_tune {variant}: RESULT_MAXERR {res['max_err']} over "
                  f"{kernel_tune.TOL_BF16}")
        results.append(res)
    launches = {name: w.launches for name, w in counted.items()}
    print(f"tune: launches in {len(TUNE_RUNS)} kernel_tune runs: "
          f"{json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        check(n > 0, f"the tuning path never launched {name}")
    del inputs
    torch.cuda.empty_cache()
    return launches, results


def profile_device(fn, device: torch.device, top: int = 12):
    """Device busy ms of one call of `fn` (sum of kernel durations seen by
    torch.profiler) and the `top` kernels by device time, as
    [name, ms, count]. (None, []) where the profiler sees no device time."""
    if device.type != "cuda":
        return None, []
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name:
        print("profile: the profiler saw no device time", flush=True)
        return None, []
    busy = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    for name, (ms, n) in ranked:
        print(f"profile: {ms:9.4f} ms {n:5d}x {name[:110]}", flush=True)
    print(f"profile: device busy {busy:.4f} ms in {sum(n for _, n in by_name.values())}"
          " kernels for one step", flush=True)
    return busy, [[name[:80], ms, n] for name, (ms, n) in ranked]


def set_attn_impl(model: torch.nn.Module, impl: str) -> None:
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.attn_impl = impl


def build_model(cfg: dict, device) -> ZUTIS:
    """Seeded random ZUTIS; matrices in bf16 and 1-D parameters in f32, as
    bench.py casts its inference weights."""
    model = ZUTIS(**cfg, dtype=torch.bfloat16, device=device)
    model.init_params(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                p.data = p.data.to(torch.bfloat16)
    return model.eval()


def phase_serving(cfg: dict = VIT_B16, image_size: int = IMAGE_SIZE,
                  n_categories: int = N_CATEGORIES, n_requests: int = 20,
                  device="cuda") -> dict:
    device = torch.device(device)
    rng = np.random.RandomState(0)
    model = build_model(cfg, device)
    text = rng.randn(n_categories, cfg["text_dim"]).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    images = [rng.randn(3, image_size, image_size).astype(np.float32)
              for _ in range(n_requests)]
    grid = image_size // cfg["patch_size"] * 2
    x = torch.from_numpy(np.stack(images[:BATCH])).to(device)

    # a threshold at which a tenth of the random model's proposal pixels
    # binarise, so that the instance decode has masks to work on
    with torch.inference_mode():
        out_k = model(x, inference=True)
    proposals = out_k["mask_proposals"][:, -1]
    threshold = float(torch.quantile(proposals.flatten()[::7].float(), 0.9))
    print(f"serving: threshold {threshold:.6f}", flush=True)

    for w in (fa.flash_attention, *(w for w, _, _ in PROBES.values())):
        w.launches = 0
    server = InferenceServer(model, text, image_size=image_size,
                             batch_size=BATCH, threshold=threshold,
                             max_wait_ms=50, device=device)
    server.start()
    futures = [server.submit(im) for im in images]
    results = [f.result(timeout=600) for f in futures]
    server.stop()
    sync = server.infer(images[:BATCH])
    launches = fa.flash_attention.launches
    probe_launches = sum(w.launches for w, _, _ in PROBES.values())
    batches = server.batches
    print(f"serving: {len(results)} async + {len(sync)} sync requests in "
          f"{batches} batch forwards, {launches} kernel launches", flush=True)

    check(len(results) == n_requests, "not every request was answered")
    n_inst = 0
    for r in results + sync:
        sem = r["semantic"]
        check(sem.shape == (grid, grid), f"semantic shape {sem.shape}")
        check(bool((sem >= 0).all() and (sem < n_categories).all()),
              "semantic ids out of range")
        for inst in r["instances"]:
            check(rle.decode(inst["segmentation"]).shape == (grid, grid),
                  "instance RLE does not decode to the token grid")
            check(0 <= inst["category_id"] < n_categories, "bad category id")
            n_inst += 1
    for a, b in zip(results[:BATCH], sync):
        check(np.array_equal(a["semantic"], b["semantic"])
              and len(a["instances"]) == len(b["instances"]),
              "sync and async answers differ for the same batch")
    print(f"serving: {n_inst} instances returned", flush=True)
    check(probe_launches == 0, "serving launched a probe kernel")
    if device.type == "cuda":
        check(launches == LAUNCHES_PER_FORWARD * batches,
              f"{launches} kernel launches for {batches} batch forwards, "
              f"expected {LAUNCHES_PER_FORWARD} each")

    # the kernel path against the "torch" attention path on one batch, and
    # both against an f32 forward of the same (bf16-rounded) weights with
    # exact attention, which arbitrates where the two bf16 paths differ
    set_attn_impl(model, "torch")
    with torch.inference_mode():
        out_t = model(x, inference=True)
    set_attn_impl(model, "auto")
    ref = ZUTIS(**cfg, dtype=torch.float32, attn_impl="torch", device=device)
    ref.load_state_dict(model.state_dict())
    with torch.inference_mode():
        out_f = ref(x, inference=True)
    del ref
    text_d = torch.from_numpy(text).to(device)

    def semantic(out):
        return torch.einsum("nc,bhwc->bnhw", text_d, out["patch_tokens"]).argmax(1)

    sem_k, sem_t, sem_f = semantic(out_k), semantic(out_t), semantic(out_f)
    agree = (sem_k == sem_t).float().mean().item()
    agree_kf = (sem_k == sem_f).float().mean().item()
    agree_tf = (sem_t == sem_f).float().mean().item()
    for name, a, b in (("kernel vs torch attention", out_k, out_t),
                       ("kernel vs f32", out_k, out_f),
                       ("torch attention vs f32", out_t, out_f)):
        d_tok = (a["patch_tokens"] - b["patch_tokens"]).abs().max().item()
        d_prop = (a["mask_proposals"] - b["mask_proposals"]).abs().max().item()
        print(f"{name}: patch_tokens max diff {d_tok:.3e}, mask_proposals "
              f"max diff {d_prop:.3e}", flush=True)
    print(f"semantic agreement: kernel vs torch attention {agree:.4%}, kernel "
          f"vs f32 {agree_kf:.4%}, torch attention vs f32 {agree_tf:.4%}",
          flush=True)
    # Random weights and 919 random text embeddings leave many pixels with a
    # near-tied argmax, and each bf16 path moves about 1% of them away from
    # the f32 forward, independently, so the two bf16 paths can agree with
    # each other below 99% (98.84% on an H100). The kernel is held to the
    # f32 forward instead: no further from it than the "torch" attention
    # path is, and above a floor half a point under the 99.0% both bf16
    # paths reach.
    check(agree_kf >= MIN_SEMANTIC_AGREEMENT,
          "kernel path's semantic map disagrees with the f32 forward")
    check(agree_kf >= agree_tf - SEMANTIC_SLACK,
          "kernel path is further from the f32 forward than the torch path")

    # the instance decode on the device against a CPU rerun
    binary = proposals > threshold
    check(bool(binary.any()), "no proposal pixel binarised")
    decoded = []
    for dev in (device, torch.device("cpu")):
        with torch.inference_mode():
            conf, cats = classify_proposals(
                proposals.to(dev), binary.to(dev),
                out_k["patch_tokens"].to(dev), text_d.to(dev),
                server.temperature)
            keep, scores = mask_nms(binary.to(dev), conf, cats,
                                    nms_threshold=server.nms_threshold)
        decoded.append((keep.cpu(), cats.cpu(), scores.cpu()))
    (keep_d, cats_d, sc_d), (keep_c, cats_c, sc_c) = decoded
    print(f"decode: {int(keep_d.sum())} kept on the device, "
          f"{int(keep_c.sum())} on the CPU, score max diff "
          f"{(sc_d - sc_c).abs().max().item():.3e}", flush=True)
    check(torch.equal(keep_d, keep_c), "NMS keep differs between card and CPU")
    check(torch.equal(cats_d, cats_c), "categories differ between card and CPU")

    # serving rate of the synchronous path, and where a batch's time goes
    rate_images = images[:2 * BATCH]
    infer_ms = host_ms(lambda: server.infer(rate_images), device, reps=5)
    with torch.inference_mode():
        fwd_ms = host_ms(lambda: model(x, inference=True), device)
        step_ms = host_ms(lambda: server.step(x), device)
        set_attn_impl(model, "torch")
        fwd_torch_ms = host_ms(lambda: model(x, inference=True), device)
        set_attn_impl(model, "auto")
    per_batch = infer_ms / 2
    busy_ms, kernels = profile_device(lambda: server.step(x), device)
    stats = dict(img_per_s=len(rate_images) / (infer_ms / 1e3),
                 ms_per_batch=per_batch, forward_ms=fwd_ms, step_ms=step_ms,
                 forward_torch_attention_ms=fwd_torch_ms, launches=launches,
                 batches=batches, instances=n_inst, step_device_busy_ms=busy_ms,
                 step_top_kernels=kernels)
    print(f"serving rate: {stats['img_per_s']:.2f} img/s sync infer, "
          f"{per_batch:.3f} ms per batch of {BATCH} (forward {fwd_ms:.3f} ms,"
          f" step with decode {step_ms:.3f} ms, forward with torch attention "
          f"{fwd_torch_ms:.3f} ms; device busy in the step "
          f"{busy_ms} ms)", flush=True)
    return stats


def main() -> None:
    card = phase_card()
    max_err, rows = phase_kernel()
    probe_err, probe_rel, probe_rows = phase_probes()
    tune_launches, tune_results = phase_tune()
    stats = phase_serving()
    print(f"serving on {card}: {json.dumps(stats)}", flush=True)

    def per_forward(key):
        return sum(r[key] * r["per_forward"] for r in rows)

    # the summed bound splits into calls bound by bytes and by operations
    bytes_ms = sum(r["bound_ms"] * r["per_forward"] for r in rows
                   if r["bound_by"] == "bytes")
    ops_ms = per_forward("bound_ms") - bytes_ms
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "zutis_tpu_torch/csrc/flash_attention.cu",
        "replaces": "zutis_tpu/ops/flash_attention.py:53",
        "launches": stats["launches"],
        "max_abs_err": max_err,
        # times and bound: the 24 calls of one batch-8 forward at 384 px
        "ms": per_forward("ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": per_forward("library_ms"),
        "shapes": rows,
    }]
    tool = next(r for r in probe_rows if r["name"] == "tool")
    headline = {"single_attention": "single unroll",
                "fastsm_attention": "fastsm lane", "kt_attention": "kt"}
    for name, (_, _, replaces) in PROBES.items():
        family = name.split("_")[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "zutis_tpu_torch/csrc/attention_probes.cu",
            "replaces": replaces,
            "launches": tune_launches[name],
            "max_abs_err": probe_err[name],
            "max_rel_err": probe_rel[name],  # of the largest |output|
            # one call at the tuning tool's shape [64, 12, 577, 577, 64]
            "ms": tool["ms"][headline[name]],
            "plain_ms": tool["plain_ms"][name],
            "bound_ms": tool["bound_ms"],
            "bound_by": tool["bound_by"],
            "library_ms": tool["library_ms"],
            "serving_launches": 0,
            "shapes": [dict(r, ms={k: t for k, t in r["ms"].items()
                                   if k.startswith(family)},
                            plain_ms=r["plain_ms"][name])
                       for r in probe_rows],
        })
    print("tune runs: " + json.dumps(
        [{k: r[k] for k in ("variant", "exp_mode", "dots_only", "max_err", "ms")}
         for r in tune_results]), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
