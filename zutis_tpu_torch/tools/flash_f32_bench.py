"""Where the flash kernels' time goes, on the card: their time at the
main-path f32 shapes and at the wide decoders' bf16 ones against another
checkout's, against copies of the source with one part taken out, and
whether the other kernels of that checkout compile to the same SASS.

    python -m zutis_tpu_torch.tools.flash_f32_bench [--against DIR] \\
        [--ablations no_split,no_softmax,one_product,rings3,wide_no_split] \\
        [--match REGEX]

- `--against DIR`: a checkout of another commit (`git archive` of it,
  unpacked into a directory git ignores). Both checkouts' `flash_attention`
  are timed at SHAPES, each run in a process of its own, in the order
  other, this, this, other; then the SASS of every kernel that both builds
  of csrc/flash_attention.cu and csrc/attention_probes.cu hold is compared
  instruction by instruction, and those that differ again with register
  numbers dropped (a kernel that differs only in them runs the same
  instructions on other registers).
- `--ablations`: copies of csrc/ with one edit each (ABLATIONS), built with
  nvcc and timed in turns with the unedited source; `d128_rings3` is the
  bf16 kernel's other layout at head dim 128 (a 3-stage ring, two blocks
  an SM, against 4 stages and one block); the `wide_` ones take a part out
  of the f32 kernel at d 128-512, and `d320_keys16` is its other chunk
  size at d 320; the `halves_` ones take a part out of the bf16 kernel at
  d 320-512 (flash_halves_kernel), and `halves_s_twice` is its design
  with S computed whole by both warpgroups and no exchange.
- `--match REGEX`: time only the shapes and forwards whose names match.

Times are device ms per call: 20 calls captured in a CUDA graph, the median
of 21 replays, on [b, s, h, d] views as the models pass them; each run also
times the bf16 kernel at the serving shapes (BF16_SHAPES: the encoder's, a
control for the card's speed, the decoder's at d 96, ViT-L/14@336px's at d
128 and the RN50x4 / x16 / x64 decoders' at d 320 / 384 / 512; one of
those given a key bias), beside nvidia-smi's SM clock and power; a
forward is its device busy in ms. Prints one JSON line per measurement.
Needs a card, nvcc and cuobjdump.
"""
from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence
from unittest import mock

# [b, h, sq, sk, d] of the f32 calls on the main paths: SelfMask's encoder
# self-attention, decoder cross- and self-attention (a 683 x 512 photo), the
# ViT-L/14@336px image bank's encoder at batch 32, and the wide decoders'
# self- and cross-attention at batch 8 (ViT-L/14@336px over 48 x 48 memory
# tokens at d 128; RN50, RN50x4, RN50x16, RN50x64 over 24 x 24 at d 256,
# 320, 384, 512)
SHAPES = {
    "selfmask encoder self": (1, 6, 5505, 5505, 64),
    "selfmask decoder cross": (1, 6, 20, 5504, 64),
    "selfmask decoder self": (1, 6, 20, 20, 64),
    "bank encoder self": (32, 16, 577, 577, 64),
    **{f"d{d} decoder {kind}": (8, 8, 100, sk if kind == "cross" else 100, d)
       for d, sk in ((128, 2304), (256, 576), (320, 576), (384, 576),
                     (512, 576))
       for kind in ("self", "cross")},
}
# f32 forwards timed whole beside the calls, --against only: one batch-8
# forward of factory.build_zutis(arch) at its default f32 on the kernel
# path, at the image size the smoke serves it
FORWARDS = {
    "RN50 f32 forward": ("RN50", 384),
    "ViT-L/14@336px f32 forward": ("ViT-L/14@336px", 336),
}
# bf16 serving forwards, --against only: one batch-8 forward of the arch's
# ZUTIS as the smoke serves it (bf16 matrices, seeded), device busy
BF16_FORWARDS = {
    "RN50x4 bf16 forward": ("RN50x4", 384),
    "RN50x64 bf16 forward": ("RN50x64", 384),
}
# f32 calls given a key bias (log of a size): the ToMe encoder's first
# block and the pooled decoder's cross-attention (the levers' shapes)
BIASED_SHAPES = {
    "tome encoder biased": (8, 12, 577, 577, 64),
    "pooled cross biased": (8, 8, 100, 576, 96),
}
# bf16 calls timed beside them: the serving encoder shape (a control for
# the card's speed), the serving decoder's d 96 shapes, the ViT-L/14@336px
# decoder's d 128 ones (over 48 x 48 memory tokens) and the RN50x4 / x16 /
# x64 decoders' d 320 / 384 / 512 ones (over 24 x 24)
BF16_SHAPES = {
    "control bf16": (8, 12, 577, 577, 64),
    "decoder self bf16": (8, 8, 100, 100, 96),
    "decoder cross bf16": (8, 8, 100, 2304, 96),
    "vitl decoder self bf16": (8, 8, 100, 100, 128),
    "vitl decoder cross bf16": (8, 8, 100, 2304, 128),
    **{f"rn50x{x} decoder {kind} bf16": (8, 8, 100, sk, d)
       for x, d in ((4, 320), (16, 384), (64, 512))
       for kind, sk in (("self", 100), ("cross", 576))},
}
# bf16 calls given a key bias (the log of a pooled memory token's count of
# valid tokens, 1 to 4): RN50x4's cross-attention
BF16_BIASED_SHAPES = {
    "rn50x4 decoder cross biased bf16": (8, 8, 100, 576, 320),
}
# the bf16 d 320-512 kernel's exchange of S's halves, whose body the
# halves_ ablations skip after its barrier
_EXCHANGE = ("__device__ __forceinline__ void add_other_half(float "
             "(&s)[kShort / 8][4], uint32_t slot, int half, int j, int n) {\n")
_EXCHANGE_BARRIER_ONLY = ("  bar_sync(kExchangeBar, kHalvesConsumers);\n"
                          "  return;\n")
# name -> [(text in csrc/flash_attention.cu, its replacement)]. The
# ablations take a part out and compute a wrong result on purpose: their
# time says what the part costs, nothing else. `rings3` is an alternative
# that stays right (d 64 only: at d 96 the rings outgrow shared memory), and
# so is `d128_rings3`, the bf16 kernel at d 128 with a 3-stage ring and two
# blocks an SM (112 KB a block) in place of 4 stages and one.
ABLATIONS = {
    # the producer splits nothing: wgmma reads stale tiles
    "no_split": [
        ("    for (int pass = 0; pass < kChunkRows / kPassRows; ++pass) {",
         "    for (int pass = 0; pass < 0; ++pass) {")],
    # p = the raw logits, O never rescaled
    "no_softmax": [
        (f"f32_chunk_softmax<kBias>(s, bits_j, p.scale_log2, m, l, alpha, bias({c}));",
         "alpha[0] = alpha[1] = 1.f;") for c in ("c0", "j")],
    # one bf16 product for each f32 one (hi * hi), in both products
    "one_product": [
        ("    hopper::WgmmaRS<kChunkRows>::template mma<0>(s, qh[ks], dl, 1);\n"
         "    hopper::WgmmaRS<kChunkRows>::template mma<0>(s, ql[ks], dh, 1);\n",
         ""),
        ("    hopper::pv_step<D>(acc, ph[c], v_lo, c);\n"
         "    hopper::pv_step<D>(acc, pl[c], v_hi, c);\n", "")],
    # three f32 and three split stages instead of two and two
    "rings3": [("constexpr int kF32Stages = 2;", "constexpr int kF32Stages = 3;"),
               ("constexpr int kSplitStages = 2;",
                "constexpr int kSplitStages = 3;")],
    "d128_rings3": [
        ("return flash_wide(d) ? kFlashStagesWide : kFlashStages; }",
         "return d >= 128 ? kFlashStagesWide : kFlashStages; }"),
        ("constexpr int flash_min_blocks(int d) { return d < 128 ? 2 : 1; }",
         "constexpr int flash_min_blocks(int d) { return d <= 128 ? 2 : 1; }")],
    # the wide kernel (d 128-512): no piece split (Q's neither: wgmma reads
    # stale tiles)
    "wide_no_split": [
        ("  for (int it = 0; it < kItems / kWideThreads; ++it) {",
         "  for (int it = 0; it < 0; ++it) {")],
    # one bf16 product for each f32 one, in S and in P V
    "wide_one_product": [
        ("    wgmma_ss<kKeys>(s, qh, desc(k_lo + ko), 1);\n"
         "    wgmma_ss<kKeys>(s, ql, kh, 1);\n", ""),
        ("    hopper::WgmmaRS<N>::template mma<1>(acc, ph[c], dl, 1);\n"
         "    hopper::WgmmaRS<N>::template mma<1>(acc, pl[c], dh, 1);\n", "")],
    # S over the first half of the head dim only: what S's products cost
    "wide_half_s": [
        ("  for (int ks = 0; ks < D / 16; ++ks) {\n"
         "    const uint32_t in_row = (ks % 2) * 32;\n"
         "    const uint32_t qo =",
         "  for (int ks = 0; ks < D / 32; ++ks) {\n"
         "    const uint32_t in_row = (ks % 2) * 32;\n"
         "    const uint32_t qo =")],
    # p = the raw logits, O never rescaled
    "wide_no_softmax": [
        ("      f32_chunk_softmax<kBias, kKeys>(s, hopper::ld_shared_u64(base + "
         "kLay.valid), p.scale_log2, m, l, alpha,\n"
         "                                      base + kLay.bias);",
         "      alpha[0] = alpha[1] = 1.f;")],
    # with one f32 slot (d 320, 512), K_{j+1}'s load issued at the barrier
    # after the softmax, not under S_j (stays right)
    "wide_late_refill": [
        ("      if constexpr (kSlots == 1) sync_refill();\n", "")],
    # an alternative that stays right: 16-key chunks at d 320 (four f32
    # slots of 20 KB) in place of 32 (one of 40 KB)
    "d320_keys16": [
        ("constexpr int wide_keys(int d) { return d <= 128 ? 64 : d <= 320 ? "
         "32 : 16; }",
         "constexpr int wide_keys(int d) { return d <= 128 ? 64 : d <= 256 ? "
         "32 : 16; }")],
    # the bf16 kernel at d 320-512: S from each warpgroup's half of the head
    # dim alone, no exchange (its barrier stays: without a producer warp
    # the loads wait for it)
    "halves_no_exchange": [(_EXCHANGE, _EXCHANGE + _EXCHANGE_BARRIER_ONLY)],
    # no loads past the first ring and no wait for them: the producer warp
    # (or the loading consumer warp) stops after halves_stages(d) chunks,
    # the consumers reuse their tiles (what the K/V loads cost)
    "halves_no_refill": [
        ("  for (int c = 0; c < n; ++c) {\n    const int s = c % kStages;",
         "  for (int c = 0; c < n && c < kStages; ++c) {\n"
         "    const int s = c % kStages;"),
        ("auto refills = [&](bool mine, int c) { return mine && c < n; };",
         "auto refills = [&](bool mine, int c) { return false && c < n; };"),
        *((f"auto {x}_ready = [&](int j) {{ hopper::mbar_wait(",
           f"auto {x}_ready = [&](int j) {{ if (j < kStages) hopper::mbar_wait(")
          for x in ("k", "v"))],
    # with no cluster multicast, half the bytes of every K and V chunk (its
    # first D / 64 boxes): the same waits and barriers with half the
    # traffic from L2 into the SMs
    "halves_half_loads": [
        ("constexpr int kHalvesCluster = 2;", "constexpr int kHalvesCluster = 1;"),
        ("    constexpr int kBoxes = D / hopper::kBoxCols, kShare = kBoxes / "
         "kHalvesCluster;",
         "    constexpr int kBoxes = D / hopper::kBoxCols / 2, kShare = kBoxes / "
         "kHalvesCluster;"),
        ("    hopper::mbar_arrive_expect_tx(full, kChunk);\n    if (blocks > 1)",
         "    hopper::mbar_arrive_expect_tx(full, kChunk / 2);\n    if (blocks > 1)")],
    # an alternative that stays right: each block loads its whole chunks,
    # no cluster multicast (twice the traffic from L2 into the SMs)
    "halves_no_multicast": [
        ("constexpr int kHalvesCluster = 2;", "constexpr int kHalvesCluster = 1;")],
    # p = the raw logits past chunk 0, O never rescaled
    "halves_no_softmax": [
        ("chunk_softmax<kBias, kShort>(s, bits, p.scale_log2, m, l, alpha, "
         "bias(j));", "alpha[0] = alpha[1] = 1.f;")],
    # alternatives that stay right: each warpgroup computes all of S (Q
    # read whole), as before the exchange; no producer warp at any head
    # dim (the first consumer warp loads between barriers, as at d 512)
    "halves_s_twice": [
        (_EXCHANGE, _EXCHANGE + _EXCHANGE_BARRIER_ONLY),
        ("hopper::qk_issue_ss_short<kHalf>(s, ",
         "hopper::qk_issue_ss_short<D>(s, "),
        ("const uint32_t q_half = base + lay.q + half * kHalfBoxes * "
         "hopper::kBoxBytes;", "const uint32_t q_half = base + lay.q;"),
        ("const uint32_t k_half = half * kHalfBoxes * "
         "hopper::box_bytes(kShort);", "const uint32_t k_half = 0;")],
    "halves_no_producer": [
        ("constexpr bool halves_producer_warp(int d) { return d < 512; }",
         "constexpr bool halves_producer_warp(int d) { return false; }")],
}


def device_ms(fn, calls=20, reps=21):
    """Device ms per call of `fn`: `calls` calls captured in a CUDA graph,
    the median of `reps` replays."""
    import statistics

    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def flash_inputs(gen, shape, dtype):
    """q, k, v as [b, h, s, d] views of [b, s, h, d] tensors on the card."""
    import torch

    b, h, sq, sk, d = shape
    return [torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
            .transpose(1, 2) for s in (sq, sk, sk)]


def forward_busy(forwards, dtype):
    """{name: device busy ms} of one forward of each (arch, image size) in
    `forwards`: the sum of the kernel durations that torch.profiler sees,
    after two warm-up forwards; seeded weights and images, batch 8. dtype
    "f32" is factory.build_zutis(arch) at its default f32; "bf16" the
    arch's ZUTIS with bf16 matrices, as the smoke serves it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zutis_tpu_torch.models import factory
    from zutis_tpu_torch.tools.instance_eval_bench import build_model

    out = {}
    for name, (arch, size) in forwards.items():
        if dtype == "f32":
            model = factory.build_zutis(arch, device="cuda").init_params(
                torch.Generator().manual_seed(0)).eval()
        else:
            model = build_model(factory.zutis_config(arch), "cuda")
        x = torch.randn(8, 3, size, size,
                        generator=torch.Generator().manual_seed(1)).cuda()
        with torch.inference_mode():
            for _ in range(2):
                model(x, inference=True)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                model(x, inference=True)
                torch.cuda.synchronize()
        out[name] = sum(e.time_range.elapsed_us() for e in prof.events()
                        if str(e.device_type).endswith("CUDA")) / 1e3
        del model
        torch.cuda.empty_cache()
    return out


def time_shapes(plan):
    """{name: device ms} of flash_attention at each shape of `plan` ("f32"
    and "bf16": {name: [b, h, sq, sk, d]}; "f32_biased" and "bf16_biased"
    the same given a key bias), the device busy of each forward of
    "f32_forwards" and "bf16_forwards" (forward_busy), and nvidia-smi's SM
    clock, power draw and limit. A shape at a head dim the checkout's
    kernels do not take is left out."""
    import subprocess

    import torch

    from zutis_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for key in ("f32", "f32_biased", "bf16", "bf16_biased"):
        dtype = torch.float32 if key.startswith("f32") else torch.bfloat16
        for name, shape in plan.get(key, {}).items():
            if shape[4] not in fa.HEAD_DIMS:
                continue
            q, k, v = flash_inputs(gen, shape, dtype)
            bias = None
            if key == "f32_biased":  # the log of a size in [1, 2)
                bias = torch.rand(shape[0], shape[3], generator=gen,
                                  device="cuda").add(1.0).log()
            elif key == "bf16_biased":  # the log of a count, 1 to 4
                bias = torch.randint(1, 5, (shape[0], shape[3]),
                                     generator=gen, device="cuda").float().log()
            out[name] = device_ms(
                lambda: fa.flash_attention(q, k, v, key_bias=bias))
    for key in ("f32", "bf16"):
        out.update(forward_busy(plan.get(f"{key}_forwards", {}), key))
    out["nvidia-smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    return out


def timing_plan(match: str = "", forwards: bool = True) -> dict:
    """time_shapes' plan: every shape (and with `forwards` every forward)
    whose name the regular expression `match` finds."""
    parts = {"f32": SHAPES, "f32_biased": BIASED_SHAPES, "bf16": BF16_SHAPES,
             "bf16_biased": BF16_BIASED_SHAPES}
    if forwards:
        parts.update(f32_forwards=FORWARDS, bf16_forwards=BF16_FORWARDS)
    found = re.compile(match)
    return {key: {name: x for name, x in part.items() if found.search(name)}
            for key, part in parts.items()}


def timer_script() -> str:
    """time_shapes as a `python -c` script: run from a checkout's root, it
    imports that checkout's package; argv[1] holds the plan as JSON."""
    return "\n\n".join(
        ["import json, sys",
         *(inspect.getsource(f) for f in (device_ms, flash_inputs,
                                          forward_busy, time_shapes)),
         "print(json.dumps(time_shapes(json.loads(sys.argv[1]))))"])


def _emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def time_checkout(root: Path, plan: dict) -> dict:
    """time_shapes(plan) in a process of its own, run from `root`."""
    proc = subprocess.run(
        [sys.executable, "-c", timer_script(), json.dumps(plan)],
        cwd=root, capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {root} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def ablated_sources(name: str, csrc: Path, into: Path) -> Path:
    """A copy of csrc/ in `into` with ablation `name` applied; the copy's
    flash_attention.cu. Raises if an edit no longer matches the source."""
    shutil.rmtree(into, ignore_errors=True)
    shutil.copytree(csrc, into)
    path = into / "flash_attention.cu"
    text = path.read_text()
    for old, new in ABLATIONS[name]:
        if old not in text:
            raise ValueError(f"ablation {name}: the source no longer holds "
                             f"{old.strip()[:60]!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return path


def nvcc(source: Path, out: Path) -> Path:
    """`source` built as _build builds a CUDA source, into `out`."""
    from zutis_tpu_torch.ops import _build

    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr[-3000:]}")
    return out


def run_ablations(names: Sequence[str], rounds: int, plan: dict) -> None:
    """Each ablation and the unedited source, built side by side, timed at
    `plan`'s shapes in turns (forward, then backward) within this
    process."""
    from zutis_tpu_torch.ops import _build
    from zutis_tpu_torch.ops import flash_attention as fa

    work = _build.BUILD_DIR / "ablations"
    work.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in ["none", *names]:
        source = (fa.SOURCE if name == "none"
                  else ablated_sources(name, _build.CSRC, work / name))
        lib = ctypes.CDLL(str(nvcc(source, work / f"lib_{name}.so")))
        lib.zutis_cuda_error_string.restype = ctypes.c_char_p
        lib.zutis_cuda_error_string.argtypes = [ctypes.c_int]
        fa._bind(lib)
        libs[name] = lib
    order = list(libs)
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            # flash_attention loads its library through _build.load
            with mock.patch.object(_build, "load",
                                   lambda *a, _lib=libs[name]: _lib):
                _emit({"ablation": name, "round": r,
                       "ms": time_shapes(plan)})


# the anonymous namespace's name in a mangled symbol, which differs between
# builds of different sources
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def sass_functions(lib: Path) -> dict:
    """{mangled name without its anonymous namespace: instructions with
    addresses and encodings stripped} from cuobjdump."""
    from zutis_tpu_torch.ops import _build

    tool = (shutil.which("cuobjdump")
            or str(Path(_build._nvcc()).parent / "cuobjdump"))
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {out.stderr[-1000:]}")
    functions = {}
    for block in out.stdout.split("Function : ")[1:]:
        name, _, body = block.partition("\n")
        lines = (re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", line)
                 .strip() for line in body.splitlines() if "/*" in line)
        functions[_ANON.sub("", name.strip())] = [ln for ln in lines if ln]
    return functions


# a register's number (R, UR, P, UP): dropped by `registers_only`
_REGISTER = re.compile(r"\b(U?[RP])\d+\b")


def compare_sass(other: Path) -> None:
    """The SASS of every kernel both checkouts' flash and probe libraries
    hold, instruction by instruction, and the differing ones again with
    register numbers dropped: one line a library."""
    from zutis_tpu_torch.ops import _build
    from zutis_tpu_torch.ops import attention_probes as ap
    from zutis_tpu_torch.ops import flash_attention as fa

    work = _build.BUILD_DIR / "sass_against"
    work.mkdir(parents=True, exist_ok=True)
    for module in (fa, ap):
        mine = sass_functions(module.build()[0])
        theirs = sass_functions(nvcc(
            other / "zutis_tpu_torch" / "csrc" / module.SOURCE.name,
            work / f"{module.STEM}.so"))
        both = sorted(set(mine) & set(theirs))
        differ = [n for n in both if mine[n] != theirs[n]]

        def renamed(lines):
            return [_REGISTER.sub(r"\1", ln) for ln in lines]

        _emit({"sass": module.SOURCE.name,
               "equal": sum(mine[n] == theirs[n] for n in both),
               "differ": differ,
               "registers_only": [n for n in differ if renamed(mine[n])
                                  == renamed(theirs[n])],
               "only_here": sorted(set(mine) - set(theirs)),
               "only_there": sorted(set(theirs) - set(mine))})


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path,
                        help="another checkout to time and compare SASS with")
    parser.add_argument("--ablations", default="",
                        help=f"comma-separated, of {', '.join(ABLATIONS)}")
    parser.add_argument("--rounds", type=int, default=2,
                        help="turns of the ablation timings")
    parser.add_argument("--match", default="",
                        help="time only the shapes and forwards whose names "
                             "this regular expression finds")
    args = parser.parse_args(argv)
    names = [n for n in args.ablations.split(",") if n]
    unknown = set(names) - set(ABLATIONS)
    if unknown:
        parser.error(f"unknown ablations {sorted(unknown)}")
    here = Path(__file__).resolve().parents[2]
    if args.against is not None:
        other = args.against.resolve()
        plan = timing_plan(args.match)
        for who in ("other", "this", "this", "other"):
            root = other if who == "other" else here
            _emit({"checkout": who, "ms": time_checkout(root, plan)})
        compare_sass(other)
    if names:
        run_ablations(names, args.rounds, timing_plan(args.match, False))


if __name__ == "__main__":
    main()
