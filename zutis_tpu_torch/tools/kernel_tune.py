"""Attention kernel tuning probe: times one attention variant at the
encoder attention shape of the bench program, b, h, sq, sk, d = 64, 12, 577,
577, 64, with bf16 inputs from np.random.RandomState(0).randn.

    python -m zutis_tpu_torch.tools.kernel_tune <variant> [block_q] \\
        [--exp exp|mul|bf16] [--dots-only] [--device cuda|cpu]

Variants:
  single      the `single` probe (ops/attention_probes.py): exact single-shot
              softmax over the whole key axis, blocks walking the heads
  batched     the same kernel; its exponential is always `exp`
  headgrid    the `single` probe with one head per block
  fastsm-mxu  the max-free clamped softmax, row sum on the tensor cores
  fastsm-lane the same, row sum on the CUDA cores
  kt          `fastsm-lane` reading K pre-transposed; its time includes the
              transposing copy of K
  ship        the port's flash_attention (ops/flash_attention.py)
  torch       the port's "torch" attention path (ops/attention.py)
  sdpa        F.scaled_dot_product_attention: a yardstick only, no path of
              the port calls it

`block_q` (default 128) is the query rows a probe's block owns: 64 or 128
(one or two 64-row warpgroups) for every probe on the card; the CPU's plain
versions take any value. `--exp` picks
the probes' exponential and `--dots-only` makes `kt` skip the softmax (p =
bf16(s), l = 1); the other variants ignore both.

Prints `RESULT_DISPATCH_OK sum=<sum of the output>`, `RESULT_MAXERR <largest
abs difference from an f32 einsum softmax of the same inputs>`, the call's
bound on an H100, and `RESULT_OK variant=... block_q=... ms=<device ms per
call>`: CUDA events around 20 calls after a warm call. On the CPU there is no
device time, and the last line says `ms=not-measured`.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from zutis_tpu_torch.core.device import resolve_device
from zutis_tpu_torch.ops import attention_probes as ap
from zutis_tpu_torch.ops.attention import dot_product_attention
from zutis_tpu_torch.ops.flash_attention import flash_attention

# H100 SXM published dense peaks (NVIDIA data sheet) for the roofline bound
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SHAPE = (64, 12, 577, 577, 64)  # b, h, sq, sk, d
SINGLE_LAYOUTS = {"single": "unroll", "batched": "batched", "headgrid": "grid"}
VARIANTS = (*SINGLE_LAYOUTS, "fastsm-mxu", "fastsm-lane", "kt", "ship",
            "torch", "sdpa")
TOL_BF16 = 2e-2  # bf16 outputs (8-bit mantissa) against an f32 softmax
TIMED_CALLS = 20


def bound(b, h, sq, sk, d, itemsize=2, valid_keys=None, extra_bytes=0):
    """(least ms on an H100, "bytes" or "operations") for one attention
    call: each of q, k, v read once and o written once (and `extra_bytes`
    more, such as a key bias), against 4*h*sq*d operations per valid key
    at the bf16 tensor-core peak; `valid_keys` is the count of unmasked
    keys summed over the batch (all b * sk without a mask)."""
    flops = 4 * h * sq * d * (b * sk if valid_keys is None else valid_keys)
    nbytes = itemsize * (2 * b * h * sq * d + 2 * b * h * sk * d) + extra_bytes
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_inputs(shape=SHAPE, device="cuda"):
    """q, k, v in bf16 as the JAX tool makes them."""
    b, h, sq, sk, d = shape
    rng = np.random.RandomState(0)
    return [torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32))
            .to(device).bfloat16() for s in (sq, sk, sk)]


def variant_fn(variant: str, block_q: int = 128, exp_mode: str = "exp",
               dots_only: bool = False):
    """The callable (q, k, v) -> o that `variant` names."""
    if variant in SINGLE_LAYOUTS:
        layout = SINGLE_LAYOUTS[variant]
        return lambda q, k, v: ap.single_attention(q, k, v, block_q, layout,
                                                   exp_mode)
    if variant in ("fastsm-mxu", "fastsm-lane"):
        sum_mode = variant.split("-")[1]
        return lambda q, k, v: ap.fastsm_attention(q, k, v, block_q, sum_mode,
                                                   exp_mode)
    if variant == "kt":
        return lambda q, k, v: ap.kt_attention(q, k, v, block_q, exp_mode,
                                               dots_only)
    if variant == "ship":
        return flash_attention
    if variant == "torch":
        return lambda q, k, v: dot_product_attention(q, k, v, impl="torch")
    if variant == "sdpa":
        return F.scaled_dot_product_attention
    raise ValueError(f"variant {variant!r} not in {VARIANTS}")


def is_exact(variant: str, exp_mode: str = "exp", dots_only: bool = False) -> bool:
    """Whether the variant computes softmax attention, so that its
    RESULT_MAXERR is held to TOL_BF16: all but the "mul" exp mode of the
    probes that take it and the dots-only `kt`."""
    if variant in ("batched", "ship", "torch", "sdpa"):
        return True
    if variant == "kt" and dots_only:
        return False
    return exp_mode != "mul"


def run(variant: str, block_q: int = 128, exp_mode: str = "exp",
        dots_only: bool = False, shape=SHAPE, device="cuda",
        inputs: Optional[Sequence[torch.Tensor]] = None) -> dict:
    """Run, check and time one variant; prints the RESULT_ lines and
    returns what they say. `inputs` (q, k, v) replaces `make_inputs`."""
    device = resolve_device(device)
    fn = variant_fn(variant, block_q, exp_mode, dots_only)
    q, k, v = make_inputs(shape, device) if inputs is None else inputs
    b, h, sq, d = q.shape
    sk = k.shape[2]
    print(f"variant={variant} block_q={block_q} exp={exp_mode} "
          f"dots_only={dots_only} shape={[b, h, sq, sk, d]} device={device} "
          "dispatching...", flush=True)
    t0 = time.perf_counter()
    out = fn(q, k, v)
    total = float(out.float().sum())
    print(f"RESULT_DISPATCH_OK sum={total:.3f} (first call "
          f"{time.perf_counter() - t0:.3f} s)", flush=True)

    # correctness against an f32 softmax of the same inputs
    qs, ks, vs = (t.float() for t in (q, k, v))
    w = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", qs, ks) * d ** -0.5, -1)
    ref = torch.einsum("bhqk,bhkd->bhqd", w, vs)
    del w
    err = float((out.float() - ref).abs().max())
    del ref
    print(f"RESULT_MAXERR {err:.6f}", flush=True)

    bound_ms, bound_by = bound(b, h, sq, sk, d)
    ms = None
    if device.type == "cuda":
        fn(q, k, v)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMED_CALLS):
            fn(q, k, v)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / TIMED_CALLS
        print(f"bound: {bound_ms:.4f} ms ({bound_by}) on an H100 at its "
              f"published peaks; {bound_ms / ms:.1%} of it", flush=True)
        print(f"RESULT_OK variant={variant} block_q={block_q} ms={ms:.4f}",
              flush=True)
    else:
        print(f"bound: {bound_ms:.4f} ms ({bound_by}) on an H100 at its "
              "published peaks", flush=True)
        print(f"RESULT_OK variant={variant} block_q={block_q} "
              "ms=not-measured (no device time on the CPU)", flush=True)
    return dict(variant=variant, block_q=block_q, exp_mode=exp_mode,
                dots_only=dots_only, shape=[b, h, sq, sk, d],
                device=str(device), sum=total, max_err=err,
                exact=is_exact(variant, exp_mode, dots_only), ms=ms,
                bound_ms=bound_ms, bound_by=bound_by)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m zutis_tpu_torch.tools.kernel_tune",
        description="Time one attention variant at the probes' shape.")
    parser.add_argument("variant", choices=VARIANTS)
    parser.add_argument("block_q", nargs="?", type=int, default=128)
    parser.add_argument("--exp", dest="exp_mode", choices=ap.EXP_MODES,
                        default="exp")
    parser.add_argument("--dots-only", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    return run(args.variant, args.block_q, args.exp_mode, args.dots_only,
               device=args.device)


if __name__ == "__main__":
    main()
