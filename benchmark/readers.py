"""What the per-layer metrics' readers share (each metric's own file under
metrics/ names its source and calls one of these).

ctx: {"trace": tracing.TraceSummary of the traced tail, "outcome":
harness.Outcome of the window, "cell": harness.Cell, "window_s": the
window's seconds}. A reader that finds nothing to read returns None.
"""
from __future__ import annotations

from benchmark import counts


def idle_pct(ctx) -> float:
    """The share of the traced tail's device phase in which no kernel, copy
    or fill ran on the device."""
    s = ctx["trace"]
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def mfu(ctx, flops: str = "flops", over: str = "window_s"):
    """The products the window's work needs, counted from shapes (the
    outcome's `flops`), over the seconds `over` names in the outcome,
    against the bf16 peak."""
    layer = ctx["outcome"].layer
    if not layer.get(flops) or not layer.get(over):
        return None
    return 100.0 * layer[flops] / layer[over] / counts.BF16_FLOPS


def roofline(ctx, patterns, bound: str):
    """The bound of the work dispatched inside the traced tail's device
    phase (the growth of the traffic driver's counter `bound`, in seconds)
    over the device seconds of the kernels that match `patterns` there."""
    s = ctx["trace"]
    secs = s.seconds_matching(patterns)
    work = s.counters.get(bound, 0.0)
    if secs <= 0 or work <= 0:
        return None
    return 100.0 * work / secs
