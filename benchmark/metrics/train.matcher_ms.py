"""train.matcher_ms (model step (matcher), program_span): the device ms a step
in the program's `train.matcher` (the per-layer costs through the matcher
and the gather) spans of the traced tail's device phase (the process's first
span session that holds `train.step`), over its `train.step` spans. A span's
device ms is the stream's interval between its two CUDA events: the kernels
it launched and any idle between them (the device waiting on the host's
dispatch included)."""
from zutis_tpu_torch.core import profiling


def read(ctx):
    if not hasattr(profiling, "first_session"):
        return None  # a program without the span recorder
    session = profiling.first_session("train.step")
    if session is None:
        return None
    ms = profiling.span_ms(session, "train.matcher", device=True)
    steps = len(profiling.span_ms(session, "train.step"))
    return sum(ms) / steps if ms and steps else None
