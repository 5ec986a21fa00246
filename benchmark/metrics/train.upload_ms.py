"""train.upload_ms (model step (upload), program_span): the host ms a step in
the program's `train.upload` (the batch's four arrays copied to the card)
spans of the traced tail's device phase (the process's first span session
that holds `train.step`), over its `train.step` spans."""
from zutis_tpu_torch.core import profiling


def read(ctx):
    if not hasattr(profiling, "first_session"):
        return None  # a program without the span recorder
    session = profiling.first_session("train.step")
    if session is None:
        return None
    ms = profiling.span_ms(session, "train.upload", device=False)
    steps = len(profiling.span_ms(session, "train.step"))
    return sum(ms) / steps if ms and steps else None
