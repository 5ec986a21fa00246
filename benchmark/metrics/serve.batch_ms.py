"""serve.batch_ms (server (batch), program_span): the median host ms of a
`server.batch` span (a chunk of `infer`, from its stack to its last
result), in the traced tail's device phase (the process's first span
session that holds `server.batch`)."""
import numpy as np

from zutis_tpu_torch.core import profiling


def read(ctx):
    if not hasattr(profiling, "first_session"):
        return None  # a program without the span recorder
    session = profiling.first_session("server.batch")
    if session is None:
        return None
    ms = profiling.span_ms(session, "server.batch")
    return float(np.median(ms)) if ms else None
