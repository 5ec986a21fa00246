"""serve.queue_p95_ms (server (queue), program_span): the 95th percentile of
the requests' waits in the server's queue: the ended `server.queue` spans
(from `submit` to the worker taking the request into a batch; cancelled
ones, and those that outlived the session, left out), in the traced
tail's device phase (the process's first span session that holds
`server.batch`)."""
import numpy as np

from zutis_tpu_torch.core import profiling


def read(ctx):
    if not hasattr(profiling, "first_session"):
        return None  # a program without the span recorder
    session = profiling.first_session("server.batch")
    if session is None:
        return None
    waits = profiling.span_ms(session, "server.queue")
    return float(np.percentile(waits, 95)) if waits else None
