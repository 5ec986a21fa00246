"""serve.upload_ms (server (upload), program_span): the mean host ms of the
`server.upload` spans (the stack of a batch and its copy to the card; one
a batch), in the traced tail's device phase (the process's first span
session that holds `server.batch`); a span that outlived the session is
left out."""
import numpy as np

from zutis_tpu_torch.core import profiling


def read(ctx):
    if not hasattr(profiling, "first_session"):
        return None  # a program without the span recorder
    session = profiling.first_session("server.batch")
    if session is None:
        return None
    ms = profiling.span_ms(session, "server.upload")
    return float(np.mean(ms)) if ms else None
