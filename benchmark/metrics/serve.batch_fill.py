"""serve.batch_fill (server, program_counter): the requests served over
the server's batch forwards (InferenceServer.batches) times the batch."""


def read(ctx):
    fill = ctx["outcome"].layer.get("batch_fill")
    return None if fill is None else 100.0 * fill
