"""serve.p50_ms (server, host_clock): the median latency of the requests
due in the window, each from when it was due to when its Future
resolved."""


def read(ctx):
    return ctx["outcome"].layer.get("p50_ms")
