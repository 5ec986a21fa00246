"""mfu.serve_max (model step, host_clock): the forward's products for the
requests completed in the window, over the window, against 989 TFLOP/s."""
from benchmark.readers import mfu as read  # noqa: F401
