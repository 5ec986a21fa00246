"""mfu.serve (model step, program_span): the forward's products for the
requests served, over the summed time of the server's batch calls (a span
the benchmark puts around `infer` on its own instance: at a fixed rate the
window's work is fixed, so the window is not the divisor), against 989
TFLOP/s."""
from benchmark.readers import mfu


def read(ctx):
    return mfu(ctx, flops="served_flops", over="infer_s")
