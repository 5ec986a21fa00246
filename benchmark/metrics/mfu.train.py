"""mfu.train (model step, host_clock): the forward and backward products
a training step needs (counts.train_step_flops), times the steps of the
window, over the window, against 989 TFLOP/s."""
from benchmark.readers import mfu as read  # noqa: F401
