"""flash_attention_roofline.train (kernels, device_trace): the bound of the
attention the traced steps' forwards need (counts.forward_attention_bound_s)
over the device time of the kernels that compute it, matched by name."""
from benchmark.readers import roofline

PATTERNS = (r"flash_",)


def read(ctx):
    return roofline(ctx, PATTERNS, "attention_bound_s")
