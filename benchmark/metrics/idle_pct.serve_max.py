"""idle_pct.serve_max (device, device_trace): the share of the traced window
with nothing running on the card."""
from benchmark.readers import idle_pct as read  # noqa: F401
