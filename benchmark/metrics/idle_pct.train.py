"""idle_pct.train (device, device_trace): the share of the traced
training window with nothing running on the card."""
from benchmark.readers import idle_pct as read  # noqa: F401
