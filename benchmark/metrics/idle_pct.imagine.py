"""The device's idle share of the traced window (`harness.idle_pct`)."""
from benchmark.harness import idle_pct as read  # noqa: F401
