"""imagined_env_steps_per_s: dreamed frames times rollouts, over every rollout
the window completed, divided by the host time to the end of the last one
(`harness.rate`). Prompt frames do not count."""
from benchmark.harness import rate as read  # noqa: F401
