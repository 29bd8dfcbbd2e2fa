"""launches_per_step.train: the host's kernel launches (`cudaLaunchKernel` and
the like) in the trace, per traced train step (`harness.launches_per`)."""
from benchmark.harness import launches_per


def read(ctx):
    return launches_per(ctx)
