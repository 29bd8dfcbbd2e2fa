"""train_step_ms_p90: the 90th percentile of the window's step times, each the
device time between the CUDA events recorded after consecutive steps (the
first from one recorded at the window's start), so a stall lands in a step."""
from benchmark.harness import percentile


def read(ctx):
    if 'step_ms' not in ctx:
        return None
    return percentile(ctx['step_ms'], 90)
