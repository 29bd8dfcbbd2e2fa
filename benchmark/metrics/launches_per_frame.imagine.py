"""launches_per_frame.imagine: the host's kernel launches in the trace, per
dreamed frame of the traced rollouts (each frame's denoising and clean passes
and heads, and the prompt pass shared out; `harness.launches_per`)."""
from benchmark.harness import launches_per


def read(ctx):
    return launches_per(ctx, 'frames')
