"""mfu_pct.train: the model FLOPs of the traced train steps (`benchmark/flops.py`:
3x the forward of the loss, plus a shortcut step's two prediction passes) over
the traced window times the H100's bf16 peak (`harness.mfu_pct`)."""
from benchmark.harness import mfu_pct as read  # noqa: F401
