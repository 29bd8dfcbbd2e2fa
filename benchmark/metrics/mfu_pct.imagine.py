"""mfu_pct.imagine: the model FLOPs of the traced rollouts (`benchmark/flops.py`:
the prompt pass, then per dreamed frame the denoising passes, the clean pass
and the heads) over the traced window times the H100's bf16 peak
(`harness.mfu_pct`)."""
from benchmark.harness import mfu_pct as read  # noqa: F401
