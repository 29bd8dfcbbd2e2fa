"""train_frames_per_s: every frame the window's train steps trained on (batch x
frames per step) over the window's host time, which ends when the device has
finished the last step issued (`harness.rate`)."""
from benchmark.harness import rate as read  # noqa: F401
