"""Metrics, logging and profiling (counterpart of
`dreamer4_tpu/train/logging.py`).

- MetricLogger: JSONL scalars (always), TensorBoard events when the
  `tensorboard` package exists, sample-gif dumps via data/video_io (a copy
  of the counterpart's).
- profile_block: context manager around `torch.profiler`, writing a Chrome
  trace of host and device execution into `logdir`, with the port's spans
  (`dreamer4_torch.tracing`).
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch


class MetricLogger:
    def __init__(self, logdir: str | Path, use_tensorboard: bool = True,
                 use_wandb: bool = False, project: str = 'dreamer4_torch',
                 wandb_kwargs: dict | None = None):
        """tensorboard and wandb are alternatives like the reference's
        Accelerate trackers (`trainers.py:456-476`); JSONL is always
        written. `use_wandb` requires the wandb package (not present in
        air-gapped images — degrades to a one-line warning)."""
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.logdir / 'metrics.jsonl', 'a')

        self._tb = None
        if use_tensorboard and not use_wandb:
            try:
                from tensorboardX import SummaryWriter  # type: ignore
                self._tb = SummaryWriter(str(self.logdir))
            except ImportError:
                try:
                    from torch.utils.tensorboard import SummaryWriter  # type: ignore
                    self._tb = SummaryWriter(str(self.logdir))
                except ImportError:
                    self._tb = None

        self._wandb = None
        if use_wandb:
            try:
                import wandb  # type: ignore
                wandb.init(project=project, dir=str(self.logdir),
                           **(wandb_kwargs or {}))
                self._wandb = wandb  # only after init succeeds
            except Exception as e:  # noqa: BLE001 — not installed / not
                # logged in / offline: degrade, never kill the training run
                print(f'MetricLogger: wandb unavailable ({e!r}); '
                      'falling back to JSONL only', flush=True)

    def log(self, step: int, **scalars):
        record = {'step': int(step), 'time': time.time()}
        for k, v in scalars.items():
            record[k] = float(v)
        self._jsonl.write(json.dumps(record) + '\n')
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))
        if self._wandb is not None:
            self._wandb.log({k: float(v) for k, v in scalars.items()},
                            step=int(step))

    def log_video(self, step: int, name: str, video: np.ndarray, fps: int = 8):
        """video: (b, c, t, h, w) in [0,1] -> grid gif on disk."""
        from ..data.video_io import save_gif, video_grid

        grid = video_grid(np.asarray(video))
        path = self.logdir / f'{name}_{step:08d}.gif'
        save_gif(path, grid, fps=fps)
        return path

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


@contextmanager
def profile_block(logdir: str | Path):
    """Trace the host, and the card where there is one, while the block
    runs; the Chrome trace goes to `logdir/trace.json` (chrome://tracing,
    Perfetto). Yields the profiler, whose `key_averages()` sums time by
    operation and kernel."""
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / 'trace.json'))

