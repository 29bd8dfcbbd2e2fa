"""Spans: named ranges of the port's host code, recorded by torch.profiler.

`span(name)` opens `torch.profiler.record_function(name)` while a profiler
is recording and is a shared no-op context otherwise: on a server CPU the
check costs about 0.1 us a call and a `record_function` about 10 us even
with no profiler running, so only the check is on the hot path. The
profiler records the spans beside its own ops and the card's kernels, on the
trace's one clock; `train.logging.profile_block` writes them into its Chrome
trace, and the profiling scripts reduce them (`benchmark/spans.py`: host,
device and idle time per span). A span launches no kernel and keeps no
clock, buffer or event of its own.

The spans (a span inside another is its child), with the benchmark's
readers of their host time:

- `dreamer4.train_step`: one call of a train step of
  `trainers.make_tokenizer_train_step` or `make_world_model_train_step`
  (every trainer that steps through them).
- `dreamer4.forward`: inside it, the training forward and the losses added
  to it (the BYOL teacher, latent consistency, self-flow):
  `host_ms.forward.train`.
- `dreamer4.backward`: inside it, `loss.backward()`: `host_ms.backward.train`
  (the caller waits in it while the autograd engine launches from its own
  thread).
- `dreamer4.optimizer`: the optimizer's step (`MultiSteps` included, so on
  every micro-step); `optimizer_ms.train` reads the profiler's own range
  around the same interval.
- `dreamer4.ema`: the EMA update, on steps that applied an update:
  `host_ms.ema.train`.
- `dreamer4.attention.small`, `.flash`, `.ring`, `.plain`: one call of
  `nn.attention.Attention` from its first op to its return, named by the
  path it takes (K4/K5; K1-K3; ring attention; the plain attention). The
  backward of a call runs outside its span.
- `dreamer4.attention_pool`: one call of `nn.attention.AttentionPool` (the
  trunk's pools, `ops/attn_pool.py` on CUDA), from its first op to its
  return; its backward runs outside it.
- `dreamer4.feedforward`: one call of `nn.attention.FeedForward` (its norm,
  projections and GLU; `ops/glu_ff.py` on CUDA), from its first op to its
  return; its backward runs outside it.
"""
from __future__ import annotations

from contextlib import nullcontext

import torch
from torch._C._autograd import _profiler_enabled

_NO_SPAN = nullcontext()


def span(name: str):
    """A context that records `name` as a range of the profiler's trace
    while a profiler records, and does nothing otherwise."""
    return torch.profiler.record_function(name) if _profiler_enabled() else _NO_SPAN
