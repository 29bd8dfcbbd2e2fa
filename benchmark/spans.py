"""The port's spans in a profiler's trace, reduced per span name
(`dreamer4_torch/tracing.py` lists the spans). The profiling scripts print
the reduction (`scripts/profile_torch_train.py`). The benchmark's traced run
does not hand its events to it, so the benchmark's readers of the spans take
their host time alone (`host_ranges_s`).

For each name `dreamer4.*` that the trace holds as a host range:
- count: its instances;
- host_s: the union of its instances' host intervals;
- launches: the kernel launches (`cudaLaunchKernel` and the like) that start
  inside an instance, on any thread: the autograd engine launches the
  backward's kernels from a thread of its own while the caller waits inside
  `dreamer4.backward`;
- device_s: the device time of the kernels, copies and memsets whose
  correlation id is that of a runtime call (a launch, a copy, a memset)
  that starts inside an instance;
- idle_s: the time inside its instances in which the device ran nothing,
  the window's idle time being the complement of its busy intervals.
Beside them, `between_steps_idle_s`: the window's idle time while no
`dreamer4.train_step` is open (None without one).

A span nested in another counts in both (the attention's in the forward's).
A program without spans gives no names.
"""
from __future__ import annotations

import bisect

from torch.autograd import DeviceType

from benchmark.harness import _is_launch, _is_runtime

PREFIX = 'dreamer4.'
STEP = 'dreamer4.train_step'


def merge(intervals) -> list[list[int]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list[list[int]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def overlap_s(a, b) -> float:
    """Seconds that two sorted, disjoint interval lists (ns) share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e9


def is_device(e) -> bool:
    """A kernel, copy or memset on the card (not the profiler's device copy
    of a host range)."""
    return (e.device_type() == DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', lambda: False)())


def busy_intervals(events) -> list[list[int]]:
    """The union of the device's kernels, copies and memsets in a trace."""
    return merge((e.start_ns(), e.end_ns()) for e in events if is_device(e))


def span_stats(events) -> tuple[dict[str, list], dict[str, dict]]:
    """From a trace's kineto events: for each span name, the union of its
    instances' host intervals, and its count, host_s, launches and
    device_s."""
    instances: dict[str, list] = {}
    calls, device = [], {}
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith(PREFIX):
                instances.setdefault(name, []).append((e.start_ns(), e.end_ns()))
            elif _is_runtime(name):
                calls.append((e.start_ns(), e.correlation_id(), _is_launch(name)))
        elif is_device(e):
            corr = e.correlation_id()
            device[corr] = device.get(corr, 0) + e.end_ns() - e.start_ns()
    calls.sort()
    starts = [c[0] for c in calls]
    intervals, stats = {}, {}
    for name, inst in instances.items():
        merged = merge(inst)
        launches = device_ns = 0
        for s, t in merged:
            for _, corr, launch in calls[bisect.bisect_left(starts, s):
                                         bisect.bisect_right(starts, t)]:
                launches += launch
                device_ns += device.get(corr, 0)
        intervals[name] = merged
        stats[name] = {'count': len(inst), 'host_s': sum(t - s for s, t in merged) / 1e9,
                       'launches': launches, 'device_s': device_ns / 1e9}
    return intervals, stats


def reduce(events, lo: int, hi: int, busy) -> dict:
    """The spans of the traced window [lo, hi] (ns, the trace's clock), whose
    device was busy in the sorted, disjoint intervals `busy`:
    {'by_name': {name: count, host_s, launches, device_s, idle_s},
     'between_steps_idle_s': ...}."""
    intervals, stats = span_stats(events)
    bounds = [lo] + [x for s, t in busy for x in (s, t)] + [hi]
    idle = [[a, b] for a, b in zip(bounds[0::2], bounds[1::2]) if b > a]
    for name, merged in intervals.items():
        stats[name]['idle_s'] = overlap_s(idle, merged)
    between = None
    if STEP in intervals:
        between = sum(b - a for a, b in idle) / 1e9 - overlap_s(idle, intervals[STEP])
    return {'by_name': stats, 'between_steps_idle_s': between}

