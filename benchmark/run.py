"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `dreamer4_torch/`. The cell's traffic
file (`benchmark/workloads/<cell>.json`) names its configuration
(`benchmark/configs/<name>.json`) and its entry's driver
(`benchmark/entries/<entry>.py`); each metric is read by
`benchmark/metrics/<metric>.py`. With `--trace 0` the result carries the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics, read from
a torch.profiler trace of `trace_calls` calls. Without a CUDA device, or with
fewer than the cell asks for, it exits with code 2 and prints no result.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every cache of a run at a fixed place inside the checkout
for var, sub in (('TRITON_CACHE_DIR', 'triton'), ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
    os.environ.setdefault(var, str(ROOT / '.bench_cache' / sub))


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def power_limit_line() -> str:
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f'(nvidia-smi gave no power limit: {e})'


def cell_metrics(man: dict, cell: str, kind: str) -> list[dict]:
    """The manifest's metrics of `kind` ('end_to_end' or 'per_layer') that
    this cell reports: the per-layer ones that list it, and the end-to-end
    ones that list it or list no cells."""
    if kind == 'end_to_end':
        return [m for m in man['end_to_end'] if cell in m.get('workloads', [cell])]
    return [m for m in man['per_layer'] if cell in m['workloads']]


def read_metrics(metrics: list[dict], ctx: dict) -> dict:
    from benchmark import harness

    out = {}
    for m in metrics:
        value = harness.metric_reader(m['name']).read(ctx)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def run(cell: str, seed: int, seconds: float, trace: bool, device, *, config: dict | None = None,
        workload: dict | None = None, man: dict | None = None):
    """One run of `cell` on `device`; -> the result's dict, `check` last.
    `config`, `workload` and `man` stand in for the files (tests pass small
    ones)."""
    import torch

    from benchmark import harness

    man = man or harness.manifest()
    wl = workload or harness.workload_file(cell)
    cfg = config or harness.config_file(wl['config'])
    chips = next((w['chips'] for w in man['workloads'] if w['name'] == cell), 1)
    cuda = device.type == 'cuda'
    if cuda:
        from dreamer4_torch.ops import cuda_build

        for name in cuda_build.build_all():
            cuda_build.load(name)

    cell_obj = harness.entry_module(wl['entry']).Cell(cfg, wl, seed, device)
    harness.synchronize(device)
    setup_s = time.perf_counter() - STARTED
    log(f'# set-up {setup_s:.2f} s')

    ctx = {'config': cfg, 'workload': wl, 'setup_s': setup_s,
           'bounds_s': getattr(cell_obj, 'bounds_s', {})}
    if trace:
        ctx.update(harness.run_traced(cell_obj, wl['trace_calls'], device))
        log(f"# launches counted by the port over the traced calls: "
            f"{ {k: v for k, v in ctx['launch_counts'].items() if v} }")
        metrics = cell_metrics(man, cell, 'per_layer')
    else:
        ctx.update(harness.run_window(cell_obj, seconds, device))
        ms = sorted(ctx['step_ms'])
        log(f"# window {ctx['elapsed_s']:.3f} s, {len(ms)} calls; ms a call: min {ms[0]:.1f}, "
            f"median {ms[len(ms) // 2]:.1f}, max {ms[-1]:.1f}; the 5 longest "
            f"{[round(x, 1) for x in ms[-5:]]}")
        metrics = cell_metrics(man, cell, 'end_to_end')
    attempted, failed = cell_obj.end_window()
    values = read_metrics(metrics, ctx)
    device_info = {'platform': 'gpu' if cuda else device.type,
                   'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
                   'count': chips,
                   'memory_peak_bytes': torch.cuda.max_memory_allocated(device) if cuda else 0}
    if trace:
        device_info.update(busy_s=ctx['busy_s'], window_s=ctx['trace_window_s'])

    t0 = time.perf_counter()
    prog = cell_obj.program_readings()
    cell_obj.release_program()
    ref = cell_obj.reference_readings('float32')
    gaps = cell_obj.gaps(prog, ref)
    log(f'# reference and comparison {time.perf_counter() - t0:.2f} s')
    limits = wl['limits']
    correct = (failed == 0 and all(math.isfinite(v) and v <= limits[k] for k, v in gaps.items()))
    result = {'correct': correct, 'attempted': attempted, 'failed': failed, 'metrics': values,
              'device': device_info}
    if trace:
        result['breakdown'] = ctx['breakdown']
    result['check'] = {k: {'value': v, 'limit': limits[k]} for k, v in gaps.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    man = harness.manifest()
    cells = {w['name']: w for w in man['workloads']}
    if args.workload not in cells:
        log(f'no cell {args.workload} in BENCHMARK.json')
        return 2
    chips = cells[args.workload]['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f'the cell needs {chips} CUDA device(s); '
            f'{torch.cuda.device_count() if torch.cuda.is_available() else 0} found')
        return 2
    log(f'# {power_limit_line()}')
    device = torch.device('cuda', 0)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), device, man=man)
    loaded = harness.forbidden_loaded(sys.modules)
    if loaded:
        log(f'modules of JAX or the JAX package were loaded: {loaded}')
        return 3
    for name, c in result['check'].items():
        log(f'check {name} {c["value"]!r} limit {c["limit"]!r}')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
