"""The readings a cell's limits are set from, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control 3] [--faults half_batch,altered_output] [--fault-seeds 3]

For each seed, the program's numbers against the reference (the lower
readings: the cell's set-up, which drives the program through its checked
first calls, then the reference). On the first `--control` seeds, the
control: the reference computed in fp8, put in the program's place (the
upper readings). On the first `--fault-seeds` seeds, each named fault of the
entry planted under the timed path. One JSON line per reading on standard
output, a summary on standard error. Needs the CUDA device a cell's run
needs; no window is timed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', required=True)
    p.add_argument('--control', type=int, default=3)
    p.add_argument('--faults', default='')
    p.add_argument('--fault-seeds', type=int, default=3)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print('calibrate needs a CUDA device', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    from dreamer4_torch.ops import cuda_build

    for name in cuda_build.build_all():
        cuda_build.load(name)
    wl = harness.workload_file(args.workload)
    cfg = harness.config_file(wl['config'])
    entry = harness.entry_module(wl['entry'])
    seeds = [int(s) for s in args.seeds.split(',')]
    faults = [f for f in args.faults.split(',') if f]
    rows = []

    def emit(kind, seed, gaps, seconds):
        row = {'kind': kind, 'seed': seed, 'gaps': gaps, 'seconds': seconds}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        cell = entry.Cell(cfg, wl, seed, device)
        prog = cell.program_readings()
        cell.release_program()
        ref = cell.reference_readings('float32')
        emit('program', seed, cell.gaps(prog, ref), time.perf_counter() - t0)
        if i < args.control:
            t0 = time.perf_counter()
            emit('control', seed, cell.gaps(cell.control_readings(), ref),
                 time.perf_counter() - t0)
        del cell
        harness.free_device_memory()
    for fault in faults:
        for seed in seeds[:args.fault_seeds]:
            t0 = time.perf_counter()
            with entry.FAULTS[fault]():
                cell = entry.Cell(cfg, wl, seed, device)
            prog = cell.program_readings()
            cell.release_program()
            emit(f'fault:{fault}', seed, cell.gaps(prog, cell.reference_readings('float32')),
                 time.perf_counter() - t0)
            del cell
            harness.free_device_memory()

    kinds = sorted({r['kind'] for r in rows})
    for name in rows[0]['gaps']:
        for kind in kinds:
            vals = [r['gaps'][name] for r in rows if r['kind'] == kind]
            print(f'{name} {kind}: min {min(vals)!r} max {max(vals)!r} over {len(vals)}',
                  file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
