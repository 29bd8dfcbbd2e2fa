"""Where the time of the PyTorch port's imagination rollout goes, on one CUDA card.

    python3 scripts/profile_torch_rollout.py

Builds the bench world model as chip_smoke.py does (dim 512, depth 8, bf16,
random weights from a seed), runs the unprompted b16 x T16 rollout once to
warm up, then once more under torch.profiler, and prints:
  - the rollout's wall time and the device's busy time (the sum of the CUDA
    kernels' times) and idle share;
  - the CUDA kernels launched per model forward (a rollout runs
    T x (num_steps + 1) forwards);
  - the CUDA kernels and the host-side PyTorch ops that take the most time.
Imports torch and the port only.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import BENCH_MODEL, HEADLINE, gpu_name_and_power_limit  # noqa: E402
from dreamer4_torch import DynamicsWorldModel, generate  # noqa: E402
from dreamer4_torch.ops.utils import cast_params_for_inference  # noqa: E402


def is_device_event(event) -> bool:
    return getattr(event, 'device_type', None) == torch.autograd.DeviceType.CUDA


def main() -> int:
    if not torch.cuda.is_available():
        print('profile_torch_rollout: no CUDA device', file=sys.stderr)
        return 1
    print(gpu_name_and_power_limit(), flush=True)
    torch.manual_seed(0)
    model = DynamicsWorldModel(**BENCH_MODEL, dtype=torch.bfloat16)
    cast_params_for_inference(model, torch.bfloat16)
    gen = torch.Generator(device=model.device).manual_seed(0)
    run = lambda: generate(model, gen, **HEADLINE)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events() if is_device_event(e)]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    forwards = HEADLINE['time_steps'] * (HEADLINE['num_steps'] + 1)
    print(f'rollout b{HEADLINE["batch_size"]} T{HEADLINE["time_steps"]} under the profiler: '
          f'{wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms '
          f'({100 * busy_ms / wall_ms:.1f}%), idle {100 * (1 - busy_ms / wall_ms):.1f}%')
    print(f'{len(kernels)} CUDA kernels, {len(kernels) / forwards:.0f} per forward over '
          f'{forwards} forwards; {wall_ms / forwards:.2f} ms wall per forward')

    averages = prof.key_averages()
    device_rows = sorted((a for a in averages if is_device_event(a)),
                         key=lambda a: -a.self_device_time_total)[:12]
    print('top CUDA kernels by device time: ms total, launches, name')
    for a in device_rows:
        print(f'  {a.self_device_time_total / 1e3:9.2f} {a.count:7d}  {a.key[:90]}')
    host_rows = sorted((a for a in averages if a.self_cpu_time_total > 0
                        and a.key.startswith('aten::')),
                       key=lambda a: -a.self_cpu_time_total)[:15]
    print('top host ops by self CPU time: ms total, calls, name')
    for a in host_rows:
        print(f'  {a.self_cpu_time_total / 1e3:9.2f} {a.count:7d}  {a.key}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
