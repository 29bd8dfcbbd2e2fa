"""Where the time of the PyTorch port's world-model train step goes, on one CUDA card.

    python3 scripts/profile_torch_train.py

Builds the bench world model as chip_smoke.py's train phase does (dim 512,
depth 8, float32 master weights, bf16 compute, flash attention on) with a
`BehaviorCloneTrainer`, and the b1 x T1024 batch. Warms up with one plain
and one shortcut step, then prints, for each variant, under torch.profiler,
one whole step: its wall time, the device's busy time (the sum of the CUDA
kernels' times) and idle share, the CUDA kernels launched, the launches and
device time of each kernel of the port (K1-K5, the pools',
`rms_normalize`'s and the GLU feedforward's), the host time, launches and
device and idle time of each of the port's spans (the step's parts: forward,
backward, optimizer, EMA, the attention calls by path and the pools;
`dreamer4_torch/tracing.py`, reduced by `benchmark/spans.py`), and the CUDA
kernels and host-side PyTorch ops that take the most time.
Imports torch, numpy, the port and the benchmark's span reduction only.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.spans import busy_intervals, reduce  # noqa: E402
from chip_smoke import (BENCH_MODEL, TRAIN, gpu_name_and_power_limit,  # noqa: E402
                        is_device_event, train_batch)
from dreamer4_torch import BehaviorCloneTrainer, DynamicsWorldModel  # noqa: E402
from dreamer4_torch.train.trainers import make_world_model_train_step  # noqa: E402

# name stems of the port's CUDA kernels (dreamer4_torch/csrc)
PORT_KERNELS = {'K1': 'flash_fwd_', 'K2': 'bwd_dq_', 'K3': 'bwd_dkv_', 'K4': 'small_fwd_',
                'K5': 'small_bwd_', 'pool': 'attn_pool_fwd', 'pool backward': 'attn_pool_bwd',
                'pool scale gradient': 'attn_pool_dscale', 'rms_normalize': 'attn_pool_rms_',
                'glu pack': 'glu_ff_pack', 'glu': 'glu_ff_fwd', 'glu backward': 'glu_ff_bwd',
                'glu unpack': 'glu_ff_unpack'}


def profile_step(step, label):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if is_device_event(e)]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(f'{label} under the profiler: {wall_ms:.1f} ms wall, device busy {busy_ms:.1f} ms '
          f'({100 * busy_ms / wall_ms:.1f}%), idle {100 * (1 - busy_ms / wall_ms):.1f}%; '
          f'{len(kernels)} CUDA kernels')
    for kid, prefix in PORT_KERNELS.items():
        mine = [e for e in kernels if prefix in e.name]
        print(f'  {kid}: {len(mine)} launches, '
              f'{sum(e.time_range.elapsed_us() for e in mine) / 1e3:.3f} ms device')
    events = prof.profiler.kineto_results.events()
    spans = reduce(events, min(e.start_ns() for e in events), max(e.end_ns() for e in events),
                   busy_intervals(events))
    print('  spans: ms host, ms device, ms idle, launches, calls, name')
    for name, sp in sorted(spans['by_name'].items()):
        print(f'    {sp["host_s"] * 1e3:9.2f} {sp["device_s"] * 1e3:9.2f} '
              f'{sp["idle_s"] * 1e3:9.2f} {sp["launches"]:7d} {sp["count"]:5d}  {name}')
    if spans['between_steps_idle_s'] is not None:
        print(f'    idle outside the train step: {spans["between_steps_idle_s"] * 1e3:.2f} ms')
    averages = prof.key_averages()
    device_rows = sorted((a for a in averages if is_device_event(a)),
                         key=lambda a: -a.self_device_time_total)[:12]
    print('  top CUDA kernels by device time: ms total, launches, name')
    for a in device_rows:
        print(f'    {a.self_device_time_total / 1e3:9.2f} {a.count:7d}  {a.key[:90]}')
    host_rows = sorted((a for a in averages if a.self_cpu_time_total > 0
                        and a.key.startswith('aten::')),
                       key=lambda a: -a.self_cpu_time_total)[:12]
    print('  top host ops by self CPU time: ms total, calls, name')
    for a in host_rows:
        print(f'    {a.self_cpu_time_total / 1e3:9.2f} {a.count:7d}  {a.key}')


def main() -> int:
    if not torch.cuda.is_available():
        print('profile_torch_train: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(gpu_name_and_power_limit(), flush=True)
    torch.manual_seed(0)
    model = DynamicsWorldModel(**BENCH_MODEL, dtype=torch.bfloat16)
    trainer = BehaviorCloneTrainer(model, learning_rate=3e-4, clip_grad_norm=1.0,
                                   with_ema=True, seed=0)
    step_fn = make_world_model_train_step(model, trainer.optimizer, ema_decay=0.999)
    batch = train_batch(model.device, 2)
    label = f'b{TRAIN["batch_size"]} x T{TRAIN["time_steps"]}'

    for shortcut in (False, True):
        def step():
            trainer.ts = step_fn(trainer.ts, batch, shortcut_train=shortcut,
                                 generator=trainer.generator)[0]
        step()
        profile_step(step, f'{"shortcut" if shortcut else "plain"} step {label}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
