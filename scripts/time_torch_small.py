"""Times the port's small-attention kernels (K4 forward, K5 backward) on one CUDA card.

    python3 scripts/time_torch_small.py
    python3 scripts/time_torch_small.py --root path/to/another/checkout
    python3 scripts/time_torch_small.py sweep
    python3 scripts/time_torch_small.py trace

Without `sweep`: K4 and K5 at every case of chip_smoke.py's
`small_kernel_cases()` (the tokenizer's time layer, the world model's space
and time layers at b8 x T32, in bf16 and float32, without the softclamp,
and the ragged n = 13 shapes), each timed four ways: device time under
torch.profiler of back-to-back calls on one set of inputs (L2-warm: a
case's inputs may sit in the 50 MB L2); the same with the inputs rotated
over enough sets to exceed 100 MB (L2-cold, the time a caller sees whose
inputs were written long before); CUDA events around back-to-back wrapper
calls (the host's launch overhead included); and the host's time to issue
one call without a synchronize, the wrapper's cost per call. Beside them
the bytes bound (chip_smoke.py's `small_bound_ms`) and the share of it each
device time reaches, the launch plan (heads per item, stages, grid), and
one PyTorch elementwise kernel that moves K4's bytes (`addcmul(q, k, v)`),
warm and L2-cold: what a plain streaming pass reaches on the card.

`trace`: K4 and K5 built again with -DSA_TRACE into
`dreamer4_torch/build/variants/`: when each block's first consumer warp
reached each point of its walk (csrc/small_attn_common.cuh).

`--root DIR` imports `dreamer4_torch` from the checkout DIR instead of this
one (its kernels built there), so that one call on one card times two
versions of the kernels and of their wrappers: run it for the parent, this
checkout, this checkout, the parent.

`sweep`: at every case but the one without a softclamp, K4 and K5 at
every plan they take (heads per item dividing h within the consumer-warp
limit, 1-3 stages where they fit), by L2-cold device time: the data
behind `small_plan`'s choices.

Imports torch, the port and chip_smoke.py only.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import itertools
import math
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

COLD_BYTES = 100e6    # inputs rotated over at least this many bytes: twice the L2


def host_ms(fn, iters=30):
    """The host's time to issue one call, without a synchronize."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def case_inputs(gen, B, n, h, dh, dtype, sets):
    return [tuple(torch.randn((B, n * h, dh), generator=gen, device='cuda').to(dtype)
                  for _ in range(4)) for _ in range(sets)]


def calls(sa, inputs, mask, h, softclamp):
    """(K4, K5) callables on each input set."""
    return ([functools.partial(sa.small_attend_flat, q, k, v, mask, h, softclamp_value=softclamp)
             for q, k, v, _ in inputs],
            [functools.partial(sa.small_attend_flat_bwd, q, k, v, do, mask, h,
                               softclamp_value=softclamp) for q, k, v, do in inputs])


def rotated(fns):
    it = itertools.cycle(fns)
    return lambda: next(it)()


def mask_of(kind, n):
    from dreamer4_torch.ops.masks import build_attend_mask
    if kind == 'causal':
        return build_attend_mask(n, n, causal=True, device='cuda')
    return build_attend_mask(n, n, num_special=1, block_size_per_special=n, device='cuda')


def cold_sets(B, n, h, dh, dtype):
    set_bytes = 4 * B * n * h * dh * torch.tensor([], dtype=dtype).element_size()
    return max(2, math.ceil(COLD_BYTES / set_bytes))


def time_cases(sa):
    gen = torch.Generator(device='cuda').manual_seed(2)
    for name, dtype, B, n, h, dh, kind, softclamp, _ in cs.small_kernel_cases():
        inputs = case_inputs(gen, B, n, h, dh, dtype, cold_sets(B, n, h, dh, dtype))
        mask = mask_of(kind, n)
        fwds, bwds = calls(sa, inputs, mask, h, softclamp)
        dt = str(dtype).split('.')[-1]
        print(f'{name} {dt} B{B} n{n} h{h} dh{dh} {kind}:', flush=True)
        # one PyTorch elementwise kernel that moves K4's bytes (q, k, v read,
        # one tensor of their shape written): what a plain streaming pass
        # reaches here
        outs = [torch.empty_like(q) for q, _, _, _ in inputs]
        passes = [functools.partial(torch.addcmul, q, k, v, out=o)
                  for (q, k, v, _), o in zip(inputs, outs)]
        print(f'   addcmul(q, k, v): device {cs.fmt_ms(cs.device_ms(passes[0]))}, L2-cold '
              f'{cs.fmt_ms(cs.device_ms(rotated(passes)))}', flush=True)
        for which, label, fns, match in (('fwd', 'K4', fwds, 'small_fwd_'),
                                         ('bwd', 'K5', bwds, 'small_bwd_')):
            bound, _ = cs.small_bound_ms(inputs[0][0], n, h, mask, which)
            warm = cs.device_ms(fns[0], match)
            cold = cs.device_ms(rotated(fns), match)
            events = cs.cuda_time_ms(fns[0])
            host = host_ms(fns[0])
            plan = ''
            if hasattr(sa, 'small_plan'):
                G, stages = sa.small_plan(n, h, dh, dtype, which)
                grid = min(B * h // G, sa.resident_blocks(which, n, h, dh, dtype))
                plan = f' plan G {G} stages {stages} grid {grid}'
            print(f'   {label}: device {warm:.4f} ms, L2-cold {cold:.4f} ms ({len(fns)} input '
                  f'sets), events {events:.4f} ms, host issue {host:.4f} ms; bound {bound:.4f} ms, '
                  f'share {bound / warm:.0%} warm, {bound / cold:.0%} cold{plan}', flush=True)


def plans(sa, n, h, dh, dtype, which):
    return [(g, s) for g in range(1, h + 1) if h % g == 0
            and sa.consumer_warps(n, g, dtype) <= sa.MAX_CONSUMER_WARPS for s in (1, 2, 3)
            if sa.small_smem_bytes(n, dh, dtype, which, g, s) <= sa.SMEM_LIMIT]


def sweep(sa):
    gen = torch.Generator(device='cuda').manual_seed(2)
    routed = sa.small_plan
    for name, dtype, B, n, h, dh, kind, softclamp, _ in cs.small_kernel_cases():
        if name == 'tok_time_noclamp':
            continue
        inputs = case_inputs(gen, B, n, h, dh, dtype, cold_sets(B, n, h, dh, dtype))
        mask = mask_of(kind, n)
        fwds, bwds = calls(sa, inputs, mask, h, softclamp)
        dt = str(dtype).split('.')[-1]
        for which, label, fns, match in (('fwd', 'K4', fwds, 'small_fwd_'),
                                         ('bwd', 'K5', bwds, 'small_bwd_')):
            bound, _ = cs.small_bound_ms(inputs[0][0], n, h, mask, which)
            cells = []
            for plan in plans(sa, n, h, dh, dtype, which):
                sa.small_plan = lambda *a, plan=plan: plan
                try:
                    cells.append(f'G{plan[0]} S{plan[1]} {cs.device_ms(rotated(fns), match):.4f}')
                finally:
                    sa.small_plan = routed
            print(f'sweep {label} {name} {dt}: bound {bound:.4f} ms; routed '
                  f'{routed(n, h, dh, dtype, which)}; L2-cold ms: ' + ', '.join(cells), flush=True)


def build_variant(cuda_build, sa, tag, defines):
    """Both kernels compiled with `defines`: {entry name: ctypes function}."""
    import subprocess
    out_dir = cuda_build.BUILD_DIR / 'variants'
    out_dir.mkdir(parents=True, exist_ok=True)
    entries = {}
    for name in ('small_attn_fwd', 'small_attn_bwd'):
        out = out_dir / f'{name}-{tag}.so'
        cmd = [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
               *[f'-D{k}={v}' for k, v in defines.items()], '-o', str(out),
               str(cuda_build.CSRC_DIR / f'{name}.cu')]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode:
            raise SystemExit(f'{tag}: nvcc failed for {name}:\n{r.stderr[-3000:]}')
        entries[name] = sa.declare_entry(getattr(ctypes.CDLL(str(out)), name), name)
    return entries


def trace(sa, cuda_build):
    """K4 and K5 in bf16 built with SA_TRACE (csrc/small_attn_common.cuh)
    at the main and one ragged case: per block, when its first consumer
    warp passed each point, in thousands of SM clocks since the block's
    start (10th / 50th / 90th percentile over the blocks that passed it in
    the last call), and the spread of the blocks' starts (globaltimer, ns)."""
    import numpy as np
    entries = build_variant(cuda_build, sa, 'trace', {'SA_TRACE': 1})
    port = sa._kernel_entry
    gen = torch.Generator(device='cuda').manual_seed(2)
    for name, dtype, B, n, h, dh, kind, softclamp, _ in cs.small_kernel_cases():
        if dtype != torch.bfloat16 or name not in ('tok_time', 'wm_space', 'wm_time',
                                                     'ragged_dh32'):
            continue
        q, k, v, do = case_inputs(gen, B, n, h, dh, dtype, 1)[0]
        mask = mask_of(kind, n)
        for which, label, middle in (('fwd', 'K4', 'released'), ('bwd', 'K5', 'dq out')):
            lib = ctypes.CDLL(str(cuda_build.BUILD_DIR / 'variants' / f'small_attn_{which}-trace.so'))
            read = getattr(lib, f'small_attn_{which}_trace')
            buf = np.zeros((8192, 16), dtype=np.uint64)
            assert read(ctypes.c_void_p(buf.ctypes.data)) == 0
            before = buf.copy()
            sa._kernel_entry = lambda nm: entries[nm]
            try:
                for _ in range(3):
                    if which == 'fwd':
                        sa.small_attend_flat(q, k, v, mask, h, softclamp_value=softclamp)
                    else:
                        sa.small_attend_flat_bwd(q, k, v, do, mask, h, softclamp_value=softclamp)
                torch.cuda.synchronize()
            finally:
                sa._kernel_entry = port
            assert read(ctypes.c_void_p(buf.ctypes.data)) == 0
            G, stages = sa.small_plan(n, h, dh, dtype, which)
            grid = min(B * h // G, sa.resident_blocks(which, n, h, dh, dtype))
            rows = buf[:grid].astype(np.float64)
            fresh = buf[:grid] != before[:grid]
            starts = rows[:, 0] - rows[:, 0].min()
            print(f'trace {label} {name}: plan G {G} stages {stages} grid {grid}; block starts '
                  f'(ns after the first) p50 {np.percentile(starts, 50):.0f} p90 '
                  f'{np.percentile(starts, 90):.0f} max {starts.max():.0f}', flush=True)
            names = {1: 'mask read', 15: 'end'}
            for j in range(4):
                names.update({2 + 3 * j: f'item {j} arrived', 3 + 3 * j: f'item {j} {middle}',
                              4 + 3 * j: f'item {j} stored'})
            for slot, text in sorted(names.items()):
                col = rows[:, slot][fresh[:, slot]] / 1e3
                if len(col):
                    print(f'   {text:<18} kclk p10 {np.percentile(col, 10):7.2f} p50 '
                          f'{np.percentile(col, 50):7.2f} p90 {np.percentile(col, 90):7.2f} '
                          f'({len(col)} blocks)', flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('mode', nargs='?', default='cases', choices=('cases', 'sweep', 'trace'))
    parser.add_argument('--root', help='import dreamer4_torch from this checkout')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('time_torch_small: no CUDA device', file=sys.stderr)
        return 1
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    from dreamer4_torch.ops import cuda_build
    from dreamer4_torch.ops import small_attention as sa

    print(cs.gpu_name_and_power_limit(), flush=True)
    print(f'# dreamer4_torch from {Path(sa.__file__).resolve().parents[2]}', flush=True)
    for name in ('small_attn_fwd', 'small_attn_bwd'):
        cuda_build.load(name)
    if args.mode == 'sweep':
        sweep(sa)
    elif args.mode == 'trace':
        trace(sa, cuda_build)
    else:
        time_cases(sa)
    return 0


if __name__ == '__main__':
    sys.exit(main())
