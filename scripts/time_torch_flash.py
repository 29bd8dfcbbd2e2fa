"""Times the port's flash-attention kernels (K1 forward, K2 and K3 backward) on one CUDA card.

    python3 scripts/time_torch_flash.py
    python3 scripts/time_torch_flash.py '[["flash_attn_fwd", "path/to/variant.cu", {"NAME": 3}]]'
    python3 scripts/time_torch_flash.py library

Without an argument: K1 at the train step's time attention (t1024: B=27, 8
heads, N=M=1024, D=64, causal, softclamp 50), at the world model's space
attention with its special token in both directions (s144: B=256, N=M=144),
at the prompted rollout's prefill (B=432, N=96, M=192, kv_len 96), with GQA
8/4 at N=M=128 (B=64; with and without the softclamp) and at a decode step
(B=432, N=1, kv_len 5), all at head dim 64, and at head dim 128 the t1024
and prefill geometries, in bf16, as `k1_variant` routes it and in each bf16
variant forced ('mma', 'sm90'); beside it the PyTorch call for the same
function (compiled flex_attention, or SDPA without a softclamp, as
chip_smoke.py picks them); then K2 and K3 at t1024. Each is
timed four ways: CUDA events around 30 back-to-back calls; the same at 10
times the batch, divided by 10, where the kernel's own time dominates; the
replay of a CUDA graph holding 10 captured calls; and the host's time to
issue one call, without a synchronize. Where the first reads much more than
the other three, the wrapper's host side, not the kernel, sets the pace of
back-to-back calls.

With a JSON list, each [entry point, source, {define: value}] is compiled
with nvcc (the port's flags, plus -D for each define) into
`dreamer4_torch/build/variants/`, swapped in for the port's library of that
entry point (K1's as its 'sm90' variant), held against the plain version and
timed the same way: one call compares variants of a kernel on one card.

`library`: the PyTorch calls that compute the kernels' functions at the
shapes chip_smoke.py times without one: flex_attention's backward at the
other bf16 cases of K2/K3, flex_attention and its backward at the float32
and n = 13 cases of K4/K5 (device time, as the kernels there), each or the
reason it gives none.

Imports torch, the port and chip_smoke.py only.
"""
from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from dreamer4_torch.ops import cuda_build as cb  # noqa: E402
from dreamer4_torch.ops import flash_attention as fa  # noqa: E402

BWD_CFG = dict(causal=True, softclamp_value=50.0)
# (name, B, Hq, H, N, M, D, offset, kv_len, cfg) of K1, bf16
CAUSAL = dict(causal=True, softclamp_value=50.0)
K1_CASES = [('t1024', 27, 8, 8, 1024, 1024, 64, 0, 1024, CAUSAL),
            *[(f's144_only_itself={o}', 256, 8, 8, 144, 144, 64, 0, 144,
               dict(softclamp_value=50.0, num_special=1, special_seq_len=144,
                    special_attend_only_itself=o)) for o in (False, True)],
            ('prefill', 432, 8, 8, 96, 192, 64, 0, 96, CAUSAL),
            *[(f'gqa_softclamp={c}', 64, 8, 4, 128, 128, 64, 0, 128,
               dict(causal=True, softclamp_value=c)) for c in (50.0, None)],
            ('decode', 432, 8, 8, 1, 192, 64, 4, 5, CAUSAL),
            ('t1024_d128', 27, 8, 8, 1024, 1024, 128, 0, 1024, CAUSAL),
            ('prefill_d128', 432, 8, 8, 96, 192, 128, 0, 96, CAUSAL)]


def build_variant(job):
    """nvcc of one [entry, source, defines] job: (entry, tag, library, the
    compiler's complaint or '', its register lines for the D=64 kernels)."""
    name, src, defs = job
    tag = Path(src).stem + ''.join(f'_{k}{v}' for k, v in defs.items())
    out_dir = cb.BUILD_DIR / 'variants'
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f'{tag}.so'
    cmd = [cb.find_nvcc(), *cb.NVCC_FLAGS, '-I', str(cb.CSRC_DIR),
           *[f'-D{k}={v}' for k, v in defs.items()], '-o', str(out), src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    log = (r.stdout + r.stderr).splitlines()
    regs = [' | '.join(x.strip()[-70:] for x in log[i + 1:i + 3]) for i, line in enumerate(log)
            if 'sm90ILi64ELb1' in line and 'Compiling' in line]
    regs += [x.strip()[-120:] for x in log if 'wgmma' in x]
    return name, tag, out, (r.stderr[-3000:] if r.returncode else ''), regs


def events_ms(fn, iters=30):
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, calls=10, reps=10):
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * calls)


def host_ms(fn, iters=30):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def four_ways(call, graph=True):
    """`call(scale)` gives the callable at 1 or 10 times the batch."""
    small, big = call(1), call(10)
    return (f'events {events_ms(small):.4f}, B x10 / 10 {events_ms(big, iters=10) / 10:.4f}, '
            f'graph {graph_ms(small) if graph else float("nan"):.4f}, '
            f'host issue {host_ms(small):.4f} ms')


def rel(a, r):
    return ((a.float() - r.float()).abs().max() / r.float().abs().max()).item()


def forced(variant):
    """Routes every K1 call to `variant` (None: as `k1_variant` would)."""
    return fa.k1_variant if variant is None else (lambda *_: variant)


def time_k1(rows, gen):
    """Each K1 case in each row's variant; the PyTorch call beside it."""
    for name, B, Hq, H, N, M, D, off, kvl, cfg in K1_CASES:
        inputs = {s: tuple(torch.randn(shape, generator=gen, device='cuda').bfloat16()
                           for shape in ((B * s, Hq, N, D), (B * s, H, M, D), (B * s, H, M, D)))
                  for s in (1, 10)}
        ref = fa.flash_attend_reference(*inputs[1], off, kvl, **cfg)
        call = lambda s: functools.partial(fa.flash_attend, *inputs[s], off, kvl, **cfg)
        print(f'K1 {name} (routed to {fa.k1_variant(N, M, D, torch.bfloat16)}):', flush=True)
        for tag, variant, entry in rows:
            port_entry, port_variant = fa._kernel_entry, fa.k1_variant
            if entry is not None:
                fa._kernel_entry = lambda n, port_entry=port_entry: (
                    entry if n == 'flash_attn_fwd' else port_entry(n))
            fa.k1_variant = forced(variant)
            try:
                err = (call(1)().float() - ref.float()).abs().max().item()
                print(f'   {tag}: {four_ways(call)}; max abs err {err:.2e}', flush=True)
            finally:
                fa._kernel_entry, fa.k1_variant = port_entry, port_variant
        full = {**dict(causal=False, num_special=0, special_seq_len=0,
                       special_attend_only_itself=False), **cfg}
        if cfg['softclamp_value'] is None:
            mask = fa.attend_mask(N, M, off, kvl, causal=full['causal'], device='cuda')
            name, lib = 'sdpa', lambda s: cs.sdpa_call(*inputs[s], mask)
        else:
            name = f'flex_attention {cs.FLEX_OPTIONS[torch.bfloat16][0]}'
            lib = lambda s: cs.flex_call(*inputs[s], off, kvl, full,
                                         cs.FLEX_OPTIONS[torch.bfloat16][0])
        try:
            err = (lib(1)().float() - ref.float()).abs().max().item()
        except Exception as e:   # the compiler refuses this setting at this shape
            print(f'   {name}: does not compile here ({type(e).__name__})', flush=True)
            continue
        print(f'   {name}: {four_ways(lib, graph=False)} (no graph); max abs err {err:.2e}',
              flush=True)


def time_bwd(rows, gen):
    inputs = {}
    for B in (27, 270):
        q, k, v, do = (torch.randn((B, 8, 1024, 64), generator=gen, device='cuda').bfloat16()
                       for _ in range(4))
        o, lse = fa.flash_attend(q, k, v, 0, 1024, return_lse=True, **BWD_CFG)
        _, delta = fa.bwd_dq(q, k, v, o, lse, do, 0, 1024, **BWD_CFG)
        inputs[B] = (q, k, v, do, o, lse, delta)
    q, k, v, do, o, lse, delta = inputs[27]
    ref_dq, ref_delta = fa.bwd_dq_reference(q, k, v, o, lse, do, 0, 1024, **BWD_CFG)
    ref_dk, ref_dv = fa.bwd_dkv_reference(q, k, v, do, lse, ref_delta, 0, 1024, **BWD_CFG)

    def call(name, scale):
        q, k, v, do, o, lse, delta = inputs[27 * scale]
        if name == 'flash_attn_bwd_dq':
            return lambda: fa.bwd_dq(q, k, v, o, lse, do, 0, 1024, **BWD_CFG)
        return lambda: fa.bwd_dkv(q, k, v, do, lse, delta, 0, 1024, **BWD_CFG)

    port_entry = fa._kernel_entry
    for name, tag, entry in rows:
        if entry is not None:
            fa._kernel_entry = lambda n, fn=entry, name=name: fn if n == name else port_entry(n)
        try:
            if name == 'flash_attn_bwd_dq':
                e = rel(call(name, 1)()[0], ref_dq)
            else:
                dk, dv = call(name, 1)()
                e = max(rel(dk, ref_dk), rel(dv, ref_dv))
            print(f'{tag} t1024: {four_ways(functools.partial(call, name))}; rel err {e:.2e}',
                  flush=True)
        finally:
            fa._kernel_entry = port_entry


def time_library():
    """flex_attention's backward at the other bf16 K2/K3 cases; flex and
    its backward at the float32 and n = 13 K4/K5 cases."""
    from dreamer4_torch.ops import small_attention as sa
    from dreamer4_torch.ops.masks import build_attend_mask

    gen = torch.Generator(device='cuda').manual_seed(1)
    for name, dtype, c in cs.bwd_kernel_cases():
        if dtype != torch.bfloat16 or name == 't1024':
            continue
        B, Hq, H, N, M, D = (c[x] for x in ('B', 'Hq', 'H', 'N', 'M', 'D'))
        q, k, v, do = (torch.randn(shape, generator=gen, device='cuda').to(dtype)
                       for shape in ((B, Hq, N, D), (B, H, M, D), (B, H, M, D), (B, Hq, N, D)))
        cfg = dict(softclamp_value=c['softclamp'], causal=c['causal'],
                   num_special=c.get('num_special', 0), special_seq_len=c.get('special_seq_len', 0),
                   special_attend_only_itself=c.get('special_attend_only_itself', False))
        off, kvl = c['offset'], c['kv_len']
        o, lse = fa.flash_attend_reference(q, k, v, off, kvl, return_lse=True, **cfg)
        ref_dq, delta = fa.bwd_dq_reference(q, k, v, o, lse, do, off, kvl, **cfg)
        refs = (ref_dq, *fa.bwd_dkv_reference(q, k, v, do, lse, delta, off, kvl, **cfg))
        ms, err, _ = cs.time_library_backward(q, k, v, do, off, kvl, cfg, refs,
                                              cs.GRAD_TOL[dtype])
        print(f'K2/K3 {name} bf16: flex backward (events) '
              + ('-' if ms is None else f'{ms:.4f} ms, rel err {err:.1e}'), flush=True)

    gen = torch.Generator(device='cuda').manual_seed(2)
    for name, dtype, B, n, h, dh, kind, softclamp, _ in cs.small_kernel_cases():
        if dtype != torch.float32 and not name.startswith('ragged'):
            continue
        q, k, v, do = (torch.randn((B, n * h, dh), generator=gen, device='cuda').to(dtype)
                       for _ in range(4))
        mask = (build_attend_mask(n, n, causal=True, device='cuda') if kind == 'causal' else
                build_attend_mask(n, n, num_special=1, block_size_per_special=n, device='cuda'))
        bias = sa.build_interleaved_bias(n, h, mask, device='cuda')
        ref = sa.small_attend_flat_reference(q, k, v, bias, softclamp)
        grad_refs = sa.small_attend_flat_bwd_reference(q, k, v, do, bias, softclamp)
        t = cs.time_small_library(
            q, k, v, do, h, mask, cs.small_flex_cfg(kind, n, softclamp), ref, grad_refs,
            cs.KERNEL_TOL[dtype], cs.GRAD_TOL[dtype])
        print(f'K4/K5 {name} {str(dtype).split(".")[-1]} B{B} n{n} h{h} dh{dh}: (device time) '
              f'fwd {cs.fmt_ms(t["fwd"])} ({t["name"]}), bwd {cs.fmt_ms(t["bwd"])} (flex '
              f'backward); CUDA events fwd {cs.fmt_ms(t["fwd_call"])}, bwd '
              f'{cs.fmt_ms(t["bwd_call"])}', flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print('time_torch_flash: no CUDA device', file=sys.stderr)
        return 1
    print(cs.gpu_name_and_power_limit(), flush=True)
    arg = sys.argv[1] if len(sys.argv) > 1 else '[]'
    if arg == 'library':
        time_library()
        return 0
    with ThreadPoolExecutor(8) as pool:
        variants = list(pool.map(build_variant, json.loads(arg)))
    k1_rows = [('routed', None, None), ('mma', 'mma', None), ('sm90', 'sm90', None)]
    bwd_rows = [(n, f'{n} (the port)', None) for n in ('flash_attn_bwd_dq', 'flash_attn_bwd_dkv')]
    for name, tag, path, err, regs in variants:
        if err:
            print(tag, 'BUILD FAILED', err)
            continue
        print(tag, regs, flush=True)
        entry = fa.declare_entry(getattr(ctypes.CDLL(str(path)), name), name)
        if name == 'flash_attn_fwd':
            k1_rows.append((tag, 'sm90', entry))
        else:
            bwd_rows.append((name, tag, entry))
    gen = torch.Generator(device='cuda').manual_seed(0)
    time_k1(k1_rows, gen)
    time_bwd(bwd_rows, gen)
    return 0


if __name__ == '__main__':
    sys.exit(main())
