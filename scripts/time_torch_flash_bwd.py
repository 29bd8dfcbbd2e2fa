"""Times the flash-attention backward kernels K2 and K3 at the train shape on one CUDA card.

    python3 scripts/time_torch_flash_bwd.py
    python3 scripts/time_torch_flash_bwd.py '[["flash_attn_bwd_dkv", "path/to/variant.cu", {"NAME": 3}]]'

At t1024 bf16 (B=27, 8 heads, N=M=1024, D=64, causal, softclamp 50) each
kernel is timed four ways: CUDA events around 30 back-to-back wrapper calls;
the same at B=270, divided by 10, where the kernel's own time dominates; the
replay of a CUDA graph holding 10 captured calls; and the host's time to
issue one call, without a synchronize. Where the first reads much more than
the other three, the wrapper's host side, not the kernel, sets the pace of
back-to-back calls.

With an argument, each [entry point, source, {define: value}] is compiled
with nvcc (the port's flags, plus -D for each define) into
`dreamer4_torch/build/variants/`, swapped in for the port's library of that
entry point, held against the plain version and timed the same way: one
call compares variants of a kernel on one card. Imports torch and the port
only.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dreamer4_torch.ops import cuda_build as cb  # noqa: E402
from dreamer4_torch.ops import flash_attention as fa  # noqa: E402

CFG = dict(causal=True, softclamp_value=50.0)


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
    return name, tag, out, (r.stderr[-3000:] if r.returncode else ''), regs


def entry_point(path, name):
    fn = getattr(ctypes.CDLL(str(path)), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


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


def main() -> int:
    if not torch.cuda.is_available():
        print('time_torch_flash_bwd: no CUDA device', file=sys.stderr)
        return 1
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    jobs = json.loads(sys.argv[1]) if len(sys.argv) > 1 else []
    with ThreadPoolExecutor(8) as pool:
        variants = list(pool.map(build_variant, jobs))
    own = lambda name: (name, f'{name} (the port)', None, '', [])

    gen = torch.Generator(device='cuda').manual_seed(0)
    inputs = {}
    for B in (27, 270):
        q, k, v, do = (torch.randn((B, 8, 1024, 64), generator=gen, device='cuda').bfloat16()
                       for _ in range(4))
        o, lse = fa.flash_attend(q, k, v, 0, 1024, return_lse=True, **CFG)
        _, delta = fa.bwd_dq(q, k, v, o, lse, do, 0, 1024, **CFG)
        inputs[B] = (q, k, v, do, o, lse, delta)
    q, k, v, do, o, lse, delta = inputs[27]
    ref_dq, ref_delta = fa.bwd_dq_reference(q, k, v, o, lse, do, 0, 1024, **CFG)
    ref_dk, ref_dv = fa.bwd_dkv_reference(q, k, v, do, lse, ref_delta, 0, 1024, **CFG)
    rel = lambda a, r: ((a.float() - r.float()).abs().max() / r.float().abs().max()).item()

    def call(name, B):
        q, k, v, do, o, lse, delta = inputs[B]
        if name == 'flash_attn_bwd_dq':
            return lambda: fa.bwd_dq(q, k, v, o, lse, do, 0, 1024, **CFG)
        return lambda: fa.bwd_dkv(q, k, v, do, lse, delta, 0, 1024, **CFG)

    port_entry = fa._kernel_entry
    rows = [own('flash_attn_bwd_dq'), own('flash_attn_bwd_dkv'), *variants]
    for rep in range(2):
        for name, tag, path, err, regs in rows:
            if err:
                print(tag, 'BUILD FAILED', err)
                continue
            if path is not None:
                fn = entry_point(path, name)
                fa._kernel_entry = lambda n, fn=fn, name=name: fn if n == name else port_entry(n)
            try:
                if name == 'flash_attn_bwd_dq':
                    e = rel(call(name, 27)()[0], ref_dq)
                else:
                    dk, dv = call(name, 27)()
                    e = max(rel(dk, ref_dk), rel(dv, ref_dv))
                t_ev = events_ms(call(name, 27))
                t_big = events_ms(call(name, 270), iters=10) / 10
                t_graph = graph_ms(call(name, 27))
                t_host = host_ms(call(name, 27))
                print(f'{tag}: events {t_ev:.4f}, B270/10 {t_big:.4f}, graph {t_graph:.4f}, '
                      f'host issue {t_host:.4f} ms; rel err {e:.2e}'
                      + (f'; {regs}' if rep == 0 and regs else ''), flush=True)
            finally:
                fa._kernel_entry = port_entry
    return 0


if __name__ == '__main__':
    sys.exit(main())
