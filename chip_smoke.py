"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:
  1. build   — compiles every CUDA kernel of the port from the sources in
               this checkout (`dreamer4_torch/csrc` into `dreamer4_torch/build`),
               one nvcc per source, all at once.
  2. kernels — holds each kernel against its plain PyTorch version on the
               card at the shapes the rollout and the train step give it,
               with stated tolerances (K3 runs from the delta K2 wrote), and
               times the kernel, the plain version, its bound and the
               PyTorch call that computes the same function (SDPA without a
               softclamp, compiled `flex_attention` with one; for the
               backward pair K2 + K3, flex_attention's backward). A bound
               is the largest of three times: the bytes at the memory rate,
               the matrix operations at the tensor-core (or float32) peak,
               and the transcendentals (2 per pair with a softclamp, else 1)
               on the exponential unit, 16 per clock per SM at the card's
               maximum SM clock; the line says which binds.
  3. model   — builds the bench world model (dim 512, depth 8, bf16) from a
               seed and drives `generate` twice: the unprompted b16 x T16
               rollout, which launches no kernel, and the prompted
               b16 x T192 rollout with a 96-frame prompt, whose prompt pass
               runs K1 on both time layers. Then the same prompt pass runs
               in bf16 with the kernel and with the plain attention, each
               held against the pass in float32.
  4. train   — builds the bench world model with float32 master weights and
               bf16 compute, and trains it at b1 x T1024 (the bench's
               long-sequence step) through `BehaviorCloneTrainer`: one plain
               and one shortcut step through the train-step function, then
               one `train_on_batch`. Both time layers run K1 with its LSE
               and K2 and K3 on every step. The plain step's loss and
               time-layer gradients through the kernels are held against
               float32, and both variants are timed.
  5. tokenizer — builds the bench tokenizer (dim 512, 64 x 64, patch 8, 16
               latents, depth 4 + 4, 4 flow steps, bf16, `use_fused_small`)
               from a seed and drives `encode`, `decode` and two train
               steps through `TokenizerTrainer` on b8 x T16 video; each
               time layer runs K4, and K5 in the backward. The step's loss
               and time-layer gradients through K4/K5 are held against
               float32.
  6. wm-fused — the bench world model with `use_fused_small` at b8 x T32:
               a plain and a shortcut step through `BehaviorCloneTrainer`,
               every space and time layer on K4/K5, the gradients held
               against float32 as in phase 4.
  7. small   — K4 and K5 (the small-attention forward and backward) against
               their plain versions at the tokenizer's time layer and the
               world model's b8 x T32 space and time layers, in bf16 and
               float32, without the softclamp, and at ragged shapes; timed
               beside their bounds, their plain versions and the PyTorch
               call for the same function (SDPA, compiled
               `flex_attention`, flex's backward). K4 and K5 run for tens
               of microseconds, so their times (and the library's) are
               device times under torch.profiler. Then the device times of
               K2, K3 and flex's backward at t1024 bf16, beside phase 2's
               CUDA-event times. The profiler can leave a cost on every
               later launch of the process, so this phase runs last, after
               every timed model phase.
Launch counts (K1 to K5) are set to 0 just before each rollout, encode,
decode and train step and read just after.

The last three lines of standard output are a JSON line with one entry per
kernel, the card's name and power limit, and the result line
`{"ok": true, "device": {...}}`. Imports torch, numpy and the port only.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core peak
                  torch.float32: 67e12}     # float32 outside the tensor cores
# the exponential unit: special-function operations (ex2, rcp, tanh) per
# clock on each SM of a Hopper card
SFU_OPS_PER_CLOCK_PER_SM = 16
# kernel vs plain version: f32 differs by summation order only; bf16 by one
# rounding of the output (1 ulp at |o| < 4 is 1.6e-2) and of p before PV
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-3
# K2 / K3 vs their plain versions, as a fraction of the largest gradient
# entry: float32 2e-4 (the kernels' one-exponential softclamp moves a score
# by up to c * 1e-6, so p by that relative amount, plus summation order);
# bf16 1e-2 (one rounding of each output, 2^-9 of it, plus ds and p rounded
# to bf16 at the TPU kernel's points, where the two may round values that
# differ in their last float32 bits to neighbouring bf16 values)
GRAD_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}
# the delta K2 writes vs `attention_delta`, relative to its largest entry:
# both sum rowsum(dO * O) in float32, in another order
DELTA_TOL = 1e-5

# bench.py:174-193 on the accelerator: flash on, bf16, no terminal head
BENCH_MODEL = dict(dim=512, dim_latent=32, num_latent_tokens=16, num_spatial_tokens=16,
                   max_steps=64, depth=8, time_block_every=4, attn_heads=8, attn_dim_head=64,
                   num_discrete_actions=(4,), multi_token_pred_len=8, num_register_tokens=8,
                   predict_terminals=False, use_flash_attention=True)
HEADLINE = dict(batch_size=16, time_steps=16, num_steps=4)    # bench.py:363-387
PROMPTED = dict(batch_size=16, time_steps=192, num_steps=4)   # cli.py:276-289, prompt = T/2
PROMPT_LEN = 96
K1_PER_PROMPTED_ROLLOUT = 2    # 2 time layers x 1 prompt pass
# prompt pass in bf16 through K1, held against the same pass in float32: its
# error may be at most this multiple of the plain bf16 attention's error.
# Both round differently (K1 rounds p before PV and normalizes last), so
# either may come out ahead by a little.
PREFILL_TOL_FACTOR = 2.0

# bench.py:166, :437-442, :655-674: the long-sequence train step, b1 x T1024,
# latents N(0, 1) * 0.5, zero rewards, zero discrete actions
TRAIN = dict(batch_size=1, time_steps=1024)
# (K1, K2, K3, K4, K5) launches per train step: two time layers; a shortcut
# step adds the two no-grad half-step passes, K1 without its LSE
LAUNCHES_PER_STEP = {False: (2, 2, 2, 0, 0), True: (6, 2, 2, 0, 0)}
TIME_LAYERS = (3, 7)   # (i + 1) % time_block_every == 0 at depth 8

# bench.py:516-521: the bench tokenizer, here with the small-attention path
# on. 80 tokens per frame: space attention (n*h = 640 > 512) stays on the
# generic path; each trunk's one time layer (T = 16, n*h = 128) runs K4/K5
BENCH_TOKENIZER = dict(dim=512, dim_latent=32, patch_size=8, image_height=64, image_width=64,
                       num_latent_tokens=16, encoder_depth=4, decoder_depth=4,
                       time_block_every=4, decoder_flow_steps=4, use_flash_attention=True,
                       use_fused_small=True)
TOK_VIDEO = dict(batch_size=8, time_steps=16)    # bench.py:524
TOK_TIME_LAYERS = ('encoder_transformer.attn_3', 'decoder.transformer.attn_3')
# (K1..K5) launches: encode one K4 (its time layer); decode 4 flow steps of
# one K4 each; a train step one K4 and one K5 in each trunk
TOK_LAUNCHES = {'tok_encode': (0, 0, 0, 1, 0), 'tok_decode': (0, 0, 0, 4, 0),
                'tok_train_step': (0, 0, 0, 2, 2), 'tok_train_on_batch': (0, 0, 0, 2, 2)}

# bench.py:165: the world model's b8 x T32 train step, with the small path:
# 6 space layers (n = 27, n*h = 216) and 2 time layers (n = 32, 256) on
# K4/K5; a shortcut step adds two no-grad passes of K4 only
WM_FUSED = dict(batch_size=8, time_steps=32)
WM_FUSED_LAUNCHES = {False: (0, 0, 0, 8, 8), True: (0, 0, 0, 24, 8)}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


@functools.cache
def sfu_ops_per_s() -> float:
    """The card's exponential-unit rate: 16 per clock per SM x its SMs x its
    maximum SM clock (`nvidia-smi --query-gpu=clocks.max.sm`)."""
    out = subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm',
                          '--format=csv,noheader,nounits'],
                         capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6


def roofline(bytes_moved, ops, dtype, transcendentals):
    """The least time of work that moves `bytes_moved` at the memory rate,
    does `ops` at the peak rate of `dtype` and `transcendentals` on the
    exponential unit: (ms, 'bytes' or 'operations' for the kernels line,
    which of the three binds, each term in ms)."""
    terms = {'bytes': bytes_moved / H100_BYTES_PER_S, 'operations': ops / PEAK_OPS_PER_S[dtype],
             'exponential unit': transcendentals / sfu_ops_per_s()}
    unit = max(terms, key=terms.get)
    return (terms[unit] * 1e3, 'bytes' if unit == 'bytes' else 'operations', unit,
            {k: v * 1e3 for k, v in terms.items()})


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def is_device_event(event) -> bool:
    """A CUDA kernel or copy of a torch.profiler trace; not a user
    annotation's range on the device (`Optimizer.step` records one,
    spanning the kernels it launches)."""
    return (getattr(event, 'device_type', None) == torch.autograd.DeviceType.CUDA
            and not getattr(event, 'is_user_annotation', False))


def device_ms(fn, match: str | None = None, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time per call of `fn` under torch.profiler over `iters`
    calls. Without `match`, the summed times of all the CUDA kernels the
    calls launch, per call. With `match`, each call launches exactly one
    kernel whose name contains it, and the time per call is the mean
    duration of the matching kernels the trace holds: a trace has been seen
    to hold fewer of them than calls were made (the line says so). Unlike
    `cuda_time_ms` it does not count the device's idle time while the host
    prepares a launch, which is most of a call that runs for tens of
    microseconds. A trace that holds none of those kernels is taken again,
    up to three times in all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if is_device_event(e)
                   and (match is None or match in e.name)]
        if kernels:
            total_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
            if match is None:
                return total_ms / iters
            if len(kernels) != iters:
                print(f'# the trace held {len(kernels)} of {iters} launches of {match}', flush=True)
            return total_ms / len(kernels)
        print(f'# a profiler trace held no device time{f" of {match}" if match else ""}; '
              'taking it again', flush=True)
    raise SystemExit(f'the profiler saw no device time{f" of {match}" if match else ""}')


def host_time_s(fn, reps: int) -> float:
    """Mean wall time of `fn`, synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


# ------------------------------------------------------------------ kernels

def attention_bound_ms(q, k, mask, softclamp, return_lse=False):
    """Least time for the work these inputs need (`roofline`): q read and o
    written once, the k/v rows some query may see read once; 4*D operations
    per unmasked (q, k) pair (score and PV), at the peak rate of the input
    type; per pair 2 transcendentals with a softclamp (tanh, exp), else 1."""
    B, Hq, N, D = q.shape
    H = k.shape[1]
    elem = q.element_size()
    kv_rows = int(mask.any(dim=0).sum())
    bytes_moved = 2 * B * Hq * N * D * elem + 2 * B * H * kv_rows * D * elem
    if return_lse:
        bytes_moved += B * Hq * N * 4
    pairs = int(mask.sum()) * B * Hq
    return roofline(bytes_moved, 4 * D * pairs, q.dtype, pairs * (2 if softclamp else 1))


def kernel_cases():
    bf16, f32 = torch.bfloat16, torch.float32
    # the prompted rollout's prompt pass: b*s = 16*27 rows, P=96 over T=192
    prefill = dict(B=432, Hq=8, H=8, N=96, M=192, D=64, causal=True, offset=0, kv_len=96)
    cases = [('prefill', dt, dict(prefill, softclamp=50.0)) for dt in (bf16, f32)]
    cases.append(('prefill_noclamp', bf16, dict(prefill, softclamp=None)))
    for dt in (bf16, f32):
        cases.append(('decode', dt, dict(prefill, N=1, offset=4, kv_len=5, softclamp=50.0)))
    for only_itself in (False, True):
        for dt in (bf16, f32):
            cases.append((f'space_special_only_itself={only_itself}', dt,
                          dict(B=256, Hq=8, H=8, N=144, M=144, D=64, causal=False, offset=0,
                               kv_len=144, softclamp=50.0, num_special=1, special_seq_len=144,
                               special_attend_only_itself=only_itself)))
    for sc in (50.0, None):
        cases.append((f'gqa_softclamp={sc}', bf16,
                      dict(B=64, Hq=8, H=4, N=128, M=128, D=64, causal=True, offset=0,
                           kv_len=128, softclamp=sc)))
    cases.append(('t1024', bf16, dict(B=27, Hq=8, H=8, N=1024, M=1024, D=64, causal=True,
                                      offset=0, kv_len=1024, softclamp=50.0)))
    for d in (16, 32, 128):
        for dt in (bf16, f32):
            cases.append((f'head_dim_{d}_lse', dt,
                          dict(B=4, Hq=4, H=2, N=77, M=130, D=d, causal=True, offset=3,
                               kv_len=101, softclamp=30.0, lse=True)))
    return cases


def sdpa_call(q, k, v, mask):
    """K1's function without a softclamp as one PyTorch call: SDPA with the
    same boolean mask. A yardstick only; the port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=q.shape[1] != k.shape[1])


# flex_attention's default tiles spill registers at head dim 64 in float32
# (85 ms at the prefill shape in an earlier run of this script) and are
# slower than these in bf16; the yardstick is the faster of these settings
FLEX_OPTIONS = {torch.bfloat16: (dict(BLOCK_M=64, BLOCK_N=64),
                                 dict(BLOCK_M=32, BLOCK_N=32, num_stages=1)),
                torch.float32: (dict(BLOCK_M=32, BLOCK_N=32, num_stages=1),)}


def flex_call(q, k, v, offset, kv_len, cfg, options):
    """K1's function with a softclamp as one PyTorch call: `flex_attention`,
    compiled, with the softclamp as its score_mod and the mask predicates
    (kv_len, causal under the offset, periodic special tokens) as its block
    mask, so wholly masked blocks are skipped as K1 skips them. A yardstick
    only; the port never calls it."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    N, M, c = q.shape[2], k.shape[2], cfg['softclamp_value']
    causal, ns = cfg['causal'], cfg['num_special']
    L = cfg['special_seq_len'] if cfg['special_seq_len'] > 0 else M
    only_itself = cfg['special_attend_only_itself']

    def mask_mod(b, h, q_idx, kv_idx):
        q_pos = q_idx + offset
        keep = kv_idx < kv_len
        if causal:
            keep = keep & (kv_idx <= q_pos)
        if ns > 0:
            q_sp, k_sp = q_pos % L >= L - ns, kv_idx % L >= L - ns
            keep = keep & ~((q_sp & ~k_sp) if only_itself else (~q_sp & k_sp))
        return keep

    def softclamp(score, b, h, q_idx, kv_idx):
        return torch.tanh(score / c) * c

    block_mask = create_block_mask(mask_mod, None, None, N, M, device=q.device)
    # a fresh compile per case: no case runs into dynamo's recompile limit
    # and falls back to the eager version, which is no yardstick
    torch._dynamo.reset()
    flex = torch.compile(flex_attention, dynamic=False)
    return lambda: flex(q, k, v, score_mod=softclamp, block_mask=block_mask,
                        enable_gqa=q.shape[1] != k.shape[1], kernel_options=options)


def time_library(q, k, v, offset, kv_len, cfg, mask, ref, tol, timer=cuda_time_ms):
    """(name, ms, max abs error against the plain version) of the one PyTorch
    call that computes K1's function here, timed by `timer`; ms is None
    where no setting of it compiles or agrees with the plain version within
    the kernel's tolerance."""
    if cfg['softclamp_value'] is None:
        candidates = [('sdpa', sdpa_call(q, k, v, mask))]
    else:
        candidates = [(f'flex {o}', flex_call(q, k, v, offset, kv_len, cfg, o))
                      for o in FLEX_OPTIONS[q.dtype]]
    best = ('-', None, None)
    for name, fn in candidates:
        try:
            err = (fn().float() - ref.float()).abs().max().item()
        except Exception as e:   # the compiler refuses this setting at this shape
            log(f'#   {name}: does not compile here ({type(e).__name__})')
            continue
        if err > tol:
            log(f'#   {name}: max_abs_err {err:.3e} above {tol:.0e}, not a yardstick')
            continue
        ms = timer(fn)
        if best[1] is None or ms < best[1]:
            best = (name, ms, err)
    return best


def run_kernel_phase():
    """K1 against `flash_attend_reference` on every case; returns the
    measurements of each case by (name, dtype)."""
    from dreamer4_torch.ops import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(0)
    results, failures = {}, []
    for name, dtype, c in kernel_cases():
        B, Hq, H, N, M, D = (c[x] for x in ('B', 'Hq', 'H', 'N', 'M', 'D'))
        q, k, v = (torch.randn(shape, generator=gen, device='cuda').to(dtype)
                   for shape in ((B, Hq, N, D), (B, H, M, D), (B, H, M, D)))
        cfg = dict(softclamp_value=c['softclamp'], causal=c['causal'],
                   num_special=c.get('num_special', 0),
                   special_seq_len=c.get('special_seq_len', 0),
                   special_attend_only_itself=c.get('special_attend_only_itself', False))
        want_lse = c.get('lse', False)
        off, kvl = c['offset'], c['kv_len']
        out = fa.flash_attend(q, k, v, off, kvl, return_lse=want_lse, **cfg)
        ref = fa.flash_attend_reference(q, k, v, off, kvl, return_lse=want_lse, **cfg)
        torch.cuda.synchronize()
        if want_lse:
            (out, lse), (ref, ref_lse) = out, ref
        err = (out.float() - ref.float()).abs().max().item()
        tol = KERNEL_TOL[dtype]
        ok = err <= tol and bool(torch.isfinite(out).all())
        line_lse = ''
        if want_lse:
            lse_err = (lse - ref_lse).abs().max().item()
            ok = ok and lse_err <= LSE_TOL
            line_lse = f' lse_err {lse_err:.2e} (tol {LSE_TOL:.0e})'
        ms = cuda_time_ms(lambda: fa.flash_attend(q, k, v, off, kvl, **cfg))
        plain_ms = cuda_time_ms(lambda: fa.flash_attend_reference(q, k, v, off, kvl, **cfg))
        mask = fa.attend_mask(N, M, off, kvl, device='cuda', **{
            x: cfg[x] for x in ('causal', 'num_special', 'special_seq_len',
                                'special_attend_only_itself')})
        # SDPA takes no softclamp; flex_attention takes it as a score_mod
        lib_name, library_ms, lib_err = time_library(q, k, v, off, kvl, cfg, mask, ref, tol)
        lib = ('library -' if library_ms is None else
               f'library {library_ms:.4f} ms ({lib_name}, its err {lib_err:.1e})')
        bound_ms, bound_by, unit, _ = attention_bound_ms(q, k, mask, cfg['softclamp_value'],
                                                         want_lse)
        log(f'K1 {name:<34} {str(dtype).split(".")[-1]:<8} max_abs_err {err:.3e} '
            f'(tol {tol:.0e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms {lib} '
            f'bound {bound_ms:.4f} ms ({unit}){line_lse}' + ('' if ok else '  FAIL'))
        if not ok:
            failures.append(f'{name}/{dtype}')
        results[(name, dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      library_ms=library_ms, bound_ms=bound_ms,
                                      bound_by=bound_by)
    if failures:
        raise SystemExit(f'kernel phase failed: {failures}')
    return results


# ------------------------------------------------------- backward kernels

def bwd_kernel_cases():
    bf16, f32 = torch.bfloat16, torch.float32
    # the train step's time attention: b*s = 27 rows, T = 1024, causal
    t1024 = dict(B=27, Hq=8, H=8, N=1024, M=1024, D=64, causal=True, offset=0, kv_len=1024,
                 softclamp=50.0)
    cases = [('t1024', dt, t1024) for dt in (bf16, f32)]
    cases.append(('gqa', bf16, dict(B=64, Hq=8, H=4, N=128, M=128, D=64, causal=True, offset=0,
                                    kv_len=128, softclamp=50.0)))
    for only_itself in (False, True):
        for dt in (bf16, f32):
            cases.append((f'space_special_only_itself={only_itself}', dt,
                          dict(B=256, Hq=8, H=8, N=144, M=144, D=64, causal=False, offset=0,
                               kv_len=144, softclamp=50.0, num_special=1, special_seq_len=144,
                               special_attend_only_itself=only_itself)))
    cases.append(('ragged_offset', bf16, dict(B=16, Hq=8, H=4, N=130, M=192, D=64, causal=True,
                                              offset=20, kv_len=150, softclamp=50.0,
                                              num_special=2, special_seq_len=9)))
    cases.append(('negative_offset', bf16, dict(B=16, Hq=8, H=8, N=100, M=96, D=64, causal=True,
                                                offset=-7, kv_len=96, softclamp=50.0)))
    for d in (16, 32, 128):
        for dt in (bf16, f32):
            cases.append((f'head_dim_{d}', dt,
                          dict(B=4, Hq=4, H=2, N=77, M=130, D=d, causal=True, offset=3,
                               kv_len=101, softclamp=30.0)))
    return cases


def backward_bound_ms(q, k, mask, which, softclamp):
    """Least time for the work of K2 (`which='dq'`) or K3 ('dkv') on these
    inputs (`roofline`). K2: the q, dO and o rows that see some key, the k
    and v rows that some query sees and the lse of those q rows read once,
    dq and delta written once; 6*D operations per unmasked pair (s, dp, dq).
    K3: the same q and dO rows, k and v rows and lse and delta read once, dk
    and dv written once; 8*D operations per pair (s, dp, dv, dk). Each at
    the peak rate of the input type, with 2 transcendentals per pair with a
    softclamp (tanh, exp), else 1."""
    B, Hq, N, D = q.shape
    H, M = k.shape[1], k.shape[2]
    elem = q.element_size()
    q_rows, kv_rows = int(mask.any(dim=1).sum()), int(mask.any(dim=0).sum())
    kv_bytes = 2 * B * H * kv_rows * D * elem
    pairs = int(mask.sum()) * B * Hq
    if which == 'dq':
        bytes_moved = (3 * B * Hq * q_rows * D * elem + kv_bytes + B * Hq * q_rows * 4
                       + B * Hq * N * D * elem + B * Hq * N * 4)
        ops = 6 * D * pairs
    else:
        bytes_moved = (2 * B * Hq * q_rows * D * elem + kv_bytes + 2 * B * Hq * q_rows * 4
                       + 2 * B * H * M * D * elem)
        ops = 8 * D * pairs
    return roofline(bytes_moved, ops, q.dtype, pairs * (2 if softclamp else 1))


def rel_err(out, ref):
    ref = ref.float()
    return ((out.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def time_library_backward(q, k, v, do, offset, kv_len, cfg, refs, tol):
    """(ms, relative error, (fwd+bwd, fwd) callables) of the backward of
    compiled `flex_attention` (fwd+bwd less fwd, both with inputs that
    require grad): the PyTorch call that computes dq, dk and dv together,
    the work of K2 + K3. A yardstick only; the port never calls it. ms and
    the callables are None where it does not compile or disagrees with the
    plain backward."""
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    try:
        fwd = flex_call(qg, kg, vg, offset, kv_len, cfg, FLEX_OPTIONS[q.dtype][0])
        grads = lambda: torch.autograd.grad(fwd(), (qg, kg, vg), do)
        err = max(rel_err(g, r) for g, r in zip(grads(), refs))
    except Exception as e:   # the compiler refuses this setting at this shape
        log(f'#   flex backward: does not compile here ({type(e).__name__}: {e})'[:300])
        return None, None, None
    if err > tol:
        log(f'#   flex backward: rel err {err:.3e} above {tol:.0e}, not a yardstick')
        return None, err, None
    return cuda_time_ms(grads) - cuda_time_ms(fwd), err, (grads, fwd)


def run_backward_kernel_phase():
    """K2 and K3 against `bwd_dq_reference` / `bwd_dkv_reference` on every
    case, from the same q, k, v, o, dO and LSE, K3 from the delta K2 wrote
    (and the plain K3 from the plain K2's); returns the measurements of each
    case by (name, dtype), and the callables of K2, K3 and flex's backward
    at t1024 bf16 for the device times of the last phase."""
    from dreamer4_torch.ops import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(1)
    results, failures, t1024_calls = {}, [], None
    for name, dtype, c in bwd_kernel_cases():
        B, Hq, H, N, M, D = (c[x] for x in ('B', 'Hq', 'H', 'N', 'M', 'D'))
        q, k, v, do = (torch.randn(shape, generator=gen, device='cuda').to(dtype)
                       for shape in ((B, Hq, N, D), (B, H, M, D), (B, H, M, D), (B, Hq, N, D)))
        cfg = dict(softclamp_value=c['softclamp'], causal=c['causal'],
                   num_special=c.get('num_special', 0),
                   special_seq_len=c.get('special_seq_len', 0),
                   special_attend_only_itself=c.get('special_attend_only_itself', False))
        off, kvl = c['offset'], c['kv_len']
        o, lse = fa.flash_attend_reference(q, k, v, off, kvl, return_lse=True, **cfg)
        dq_args = (q, k, v, o, lse, do, off, kvl)
        dq, delta = fa.bwd_dq(*dq_args, **cfg)
        dk, dv = fa.bwd_dkv(q, k, v, do, lse, delta, off, kvl, **cfg)
        ref_dq, ref_delta = fa.bwd_dq_reference(*dq_args, **cfg)
        dkv_args = (q, k, v, do, lse, ref_delta, off, kvl)
        ref_dk, ref_dv = fa.bwd_dkv_reference(*dkv_args, **cfg)
        torch.cuda.synchronize()
        tol = GRAD_TOL[dtype]
        errs = {n: rel_err(out, ref) for n, out, ref in
                (('dq', dq, ref_dq), ('dk', dk, ref_dk), ('dv', dv, ref_dv))}
        delta_err = rel_err(delta, ref_delta)
        finite = all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
        ok = finite and max(errs.values()) <= tol and delta_err <= DELTA_TOL
        abs_err = {'dq': (dq.float() - ref_dq.float()).abs().max().item(),
                   'dkv': max((dk.float() - ref_dk.float()).abs().max().item(),
                              (dv.float() - ref_dv.float()).abs().max().item())}
        mask = fa.attend_mask(N, M, off, kvl, device='cuda', **{
            x: cfg[x] for x in ('causal', 'num_special', 'special_seq_len',
                                'special_attend_only_itself')})
        # partial, not lambda: t1024's calls are timed again after the loop
        # has moved on to other cases
        kernels = {'dq': functools.partial(fa.bwd_dq, *dq_args, **cfg),
                   'dkv': functools.partial(fa.bwd_dkv, q, k, v, do, lse, delta, off, kvl, **cfg)}
        plains = {'dq': functools.partial(fa.bwd_dq_reference, *dq_args, **cfg),
                  'dkv': functools.partial(fa.bwd_dkv_reference, *dkv_args, **cfg)}
        row = {}
        for which in ('dq', 'dkv'):
            bound_ms, bound_by, unit, terms = backward_bound_ms(q, k, mask, which,
                                                                cfg['softclamp_value'])
            row[which] = dict(max_abs_err=abs_err[which], ms=cuda_time_ms(kernels[which]),
                              plain_ms=cuda_time_ms(plains[which], iters=5), bound_ms=bound_ms,
                              bound_by=bound_by, bound_unit=unit, bounds_ms=terms,
                              library_ms=None)
        lib = ''
        if name == 't1024':
            lib_ms, lib_err, lib_calls = time_library_backward(q, k, v, do, off, kvl, cfg,
                                                               (ref_dq, ref_dk, ref_dv), tol)
            for which in ('dq', 'dkv'):
                row[which]['library_ms'] = lib_ms
            pair = row['dq']['ms'] + row['dkv']['ms']
            lib = ('   library -' if lib_ms is None else
                   f'   K2 + K3 {pair:.4f} ms vs flex backward (dq+dk+dv) {lib_ms:.4f} ms '
                   f'({pair / lib_ms:.2f}x), its rel err {lib_err:.1e}')
            if dtype == torch.bfloat16 and lib_calls is not None:
                t1024_calls = dict(kernels, flex=lib_calls)
        dt = str(dtype).split('.')[-1]
        log(f'K2/K3 {name:<32} {dt:<8} rel err dq {errs["dq"]:.2e} dk {errs["dk"]:.2e} '
            f'dv {errs["dv"]:.2e} (tol {tol:.0e}), delta {delta_err:.1e} (tol {DELTA_TOL:.0e})'
            + ('' if ok else '  FAIL'))
        for which, label in (('dq', 'K2'), ('dkv', 'K3')):
            r = row[which]
            terms = ', '.join(f'{u} {t:.4f}' for u, t in r['bounds_ms'].items())
            log(f'   {label} kernel {r["ms"]:.4f} ms plain {r["plain_ms"]:.4f} ms '
                f'bound {r["bound_ms"]:.4f} ms ({r["bound_unit"]}; {terms})')
        if lib:
            log(lib)
        if not ok:
            failures.append(f'{name}/{dt}')
        results[(name, dtype)] = row
    if failures:
        raise SystemExit(f'backward kernel phase failed: {failures}')
    return results, t1024_calls


def backward_device_times(row, calls):
    """Device times under torch.profiler of K2, K3 and flex's backward
    (fwd+bwd less fwd) at t1024 bf16, into `row`; run after the timed model
    phases, as `device_ms` can leave a cost on later launches."""
    row['dq']['device_ms'] = device_ms(calls['dq'], 'bwd_dq_')
    row['dkv']['device_ms'] = device_ms(calls['dkv'], 'bwd_dkv_')
    grads, fwd = calls['flex']
    flex_ms = device_ms(grads) - device_ms(fwd)
    for which in ('dq', 'dkv'):
        row[which]['library_device_ms'] = flex_ms
    pair = row['dq']['device_ms'] + row['dkv']['device_ms']
    log(f'K2/K3 t1024 bf16 device time: K2 {row["dq"]["device_ms"]:.4f} ms, K3 '
        f'{row["dkv"]["device_ms"]:.4f} ms, K2 + K3 {pair:.4f} ms vs flex backward '
        f'{flex_ms:.4f} ms ({pair / flex_ms:.2f}x)')


# -------------------------------------------------------------------- model

def check_experience(exp, b, T, P, dim, latent_shape, prompt=None):
    """The rollout's record has the expected shapes and finite values, and
    keeps the prompt as given."""
    n, d = latent_shape
    expect = dict(latents=(b, T, n, d), rewards=(b, T), agent_embed=(b, T, dim),
                  values=(b, T), lens=(b,))
    for name, shape in expect.items():
        t = getattr(exp, name)
        if tuple(t.shape) != shape:
            raise SystemExit(f'experience.{name}: shape {tuple(t.shape)} != {shape}')
        if not bool(torch.isfinite(t.float()).all()):
            raise SystemExit(f'experience.{name} is not finite')
    acts, lps = exp.actions.discrete, exp.log_probs.discrete
    if tuple(acts.shape) != (b, T, 1) or not bool(((acts >= 0) & (acts < 4)).all()):
        raise SystemExit('experience.actions out of shape or range')
    if not bool(torch.isfinite(lps[:, P:]).all()) or bool((lps[:, P:] > 0).any()):
        raise SystemExit('experience.log_probs are not finite log probabilities')
    if bool((exp.lens != T).any()) or exp.prompt_len != P:
        raise SystemExit('experience.lens / prompt_len wrong for a model without terminals')
    if float(exp.latents.abs().max()) > 1.0:
        raise SystemExit('experience.latents outside [-1, 1]')
    if prompt is not None:
        if not torch.equal(exp.latents[:, :P], prompt['prompt_latents']):
            raise SystemExit('experience.latents do not keep the prompt')
        if not torch.equal(exp.actions.discrete[:, :P], prompt['prompt_discrete_actions']):
            raise SystemExit('experience.actions do not keep the prompt actions')


def compare_prefill(model, prompt, max_time):
    """The prompted rollout's prompt pass in bf16 through K1 and through the
    plain attention (`use_flash_attention` off), each held against the same
    pass in float32 (plain attention, the bf16 weights upcast). Returns, per
    output, (K1 error, plain error, K1 vs plain), and both bf16 times."""
    from dreamer4_torch import DynamicsWorldModel

    K = model.max_steps
    kw = dict(latents=prompt['prompt_latents'],
              discrete_actions=prompt['prompt_discrete_actions'], signal_levels=K - 1,
              step_sizes=K // PROMPTED['num_steps'], latent_is_noised=True,
              return_intermediates=True, max_time=max_time)
    outputs = lambda out: dict(flow=out[0].flow.float(), agent=out[1][0].agent.float())
    with torch.no_grad():
        kernel = outputs(model(**kw))
        ms_kernel = host_time_s(lambda: model(**kw), reps=3) * 1e3
        model.transformer.use_flash_attention = False
        try:
            plain = outputs(model(**kw))
            ms_plain = host_time_s(lambda: model(**kw), reps=3) * 1e3
        finally:
            model.transformer.use_flash_attention = True
        ref_model = DynamicsWorldModel(**{**BENCH_MODEL, 'use_flash_attention': False})
        ref_model.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
        ref = outputs(ref_model(**kw))
        del ref_model
    err = lambda a, b: (a - b).abs().max().item()
    return ({name: (err(kernel[name], ref[name]), err(plain[name], ref[name]),
                    err(kernel[name], plain[name])) for name in ref},
            ms_kernel, ms_plain)


def run_model_phase(seed: int = 0) -> dict:
    """Builds the bench model and drives both rollouts; returns the (K1..K5)
    launches of each rollout."""
    from dreamer4_torch import DynamicsWorldModel, generate
    from dreamer4_torch.ops import flash_attention as fa
    from dreamer4_torch.ops.utils import cast_params_for_inference

    torch.manual_seed(seed)
    model = DynamicsWorldModel(**BENCH_MODEL, dtype=torch.bfloat16)   # default device: CUDA
    model.eval()
    cast_params_for_inference(model, torch.bfloat16)   # bench.py:353-354
    if model.device.type != 'cuda':
        raise SystemExit(f'model built on {model.device}, not on the card')
    n_params = sum(p.numel() for p in model.parameters())
    log(f'# model: {n_params / 1e6:.2f}M params, {model.tokens_per_frame} tokens/frame, '
        f'{model.device}, bf16 weights and cache')

    dev = model.device
    b, P = PROMPTED['batch_size'], PROMPT_LEN
    pgen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompt = dict(
        prompt_latents=torch.rand((b, P, *model.latent_shape), generator=pgen, device=dev) * 2 - 1,
        prompt_discrete_actions=torch.randint(0, 4, (b, P, 1), generator=pgen, device=dev))

    gen = torch.Generator(device=dev)
    launches = {}
    for name, kw, extra, want, reps in (('headline', HEADLINE, {}, (0, 0, 0, 0, 0), 5),
                                        ('prompted', PROMPTED, prompt,
                                         (K1_PER_PROMPTED_ROLLOUT, 0, 0, 0, 0), 2)):
        gen.manual_seed(seed)
        zero_counts()
        exp = generate(model, gen, **kw, **extra)
        torch.cuda.synchronize()
        launches[name] = read_counts()
        p_len = P if extra else 0
        check_experience(exp, kw['batch_size'], kw['time_steps'], p_len, model.dim,
                         model.latent_shape, prompt=extra or None)
        if launches[name] != want:
            raise SystemExit(f'{name} rollout launched (K1..K5) {launches[name]} times, '
                             f'expected {want}')
        sec = host_time_s(lambda: generate(model, gen, **kw, **extra), reps)
        env_steps = kw['batch_size'] * (kw['time_steps'] - p_len)
        log(f'rollout {name:<9} b{kw["batch_size"]} T{kw["time_steps"]} P{p_len} '
            f'steps {kw["num_steps"]}: (K1..K5) launches {launches[name]} (expected '
            f'{want}), {sec * 1e3:.1f} ms/rollout, {env_steps / sec:.1f} env-steps/s '
            f'(mean of {reps} after a first run)')

    errors, ms_k, ms_p = compare_prefill(model, prompt, PROMPTED['time_steps'])
    ok = True
    for name, (e_kernel, e_plain, e_between) in errors.items():
        good = e_kernel <= PREFILL_TOL_FACTOR * e_plain
        ok = ok and good
        log(f'prompt pass {name:<5}: max |bf16 K1 - f32| {e_kernel:.3e} (tol '
            f'{PREFILL_TOL_FACTOR} x {e_plain:.3e}, max |bf16 plain - f32|); '
            f'max |K1 - plain| {e_between:.3e}' + ('' if good else '  FAIL'))
    log(f'prompt pass b{b} P{P} max_time {PROMPTED["time_steps"]}: {ms_k:.2f} ms with K1, '
        f'{ms_p:.2f} ms with the plain attention')
    if not ok:
        raise SystemExit('prompt pass: K1 is further from float32 than the plain attention')
    return launches


def zero_counts():
    from dreamer4_torch.ops import flash_attention as fa
    from dreamer4_torch.ops import small_attention as sa
    fa.LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0
    sa.FWD_LAUNCHES = sa.BWD_LAUNCHES = 0


def read_counts() -> tuple[int, int, int, int, int]:
    """(K1, K2, K3, K4, K5) launches since the last `zero_counts`."""
    from dreamer4_torch.ops import flash_attention as fa
    from dreamer4_torch.ops import small_attention as sa
    return (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES, sa.FWD_LAUNCHES,
            sa.BWD_LAUNCHES)


# -------------------------------------------------------------------- train

def train_batch(device, seed):
    """bench.py:437-442 at b1 x T1024."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, t = TRAIN['batch_size'], TRAIN['time_steps']
    return dict(latents=torch.randn((b, t, 16, 32), generator=g, device=device) * 0.5,
                rewards=torch.zeros((b, t), device=device),
                discrete_actions=torch.zeros((b, t, 1), dtype=torch.long, device=device))


def step_grads(model, loss_fn, names):
    """`loss_fn(model)`'s value and the gradients of the parameters `names`;
    the weights are left as they are."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model)
    loss.backward()
    params = dict(model.named_parameters())
    grads = {n: params[n].grad.float().clone() for n in names}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def set_attention(model, cls_name: str, flag: str, value: bool):
    """Sets `flag` on every submodule of class `cls_name`: the trunks'
    `use_flash_attention` or the attentions' `use_fused_small`."""
    for m in model.modules():
        if type(m).__name__ == cls_name:
            setattr(m, flag, value)


def compare_grads(model, ref_model, loss_fn, names, cls_name, flag):
    """The loss and gradients in bf16 through the kernels and through the
    plain attention (`flag` off on every `cls_name`), each held against
    `ref_model` (the same weights in float32, plain attention): loss as
    |difference|, gradients as the relative L2 distance. Returns {output:
    (kernel distance, plain distance)}."""
    kernel = step_grads(model, loss_fn, names)
    set_attention(model, cls_name, flag, False)
    try:
        plain = step_grads(model, loss_fn, names)
    finally:
        set_attention(model, cls_name, flag, True)
    ref = step_grads(ref_model, loss_fn, names)
    out = {'loss': (abs(kernel[0] - ref[0]), abs(plain[0] - ref[0]))}
    dist = lambda g, r: ((g - r).norm() / r.norm()).item()
    for name, r in ref[1].items():
        out[name] = (dist(kernel[1][name], r), dist(plain[1][name], r))
    return out


def check_grad_distances(label, distances):
    ok = True
    for name, (e_kernel, e_plain) in distances.items():
        good = e_kernel <= PREFILL_TOL_FACTOR * e_plain
        ok = ok and good
        log(f'{label} {name:<36}: |bf16 kernels - f32| {e_kernel:.3e} (tol '
            f'{PREFILL_TOL_FACTOR} x {e_plain:.3e}, |bf16 plain - f32|)' + ('' if good else '  FAIL'))
    if not ok:
        raise SystemExit(f'{label}: the kernels are further from float32 than the plain attention')


def wm_plain_step_loss(batch, seed):
    """The world model's plain training forward with its draws from `seed`."""
    def loss_fn(model):
        gen = torch.Generator(device=model.device).manual_seed(seed)
        return model(**batch, shortcut_train=False, generator=gen)
    return loss_fn


def run_train_phase(seed: int = 0) -> dict:
    """Trains the bench model at b1 x T1024 through `BehaviorCloneTrainer`;
    returns the (K1..K5) launches of each step it drove."""
    from dreamer4_torch import BehaviorCloneTrainer, DynamicsWorldModel
    from dreamer4_torch.train.trainers import make_world_model_train_step

    torch.manual_seed(seed)
    # float32 master weights, bf16 compute (no cast_params_for_inference)
    model = DynamicsWorldModel(**BENCH_MODEL, dtype=torch.bfloat16)
    if model.device.type != 'cuda':
        raise SystemExit(f'model built on {model.device}, not on the card')
    batch = train_batch(model.device, seed + 2)
    frames = TRAIN['batch_size'] * TRAIN['time_steps']

    ref_model = DynamicsWorldModel(**{**BENCH_MODEL, 'use_flash_attention': False})
    ref_model.load_state_dict(model.state_dict())
    names = [f'transformer.attn_{i}.{w}.weight' for i in TIME_LAYERS
             for w in ('to_q', 'to_k', 'to_v')]
    check_grad_distances('train grads', compare_grads(
        model, ref_model, wm_plain_step_loss(batch, seed + 3), names,
        'AxialSpaceTimeTransformer', 'use_flash_attention'))
    del ref_model

    trainer = BehaviorCloneTrainer(model, learning_rate=3e-4, clip_grad_norm=1.0,
                                   with_ema=True, seed=seed)
    step_fn = make_world_model_train_step(model, trainer.optimizer, ema_decay=0.999)
    launches = {}
    for shortcut in (False, True):
        name = 'train_shortcut' if shortcut else 'train_plain'
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        ema_before = {n: e.clone() for n, e in trainer.ts.ema_params.items()}
        ts_before = trainer.ts
        zero_counts()
        trainer.ts, loss, losses = step_fn(trainer.ts, batch, shortcut_train=shortcut,
                                           generator=trainer.generator)
        torch.cuda.synchronize()
        launches[name] = read_counts()
        n_grad = check_step(model, ts_before, trainer.ts, loss, losses, before, ema_before,
                            name)
        want = LAUNCHES_PER_STEP[shortcut]
        log(f'{name}: loss {loss.item():.5f} (flow {losses.flow.item():.5f}, shortcut '
            f'{losses.shortcut.item():.5f}); {n_grad} parameters with a gradient, all moved '
            f'with their EMA; (K1..K5) launches {launches[name]} (expected {want})')
        if launches[name] != want:
            raise SystemExit(f'{name} launched (K1..K5) {launches[name]}, expected {want}')
        del before, ema_before

    # the trainer's own branch draw: numpy default_rng(seed), untouched so far
    shortcut = bool(np.random.default_rng(seed).random() < model.prob_shortcut_train)
    zero_counts()
    loss, losses = trainer.train_on_batch(batch)
    torch.cuda.synchronize()
    launches['train_on_batch'] = read_counts()
    want = LAUNCHES_PER_STEP[shortcut]
    log(f'train_on_batch (shortcut {shortcut}): loss {loss.item():.5f}, step {trainer.ts.step}, '
        f'(K1..K5) launches {launches["train_on_batch"]} (expected {want})')
    if launches['train_on_batch'] != want or not torch.isfinite(loss) or trainer.ts.step != 3:
        raise SystemExit('train_on_batch: wrong launches, loss or step')

    for shortcut in (False, True):
        def one_step():
            trainer.ts = step_fn(trainer.ts, batch, shortcut_train=shortcut,
                                 generator=trainer.generator)[0]
        one_step()
        sec = host_time_s(one_step, reps=3)
        log(f'train step {"shortcut" if shortcut else "plain":<8} b{TRAIN["batch_size"]} '
            f'T{TRAIN["time_steps"]}: {sec * 1e3:.1f} ms/step, {frames / sec:.1f} frames/s '
            f'(mean of 3 after a warm step)')
    return launches


# ---------------------------------------------------------- small kernels

def small_kernel_cases():
    """(name, dtype, B, n, h, dh, mask kind, softclamp, time the library)."""
    bf16, f32 = torch.bfloat16, torch.float32
    main = [('tok_time', 640, 16, 8, 64, 'causal'),     # b8 x 80 tokens, T = 16
            ('wm_space', 256, 27, 8, 64, 'special'),    # b8 x T32, 27 tokens
            ('wm_time', 216, 32, 8, 64, 'causal')]      # b8 x 27 tokens, T = 32
    cases = [(name, dt, *shape, 50.0, dt == bf16) for name, *shape in main for dt in (bf16, f32)]
    cases.append(('tok_time_noclamp', bf16, 640, 16, 8, 64, 'causal', None, True))
    for dh in (16, 32, 128):
        for dt in (bf16, f32):
            cases.append((f'ragged_dh{dh}', dt, 96, 13, 4, dh, 'causal', 30.0, False))
    return cases


def small_flex_cfg(kind, n, softclamp):
    return dict(softclamp_value=softclamp, causal=kind == 'causal',
                num_special=1 if kind == 'special' else 0,
                special_seq_len=n if kind == 'special' else 0,
                special_attend_only_itself=False)


def small_bound_ms(q, n, h, mask, which):
    """Least time for K4 (`which='fwd'`: q, k, v read, o written) or K5
    ('bwd': q, k, v, dO read, dq, dk, dv written), the (n, n) mask read
    once; 4 dh operations per allowed (query, key) pair of each head for K4
    (scores, PV), 10 dh for K5 (s, dp, dq, dk, dv), counted per head
    without the TPU kernel's h-fold redundant scores."""
    B, NH, D = q.shape
    elem = q.element_size()
    tensors, per_pair = (4, 4) if which == 'fwd' else (7, 10)
    bytes_moved = tensors * B * NH * D * elem + n * n
    ops = per_pair * D * int(mask.sum()) * B * h
    t_bytes = bytes_moved / H100_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[q.dtype]
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops else 'operations')


def to_heads(x, h):
    """(B, n*h, dh) -> a (B, h, n, dh) view, the layout of SDPA and flex."""
    B, NH, D = x.shape
    return x.view(B, NH // h, h, D).transpose(1, 2)


def from_heads(x):
    B, h, n, D = x.shape
    return x.transpose(1, 2).reshape(B, n * h, D)


def time_small_library(q, k, v, do, h, mask, cfg, ref, grad_refs, tol, grad_tol):
    """(forward ms, backward ms, names) of the PyTorch calls that compute
    K4's and K5's function on the same inputs, in the (B, h, n, dh) views
    of the flat tensors: SDPA with the boolean mask without a softclamp,
    compiled `flex_attention` with it; for K5 flex's backward (fwd+bwd less
    fwd). Device time per call, as the kernels are timed. A yardstick only;
    the port never calls them. None where no setting compiles or agrees
    with the plain version."""
    n = mask.shape[0]
    qh, kh, vh = (to_heads(t, h) for t in (q, k, v))
    ref_h = to_heads(ref, h)
    lib_name, fwd_ms, _ = time_library(qh, kh, vh, 0, n, cfg, mask, ref_h, tol, timer=device_ms)
    bwd_ms = None
    if cfg['softclamp_value'] is not None:
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        try:
            fwd = flex_call(*(to_heads(t, h) for t in leaves), 0, n, cfg,
                            FLEX_OPTIONS[q.dtype][0])
            grads = lambda: torch.autograd.grad(fwd(), leaves, to_heads(do, h))
            err = max(rel_err(g, r) for g, r in zip(grads(), grad_refs))
            if err <= grad_tol:
                bwd_ms = device_ms(grads) - device_ms(fwd)
            else:
                log(f'#   flex backward: rel err {err:.3e} above {grad_tol:.0e}, not a yardstick')
        except Exception as e:   # the compiler refuses this setting at this shape
            log(f'#   flex backward: does not compile here ({type(e).__name__}: {e})'[:300])
    return fwd_ms, bwd_ms, lib_name


def run_small_kernel_phase():
    """K4 against `small_attend_flat_reference` and K5 against
    `small_attend_flat_bwd_reference` on every case, from the same q, k, v
    and dO; returns the measurements of each case by (name, dtype). The
    checks and the CUDA-event times come first; the device times under
    torch.profiler after them, as the profiler can leave a cost on every
    later launch of the process (this phase runs last for the same
    reason)."""
    from dreamer4_torch.ops import small_attention as sa
    from dreamer4_torch.ops.masks import build_attend_mask

    gen = torch.Generator(device='cuda').manual_seed(2)
    results, failures, timed = {}, [], []
    for name, dtype, B, n, h, dh, kind, softclamp, with_library in small_kernel_cases():
        q, k, v, do = (torch.randn((B, n * h, dh), generator=gen, device='cuda').to(dtype)
                       for _ in range(4))
        mask = (build_attend_mask(n, n, causal=True, device='cuda') if kind == 'causal' else
                build_attend_mask(n, n, num_special=1, block_size_per_special=n, device='cuda'))
        bias = sa.build_interleaved_bias(n, h, mask, device='cuda')
        fwd = functools.partial(sa.small_attend_flat, q, k, v, mask, h, softclamp_value=softclamp)
        bwd = functools.partial(sa.small_attend_flat_bwd, q, k, v, do, mask, h,
                                softclamp_value=softclamp)
        plain_fwd = functools.partial(sa.small_attend_flat_reference, q, k, v, bias, softclamp)
        plain_bwd = functools.partial(sa.small_attend_flat_bwd_reference, q, k, v, do, bias,
                                      softclamp)
        out, grads = fwd(), bwd()
        ref, grad_refs = plain_fwd(), plain_bwd()
        torch.cuda.synchronize()
        tol, grad_tol = KERNEL_TOL[dtype], GRAD_TOL[dtype]
        err = (out.float() - ref.float()).abs().max().item()
        rel = {g: rel_err(x, r) for g, x, r in zip(('dq', 'dk', 'dv'), grads, grad_refs)}
        abs_bwd = max((x.float() - r.float()).abs().max().item() for x, r in zip(grads, grad_refs))
        finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads))
        ok = finite and err <= tol and max(rel.values()) <= grad_tol
        dt = str(dtype).split('.')[-1]
        log(f'K4/K5 {name:<18} {dt:<8} B{B} n{n} h{h} dh{dh} {kind}: K4 max_abs_err {err:.3e} '
            f'(tol {tol:.0e}); K5 rel err dq {rel["dq"]:.2e} dk {rel["dk"]:.2e} dv '
            f'{rel["dv"]:.2e} (tol {grad_tol:.0e})' + ('' if ok else '  FAIL'))
        if not ok:
            failures.append(f'{name}/{dt}')
        row = {}
        for which, kernel, plain, e in (('fwd', fwd, plain_fwd, err), ('bwd', bwd, plain_bwd, abs_bwd)):
            bound_ms, bound_by = small_bound_ms(q, n, h, mask, which)
            # call_ms: wrapper calls as the host issues them back to back,
            # their launch overhead included; `ms` (below) is device time
            row[which] = dict(max_abs_err=e, call_ms=cuda_time_ms(kernel),
                              plain_ms=cuda_time_ms(plain, iters=5), bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=None)
        results[(name, dtype)] = row
        timed.append((name, dtype, row, fwd, bwd, with_library,
                      (q, k, v, do, h, mask, small_flex_cfg(kind, n, softclamp), ref, grad_refs,
                       tol, grad_tol)))
    if failures:
        raise SystemExit(f'small kernel phase failed: {failures}')

    for name, dtype, row, fwd, bwd, with_library, lib_args in timed:
        row['fwd']['ms'] = device_ms(fwd, 'small_fwd_')
        row['bwd']['ms'] = device_ms(bwd, 'small_bwd_')
        lib = ''
        if with_library:
            fwd_lib, bwd_lib, lib_name = time_small_library(*lib_args)
            row['fwd']['library_ms'], row['bwd']['library_ms'] = fwd_lib, bwd_lib
            fmt = lambda ms: '-' if ms is None else f'{ms:.4f} ms'
            lib = (f'   library (device time) fwd {fmt(fwd_lib)} ({lib_name}), bwd '
                   f'{fmt(bwd_lib)} (flex backward)')
        log(f'K4/K5 {name:<18} {str(dtype).split(".")[-1]}:')
        for which, label in (('fwd', 'K4'), ('bwd', 'K5')):
            r = row[which]
            log(f'   {label} kernel {r["ms"]:.4f} ms (a wrapper call {r["call_ms"]:.4f} ms) plain '
                f'{r["plain_ms"]:.4f} ms bound {r["bound_ms"]:.4f} ms ({r["bound_by"]})')
        if lib:
            log(lib)
    return results


# ---------------------------------------------------------------- tokenizer

def check_step(model, ts_before, ts, loss, losses, before, ema_before, label):
    """Loss and every gradient finite; every parameter with a nonzero
    gradient moved, its EMA too; the step counted."""
    if not (torch.isfinite(loss) and all(bool(torch.isfinite(l).all()) for l in losses)):
        raise SystemExit(f'{label}: loss not finite ({loss.item()})')
    n_grad = n_moved = 0
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        if not bool(torch.isfinite(p.grad).all()):
            raise SystemExit(f'{label}: gradient of {name} not finite')
        if bool(p.grad.any()):
            n_grad += 1
            moved = not torch.equal(p.detach(), before[name])
            ema_moved = not torch.equal(ts.ema_params[name], ema_before[name])
            n_moved += moved and ema_moved
    if n_grad == 0 or n_moved != n_grad or ts.step != ts_before.step + 1:
        raise SystemExit(f'{label}: {n_moved} of {n_grad} parameters with a gradient moved '
                         f'with their EMA; step {ts_before.step} -> {ts.step}')
    return n_grad


def expect_launches(label, got, want):
    if got != want:
        raise SystemExit(f'{label} launched (K1..K5) {got}, expected {want}')


def run_tokenizer_phase(seed: int = 0) -> dict:
    """Drives the bench tokenizer's encode, decode and training; returns the
    (K1..K5) launches of each run."""
    from dreamer4_torch import TokenizerTrainer, VideoTokenizer
    from dreamer4_torch.train.trainers import make_tokenizer_train_step

    torch.manual_seed(seed)
    # float32 master weights, bf16 compute in the trunks
    tok = VideoTokenizer(**BENCH_TOKENIZER, dtype=torch.bfloat16)
    if tok.device.type != 'cuda':
        raise SystemExit(f'tokenizer built on {tok.device}, not on the card')
    dev = tok.device
    b, t = TOK_VIDEO['batch_size'], TOK_VIDEO['time_steps']
    frames = b * t
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    video = torch.rand((b, 3, t, 64, 64), generator=gen, device=dev)
    n_params = sum(p.numel() for p in tok.parameters())
    log(f'# tokenizer: {n_params / 1e6:.2f}M params, {(64 // 8) ** 2 + 16} tokens/frame, '
        f'b{b} x T{t} video, {dev}')
    launches = {}

    with torch.no_grad():
        zero_counts()
        latents = tok.encode(video)
        torch.cuda.synchronize()
        launches['tok_encode'] = read_counts()
        if (tuple(latents.shape) != (b, t, 16, 32) or not bool(torch.isfinite(latents).all())
                or float(latents.abs().max()) > 1.0):
            raise SystemExit(f'encode: latents of shape {tuple(latents.shape)}, not finite or '
                             'outside [-1, 1]')
        enc_s = host_time_s(lambda: tok.encode(video), reps=3)
        zero_counts()
        recon = tok.decode(latents, generator=gen)
        torch.cuda.synchronize()
        launches['tok_decode'] = read_counts()
        if tuple(recon.shape) != tuple(video.shape) or not bool(torch.isfinite(recon).all()):
            raise SystemExit(f'decode: video of shape {tuple(recon.shape)} or not finite')
        dec_s = host_time_s(lambda: tok.decode(latents, generator=gen), reps=3)
    for name in ('tok_encode', 'tok_decode'):
        expect_launches(name, launches[name], TOK_LAUNCHES[name])
    log(f'encode b{b} T{t}: {enc_s * 1e3:.1f} ms, {frames / enc_s:.1f} frames/s; decode '
        f'(4 flow steps): {dec_s * 1e3:.1f} ms, {frames / dec_s:.1f} frames/s (means of 3 after '
        f'a first run); (K1..K5) launches encode {launches["tok_encode"]}, decode '
        f'{launches["tok_decode"]}')

    ref = VideoTokenizer(**{**BENCH_TOKENIZER, 'use_fused_small': False})
    ref.load_state_dict(tok.state_dict())

    def loss_fn(model):
        g = torch.Generator(device=dev).manual_seed(seed + 3)
        return model(video, update_loss_ema=False, generator=g)

    names = [f'{layer}.{w}.weight' for layer in TOK_TIME_LAYERS for w in ('to_q', 'to_k', 'to_v')]
    check_grad_distances('tokenizer grads', compare_grads(tok, ref, loss_fn, names, 'Attention',
                                                          'use_fused_small'))
    del ref

    trainer = TokenizerTrainer(tok, learning_rate=3e-4, clip_grad_norm=1.0, with_ema=True,
                               seed=seed)
    step_fn = make_tokenizer_train_step(tok, trainer.optimizer, ema_decay=0.999)
    before = {n: p.detach().clone() for n, p in tok.named_parameters()}
    ema_before = {n: e.clone() for n, e in trainer.ts.ema_params.items()}
    ts_before = trainer.ts
    zero_counts()
    trainer.ts, loss, losses = step_fn(trainer.ts, video, generator=trainer.generator)
    torch.cuda.synchronize()
    launches['tok_train_step'] = read_counts()
    n_grad = check_step(tok, ts_before, trainer.ts, loss, losses, before, ema_before,
                        'tokenizer train step')
    del before, ema_before
    zero_counts()
    loss2, _ = trainer.train_on_batch(video)
    torch.cuda.synchronize()
    launches['tok_train_on_batch'] = read_counts()
    if not torch.isfinite(loss2) or trainer.ts.step != 2:
        raise SystemExit('tokenizer train_on_batch: loss not finite or step not counted')
    for name in ('tok_train_step', 'tok_train_on_batch'):
        expect_launches(name, launches[name], TOK_LAUNCHES[name])
    log(f'tokenizer train step: loss {loss.item():.5f}, then {loss2.item():.5f}; {n_grad} '
        f'parameters with a gradient, all moved with their EMA; (K1..K5) launches '
        f'{launches["tok_train_step"]} and {launches["tok_train_on_batch"]}')

    def one_step():
        trainer.ts = step_fn(trainer.ts, video, generator=trainer.generator)[0]
    for fused in (True, False, True):
        set_attention(tok, 'Attention', 'use_fused_small', fused)
        one_step()
        sec = host_time_s(one_step, reps=3)
        log(f'tokenizer train step b{b} T{t}, {"K4/K5" if fused else "plain attention"}: '
            f'{sec * 1e3:.1f} ms/step, {frames / sec:.1f} frames/s (mean of 3 after a warm step)')
    return launches


# --------------------------------------------------------- wm, small path

def run_wm_fused_phase(seed: int = 0) -> dict:
    """The bench world model with `use_fused_small` at b8 x T32 through
    `BehaviorCloneTrainer`: a plain and a shortcut step; returns their
    (K1..K5) launches."""
    from dreamer4_torch import BehaviorCloneTrainer, DynamicsWorldModel
    from dreamer4_torch.train.trainers import make_world_model_train_step

    torch.manual_seed(seed)
    cfg = {**BENCH_MODEL, 'use_fused_small': True}
    model = DynamicsWorldModel(**cfg, dtype=torch.bfloat16)
    b, t = WM_FUSED['batch_size'], WM_FUSED['time_steps']
    g = torch.Generator(device=model.device).manual_seed(seed + 2)
    batch = dict(latents=torch.randn((b, t, 16, 32), generator=g, device=model.device) * 0.5,
                 rewards=torch.zeros((b, t), device=model.device),
                 discrete_actions=torch.zeros((b, t, 1), dtype=torch.long, device=model.device))

    ref = DynamicsWorldModel(**{**cfg, 'use_fused_small': False})
    ref.load_state_dict(model.state_dict())
    names = [f'transformer.attn_{i}.{w}.weight' for i in (0, 3) for w in ('to_q', 'to_k', 'to_v')]
    check_grad_distances('wm fused grads', compare_grads(
        model, ref, wm_plain_step_loss(batch, seed + 3), names, 'Attention', 'use_fused_small'))
    del ref

    trainer = BehaviorCloneTrainer(model, learning_rate=3e-4, clip_grad_norm=1.0, with_ema=True,
                                   seed=seed)
    step_fn = make_world_model_train_step(model, trainer.optimizer, ema_decay=0.999)
    launches = {}
    for shortcut in (False, True):
        name = 'wm_fused_shortcut' if shortcut else 'wm_fused_plain'
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        ema_before = {n: e.clone() for n, e in trainer.ts.ema_params.items()}
        ts_before = trainer.ts
        zero_counts()
        trainer.ts, loss, losses = step_fn(trainer.ts, batch, shortcut_train=shortcut,
                                           generator=trainer.generator)
        torch.cuda.synchronize()
        launches[name] = read_counts()
        n_grad = check_step(model, ts_before, trainer.ts, loss, losses, before, ema_before, name)
        expect_launches(name, launches[name], WM_FUSED_LAUNCHES[shortcut])
        log(f'{name}: loss {loss.item():.5f}; {n_grad} parameters with a gradient, all moved '
            f'with their EMA; (K1..K5) launches {launches[name]}')
        del before, ema_before

        def one_step():
            trainer.ts = step_fn(trainer.ts, batch, shortcut_train=shortcut,
                                 generator=trainer.generator)[0]
        for fused in (True, False, True):
            set_attention(model, 'Attention', 'use_fused_small', fused)
            one_step()
            sec = host_time_s(one_step, reps=3)
            log(f'wm train step {"shortcut" if shortcut else "plain":<8} b{b} T{t}, '
                f'{"K4/K5" if fused else "plain attention"}: {sec * 1e3:.1f} ms/step, '
                f'{b * t / sec:.1f} frames/s (mean of 3 after a warm step)')
    return launches


# ------------------------------------------------------------------- main

def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    try:
        from dreamer4_torch.ops import cuda_build
    except ImportError as e:
        print(f'chip_smoke: the port is not importable here: {e}', file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_power_limit()
    log(card)
    log(f'# python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}')

    t0 = time.perf_counter()
    builds = cuda_build.build_all()
    log(f'# build {", ".join(f"{n}.cu" for n in builds)}: {time.perf_counter() - t0:.1f} s '
        '(one nvcc each, in parallel)')
    for name, (_, build_log) in builds.items():
        for line in build_log.splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'#   {name}: {line.strip()}')

    kernel_results = run_kernel_phase()
    main_shape = kernel_results[('prefill', torch.bfloat16)]
    if main_shape['library_ms'] is None:
        raise SystemExit('no library yardstick at the prefill shape')
    bwd_results, t1024_calls = run_backward_kernel_phase()
    train_shape = bwd_results[('t1024', torch.bfloat16)]
    if t1024_calls is None:
        raise SystemExit('no library yardstick for the backward at the train shape')
    launches = {**run_model_phase(), **run_train_phase(), **run_tokenizer_phase(),
                **run_wm_fused_phase()}
    small_results = run_small_kernel_phase()
    backward_device_times(train_shape, t1024_calls)
    small_shape = small_results[('tok_time', torch.bfloat16)]
    if small_shape['fwd']['library_ms'] is None or small_shape['bwd']['library_ms'] is None:
        raise SystemExit('no library yardstick for K4 / K5 at the tokenizer time shape')
    totals = [sum(c[i] for c in launches.values()) for i in range(5)]
    by_path = lambda i: {path: c[i] for path, c in launches.items() if c[i]}

    kernels = [dict(name='K1 flash_attn_fwd', route='cuda',
                    source='dreamer4_torch/csrc/flash_attn_fwd.cu',
                    replaces='dreamer4_tpu/ops/flash_attention.py:86',
                    launches=totals[0], launches_by_path=by_path(0), **main_shape),
               dict(name='K2 flash_attn_bwd_dq', route='cuda',
                    source='dreamer4_torch/csrc/flash_attn_bwd_dq.cu',
                    replaces='dreamer4_tpu/ops/flash_attention.py:269',
                    launches=totals[1], launches_by_path=by_path(1), **train_shape['dq'],
                    library_covers='flex_attention backward: dq, dk and dv together'),
               dict(name='K3 flash_attn_bwd_dkv', route='cuda',
                    source='dreamer4_torch/csrc/flash_attn_bwd_dkv.cu',
                    replaces='dreamer4_tpu/ops/flash_attention.py:309',
                    launches=totals[2], launches_by_path=by_path(2), **train_shape['dkv'],
                    library_covers='flex_attention backward: dq, dk and dv together'),
               dict(name='K4 small_attn_fwd', route='cuda',
                    source='dreamer4_torch/csrc/small_attn_fwd.cu',
                    replaces='dreamer4_tpu/ops/small_attention.py:77',
                    launches=totals[3], launches_by_path=by_path(3), **small_shape['fwd'],
                    library_covers='compiled flex_attention, softclamp as score_mod'),
               dict(name='K5 small_attn_bwd', route='cuda',
                    source='dreamer4_torch/csrc/small_attn_bwd.cu',
                    replaces='dreamer4_tpu/ops/small_attention.py:94',
                    launches=totals[4], launches_by_path=by_path(4), **small_shape['bwd'],
                    library_covers='flex_attention backward: dq, dk and dv together')]
    missing = [k['name'] for k in kernels if k['launches'] == 0]
    if missing:
        raise SystemExit(f'kernels never launched on the main paths: {missing}')
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                            'kind': torch.cuda.get_device_name(0),
                                            'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
