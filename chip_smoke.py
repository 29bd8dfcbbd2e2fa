"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:
  1. build   — compiles every CUDA kernel of the port from the sources in
               this checkout (`dreamer4_torch/csrc` into `dreamer4_torch/build`).
  2. kernels — holds each kernel against its plain PyTorch version on the
               card at the shapes the rollout gives it, with stated
               tolerances, and times the kernel, the plain version and the
               one PyTorch call that computes the same function (SDPA
               without a softclamp, compiled `flex_attention` with one).
  3. model   — builds the bench world model (dim 512, depth 8, bf16) from a
               seed and drives `generate` twice: the unprompted b16 x T16
               rollout, which launches no kernel, and the prompted
               b16 x T192 rollout with a 96-frame prompt, whose prompt pass
               runs K1 on both time layers. Launch counts are set to 0 just
               before each rollout and read just after. Then the same prompt
               pass runs in bf16 with the kernel and with the plain
               attention, each held against the pass in float32.

The last three lines of standard output are a JSON line with one entry per
kernel, the card's name and power limit, and the result line
`{"ok": true, "device": {...}}`. Imports torch and the port only.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

H100_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core peak
                  torch.float32: 67e12}     # float32 outside the tensor cores
# kernel vs plain version: f32 differs by summation order only; bf16 by one
# rounding of the output (1 ulp at |o| < 4 is 1.6e-2) and of p before PV
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-3

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


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def host_time_s(fn, reps: int) -> float:
    """Mean wall time of `fn`, synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


# ------------------------------------------------------------------ kernels

def attention_bound_ms(q, k, mask, return_lse=False):
    """Least time for the work these inputs need: q read and o written once,
    the k/v rows some query may see read once; 4*D operations per unmasked
    (q, k) pair (score and PV), at the peak rate of the input type."""
    B, Hq, N, D = q.shape
    H = k.shape[1]
    elem = q.element_size()
    kv_rows = int(mask.any(dim=0).sum())
    bytes_moved = 2 * B * Hq * N * D * elem + 2 * B * H * kv_rows * D * elem
    if return_lse:
        bytes_moved += B * Hq * N * 4
    ops = 4 * D * int(mask.sum()) * B * Hq
    t_bytes = bytes_moved / H100_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[q.dtype]
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops else 'operations')


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


def time_library(q, k, v, offset, kv_len, cfg, mask, ref, tol):
    """(name, ms, max abs error against the plain version) of the one PyTorch
    call that computes K1's function here; ms is None where no setting of
    it compiles or agrees with the plain version within the kernel's
    tolerance."""
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
        ms = cuda_time_ms(fn)
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
        bound_ms, bound_by = attention_bound_ms(q, k, mask, want_lse)
        log(f'K1 {name:<34} {str(dtype).split(".")[-1]:<8} max_abs_err {err:.3e} '
            f'(tol {tol:.0e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms {lib} '
            f'bound {bound_ms:.4f} ms ({bound_by}){line_lse}' + ('' if ok else '  FAIL'))
        if not ok:
            failures.append(f'{name}/{dtype}')
        results[(name, dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      library_ms=library_ms, bound_ms=bound_ms,
                                      bound_by=bound_by)
    if failures:
        raise SystemExit(f'kernel phase failed: {failures}')
    return results


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


def run_model_phase(seed: int = 0) -> int:
    """Builds the bench model and drives both rollouts; returns K1's launches
    in the prompted rollout."""
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
    for name, kw, extra, want, reps in (('headline', HEADLINE, {}, 0, 5),
                                        ('prompted', PROMPTED, prompt,
                                         K1_PER_PROMPTED_ROLLOUT, 2)):
        gen.manual_seed(seed)
        fa.LAUNCHES = 0
        exp = generate(model, gen, **kw, **extra)
        torch.cuda.synchronize()
        launches[name] = fa.LAUNCHES
        p_len = P if extra else 0
        check_experience(exp, kw['batch_size'], kw['time_steps'], p_len, model.dim,
                         model.latent_shape, prompt=extra or None)
        if launches[name] != want:
            raise SystemExit(f'{name} rollout launched K1 {launches[name]} times, '
                             f'expected {want}')
        sec = host_time_s(lambda: generate(model, gen, **kw, **extra), reps)
        env_steps = kw['batch_size'] * (kw['time_steps'] - p_len)
        log(f'rollout {name:<9} b{kw["batch_size"]} T{kw["time_steps"]} P{p_len} '
            f'steps {kw["num_steps"]}: K1 launches {launches[name]} (expected {want}), '
            f'{sec * 1e3:.1f} ms/rollout, {env_steps / sec:.1f} env-steps/s '
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
    return launches['prompted']


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
    _, build_log = cuda_build.build('flash_attn_fwd')
    log(f'# build flash_attn_fwd.cu: {time.perf_counter() - t0:.1f} s')
    for line in build_log.splitlines():
        if 'registers' in line or 'spill' in line:
            log(f'#   {line.strip()}')

    kernel_results = run_kernel_phase()
    main_shape = kernel_results[('prefill', torch.bfloat16)]
    if main_shape['library_ms'] is None:
        raise SystemExit('no library yardstick at the prefill shape')
    launches = run_model_phase()

    kernels = [dict(name='K1 flash_attn_fwd', route='cuda',
                    source='dreamer4_torch/csrc/flash_attn_fwd.cu',
                    replaces='dreamer4_tpu/ops/flash_attention.py:86',
                    launches=launches, **main_shape)]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                            'kind': torch.cuda.get_device_name(0),
                                            'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
