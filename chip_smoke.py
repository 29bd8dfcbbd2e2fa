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
               maximum SM clock; the line says which binds. Each K1 line
               names the kernel `k1_variant` chose (f32, mma or sm90); the
               bf16 cases at t1024, s=144, the prefill, the full-model
               RL replay (`rl_full`: 432 rows, N = M = 192, with the LSE;
               K2 and K3 at the same shape) and the sim phase's dynamics
               step (`sim`: 432 rows, N = M = 151, with the LSE; K2 and K3
               too) must take the wgmma kernel.
  3. model   — builds the bench world model (dim 512, depth 8, bf16) from a
               seed and drives `generate` twice: the unprompted b16 x T16
               rollout, which launches no kernel, and the prompted
               b16 x T192 rollout with a 96-frame prompt, whose prompt pass
               runs K1 on both time layers, each launch of the wgmma kernel.
               Then the same prompt pass runs
               in bf16 with the kernel and with the plain attention, each
               held against the pass in float32.
  4. train   — builds the bench world model with float32 master weights and
               bf16 compute, and trains it at b1 x T1024 (the bench's
               long-sequence step) through `BehaviorCloneTrainer`: one plain
               and one shortcut step through the train-step function, then
               one `train_on_batch`. Both time layers run K1 with its LSE
               and K2 and K3 on every step; every K1 launch of a step must
               be of the wgmma kernel. The plain step's loss and
               time-layer gradients through the kernels are held against
               float32, and both variants are timed.
  5. dream   — RL in imagination on the bench world model (float32 master
               weights, bf16 compute): `DreamTrainer` steps (heads-only
               PPO) that dream the prompted b16 x T192 rollout from the
               model phase's 96-frame prompt, whose prompt pass runs K1 on
               both time layers, and update the heads on it; only the
               policy head, the value head and the unembedding may move.
               Then full-model RL updates (`make_rl_optimizer` with a trunk
               rate, `make_rl_update_step(only_learn_policy_value_heads=
               False)`) on that dream: the trunk replay runs K1 with its LSE
               on both time layers (N = M = 192), and K2 and K3 in the
               backward, every K1 launch on the wgmma kernel; the RL loss
               and the time layers' attention-projection gradients through
               the kernels are held against float32 as in phase 4, on the
               dream's first 4 rows (float32 over all 16 needs more than
               the card's memory). Prints ms
               per dream step (dream and update apart), dreamed
               env-steps/s, ms per full-model update and its peak memory.
  6. tokenizer — builds the bench tokenizer (dim 512, 64 x 64, patch 8, 16
               latents, depth 4 + 4, 4 flow steps, bf16, `use_fused_small`)
               from a seed and drives `encode`, `decode` and two train
               steps through `TokenizerTrainer` on b8 x T16 video; each
               time layer runs K4, and K5 in the backward. The step's loss
               and time-layer gradients through K4/K5 are held against
               float32.
  7. wm-fused — the bench world model with `use_fused_small` at b8 x T32:
               a plain and a shortcut step through `BehaviorCloneTrainer`,
               every space and time layer on K4/K5, the gradients held
               against float32 as in phase 4.
  8. sim     — RL against an environment at the bench world model's width,
               with the CartPole recipe's RL settings (float32 master
               weights, bf16 compute): `SimTrainer` on MockStateEnv (b16,
               up to 150 steps), two heads-only steps, then one full-model
               step (`rl_trunk_lr`). Each step's rollout, dynamics step and
               RL epochs are counted, timed and checked apart: the rollout
               launches nothing (one query per frame), the dynamics step
               on the rollouts padded to 151 frames runs K1 (with its LSE),
               K2 and K3 on both time layers (16 x 27 rows, N = M = 151),
               a shortcut step 4 more K1, and a full-model update as many
               again per epoch; every K1 on the wgmma kernel. Prints ms per
               part, env-steps/s (the sum of lens over the step's time) and
               peak memory; the trunk must not move in a heads-only update.
  9. pixel   — one `EnvInteractor` rollout on MockEnv 64 x 64 pixels (b16,
               16 frames): the bench tokenizer's streaming encode in front
               of the bench world model; the streamed latents held against
               one uncached encode of the recorded video. Prints ms per
               frame and env-steps/s.
 10. small   — K4 and K5 (the small-attention forward and backward) against
               their plain versions at the tokenizer's time layer and the
               world model's b8 x T32 space and time layers, in bf16 and
               float32, without the softclamp, and at ragged shapes; timed
               beside their bounds, their plain versions and the PyTorch
               call for the same function (SDPA, compiled
               `flex_attention`, flex's backward; at the ragged n = 13 shapes
               too, in bf16). K4 and K5 run for tens
               of microseconds, so their times (and the library's) are
               device times under torch.profiler, with the library's
               CUDA-event times beside them. Each case prints the kernels'
               launch plans (`small_plan`: heads per item, stages, shared
               memory, blocks per SM) and each time's share of its bound;
               the three main cases also the L2-cold time (inputs rotated
               over more than 100 MB), the ragged ones an empty kernel's
               device time beside K4's and flex's. Then the device times of
               K1 and flex_attention at the bf16 `K1_SM90_CASES`,
               and of K2, K3 and flex's backward at t1024 bf16, beside phase 2's
               CUDA-event times. The profiler can leave a cost on every
               later launch of the process, so this phase runs last, after
               every timed model phase.
Launch counts (K1 to K5, and K1's by variant) are set to 0 just before
each rollout, dream step, RL update, encode, decode, train step and part of
a sim step and read just after.

The last three lines of standard output are a JSON line with one entry per
kernel, the card's name and power limit, and the result line
`{"ok": true, "device": {...}}`. Imports torch, numpy and the port only.
"""
from __future__ import annotations

import functools
import json
import re
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

# RL in imagination on the bench model: `DreamTrainer` dreams the prompted
# rollout (PROMPTED with the 96-frame prompt) and takes a heads-only PPO
# update per step; full-model RL re-forwards the trunk over the whole dream
DREAM = dict(PROMPTED, objective='ppo')
# (K1..K5) launches: a dream step runs K1 in its prompt pass only (the heads'
# update reads the stored agent embeddings); a full-model update replays
# b16 x T192 (rows 16 x 27 = 432, N = M = 192, causal) through both time
# layers, K1 with its LSE forward and K2, K3 backward
LAUNCHES_PER_DREAM_STEP = (K1_PER_PROMPTED_ROLLOUT, 0, 0, 0, 0)
LAUNCHES_PER_RL_FULL_UPDATE = (2, 2, 2, 0, 0)
RL_LR = dict(policy_lr=1e-4, value_lr=1e-4, trunk_lr=1e-5)
# the full-model update's gradient check runs on the dream's first rows: the
# float32 reference over all 16 rows needs more than the card's 80 GB (an
# earlier run of this script ran out of memory there). 4 rows keep each
# kernel's per-row shape (N = M = 192, head dim 64) over 4 x 27 = 108 rows
GRAD_CHECK_ROWS = 4
# the shape each time layer of that replay gives K1 (with its LSE), K2 and
# K3, held against their plain versions in the kernel phases
RL_FULL_ATTENTION = dict(B=DREAM['batch_size'] * 27, Hq=8, H=8, N=DREAM['time_steps'],
                         M=DREAM['time_steps'], D=64, causal=True, offset=0,
                         kv_len=DREAM['time_steps'], softclamp=50.0)

# RL against an environment: the bench world model with the CartPole
# recipe's RL settings (examples/train_cartpole_with_dynamics_rl.py:108-128,
# its defaults: no delight gating, reward range +-1.2 x 150), float32 master
# weights and bf16 compute, on MockStateEnv batches of 16 for up to 150 steps
SIM_MODEL = dict(BENCH_MODEL, num_discrete_actions=(2,), predict_terminals=True, dim_state=4,
                 dim_critic_state=4, keep_reward_ema_stats=True, reward_range=(-180.0, 180.0),
                 use_delight_gating=False)
SIM_ENV = dict(dim_state=4, num_actions=2, batch=16, max_steps=150)
# the recipe's SimTrainer (examples/train_cartpole_with_dynamics_rl.py:136-142
# and its argument defaults); the full-model step's trunk rate is the dream
# phase's
SIM_TRAINER = dict(max_timesteps=150, num_steps=4, update_epochs=4, dynamics_lr=1e-4,
                   policy_lr=3e-4, value_lr=3e-4, objective='ppo')
SIM_TRUNK_LR = RL_LR['trunk_lr']
# the time attention of the dynamics step and of a full-model update: every
# rollout is padded to max_timesteps + 1 = 151 frames, 16 x 27 rows
SIM_ATTENTION = dict(B=SIM_ENV['batch'] * 27, Hq=8, H=8, N=SIM_TRAINER['max_timesteps'] + 1,
                     M=SIM_TRAINER['max_timesteps'] + 1, D=64, causal=True, offset=0,
                     kv_len=SIM_TRAINER['max_timesteps'] + 1, softclamp=50.0)
# (K1..K5) launches of each part of a sim step: the rollout runs no kernel
# (one query per frame over at most 151 keys, under the flash gate); the
# dynamics step is a train step (LAUNCHES_PER_STEP); a full-model update
# replays the trunk as in the dream phase, once per epoch
SIM_ROLLOUT_LAUNCHES = (0, 0, 0, 0, 0)
SIM_UPDATE_LAUNCHES = {False: (0, 0, 0, 0, 0),
                       True: tuple(n * SIM_TRAINER['update_epochs']
                                   for n in LAUNCHES_PER_RL_FULL_UPDATE)}
SIM_HEADS_ONLY_STEPS = 2

# pixels: the bench tokenizer's streaming encode in front of the bench world
# model, on MockEnv 64 x 64 RGB frames, b16, up to 16 frames
PIXEL_ENV = dict(image_size=(64, 64), num_actions=4, batch=16)
PIXEL_STEPS = 16
# the streamed latents (plain attention over the bf16 KV cache) vs one
# uncached bf16 encode of the recorded video (K4 in the time layer): both
# round the trunk's activations to bf16 through 4 layers, in other orders
# (other GEMM shapes, K4 against the plain attention), so they may differ
# by at most this multiple of the uncached encode's own distance from the
# same encode in float32
PIXEL_TOL_FACTOR = PREFILL_TOL_FACTOR

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


def is_launch_event(event) -> bool:
    """The host side of a kernel launch in a torch.profiler trace
    (`cudaLaunchKernel`, `cuLaunchKernel`, `cuLaunchKernelEx`, ...)."""
    return (getattr(event, 'device_type', None) == torch.autograd.DeviceType.CPU
            and 'LaunchKernel' in event.name)


def device_ms(fn, match: str | None = None, iters: int = 20,
              warmup: int = 3) -> float | None:
    """Mean device time per call of `fn` under torch.profiler over `iters`
    calls. Unlike `cuda_time_ms` it does not count the device's idle time
    while the host prepares a launch, which is most of a call that runs for
    tens of microseconds. A trace has been seen to hold fewer device events
    than the calls launched (the line says so), so:
    - with `match`, each call launches exactly one kernel whose name
      contains it, and the time per call is the mean duration of the
      matching kernels the trace holds;
    - without `match`, every kernel and copy the calls launch counts, as
      `traced_call_ms` matches them to their launches; None where no trace
      could be matched so.
    A trace that holds none of those kernels is taken again, up to three
    times in all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        if match is None:
            ms = traced_call_ms(events, iters)
            if ms is not None:
                return ms
            continue
        held = [e for e in events if is_device_event(e) and match in e.name]
        if held:
            if len(held) != iters:
                print(f'# the trace held {len(held)} of {iters} launches of {match}', flush=True)
            return sum(e.time_range.elapsed_us() for e in held) / 1e3 / len(held)
        print(f'# a profiler trace held no device time of {match}; taking it again', flush=True)
    if match is None:
        print('# no profiler trace of the call could be matched to its launches', flush=True)
        return None
    raise SystemExit(f'the profiler saw no device time of {match}')


def traced_call_ms(events, iters: int) -> float | None:
    """Device time per call in a trace of `iters` calls of one function
    that launches the same kernels in the same order on every call. Each
    host launch is matched to its kernel by correlation id (the `id` that
    both events of one launch carry). Launch j of every call runs the same
    kernel, so a launch whose kernel the trace lost takes the mean duration
    of launch j's kernels that the trace holds. Copies and memsets count as
    the trace holds them. None, with the reason printed, where the trace
    holds no kernel, its launches do not split into `iters` equal calls,
    or some launch j holds no kernel or two kernel names."""
    device = [e for e in events if is_device_event(e)]
    copies = [e for e in device if e.name.startswith(('Memcpy', 'Memset'))]
    kernels = {e.id: e for e in device if e not in copies}
    launches = sorted((e for e in events if is_launch_event(e)),
                      key=lambda e: e.time_range.start)
    us = lambda e: e.time_range.elapsed_us()
    if not kernels or not launches or len(launches) % iters:
        print(f'# a profiler trace held {len(kernels)} kernels of {len(launches)} launches '
              f'over {iters} calls; taking it again', flush=True)
        return None
    per_call = len(launches) // iters
    total_us, matched = sum(us(e) for e in copies), 0
    for j in range(per_call):
        held = [kernels[e.id] for e in launches[j::per_call] if e.id in kernels]
        names = {e.name for e in held}
        if len(names) != 1:
            print(f'# launch {j} of each call holds the kernels {sorted(names)[:2]} in the '
                  'trace; taking it again', flush=True)
            return None
        matched += len(held)
        total_us += sum(us(e) for e in held) / len(held) * iters
    launch_ids = {e.id for e in launches}
    unlaunched = [e for i, e in kernels.items() if i not in launch_ids]
    total_us += sum(us(e) for e in unlaunched)
    if matched != len(launches) or unlaunched:
        print(f'# the trace held the kernels of {matched} of {len(launches)} launches (a lost '
              f'one counts its launch\'s mean) and {len(unlaunched)} kernels of no launch',
              flush=True)
    return total_us / 1e3 / iters


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
    # the full-model RL update's trunk replay: the b16 x T192 dream's time
    # attention, 16*27 rows, N = M = 192, with the LSE kept for K2/K3
    cases.append(('rl_full', bf16, dict(RL_FULL_ATTENTION, lse=True)))
    # the sim phase's dynamics step and full-model update: b16 rollouts
    # padded to 151 frames, 16*27 rows, with the LSE
    cases.append(('sim', bf16, dict(SIM_ATTENTION, lse=True)))
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
    """(name, ms, max abs error against the plain version, callable) of the
    one PyTorch call that computes K1's function here, timed by `timer`; ms
    and the callable are None where no setting of it compiles or agrees with
    the plain version within the kernel's tolerance."""
    if cfg['softclamp_value'] is None:
        candidates = [('sdpa', sdpa_call(q, k, v, mask))]
    else:
        candidates = [(f'flex {o}', flex_call(q, k, v, offset, kv_len, cfg, o))
                      for o in FLEX_OPTIONS[q.dtype]]
    best = ('-', None, None, None)
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
        if ms is None:
            log(f'#   {name}: not timed')
            continue
        if best[1] is None or ms < best[1]:
            best = (name, ms, err, fn)
    return best


# K1 cases that must take the wgmma kernel in bf16, and whose device time
# is taken beside flex_attention's in the last phase
K1_SM90_CASES = ('t1024', 'space_special_only_itself=False', 'space_special_only_itself=True',
                 'prefill', 'rl_full', 'sim')


def run_kernel_phase():
    """K1 against `flash_attend_reference` on every case; returns the
    measurements of each case by (name, dtype), and the callables of K1 and
    flex_attention at the bf16 `K1_SM90_CASES` for the device times of the
    last phase."""
    from dreamer4_torch.ops import flash_attention as fa

    gen = torch.Generator(device='cuda').manual_seed(0)
    results, failures, device_calls = {}, [], {}
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
        before = dict(fa.K1_LAUNCHES)
        out = fa.flash_attend(q, k, v, off, kvl, return_lse=want_lse, **cfg)
        variant, = (x for x, n in fa.K1_LAUNCHES.items() if n != before[x])
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
        # timed as the path calls it: with the LSE where the case keeps it
        kernel = functools.partial(fa.flash_attend, q, k, v, off, kvl, return_lse=want_lse,
                                   **cfg)
        ms = cuda_time_ms(kernel)
        plain_ms = cuda_time_ms(functools.partial(fa.flash_attend_reference, q, k, v, off, kvl,
                                                  return_lse=want_lse, **cfg))
        mask = fa.attend_mask(N, M, off, kvl, device='cuda', **{
            x: cfg[x] for x in ('causal', 'num_special', 'special_seq_len',
                                'special_attend_only_itself')})
        # SDPA takes no softclamp; flex_attention takes it as a score_mod
        lib_name, library_ms, lib_err, lib_fn = time_library(q, k, v, off, kvl, cfg, mask, ref,
                                                             tol)
        lib = ('library -' if library_ms is None else
               f'library {library_ms:.4f} ms ({lib_name}, its err {lib_err:.1e})')
        bound_ms, bound_by, unit, _ = attention_bound_ms(q, k, mask, cfg['softclamp_value'],
                                                         want_lse)
        if dtype == torch.bfloat16 and name in K1_SM90_CASES:
            ok = ok and variant == 'sm90'
            device_calls[name] = (kernel, lib_fn)
        log(f'K1 {name:<34} {str(dtype).split(".")[-1]:<8} {variant:<5} max_abs_err {err:.3e} '
            f'(tol {tol:.0e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms {lib} '
            f'bound {bound_ms:.4f} ms ({unit}){line_lse}' + ('' if ok else '  FAIL'))
        if not ok:
            failures.append(f'{name}/{dtype}')
        results[(name, dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                      library_ms=library_ms, bound_ms=bound_ms,
                                      bound_by=bound_by, variant=variant)
    if failures:
        raise SystemExit(f'kernel phase failed: {failures}')
    return results, device_calls


def diff_ms(a, b):
    """a - b, or None where either time is missing."""
    return None if a is None or b is None else a - b


def fmt_ms(ms):
    return '-' if ms is None else f'{ms:.4f} ms'


def forward_device_times(results, calls):
    """Device times under torch.profiler of K1 (its wgmma kernel) and of
    flex_attention (all the kernels of one call) at the bf16
    `K1_SM90_CASES`, into `results`; run after the timed model phases, as
    `device_ms` can leave a cost on later launches."""
    for name, (kernel, flex) in calls.items():
        row = results[(name, torch.bfloat16)]
        row['device_ms'] = device_ms(kernel, 'flash_fwd_sm90')
        row['library_device_ms'] = None if flex is None else device_ms(flex)
        lib_ms = row['library_device_ms']
        lib = f'flex_attention {fmt_ms(lib_ms)}' + (
            '' if lib_ms is None else f' ({row["device_ms"] / lib_ms:.2f}x)')
        log(f'K1 {name} bf16 device time: K1 {row["device_ms"]:.4f} ms vs {lib}')


# ------------------------------------------------------- backward kernels

def bwd_kernel_cases():
    bf16, f32 = torch.bfloat16, torch.float32
    # the train step's time attention: b*s = 27 rows, T = 1024, causal
    t1024 = dict(B=27, Hq=8, H=8, N=1024, M=1024, D=64, causal=True, offset=0, kv_len=1024,
                 softclamp=50.0)
    cases = [('t1024', dt, t1024) for dt in (bf16, f32)]
    cases.append(('rl_full', bf16, RL_FULL_ATTENTION))
    cases.append(('sim', bf16, SIM_ATTENTION))
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


# backward cases timed beside flex_attention's backward (with a float32 one)
BWD_LIBRARY_CASES = ('t1024', 'rl_full', 'sim')


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
        if name in BWD_LIBRARY_CASES or (name == 'space_special_only_itself=False'
                                            and dtype == torch.float32):
            lib_ms, lib_err, lib_calls = time_library_backward(q, k, v, do, off, kvl, cfg,
                                                               (ref_dq, ref_dk, ref_dv), tol)
            for which in ('dq', 'dkv'):
                row[which]['library_ms'] = lib_ms
            pair = row['dq']['ms'] + row['dkv']['ms']
            lib = ('   library -' if lib_ms is None else
                   f'   K2 + K3 {pair:.4f} ms vs flex backward (dq+dk+dv) {lib_ms:.4f} ms '
                   f'({pair / lib_ms:.2f}x), its rel err {lib_err:.1e}')
            if name == 't1024' and dtype == torch.bfloat16 and lib_calls is not None:
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
    flex_ms = diff_ms(device_ms(grads), device_ms(fwd))
    for which in ('dq', 'dkv'):
        row[which]['library_device_ms'] = flex_ms
    pair = row['dq']['device_ms'] + row['dkv']['device_ms']
    log(f'K2/K3 t1024 bf16 device time: K2 {row["dq"]["device_ms"]:.4f} ms, K3 '
        f'{row["dkv"]["device_ms"]:.4f} ms, K2 + K3 {pair:.4f} ms vs flex backward '
        f'{fmt_ms(flex_ms)}' + ('' if flex_ms is None else f' ({pair / flex_ms:.2f}x)'))


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


def bench_prompt(model, seed: int) -> dict:
    """The prompted rollout's fixed 96-frame prompt, from `seed`."""
    dev, b, P = model.device, PROMPTED['batch_size'], PROMPT_LEN
    pgen = torch.Generator(device=dev).manual_seed(seed + 1)
    return dict(
        prompt_latents=torch.rand((b, P, *model.latent_shape), generator=pgen, device=dev) * 2 - 1,
        prompt_discrete_actions=torch.randint(0, 4, (b, P, 1), generator=pgen, device=dev))


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
    prompt = bench_prompt(model, seed)

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
        variants = read_k1_variants()
        p_len = P if extra else 0
        check_experience(exp, kw['batch_size'], kw['time_steps'], p_len, model.dim,
                         model.latent_shape, prompt=extra or None)
        if launches[name] != want:
            raise SystemExit(f'{name} rollout launched (K1..K5) {launches[name]} times, '
                             f'expected {want}')
        if variants != ({'sm90': want[0]} if want[0] else {}):
            raise SystemExit(f'{name} rollout: K1 ran as {variants}, not all on the wgmma '
                             'kernel')
        sec = host_time_s(lambda: generate(model, gen, **kw, **extra), reps)
        env_steps = kw['batch_size'] * (kw['time_steps'] - p_len)
        log(f'rollout {name:<9} b{kw["batch_size"]} T{kw["time_steps"]} P{p_len} '
            f'steps {kw["num_steps"]}: (K1..K5) launches {launches[name]} (expected '
            f'{want}; K1 by variant {variants}), {sec * 1e3:.1f} ms/rollout, '
            f'{env_steps / sec:.1f} env-steps/s (mean of {reps} after a first run)')

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
    fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0
    fa.K1_LAUNCHES = dict.fromkeys(fa.K1_VARIANTS, 0)
    sa.FWD_LAUNCHES = sa.BWD_LAUNCHES = 0


def read_counts() -> tuple[int, int, int, int, int]:
    """(K1, K2, K3, K4, K5) launches since the last `zero_counts`."""
    from dreamer4_torch.ops import flash_attention as fa
    from dreamer4_torch.ops import small_attention as sa
    return (sum(fa.K1_LAUNCHES.values()), fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES,
            sa.FWD_LAUNCHES, sa.BWD_LAUNCHES)


def read_k1_variants() -> dict[str, int]:
    """K1 launches by variant since the last `zero_counts`, those launched."""
    from dreamer4_torch.ops import flash_attention as fa
    return {v: n for v, n in fa.K1_LAUNCHES.items() if n}


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
        variants = read_k1_variants()
        n_grad = check_step(model, ts_before, trainer.ts, loss, losses, before, ema_before,
                            name)
        want = LAUNCHES_PER_STEP[shortcut]
        log(f'{name}: loss {loss.item():.5f} (flow {losses.flow.item():.5f}, shortcut '
            f'{losses.shortcut.item():.5f}); {n_grad} parameters with a gradient, all moved '
            f'with their EMA; (K1..K5) launches {launches[name]} (expected {want}); K1 by '
            f'variant {variants} (expected all sm90)')
        if launches[name] != want:
            raise SystemExit(f'{name} launched (K1..K5) {launches[name]}, expected {want}')
        if variants != {'sm90': want[0]}:
            raise SystemExit(f'{name}: K1 ran as {variants}, not all on the wgmma kernel')
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


# -------------------------------------------------------------------- dream

def check_rl_outputs(label, out):
    values = {'policy_loss': out.policy_loss, 'value_loss': out.value_loss, **out.stats,
              'return_mean': out.return_stats.mean, 'return_var': out.return_stats.var}
    bad = [k for k, v in values.items() if not bool(torch.isfinite(v))]
    if bad:
        raise SystemExit(f'{label}: not finite: {bad}')


def rl_full_loss(exp):
    """The full-model RL loss (policy + value) of `exp`, as the update step
    differentiates it."""
    from dreamer4_torch.models.rl import ReturnStats, rl_losses

    def loss_fn(model):
        out = rl_losses(model, exp, objective=DREAM['objective'],
                        only_learn_policy_value_heads=False,
                        return_stats=ReturnStats.create(device=model.device))
        return out.policy_loss + out.value_loss
    return loss_fn


def run_dream_phase(seed: int = 0) -> dict:
    """RL in imagination on the bench model: `DreamTrainer` steps, then
    full-model RL updates on the last dream; returns the (K1..K5) launches
    of a dream step and of a full-model update."""
    from dreamer4_torch import DreamTrainer, DynamicsWorldModel
    from dreamer4_torch.data.experience import index_experience
    from dreamer4_torch.train.trainers import (create_rl_state, make_rl_optimizer,
                                               make_rl_update_step, rl_param_labels)

    torch.manual_seed(seed)
    # float32 master weights, bf16 compute, as in the train phase
    model = DynamicsWorldModel(**BENCH_MODEL, dtype=torch.bfloat16)
    if model.device.type != 'cuda':
        raise SystemExit(f'model built on {model.device}, not on the card')
    b, T, P = DREAM['batch_size'], DREAM['time_steps'], PROMPT_LEN
    if b * model.tokens_per_frame != RL_FULL_ATTENTION['B']:
        raise SystemExit(f'the dream has {b} x {model.tokens_per_frame} time-attention rows, '
                         f'not the {RL_FULL_ATTENTION["B"]} of the kernel phases\' rl_full case')
    prompt = bench_prompt(model, seed)
    trainer = DreamTrainer(model, time_steps=T, num_steps=DREAM['num_steps'], batch_size=b,
                           objective=DREAM['objective'], prompt_fn=lambda generator: prompt,
                           seed=seed)
    launches = {}

    # one step, counted and checked; it is the warm step of the timing
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    zero_counts()
    exp, out = trainer.step()
    torch.cuda.synchronize()
    launches['dream'] = read_counts()
    variants = read_k1_variants()
    check_experience(exp, b, T, P, model.dim, model.latent_shape, prompt=prompt)
    check_rl_outputs('dream step', out)
    labels = rl_param_labels(model)
    frozen_moved = [n for n, p in model.named_parameters()
                    if labels[n] == 'frozen' and not torch.equal(p, before[n])]
    heads_still = [n for n, p in model.named_parameters()
                   if labels[n] != 'frozen' and torch.equal(p, before[n])]
    if frozen_moved or heads_still:
        raise SystemExit(f'dream step: frozen parameters moved {frozen_moved[:5]}, head '
                         f'parameters that did not move {heads_still[:5]}')
    expect_launches('dream step', launches['dream'], LAUNCHES_PER_DREAM_STEP)
    if variants != {'sm90': LAUNCHES_PER_DREAM_STEP[0]}:
        raise SystemExit(f'dream step: K1 ran as {variants}, not all on the wgmma kernel')
    del before
    log(f'dream step b{b} T{T} P{P} (heads-only {DREAM["objective"]}): (K1..K5) launches '
        f'{launches["dream"]} (expected {LAUNCHES_PER_DREAM_STEP}; K1 by variant {variants}); '
        f'stats {", ".join(f"{k} {v.item():.4f}" for k, v in out.stats.items())}; only the '
        'policy head, the value head and the unembedding moved')

    # two timed steps of the trainer; then its own update step alone on the
    # last dream, which a step runs `update_epochs` times after its dream
    def one_step():
        nonlocal exp, out
        exp, out = trainer.step()
    step_s = host_time_s(one_step, reps=2)
    check_rl_outputs('timed dream step', out)

    def one_update():
        trainer.rl_state = trainer._update(trainer.rl_state, exp)[0]
    update_s = host_time_s(one_update, reps=3) * trainer.update_epochs
    env_steps = b * (T - P)
    log(f'dream step b{b} T{T} P{P}: {step_s * 1e3:.1f} ms/step (mean of 2 after a warm step), '
        f'{env_steps / step_s:.1f} dreamed env-steps/s; of a step, the heads-only update '
        f'{update_s * 1e3:.1f} ms (mean of 3 apart, x {trainer.update_epochs} epochs) and the '
        f'dream the rest, {(step_s - update_s) * 1e3:.1f} ms')

    # full-model RL on the last dream: gradients through K1-K3 against float32
    ref = DynamicsWorldModel(**{**BENCH_MODEL, 'use_flash_attention': False})
    ref.load_state_dict(model.state_dict())
    names = [f'transformer.attn_{i}.{w}.weight' for i in TIME_LAYERS
             for w in ('to_q', 'to_k', 'to_v')]
    torch.cuda.reset_peak_memory_stats()
    check_grad_distances(f'rl_full grads ({GRAD_CHECK_ROWS} rows)', compare_grads(
        model, ref, rl_full_loss(index_experience(exp, slice(0, GRAD_CHECK_ROWS))), names,
        'AxialSpaceTimeTransformer', 'use_flash_attention'))
    del ref
    grad_check_gib = torch.cuda.max_memory_allocated() / 2**30

    opt = make_rl_optimizer(model, **RL_LR)
    full_update = make_rl_update_step(model, opt, DREAM['objective'],
                                      only_learn_policy_value_heads=False)
    state = create_rl_state(model, opt)
    trunk_before = {n: p.detach().clone() for n, p in model.named_parameters()
                    if n.startswith('transformer.')}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    state, out = full_update(state, exp)
    torch.cuda.synchronize()
    launches['rl_full'] = read_counts()
    variants = read_k1_variants()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check_rl_outputs('full-model update', out)
    trunk_still = [n for n, p in model.named_parameters()
                   if n in trunk_before and torch.equal(p, trunk_before[n])]
    del trunk_before
    if trunk_still:
        raise SystemExit(f'full-model update: trunk parameters did not move: {trunk_still[:5]}')
    expect_launches('full-model update', launches['rl_full'], LAUNCHES_PER_RL_FULL_UPDATE)
    if variants != {'sm90': LAUNCHES_PER_RL_FULL_UPDATE[0]}:
        raise SystemExit(f'full-model update: K1 ran as {variants}, not all on the wgmma kernel')

    def one_update():
        nonlocal state
        state = full_update(state, exp)[0]
    sec = host_time_s(one_update, reps=3)
    log(f'rl_full update b{b} T{T} ({b * T * model.tokens_per_frame} tokens): (K1..K5) launches '
        f'{launches["rl_full"]} (expected {LAUNCHES_PER_RL_FULL_UPDATE}; K1 by variant '
        f'{variants}, its LSE kept for K2/K3); the trunk moved; {sec * 1e3:.1f} ms/update '
        f'(mean of 3 after a warm update); peak memory {peak_gib:.2f} GiB (the gradient check '
        f'on {GRAD_CHECK_ROWS} rows in bf16 and float32: {grad_check_gib:.2f} GiB)')
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
            cases.append((f'ragged_dh{dh}', dt, 96, 13, 4, dh, 'causal', 30.0, dt == bf16))
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
    """The times of the PyTorch calls that compute K4's and K5's function
    on the same inputs, in the (B, h, n, dh) views of the flat tensors:
    SDPA with the boolean mask without a softclamp, compiled
    `flex_attention` with it; for K5 flex's backward (fwd+bwd less fwd).
    {'fwd', 'bwd'}: device time per call, as the kernels are timed;
    {'fwd_call', 'bwd_call'}: CUDA-event time per call issued back to back,
    as the wrappers' `call_ms`; 'name': the forward's call. A yardstick
    only; the port never calls them. A time is None where no setting
    compiles or agrees with the plain version."""
    n = mask.shape[0]
    qh, kh, vh = (to_heads(t, h) for t in (q, k, v))
    ref_h = to_heads(ref, h)
    lib_name, fwd_ms, _, fwd_fn = time_library(qh, kh, vh, 0, n, cfg, mask, ref_h, tol,
                                               timer=device_ms)
    out = dict(name=lib_name, fwd=fwd_ms, bwd=None, bwd_call=None,
               fwd_call=None if fwd_fn is None else cuda_time_ms(fwd_fn))
    if cfg['softclamp_value'] is not None:
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        try:
            fwd = flex_call(*(to_heads(t, h) for t in leaves), 0, n, cfg,
                            FLEX_OPTIONS[q.dtype][0])
            grads = lambda: torch.autograd.grad(fwd(), leaves, to_heads(do, h))
            err = max(rel_err(g, r) for g, r in zip(grads(), grad_refs))
            if err <= grad_tol:
                out['bwd'] = diff_ms(device_ms(grads), device_ms(fwd))
                out['bwd_call'] = cuda_time_ms(grads) - cuda_time_ms(fwd)
            else:
                log(f'#   flex backward: rel err {err:.3e} above {grad_tol:.0e}, not a yardstick')
        except Exception as e:   # the compiler refuses this setting at this shape
            log(f'#   flex backward: does not compile here ({type(e).__name__}: {e})'[:300])
    return out


# the cases timed also with their inputs rotated over more than the L2
SMALL_MAIN_CASES = ('tok_time', 'wm_space', 'wm_time')
COLD_BYTES = 100e6    # twice the card's 50 MB L2


def small_cold_ms(sa, B, n, h, dh, dtype, mask, softclamp):
    """L2-cold device times (K4, K5): each call on another of enough input
    sets (q, k, v, dO) to exceed COLD_BYTES, as a caller whose inputs were
    written long before finds them."""
    import itertools
    import math

    set_bytes = 4 * B * n * h * dh * torch.tensor([], dtype=dtype).element_size()
    gen = torch.Generator(device='cuda').manual_seed(3)
    sets = [[torch.randn((B, n * h, dh), generator=gen, device='cuda').to(dtype)
             for _ in range(4)] for _ in range(max(2, math.ceil(COLD_BYTES / set_bytes)))]
    fwd = itertools.cycle([functools.partial(sa.small_attend_flat, q, k, v, mask, h,
                                             softclamp_value=softclamp) for q, k, v, _ in sets])
    bwd = itertools.cycle([functools.partial(sa.small_attend_flat_bwd, q, k, v, do, mask, h,
                                             softclamp_value=softclamp) for q, k, v, do in sets])
    return (device_ms(lambda: next(fwd)(), 'small_fwd_'),
            device_ms(lambda: next(bwd)(), 'small_bwd_'))


def small_plan_line(sa, B, n, h, dh, dtype):
    """Each kernel's launch plan at this shape: heads per item, stages,
    dynamic shared memory, blocks per SM, and for K5 in bf16 whether it
    stores from registers (its grid holds every item at once)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    parts = []
    for which, label in (('fwd', 'K4'), ('bwd', 'K5')):
        G, stages = sa.small_plan(n, h, dh, dtype, which)
        smem = sa.small_smem_bytes(n, dh, dtype, which, G, stages)
        resident = sa.resident_blocks(which, n, h, dh, dtype)
        direct = (which == 'bwd' and dtype == torch.bfloat16 and B * h // G <= resident)
        parts.append(f'{label} G {G} stages {stages} smem {smem} B {resident / sms:g} blocks/SM'
                     + (' (stores from registers)' if direct else ''))
    return '; '.join(parts)


def run_small_kernel_phase():
    """K4 against `small_attend_flat_reference` and K5 against
    `small_attend_flat_bwd_reference` on every case, from the same q, k, v
    and dO; returns the measurements of each case by (name, dtype). The
    checks and the CUDA-event times come first; the device times under
    torch.profiler after them, as the profiler can leave a cost on every
    later launch of the process (this phase runs last for the same
    reason). Each case prints its launch plan and each time its share of
    the bound; the main cases also their L2-cold times, the ragged ones an
    empty kernel's device time (a one-element fill) beside K4 and flex."""
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

    fill = torch.zeros(1, device='cuda')
    empty_ms = device_ms(lambda: fill.fill_(0.0))
    for name, dtype, row, fwd, bwd, with_library, lib_args in timed:
        row['fwd']['ms'] = device_ms(fwd, 'small_fwd_')
        row['bwd']['ms'] = device_ms(bwd, 'small_bwd_')
        q, _, _, _, h, mask, cfg = lib_args[:7]
        B, NH, dh = q.shape
        n = NH // h
        log(f'K4/K5 {name:<18} {str(dtype).split(".")[-1]} plan: '
            + small_plan_line(sa, B, n, h, dh, dtype))
        if name in SMALL_MAIN_CASES:
            cold = small_cold_ms(sa, B, n, h, dh, dtype, mask, cfg['softclamp_value'])
            row['fwd']['l2_cold_ms'], row['bwd']['l2_cold_ms'] = cold
        lib = ''
        if with_library:
            t = time_small_library(*lib_args)
            # the wrappers by CUDA events again, beside the library's, as
            # the profiler may have left a cost on every launch since
            # `call_ms` was taken
            calls = {'fwd': cuda_time_ms(fwd), 'bwd': cuda_time_ms(bwd)}
            for which in ('fwd', 'bwd'):
                row[which]['library_ms'] = t[which]
                row[which]['library_call_ms'] = t[f'{which}_call']
                row[which]['call_ms_beside_library'] = calls[which]
            lib = (f'   library (device time) fwd {fmt_ms(t["fwd"])} ({t["name"]}), bwd '
                   f'{fmt_ms(t["bwd"])} (flex backward); by CUDA events, back to back: K4 '
                   f'{fmt_ms(calls["fwd"])} vs {fmt_ms(t["fwd_call"])}, K5 '
                   f'{fmt_ms(calls["bwd"])} vs flex backward {fmt_ms(t["bwd_call"])}')
        log(f'K4/K5 {name:<18} {str(dtype).split(".")[-1]}:')
        for which, label in (('fwd', 'K4'), ('bwd', 'K5')):
            r = row[which]
            cold = ('' if 'l2_cold_ms' not in r else
                    f', L2-cold {r["l2_cold_ms"]:.4f} ms ({r["bound_ms"] / r["l2_cold_ms"]:.0%})')
            log(f'   {label} kernel {r["ms"]:.4f} ms ({r["bound_ms"] / r["ms"]:.0%} of its bound'
                f'{cold}; a wrapper call {r["call_ms"]:.4f} ms) plain {r["plain_ms"]:.4f} ms '
                f'bound {r["bound_ms"]:.4f} ms ({r["bound_by"]})')
        if name.startswith('ragged'):
            flex = row['fwd']['library_ms']
            log(f'   K4 {row["fwd"]["ms"]:.4f} ms vs flex {fmt_ms(flex)} vs an empty kernel '
                f'{fmt_ms(empty_ms)} (device time, this run)')
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


# ---------------------------------------------------------------------- sim

def check_moved(label, model, before, names, moved: bool):
    """Fails unless every parameter in `names` moved (`moved`) or none did."""
    wrong = [n for n, p in model.named_parameters()
             if n in names and torch.equal(p, before[n]) == moved]
    if wrong:
        raise SystemExit(f'{label}: parameters that {"did not move" if moved else "moved"}: '
                         f'{wrong[:5]} ({len(wrong)} in all)')


def timed(fn):
    """(fn(), wall seconds), synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counted(fn):
    """(fn(), seconds, (K1..K5) launches, K1 launches by variant)."""
    zero_counts()
    out, sec = timed(fn)
    return out, sec, read_counts(), read_k1_variants()


def expect_sm90(label, launches, variants):
    if variants != ({'sm90': launches[0]} if launches[0] else {}):
        raise SystemExit(f'{label}: K1 ran as {variants}, not all on the wgmma kernel')


def run_sim_step(trainer, label, full_model: bool) -> dict:
    """One `SimTrainer` step, its three parts (`step` runs exactly these:
    the rollout, the dynamics training, the RL epochs) each counted, timed
    and checked; returns their launches by path."""
    from dreamer4_torch.train.trainers import rl_param_labels

    model = trainer.model
    labels = rl_param_labels(model, full_model=full_model)
    torch.cuda.reset_peak_memory_stats()
    exp, roll_s, roll_n, roll_v = counted(trainer.rollout)
    b, t = exp.batch_size, exp.time_steps
    if (b * model.tokens_per_frame, t) != (SIM_ATTENTION['B'], SIM_ATTENTION['N']):
        raise SystemExit(f'{label}: the experience is b{b} x T{t} ({b * model.tokens_per_frame} '
                         f'time-attention rows), not the {SIM_ATTENTION["B"]} rows x '
                         f'{SIM_ATTENTION["N"]} of the sim kernel cases')
    for name in ('latents', 'values', 'agent_embed', 'critic_state', 'rewards'):
        if not bool(torch.isfinite(getattr(exp, name)).all()):
            raise SystemExit(f'{label}: experience.{name} is not finite')
    env_steps = int(exp.lens.sum())
    frames_run = int(exp.lens.max())

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    shortcut_draws = trainer.rng.bit_generator.state
    wm_loss, wm_s, wm_n, wm_v = counted(lambda: trainer.train_dynamics_on(exp))
    # the step's shortcut flag, drawn again from the generator's state before it
    rng = np.random.default_rng()
    rng.bit_generator.state = shortcut_draws
    shortcut = bool(rng.random() < model.prob_shortcut_train)
    if wm_loss is None or not bool(torch.isfinite(wm_loss)):
        raise SystemExit(f'{label}: dynamics loss {wm_loss}')
    # every parameter with a gradient moved, the trunk's among them
    with_grad = {n for n, p in model.named_parameters() if p.grad is not None and p.grad.any()}
    if not any(n.startswith('transformer.') for n in with_grad):
        raise SystemExit(f'{label} dynamics step: no gradient reached the trunk')
    check_moved(f'{label} dynamics step', model, before, with_grad, moved=True)

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    outs, upd_s, upd_n, upd_v = counted(lambda: trainer.update(exp))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for i, out in enumerate(outs):
        check_rl_outputs(f'{label} update {i}', out)
    # heads-only: the heads moved, nothing else; full-model: the trunk too
    heads = {n for n, l in labels.items() if l in ('policy', 'value')}
    trunk = {n for n in labels if n.startswith('transformer.')}
    check_moved(f'{label} RL update', model, before, heads | (trunk if full_model else set()),
                moved=True)
    if not full_model:
        check_moved(f'{label} RL update', model, before, set(labels) - heads, moved=False)
    del before

    want = {'rollout': SIM_ROLLOUT_LAUNCHES, 'dynamics': LAUNCHES_PER_STEP[shortcut],
            'update': SIM_UPDATE_LAUNCHES[full_model]}
    got = {'rollout': roll_n, 'dynamics': wm_n, 'update': upd_n}
    for part, variants in (('rollout', roll_v), ('dynamics', wm_v), ('update', upd_v)):
        expect_launches(f'{label} {part}', got[part], want[part])
        expect_sm90(f'{label} {part}', got[part], variants)
    total_s = roll_s + wm_s + upd_s
    log(f'{label} b{b} T{t} ({"full-model" if full_model else "heads-only"} '
        f'{SIM_TRAINER["objective"]}, {len(outs)} updates): rollout {roll_s * 1e3:.1f} ms '
        f'({frames_run} frames, {roll_s * 1e3 / frames_run:.2f} ms/frame), dynamics '
        f'{"shortcut" if shortcut else "plain"} step {wm_s * 1e3:.1f} ms (loss '
        f'{wm_loss.item():.4f}), update {upd_s * 1e3:.1f} ms, total {total_s * 1e3:.1f} ms; '
        f'{env_steps} env steps (sum of lens), {env_steps / total_s:.1f} env-steps/s; '
        f'mean episode return {exp.episode_return.mean().item():.3f}; peak memory '
        f'{peak_gib:.2f} GiB; (K1..K5) launches rollout {roll_n}, dynamics {wm_n}, update '
        f'{upd_n} (expected {want["rollout"]}, {want["dynamics"]}, {want["update"]}; every '
        f'K1 on sm90); {"the trunk" if full_model else "only the heads"} moved in the update')
    return {f'{label}_rollout': roll_n, f'{label}_dynamics': wm_n, f'{label}_update': upd_n}


def run_sim_phase(seed: int = 0) -> dict:
    """RL against an environment at the bench world model's width:
    `SimTrainer` steps on MockStateEnv, heads-only then full-model; returns
    the (K1..K5) launches of each part of each step."""
    from dreamer4_torch import DynamicsWorldModel, SimTrainer
    from dreamer4_torch.envs.mocks import MockStateEnv

    torch.manual_seed(seed)
    model = DynamicsWorldModel(**SIM_MODEL, dtype=torch.bfloat16)
    if model.device.type != 'cuda':
        raise SystemExit(f'model built on {model.device}, not on the card')
    log(f'# sim: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M params, '
        f'{model.tokens_per_frame} tokens/frame, MockStateEnv b{SIM_ENV["batch"]} up to '
        f'{SIM_ENV["max_steps"]} steps')
    env = MockStateEnv(**SIM_ENV, seed=seed)
    launches = {}
    trainer = SimTrainer(model, env, **SIM_TRAINER, seed=seed)
    for i in range(SIM_HEADS_ONLY_STEPS):
        launches.update(run_sim_step(trainer, f'sim_heads_{i}', full_model=False))
    trainer = SimTrainer(model, env, **SIM_TRAINER, rl_trunk_lr=SIM_TRUNK_LR, seed=seed + 1)
    launches.update(run_sim_step(trainer, 'sim_full', full_model=True))
    return launches


# -------------------------------------------------------------------- pixel

def run_pixel_phase(seed: int = 0) -> dict:
    """One `EnvInteractor` rollout on pixels: the bench tokenizer's streaming
    encode in front of the bench world model; the streamed latents held
    against one uncached encode of the recorded video. Returns the
    rollout's (K1..K5) launches."""
    from dreamer4_torch import DynamicsWorldModel, EnvInteractor, VideoTokenizer
    from dreamer4_torch.envs.mocks import MockEnv

    torch.manual_seed(seed)
    tok = VideoTokenizer(**BENCH_TOKENIZER, dtype=torch.bfloat16)
    model = DynamicsWorldModel(**BENCH_MODEL, dtype=torch.bfloat16)
    if model.latent_shape != tok.latent_shape:
        raise SystemExit(f'latent shapes differ: {model.latent_shape} vs {tok.latent_shape}')
    interactor = EnvInteractor(model, tokenizer=tok)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    run = lambda: interactor(MockEnv(**PIXEL_ENV, seed=seed), gen, max_timesteps=PIXEL_STEPS,
                             num_steps=4)
    run()   # warm
    exp, sec, launches, _ = counted(run)
    expect_launches('pixel rollout', launches, (0, 0, 0, 0, 0))
    frames = exp.time_steps
    env_steps = int(exp.lens.sum())
    with torch.no_grad():
        uncached = tok.encode(exp.video)
        ref = VideoTokenizer(**{**BENCH_TOKENIZER, 'use_fused_small': False})
        ref.load_state_dict(tok.state_dict())
        f32 = ref.encode(exp.video)
        del ref
    streamed = exp.latents[:, :exp.video.shape[2]]
    err = (streamed - uncached).abs().max().item()
    err_f32 = {'streamed': (streamed - f32).abs().max().item(),
               'uncached': (uncached - f32).abs().max().item()}
    tol = PIXEL_TOL_FACTOR * err_f32['uncached']
    ok = err <= tol and bool(torch.isfinite(exp.values).all())
    log(f'pixel rollout b{PIXEL_ENV["batch"]} {frames} frames ({exp.video.shape[2]} observed, '
        f'64 x 64 RGB): {sec * 1e3:.1f} ms, {sec * 1e3 / frames:.2f} ms/frame, '
        f'{env_steps / sec:.1f} env-steps/s (sum of lens {env_steps}; second run); (K1..K5) '
        f'launches {launches}; streamed latents vs one uncached encode: max |diff| {err:.3e} '
        f'(tol {tol:.3e}: {PIXEL_TOL_FACTOR} x the uncached bf16 encode\'s distance from '
        f'float32, {err_f32["uncached"]:.3e}); the streamed latents\' distance from float32 '
        f'{err_f32["streamed"]:.3e}' + ('' if ok else '  FAIL'))
    if not ok:
        raise SystemExit('pixel: the streamed latents disagree with the uncached encode')
    return {'pixel_rollout': launches}


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
        kernel = ''
        for line in build_log.splitlines():
            # ptxas names each kernel (mangled) before its stack, spill and register lines
            entry = re.search(r"entry function '.*?_cu_[0-9a-f]+\d+(\w+?)EvN", line)
            if entry:
                kernel = entry.group(1)
            elif 'registers' in line or 'spill' in line or 'wgmma' in line:
                log(f'#   {name} {kernel}: {line.strip()}')

    kernel_results, k1_device_calls = run_kernel_phase()
    main_shape = kernel_results[('prefill', torch.bfloat16)]
    if main_shape['library_ms'] is None:
        raise SystemExit('no library yardstick at the prefill shape')
    bwd_results, t1024_calls = run_backward_kernel_phase()
    train_shape = bwd_results[('t1024', torch.bfloat16)]
    if t1024_calls is None:
        raise SystemExit('no library yardstick for the backward at the train shape')
    launches = {**run_model_phase(), **run_train_phase(), **run_dream_phase(),
                **run_tokenizer_phase(), **run_wm_fused_phase(), **run_sim_phase(),
                **run_pixel_phase()}
    small_results = run_small_kernel_phase()
    forward_device_times(kernel_results, k1_device_calls)
    backward_device_times(train_shape, t1024_calls)
    small_shape = small_results[('tok_time', torch.bfloat16)]
    if small_shape['fwd']['library_ms'] is None or small_shape['bwd']['library_ms'] is None:
        raise SystemExit('no library yardstick for K4 / K5 at the tokenizer time shape')
    totals = [sum(c[i] for c in launches.values()) for i in range(5)]
    by_path = lambda i: {path: c[i] for path, c in launches.items() if c[i]}

    k1_at = {name: {x: kernel_results[(name, torch.bfloat16)][x]
                    for x in ('ms', 'device_ms', 'library_ms', 'library_device_ms', 'bound_ms')}
             for name in K1_SM90_CASES}
    bwd_at = {which: {name: {x: bwd_results[(name, torch.bfloat16)][which][x]
                             for x in ('ms', 'library_ms', 'bound_ms')}
                      for name in BWD_LIBRARY_CASES if name != 't1024'}
              for which in ('dq', 'dkv')}
    kernels = [dict(name='K1 flash_attn_fwd', route='cuda',
                    source='dreamer4_torch/csrc/flash_attn_fwd.cu',
                    replaces='dreamer4_tpu/ops/flash_attention.py:86',
                    launches=totals[0], launches_by_path=by_path(0), **main_shape,
                    at_other_shapes=k1_at),
               dict(name='K2 flash_attn_bwd_dq', route='cuda',
                    source='dreamer4_torch/csrc/flash_attn_bwd_dq.cu',
                    replaces='dreamer4_tpu/ops/flash_attention.py:269',
                    launches=totals[1], launches_by_path=by_path(1), **train_shape['dq'],
                    library_covers='flex_attention backward: dq, dk and dv together',
                    at_other_shapes=bwd_at['dq']),
               dict(name='K3 flash_attn_bwd_dkv', route='cuda',
                    source='dreamer4_torch/csrc/flash_attn_bwd_dkv.cu',
                    replaces='dreamer4_tpu/ops/flash_attention.py:309',
                    launches=totals[2], launches_by_path=by_path(2), **train_shape['dkv'],
                    library_covers='flex_attention backward: dq, dk and dv together',
                    at_other_shapes=bwd_at['dkv']),
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
