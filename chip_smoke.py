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
               too) must take the wgmma kernel, and so must the continuous
               phase's train step (`cont_train`: 29 rows, N = M = 1024) and
               full-model update (`cont_rl_full`: 232 rows, N = M = 192),
               and the recipe phase's train step (`recipe_train`: 28 rows,
               N = M = 1024) and dynamics step (`recipe_sim`: 448 rows,
               N = M = 151), and the wm-options phase's full-model update
               (`wmopt_rl_full`: 112 rows, N = M = 192), each with the
               LSE, K2 and K3 at the same shapes, timed beside flex's
               backward, and its dream's prompt pass (`wmopt_prefill`:
               448 rows, N = 96, M = 192), and the wm-subsystems phase's
               MoT time attention at T1024 (`mot_main`: 42 rows;
               `mot_special`: 1 row, 128 blocks), with the LSE, K2 and K3
               at the same shapes, each timed beside flex's forward and
               backward.
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
 10. cli     — the data plane, the CLI and serving at the CLI's default
               widths (the bench tokenizer, float32; a dim-512, depth-8
               world model with 16 spatial tokens), as a user runs them:
               16 Snake episodes (4 x 4 grid, 64 x 64 frames, seeded random
               actions) recorded into a `ReplayBuffer` through
               `RecordToReplayBufferEnvWrapper`; the native prefetch library
               built into `dreamer4_torch/build/` and its `PrefetchSampler`
               held against `sample_batch` and timed beside the synchronous
               path; `inspect-replay-buffer` in a subprocess, its JSON held
               against the buffer; `train-video-tokenizer` (2 steps of 2
               micro-batches, then resumed to 3) and `train-dynamics` (2
               steps, sampling on) in this process through
               `dreamer4_torch.cli.main`; `serve-world-model` on those
               checkpoints in a subprocess, answering `/reset`, 16 `/step`s
               (each frame a 64 x 64 PNG, rewards finite) and `/`, then the
               same command on Snake, then `inspect-replay-buffer --serve`.
               The served world model's environment is also built here
               (`cli.world_model_env`) and stepped 16 times, counted. The
               CLI builds its models as the JAX CLI does, with the flash
               and small paths off, so K1-K5 launch 0 times. Prints seconds
               per tokenizer and dynamics step (from the step times in
               `metrics.jsonl`), ms per `/reset` and the median and max ms
               per `/step`, peak memory and whether the native library
               loaded. Its files go to `smoke_work/` (gitignored), which it
               removes at its end.
 11. continuous — the bench world model with the reacher recipe's
               continuous actions and proprio (6 Beta actions in [-1, 1],
               4-dim proprio, the action embedding on the spatial tokens)
               and the state-prediction head, 29 tokens per frame, float32
               master weights and bf16 compute, on the recipe's arm
               trajectories made on the card from the seed (frames mapped
               to latents by a fixed seeded projection): a. a plain and a
               shortcut `BehaviorCloneTrainer` step at b1 x T1024 (K1 2 / 6,
               K2 2, K3 2 at B = 29, N = M = 1024); b. the prompted
               b16 x T192 dream (96-frame prompt with continuous actions
               and proprio), sampled, then with +-0.9 forced actions, whose
               latents must diverge by 1% of their scale (K1 2 each, B =
               464); c. a heads-only PMPO `DreamTrainer` step (K1 2);
               d. a full-model update over b8 rows of that dream (K1 2, K2
               2, K3 2 at B = 232, N = M = 192); e. a heads-only
               `SimTrainer` step on the sim phase's environment with 6
               continuous actions, the state head and its entropy bonus,
               no proprio (the dynamics step runs K1-K3 at B = 448, N = M
               = 151); f. 8 frames of `DynamicsWorldModelWrapper` with
               continuous actions (no kernel). Each part counted by
               kernel, timed, checked finite (proprio, the continuous log
               probs and the state-prediction loss among them) and its
               peak memory printed.
 12. recipe  — the RL options of the imagination-only CartPole recipe
               (examples/train_cartpole_dream_rl.py:136-159) on the sim
               phase's model: the state head, the agent's state prediction
               (frac 0.5), the action embedding on the spatial tokens, the
               latent-input policy and value heads, and the actor's SPR over
               2 rollouts, 28 tokens per frame, float32 master weights and
               bf16 compute: a. a plain `BehaviorCloneTrainer` step at
               b1 x T1024, the agent-state loss finite and nonzero (K1, K2,
               K3 2 each at B = 28, N = M = 1024); b. a heads-only PPO
               `DreamTrainer` step at the recipe's b32 x T17 dream (4
               denoise steps, a 3-frame prompt): only the heads, the
               unembedding and the latent encoders move, `actor_spr_module`
               (frozen, as in JAX) does not (no kernel); c. a full-model
               update of the latent-input heads on that dream
               (`latent_input_full_model_ok`): the encoders, the heads and
               the SPR module move, the trunk has a zero gradient and moves
               by AdamW's decay alone (no kernel); d. a heads-only
               `SimTrainer` step on the sim phase's environment (the
               dynamics step runs K1-K3 at B = 448, N = M = 151). Every K1
               on the wgmma kernel; ms, peak memory and launches per part.
 13. tok-options — the pixel CartPole recipe's tokenizer options and the
               remaining loss terms: a. the bench tokenizer (bf16 trunks,
               `use_fused_small`) with the causal conv3d, shifted patch
               tokenization, LPIPS on seeded random VGG16 features
               (`TokenizerTrainer(use_lpips=True)`), both decorrelations,
               ortho, sigreg and latent consistency at 0.1 and the loss
               normalization: the loss and time-layer gradients through
               K4/K5 held against float32 as in phase 6, every loss term
               finite and nonzero, two train steps at b8 x T16 (K4 3, K5 3
               each, as predicted in `TOK_OPTIONS_LAUNCHES`), every
               normalizer moved, ms per step beside the bench tokenizer's
               without the options and peak memory; b. its streaming
               encode over 16 frames through the four cache parts held
               against one uncached encode; c. the pixel recipe's own
               tokenizer and world model
               (examples/train_cartpole_pixels_dream_rl.py:497-502,
               :296-315): two `TokenizerTrainer` steps at b8 x T8 and an
               `EnvInteractor` rollout on MockEnv 64 x 64, b16, 16 frames,
               the streamed latents held against an uncached encode (no
               kernel: the recipe builds flash and the small path off);
               d. a plain b1 x T1024 step of the bench world model with
               `use_loss_normalization` (K1-K3 2 / 2 / 2, all K1 on sm90;
               the four normalizers of its losses move).
 14. wm-options — the world model's remaining options on the bench world
               model (float32 master weights, bf16 compute): tasks and
               latent genes, actor and critic trunks of depth 4 (one time
               layer each, flash on), one-layer spatial and action
               pre-encoders (no flash), the aug token (28 tokens per
               frame), LAPO, TEM and the action-conditioned latent AR loss
               (hidden 8 to 16): a. a plain and a shortcut
               `BehaviorCloneTrainer` step at b1 x T1024 with a task per
               row (K1-K3 4 / 3 / 3 and 12 / 3 / 3: no backward through
               the critic trunk, whose output no loss reads), the loss and
               the main and actor trunks' time-layer gradients through the
               kernels held against float32 as in phase 4, every new loss
               term finite and nonzero, the critic trunk's gradient zero;
               c. the prompted b16 x T192 dream with a task and a latent
               gene per row, then a heads-only PPO `DreamTrainer` step (K1
               4 each: 448 rows, N = 96, M = 192), only the heads and the
               unembedding moving; d. a full-model update over the
               dream's first 4 rows (4 / 2 / 2 at 112 rows, N = M = 192);
               b. the bench model with `use_self_flow` (6 / 3 / 3), the
               head moving. Every K1 on the wgmma kernel; ms (first and
               warm), peak memory and launches per part, dreamed
               env-steps/s.
 15. tok-full — the tokenizer's remaining options, PoPE and MOSS, and
               SUGAR's backward: a. the bench tokenizer (bf16 trunks,
               `use_fused_small`) with the latent init from 4 x 4 patches,
               slot attention initializing the encoder's latents and the
               decoder's spatial tokens, the separate flow decoder, the aug
               token (81 tokens per frame), BYOL through SEM against the
               EMA teacher, the latent AR loss, time and space PoPE in
               every trunk and a MOSS layer in the encoder and the decoder
               (`TOK_FULL`), under `TokenizerTrainer` at b8 x T16: a main-
               decoder and a flow-decoder step through the step function,
               then two `train_on_batch` (K4 3, K5 2 each at B = 648: the
               EMA teacher's encode, the student's encode, the decoder that
               trains), the loss and the time-layer gradients through K4/K5
               held against float32 for each decoder as in phase 6, the new
               loss terms finite and nonzero, the idle decoder's gradient
               zero, PoPE and slot attention moving, ms per step beside the
               bench tokenizer's; b. encode with aug ids 0 and 2 (they
               differ), a 4-step decode (step 0 on the main decoder, 1-3 on
               the flow decoder), the streaming encode over 16 frames
               through the four-part cache (the trunk's part with the MOSS
               cache) held against one uncached encode, and
               `latent_disagreement`; c. two steps of the bench tokenizer
               with Beta(2, 1) flow times, the mean of 1e5 of the port's
               Beta draws within 0.01 of 2/3, and SUGAR's gradient on a
               (4096, 512) float32 tensor within 1e-6 of its float64 closed
               form; d. the bench world model with time PoPE: a plain
               b1 x T1024 step (K1-K3 2 / 2 / 2; the loss and the
               time-layer gradients, PoPE's included, against float32 as
               in phase 4) timed beside the bench model's, and the prompted
               b16 x T192 dream (K1 2), its prompt pass held against
               float32 as in phase 3.
 16. wm-subsystems — the bench world model with the trunk's remaining
               subsystems (`WMSUB_MODEL`: the GRU time layer, MoT, a fixed
               H-Net after layer 3, two views; 43 tokens per frame): a. a
               plain and a shortcut b1 x T1024 `BehaviorCloneTrainer` step
               (K1-K3 4 / 4 / 4 and 12 / 4 / 4: each MoT time layer runs
               K1 for the 42 main rows and for the special row), the loss
               and the time layers' gradients through the kernels against
               float32, nonzero gradients of the GRUs, the special
               attentions, `view_emb` and the H-Net's scores, `losses.h_net`
               finite, the GRU layers' share of the step; b. the plain step
               with the dynamic H-Net (the boundary head learning); c. the
               prompted b16 x T192 dream from a (b, 96, 2, n, d) prompt
               (K1 4), its prompt pass against float32 as in phase 3, and
               8 cached frames after a prefill against the parallel pass;
               d. FIRE (every 2-D weight's Frobenius norm kept within
               1e-3), FIRE with shrink-and-perturb and a latent-gene
               evolution on the trained model; e. a BC step on b8 x T16
               video through the bench tokenizer and an aux encoder of 4
               tokens (K4 1, the tokenizer's encode).
 17. tok-subsystems — the bench tokenizer with the GRU time layer and a
               fixed H-Net in its encoder: the loss and time-layer
               gradients through K4/K5 against float32, a `TokenizerTrainer`
               step (K4 2 / K5 2; the GRU and the H-Net's scores learning),
               an uncached encode (K4 1) and the streamed encode over 16
               frames, its distance from float32 within 2 x the uncached
               encode's.
 18. parallel — the port's parallelism (`dreamer4_torch/parallel`). a. the
               flash ring's block math in one process (`flash_ring_blocks`,
               the step functions the distributed ring runs) at the train
               step's time attention (27 x 8 heads, N = 1024, D = 64, bf16,
               causal) for P = 4 and 8 virtual ranks: P^2 launches each of
               K1, K2 and K3 (every K1 on the wgmma kernel, at offsets down
               to -(P - 1) N / P), its output and dq/dk/dv within 2 x the
               single full-length call's distance from float32 plain
               attention; a block no query sees alone (finite K1 rows, LSE
               near -1e30, zero K2/K3); the ring timed beside the single
               call. b. NCCL initialized at world size 1 on the card and a
               (data, model) mesh over it: one data-parallel
               `BehaviorCloneTrainer` step of the bench model (b1 x T1024)
               through the mesh, its loss and updated weights against the
               plain step's. c. the bench trunk with `time_ring_axis` over
               that group: one T1024 step's loss and time-layer gradients
               through the ring against float32, within 2 x the plain bf16
               step's. The card holds one rank: NCCL puts no two ranks on
               one device, so the distributed ring itself is held on the
               CPU over gloo (tests/test_torch_parallel.py).
 19. recipes — the port's ten recipes (`dreamer4_torch/examples`) through
               their own functions, at their own widths, iterations and
               steps cut: the scripted Snake collector in full (200
               episodes, its apple gate), 5 iterations of the learned Snake
               collector and a 16-episode collection, the sprites dataset
               (16 episodes), tokenizer and dynamics (20 steps each, one
               sample GIF), the reacher (20 + 20 steps, the forced dreams),
               one iteration of each CartPole recipe on MockStateEnv (b16,
               up to 150 steps: gymnasium is not on the card), the pixel
               one through its six phases on mock 64 x 64 frames. Every
               trainer step they take is checked: finite losses, the
               weights it trains moved, the frozen ones (the heads in the
               dream recipes' world-model updates, the trunk in heads-only
               RL) bitwise still; no recipe launches a kernel (flash off,
               as in JAX). Then the CartPole online model built with
               `use_flash_attention` takes one `SimTrainer` step beside the
               flash-off model from the same seed: rollout 0, dynamics K1 3
               / K2 1 / K3 1 at seed 0 (a shortcut step; B = 176, N = M =
               151, head dim 16, float32: the f32 K1), RL epochs 0, its
               dynamics loss within 1e-4 relative of flash-off's. The
               kernel phases hold K1-K3 at that shape (`cartpole_f32`),
               timed beside flex's forward and backward.
 20. small   — K4 and K5 (the small-attention forward and backward) against
               their plain versions at the tokenizer's time layer and the
               world model's b8 x T32 space and time layers, in bf16 and
               float32, without the softclamp, at the all-options
               tokenizer's time layer (`tokfull_time`, B = 648, bf16), and
               at ragged shapes; timed
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
each rollout, dream step, RL update, encode, decode, train step, part of
a sim step and CLI command run in this process, and read just after.

The last three lines of standard output are a JSON line with one entry per
kernel, the card's name and power limit, and the result line
`{"ok": true, "device": {...}}`. Imports torch, numpy and the port only.
"""
from __future__ import annotations

import base64
import contextlib
import functools
import gc
import io
import json
import re
import shutil
import socket
import struct
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,   # dense tensor-core peak
                  torch.float32: 67e12}     # float32 outside the tensor cores
# the exponential unit: special-function operations (ex2, rcp, tanh) per
# clock on each SM of a Hopper card
SFU_OPS_PER_CLOCK_PER_SM = 16
# kernel vs plain version: f32 differs by summation order only; bf16 by one
# rounding of the output (1 ulp at |o| < 4 is 1.6e-2) and of p before PV,
# so a bf16 element may also differ by one ulp of the plain version's
# value where that is larger (`within_tol`: 3.1e-2 at 4 <= |o| < 8)
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-3


def within_tol(x, ref, tol) -> bool:
    """Every element of `x` within `tol` of `ref`, or in bf16 within one
    ulp of `ref`'s element where that is larger."""
    diff = (x.float() - ref.float()).abs()
    bound = torch.full_like(diff, tol)
    if x.dtype == torch.bfloat16:
        mag = ref.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
        ulp = torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(torch.log2(mag)))
        bound = torch.maximum(bound, ulp)
    return bool((diff <= bound).all())
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

# the cli phase: Snake recorded as examples/train_snake_ppo.py:51-55 does,
# at 64 x 64 frames; the CLI commands at their default widths
# (dreamer4_tpu/cli.py:21-30, :141-147), with short runs
CLI_SNAKE = dict(grid_size=4, max_steps=20, image_size=64)
CLI_EPISODES = 16
CLI_TOKENIZER_ARGS = ['--grad-accum', '2', '--log-every', '1', '--checkpoint-every', '2',
                      '--sample-every', '2']
CLI_DYNAMICS_ARGS = ['--num-discrete-actions', '4', '--num-steps', '2', '--log-every', '1',
                     '--checkpoint-every', '2', '--sample-every', '2']
CLI_SERVE_STEPS = 16
CLI_PREFETCH = dict(batch_size=8, seq_len=8, batches=20)
CLI_WORK_DIR = Path(__file__).resolve().parent / 'smoke_work'

# the continuous phase: the bench world model with what the reacher recipe
# sets (examples/train_reacher_proprio_dynamics.py:130-136: 6 Beta actions
# in [-1, 1], 4-dim proprio, the action embedding added to the spatial
# tokens) and the state-prediction head: 29 tokens per frame
CONT_MODEL = dict(BENCH_MODEL, num_discrete_actions=(), num_continuous_actions=6,
                  continuous_dist_type='beta', continuous_target_action_range=(-1.0, 1.0),
                  dim_proprio=4, add_action_embed_to_spatial=True, add_state_pred_head=True)
CONT_TOKENS = 29
# a. the b1 x T1024 train step's time attention; d. the full-model update
# over b8 rows of the b16 x T192 dream (b16 at 27 tokens peaked at 65.07 GiB)
CONT_TRAIN_ATTENTION = dict(B=TRAIN['batch_size'] * CONT_TOKENS, Hq=8, H=8,
                            N=TRAIN['time_steps'], M=TRAIN['time_steps'], D=64, causal=True,
                            offset=0, kv_len=TRAIN['time_steps'], softclamp=50.0)
CONT_RL_ROWS = 8
CONT_RL_FULL_ATTENTION = dict(RL_FULL_ATTENTION, B=CONT_RL_ROWS * CONT_TOKENS)
# e. SimTrainer with continuous actions and the state head's entropy bonus,
# no proprio (the interactor refuses it: the JAX one cannot drive it), on
# the sim phase's environment and trainer: 28 tokens per frame
CONT_SIM_MODEL = dict(SIM_MODEL, num_discrete_actions=(), num_continuous_actions=6,
                      continuous_dist_type='beta', continuous_target_action_range=(-1.0, 1.0),
                      add_action_embed_to_spatial=True, add_state_pred_head=True,
                      state_entropy_bonus_weight=0.01)
CONT_SIM_ATTENTION = dict(SIM_ATTENTION, B=SIM_ENV['batch'] * (CONT_TOKENS - 1))
# b. the forced-action dreams: constant +-0.9 on every action dimension, whose
# latents must diverge after the prompt by the recipe's bound
# (examples/train_reacher_proprio_dynamics.py:176-191)
CONT_FORCED = 0.9
CONT_DIVERGENCE = 0.01
CONT_DREAM_LAUNCHES = (K1_PER_PROMPTED_ROLLOUT, 0, 0, 0, 0)
CONT_WRAPPER_FRAMES = 8

# the recipe phase: the sim phase's model with what the imagination-only
# CartPole recipe sets (examples/train_cartpole_dream_rl.py:136-159: the
# state head, the agent's state prediction with half its gradient to the
# trunk, the action embedding on the spatial tokens, and behind
# --latent-actor the latent-input policy and value heads) and the actor's
# SPR over 2 rollouts: 28 tokens per frame
RECIPE_MODEL = dict(SIM_MODEL, add_state_pred_head=True, agent_predicts_state=True,
                    agent_predicts_state_frac_gradient=0.5, add_action_embed_to_spatial=True,
                    actor_critic_latent_input=True, actor_spr=True, actor_spr_num_rollouts=2)
RECIPE_TOKENS = 28
# a. the b1 x T1024 train step's time attention; d. the SimTrainer dynamics
# step's, b16 rollouts padded to 151 frames
RECIPE_TRAIN_ATTENTION = dict(CONT_TRAIN_ATTENTION, B=TRAIN['batch_size'] * RECIPE_TOKENS)
RECIPE_SIM_ATTENTION = dict(SIM_ATTENTION, B=SIM_ENV['batch'] * RECIPE_TOKENS)
# b. the recipe's DreamTrainer (its argument defaults: b32 x T17 dreams, 4
# denoise steps, a 3-frame prompt, soft terminals, 2 PPO epochs, rates 3e-4)
RECIPE_DREAM = dict(batch_size=32, time_steps=17, num_steps=4, objective='ppo',
                    policy_lr=3e-4, value_lr=3e-4, update_epochs=2)
RECIPE_PROMPT_LEN = 3
# c. full-model RL of latent-input heads: no trunk replay, so no gradient
# reaches the trunk; at this trunk rate AdamW's decay (lr x 1e-4 = 1e-6 of
# each weight) shows in float32, so the trunk moves by the decay alone
RECIPE_RL_FULL_LR = dict(policy_lr=3e-4, value_lr=3e-4, trunk_lr=1e-2)
# d. the SimTrainer's seed: its first shortcut draw (default_rng(4).random()
# = 0.943, above 5/6) makes the dynamics step a plain one, K1-K3 2 / 2 / 2
RECIPE_SIM_SEED = 4

# the tok-options phase. a. the bench tokenizer with every option of the
# pixel recipe's slice: the causal conv3d and shifted patch tokenization,
# LPIPS on seeded random VGG16 features (the default weight 0.2), both
# decorrelations, ortho, sigreg and latent consistency at 0.1, the loss
# normalization (on by default)
TOK_OPTIONS = dict(BENCH_TOKENIZER, use_causal_conv3d=True, use_shifted_patch_tokenization=True,
                   encoder_add_decorr_aux_loss=True, latent_sigreg_loss_weight=0.1,
                   latent_ortho_loss_weight=0.1, latent_consistency_loss_weight=0.1)
# predicted before the first run: a train step launches K4 in each trunk's
# time layer and once more for the consistency re-encode, and K5 in all
# three, as the re-encode runs under grad (the reconstruction it reads
# takes a gradient); space attention (n*h = 640) and K1-K3 stay off
TOK_OPTIONS_LAUNCHES = (0, 0, 0, 3, 3)
# b. the streaming encode: each cached frame takes the plain attention; the
# uncached encode one K4
TOK_OPTIONS_STREAM_LAUNCHES = {'tok_options_stream': (0, 0, 0, 0, 0),
                               'tok_options_uncached': (0, 0, 0, 1, 0)}
# c. examples/train_cartpole_pixels_dream_rl.py: its tokenizer (:497-502)
# and pixel world model (:296-315, its defaults: terminal_pos_weight 30,
# entropy weight 0.01, 150-step episodes), float32 with flash and the
# small path off as the recipe builds them; --tok-batch 8 x --tok-clip-t 8
# (:181-182), --n-envs 16 (:164)
PIXEL_RECIPE_TOKENIZER = dict(dim=64, dim_latent=16, patch_size=8, image_height=64,
                              image_width=64, channels=3, num_latent_tokens=4, encoder_depth=3,
                              decoder_depth=3, time_block_every=2, attn_heads=4,
                              attn_dim_head=16, decoder_flow_steps=2, use_causal_conv3d=True,
                              use_shifted_patch_tokenization=True, lpips_loss_weight=0.0)
PIXEL_RECIPE_MODEL = dict(dim=64, dim_latent=16, num_latent_tokens=4, num_spatial_tokens=4,
                          max_steps=16, depth=2, time_block_every=2, attn_heads=4,
                          attn_dim_head=16, num_discrete_actions=(2,), multi_token_pred_len=4,
                          num_register_tokens=4, predict_terminals=True,
                          add_action_embed_to_spatial=True, terminal_pos_weight=30.0,
                          policy_entropy_weight=0.01, keep_reward_ema_stats=True,
                          reward_range=(-180.0, 180.0))
PIXEL_RECIPE_TOK_VIDEO = dict(batch_size=8, time_steps=8)
PIXEL_RECIPE_ENV = dict(image_size=(64, 64), num_actions=2, batch=16)
# float32 throughout: streamed against uncached latents at K4's float32
# tolerance (tests/test_torch_cuda.py), as both sum in other orders
PIXEL_RECIPE_STREAM_TOL = 1e-4
# d. the bench world model with the loss normalization: the b1 x T1024
# plain step (K1-K3 2 / 2 / 2); its batch has rewards and discrete actions,
# no terminals and no continuous actions, so four normalizers move
WM_NORMALIZED = ('flow', 'shortcut', 'reward', 'discrete_actions')

# the wm-options phase: the bench world model with every world-model option
# of the counterpart that the port takes: tasks and latent genes, actor and critic trunks
# of depth 4 (one time layer each, built like the main trunk, flash on),
# one-layer spatial and action pre-encoders (no flash, as the JAX package
# builds them), the aug token (a second special token: 28 tokens per
# frame), LAPO, TEM and the action-conditioned latent AR loss from the
# main trunk's hidden 8 (after layer 3) to 16 (after layer 7)
WMOPT_MODEL = dict(BENCH_MODEL, num_tasks=4, num_latent_genes=4, actor_depth=4, critic_depth=4,
                   spatial_pre_encoder_depth=1, action_pre_encoder_depth=1,
                   has_aug_conditioning=True, ssl_lapo=True, ssl_tem=True, latent_ar=True,
                   latent_ar_layer=(8, 16), latent_ar_action_conditioned=True,
                   latent_ar_loss_weight=0.1)
WMOPT_TOKENS = 28
WMOPT_NEW_LOSSES = ('latent_ar', 'latent_ar_sigreg', 'lapo_action', 'lapo_fdm',
                    'lapo_raw_latent_fdm', 'tem')
# d. the full-model update runs over the dream's first 4 rows (memory):
# the replay's time attention is 4 x 28 rows, N = M = 192, with the LSE
WMOPT_RL_ROWS = 4
WMOPT_RL_FULL_ATTENTION = dict(RL_FULL_ATTENTION, B=WMOPT_RL_ROWS * WMOPT_TOKENS)
# predicted before the first run, counting that autograd runs no backward
# through a trunk whose output no loss reads (the critic trunk's):
# a. a plain step: K1 in the main trunk's 2 time layers and the actor's
# and critic's 1 each, K2/K3 in the main trunk's and the actor's (BC's
# action loss reads the actor trunk); a shortcut step adds two no-grad
# half-step passes through all three trunks (8 more K1, no LSE);
# b. self-flow on the bench model: the training forward's 2 + 2 + 2, the
# student's forward 2 and backward 1 + 1 (hidden -3, after layer 6, is
# reached from layer 3's time attention only), the EMA teacher's 2 K1
# without grad; c. the prompt pass of a dream runs K1 in the 4 time layers
# of the three trunks (448 rows, N = 96, M = 192), the frames none (1 x 192
# scores, under the gate), a heads-only update none; d. the full-model
# replay runs K1 in all 4 and K2/K3 in the main trunk's 2 (`rl_losses`
# reads the main trunk's agent embedding); the pre-encoders never launch
WMOPT_LAUNCHES = {'wmopt_train_plain': (4, 3, 3, 0, 0),
                  'wmopt_train_shortcut': (12, 3, 3, 0, 0),
                  'wmopt_self_flow': (6, 3, 3, 0, 0),
                  'wmopt_generate': (4, 0, 0, 0, 0),
                  'wmopt_dream_trainer': (4, 0, 0, 0, 0),
                  'wmopt_rl_full': (4, 2, 2, 0, 0)}

# the tok-full phase. a. the bench tokenizer with every option of the
# tokenizer's last slice: the latent init from 4 x 4 patches, slot attention
# initializing the encoder's latents and the decoder's spatial tokens, the
# separate flow decoder, the aug token (81 tokens per frame), BYOL through
# SEM against the EMA teacher, the latent AR loss, time and space PoPE in
# every trunk and a MOSS layer after layer 1 of the encoder and the decoder
TOK_FULL = dict(BENCH_TOKENIZER, latent_init_patch_size=4, slot_attention_initted_latents=True,
                decoder_slot_attention_initted_spatial_tokens=True, separate_flow_decoder=True,
                has_aug_conditioning=True, has_byol=True, byol_use_sem=True,
                latent_ar_loss_weight=0.1, time_attention_use_pope=True,
                space_attention_use_pope=True, encoder_moss_layers=(1,), decoder_moss_layers=(1,))
TOK_FULL_TOKENS = 81
TOK_FULL_NEW_LOSSES = ('byol', 'latent_ar', 'latent_ar_sigreg')
# predicted before the first run: a train step runs K4 in the EMA teacher's
# encode (no grad), the student's encode and the one decoder that trains,
# K5 in the last two (B = 8 x 81 = 648, n = 16); space attention (n*h =
# 648) and K1-K3 stay off. b. an uncached encode one K4, a 4-step decode
# one per step (main decoder, then 3 flow-decoder steps), the streamed
# frames none (cached calls take the plain attention), latent_disagreement
# a decode and an encode. c. the bench tokenizer with Beta flow times, as
# phase 6's step. d. the bench world model with time PoPE: a plain train
# step as phase 4's, the prompted dream's prompt pass K1 in 2 time layers
TOK_FULL_LAUNCHES = {'tokfull_step_main': (0, 0, 0, 3, 2), 'tokfull_step_flow': (0, 0, 0, 3, 2),
                     'tokfull_train_on_batch_0': (0, 0, 0, 3, 2),
                     'tokfull_train_on_batch_1': (0, 0, 0, 3, 2),
                     'tokfull_encode': (0, 0, 0, 1, 0), 'tokfull_decode': (0, 0, 0, 4, 0),
                     'tokfull_stream': (0, 0, 0, 0, 0), 'tokfull_disagreement': (0, 0, 0, 5, 0),
                     'tokbeta_train_on_batch_0': (0, 0, 0, 2, 2),
                     'tokbeta_train_on_batch_1': (0, 0, 0, 2, 2),
                     'pope_wm_train_plain': LAUNCHES_PER_STEP[False],
                     'pope_wm_generate': (K1_PER_PROMPTED_ROLLOUT, 0, 0, 0, 0)}
TOK_BETA = (2.0, 1.0)
TOK_BETA_DRAWS = 100_000
TOK_BETA_MEAN_TOL = 0.01      # the mean of Beta(2, 1) is 2/3
SUGAR_SHAPE = (4096, 512)
SUGAR_TOL = 1e-6

# the wm-subsystems phase: the bench world model with the trunk's remaining
# subsystems: the GRU time layer before each time layer's attention, MoT
# (the agent token, the last of 43 per frame, gets its own time attention,
# feedforward and KV cache), a fixed-stride H-Net spliced after layer 3
# (4 frames per chunk), two video views (2 x 16 spatial tokens) and 4
# latent genes for the evolution step
WMSUB_MODEL = dict(BENCH_MODEL, use_time_rnn=True, mot_temporal=True, h_net_layer=3,
                   num_video_views=2, num_latent_genes=4)
WMSUB_TOKENS = 43
# the time attention of the b1 x T1024 step under MoT: the main tokens
# (42 rows) and the special one (1 row: 8 heads x 16 query tiles, 128
# blocks, under one wave of the card's 132 SMs), each causal at N = M = 1024
MOT_MAIN_ATTENTION = dict(B=TRAIN['batch_size'] * (WMSUB_TOKENS - 1), Hq=8, H=8,
                          N=TRAIN['time_steps'], M=TRAIN['time_steps'], D=64, causal=True,
                          offset=0, kv_len=TRAIN['time_steps'], softclamp=50.0)
MOT_SPECIAL_ATTENTION = dict(MOT_MAIN_ATTENTION, B=TRAIN['batch_size'])
# e. BC on video (one view): the bench tokenizer's 16 latents and an aux
# encoder's 4
WMSUB_AUX_TOKENS = 4
# predicted before the first run: a plain step runs K1 (with its LSE) twice
# in each of the 2 time layers (the main and the special attention), K2 and
# K3 as often in the backward; a shortcut step adds two no-grad half-step
# passes of 4 K1 each; the dynamic H-Net changes nothing of that; the
# prompt pass of the b16 x T192 dream runs K1 in both attentions of both
# time layers (672 and 16 rows, N = 96, M = 192) and the frames none (their
# 1 x 192 scores stay under the gate; the H-Net and the GRU are plain ops);
# FIRE and evolution launch nothing; the BC step on b8 x T16 video runs K4
# once in the tokenizer's encode, and the world model none (T = 16 and
# 43 x 43 scores stay under the gate, no small path)
WMSUB_LAUNCHES = {'wmsub_train_plain': (4, 4, 4, 0, 0),
                  'wmsub_train_shortcut': (12, 4, 4, 0, 0),
                  'wmsub_dynamic_plain': (4, 4, 4, 0, 0),
                  'wmsub_generate': (4, 0, 0, 0, 0),
                  'wmsub_fire': (0, 0, 0, 0, 0),
                  'wmsub_aux_bc': (0, 0, 0, 1, 0)}
# the cached frames of the subsystem model against its parallel pass: 4
# rows of the prompt, 8 frames on the cache after a 96-frame prefill
WMSUB_CACHED_ROWS, WMSUB_CACHED_FRAMES = 4, 8
FIRE_NORM_TOL = 1e-3

# the tok-subsystems phase: the bench tokenizer with the GRU time layer and
# a fixed-stride H-Net after layer 3 of its encoder. Predicted before the
# first run: a train step as phase 6's (K4 in each trunk's time layer, K5
# in both backwards); an uncached encode one K4; the streamed frames none
TOK_SUB = dict(BENCH_TOKENIZER, use_time_rnn=True, h_net_layer=3)
TOK_SUB_LAUNCHES = {'toksub_train_step': (0, 0, 0, 2, 2), 'toksub_encode': (0, 0, 0, 1, 0),
                    'toksub_stream': (0, 0, 0, 0, 0)}


# ------------------------------------------------------------------ recipes
# the recipes phase: the port's ten recipes (`dreamer4_torch/examples`)
# at their own widths, iterations and steps cut. gymnasium is not on the
# card, so the CartPole recipes step MockStateEnv at CartPole's sizes
RECIPES_DIR = CLI_WORK_DIR / 'recipes'
RECIPES_CARTPOLE_ENV = dict(dim_state=4, num_actions=2, batch=16, max_steps=150)
RECIPES_SNAKE_ITERATIONS = 5
RECIPES_SPRITES = dict(episodes=16, tokenizer_steps=20, dynamics_steps=20)
RECIPES_REACHER_STEPS = 20
# examples/train_cartpole_with_dynamics_rl.py:108-125: 11 tokens per frame,
# 4 heads of 16, one time layer; its dynamics step over b16 rollouts padded
# to 151 frames: 16 x 11 rows, float32, so K1 on its f32 kernel
CARTPOLE_ATTENTION = dict(B=RECIPES_CARTPOLE_ENV['batch'] * 11, Hq=4, H=4, N=151, M=151, D=16,
                          causal=True, offset=0, kv_len=151, softclamp=50.0)
# with `use_flash_attention` (checked on the CPU by counting the plain
# versions): no launch in the rollout (one query per frame) or the
# heads-only epochs; the dynamics step 1 / 1 / 1, a shortcut one (seed 0's
# first draw) 3 / 1 / 1: the two half steps without gradient, then the
# training forward
CARTPOLE_FLASH_LAUNCHES = {'rollout': (0, 0, 0, 0, 0),
                           'dynamics': {False: (1, 1, 1, 0, 0), True: (3, 1, 1, 0, 0)},
                           'update': (0, 0, 0, 0, 0)}
# the flash-on dynamics loss against the flash-off one from the same weights,
# experience and draws: K1-K3 at float32 against the plain attention
CARTPOLE_FLASH_LOSS_RTOL = 1e-4


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
    # the continuous phase's train step (b1 x 29 rows at T1024) and
    # full-model update (b8 x 29 rows at T192), with the LSE
    cases.append(('cont_train', bf16, dict(CONT_TRAIN_ATTENTION, lse=True)))
    cases.append(('cont_rl_full', bf16, dict(CONT_RL_FULL_ATTENTION, lse=True)))
    # the recipe phase's train step (b1 x 28 rows at T1024) and SimTrainer
    # dynamics step (b16 x 28 rows at 151 frames), with the LSE
    cases.append(('recipe_train', bf16, dict(RECIPE_TRAIN_ATTENTION, lse=True)))
    cases.append(('recipe_sim', bf16, dict(RECIPE_SIM_ATTENTION, lse=True)))
    # the wm-options phase's dream prompt pass (b16 x 28 rows, P=96 over
    # T=192) and full-model replay (4 x 28 rows at T192, with the LSE); its
    # train step has recipe_train's shape
    cases.append(('wmopt_prefill', bf16, dict(prefill, softclamp=50.0,
                                              B=WMOPT_TOKENS * DREAM['batch_size'])))
    cases.append(('wmopt_rl_full', bf16, dict(WMOPT_RL_FULL_ATTENTION, lse=True)))
    # the wm-subsystems phase's train step under MoT: the main tokens' and
    # the special token's time attention, each with the LSE
    cases.append(('mot_main', bf16, dict(MOT_MAIN_ATTENTION, lse=True)))
    cases.append(('mot_special', bf16, dict(MOT_SPECIAL_ATTENTION, lse=True)))
    # the CartPole recipe's dynamics step with flash on: float32,
    # head dim 16, with the LSE
    cases.append(('cartpole_f32', f32, dict(CARTPOLE_ATTENTION, lse=True)))
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
    the plain version within the kernel's tolerance (`within_tol`)."""
    if cfg['softclamp_value'] is None:
        candidates = [('sdpa', sdpa_call(q, k, v, mask))]
    else:
        candidates = [(f'flex {o}', flex_call(q, k, v, offset, kv_len, cfg, o))
                      for o in FLEX_OPTIONS[q.dtype]]
    best = ('-', None, None, None)
    for name, fn in candidates:
        try:
            out = fn()
        except Exception as e:   # the compiler refuses this setting at this shape
            log(f'#   {name}: does not compile here ({type(e).__name__})')
            continue
        err = (out.float() - ref.float()).abs().max().item()
        if not within_tol(out, ref, tol):
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
# bf16 K1 cases of the continuous and recipe phases' paths: the wgmma
# kernel too
K1_SM90_ONLY_CASES = ('cont_train', 'cont_rl_full', 'recipe_train', 'recipe_sim',
                      'wmopt_prefill', 'wmopt_rl_full', 'mot_main', 'mot_special')


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
        ok = within_tol(out, ref, tol) and bool(torch.isfinite(out).all())
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
        if dtype == torch.bfloat16 and name in K1_SM90_CASES + K1_SM90_ONLY_CASES:
            ok = ok and variant == 'sm90'
        if dtype == torch.bfloat16 and name in K1_SM90_CASES:
            device_calls[name] = (kernel, lib_fn)
        log(f'K1 {name:<34} {str(dtype).split(".")[-1]:<8} {variant:<5} max_abs_err {err:.3e} '
            f'(tol {tol:.0e} or 1 ulp) kernel {ms:.4f} ms plain {plain_ms:.4f} ms {lib} '
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
    cases.append(('cont_train', bf16, CONT_TRAIN_ATTENTION))
    cases.append(('cont_rl_full', bf16, CONT_RL_FULL_ATTENTION))
    cases.append(('recipe_train', bf16, RECIPE_TRAIN_ATTENTION))
    cases.append(('recipe_sim', bf16, RECIPE_SIM_ATTENTION))
    cases.append(('wmopt_rl_full', bf16, WMOPT_RL_FULL_ATTENTION))
    cases.append(('mot_main', bf16, MOT_MAIN_ATTENTION))
    cases.append(('mot_special', bf16, MOT_SPECIAL_ATTENTION))
    cases.append(('cartpole_f32', f32, CARTPOLE_ATTENTION))
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
# the float32 cases of a model path, each in the kernels line
F32_PATH_CASES = ('cartpole_f32',)
BWD_LIBRARY_CASES = ('t1024', 'rl_full', 'sim', 'cont_train', 'cont_rl_full', 'recipe_train',
                     'recipe_sim', 'wmopt_rl_full', 'mot_main', 'mot_special')


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
        if name in BWD_LIBRARY_CASES + F32_PATH_CASES or (
                name == 'space_special_only_itself=False' and dtype == torch.float32):
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

def check_experience(exp, b, T, P, dim, latent_shape, prompt=None, views=1):
    """The rollout's record has the expected shapes and finite values, and
    keeps the prompt as given."""
    n, d = latent_shape
    lat_shape = (b, T, n, d) if views == 1 else (b, T, views, n, d)
    expect = dict(latents=lat_shape, rewards=(b, T), agent_embed=(b, T, dim),
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


def compare_prefill(model, prompt, max_time, config=BENCH_MODEL):
    """The prompted rollout's prompt pass in bf16 through K1 and through the
    plain attention (`use_flash_attention` off), each held against the same
    pass in float32 (a model of `config`, plain attention, the weights
    upcast). Returns, per output, (K1 error, plain error, K1 vs plain), and
    both bf16 times."""
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
        ref_model = DynamicsWorldModel(**{**config, 'use_flash_attention': False})
        ref_model.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
        ref = outputs(ref_model(**kw))
        del ref_model
    err = lambda a, b: (a - b).abs().max().item()
    return ({name: (err(kernel[name], ref[name]), err(plain[name], ref[name]),
                    err(kernel[name], plain[name])) for name in ref},
            ms_kernel, ms_plain)


def bench_prompt(model, seed: int) -> dict:
    """The prompted rollout's fixed 96-frame prompt, from `seed`; a
    multi-view model's with the view axis, (b, P, v, n, d)."""
    dev, b, P = model.device, PROMPTED['batch_size'], PROMPT_LEN
    pgen = torch.Generator(device=dev).manual_seed(seed + 1)
    views = () if model.num_video_views == 1 else (model.num_video_views,)
    return dict(
        prompt_latents=torch.rand((b, P, *views, *model.latent_shape), generator=pgen,
                                  device=dev) * 2 - 1,
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
    for name, kw, extra, want, reps in (('headline', HEADLINE, {}, (0, 0, 0, 0, 0), 3),
                                        ('prompted', PROMPTED, prompt,
                                         (K1_PER_PROMPTED_ROLLOUT, 0, 0, 0, 0), 1)):
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

# examples/train_reacher_proprio_dynamics.py:28-75: a procedural 2-joint arm
# on 32 x 32 frames, 6 continuous actions in [-1, 1] of which dims 0-1 turn
# the joints (by 0.35 each), proprio the sin and cos of both joint angles
REACHER_IMAGE = 32


def render_arms(theta: torch.Tensor) -> torch.Tensor:
    """The recipe's `render_arm` for a batch of joint angles (..., 2), on
    their device -> frames (..., 3, 32, 32) in [0, 1]: each link a line of
    24 Gaussian stamps (width 1.1) in the red and green channel, the tip a
    stamp of width 1.5 in blue."""
    size = REACHER_IMAGE
    c = size / 2
    l1, l2 = size * 0.28, size * 0.22
    t1, t2 = theta[..., 0].float(), theta[..., 1].float()
    x1, y1 = c + l1 * torch.cos(t1), c + l1 * torch.sin(t1)
    x2, y2 = x1 + l2 * torch.cos(t1 + t2), y1 + l2 * torch.sin(t1 + t2)
    grid = torch.arange(size, dtype=torch.float32, device=theta.device)
    yy, xx = grid[:, None], grid[None, :]
    steps = torch.linspace(0.0, 1.0, 24, device=theta.device)

    def stamp(px, py, width):   # px, py (..., n) -> (..., size, size)
        d2 = (xx - px[..., None, None]).square() + (yy - py[..., None, None]).square()
        return torch.exp(-d2 / (2 * width ** 2)).sum(dim=-3)

    def line(x0, y0, x1, y1):
        x0, y0 = (torch.as_tensor(v, device=theta.device).expand_as(x1) for v in (x0, y0))
        return stamp(x0[..., None] + (x1 - x0)[..., None] * steps,
                     y0[..., None] + (y1 - y0)[..., None] * steps, 1.1)

    img = torch.stack([line(c, c, x1, y1), line(x1, y1, x2, y2),
                       stamp(x2[..., None], y2[..., None], 1.5)], dim=-3)
    return img.clamp(0.0, 1.0)


def reacher_trajectories(b: int, t: int, generator: torch.Generator) -> dict:
    """The recipe's `make_dataset` for b trajectories of t frames, drawn from
    `generator` on its device: video (b, 3, t, 32, 32), continuous actions
    (b, t - 1, 6) uniform in [-1, 1], proprio (b, t, 4), zero rewards."""
    device = generator.device
    theta0 = torch.rand((b, 1, 2), generator=generator, device=device) * 2 * np.pi - np.pi
    actions = torch.rand((b, t, 6), generator=generator, device=device) * 2 - 1
    turns = torch.cumsum(0.35 * actions[:, :-1, :2], dim=1)
    theta = theta0 + torch.cat([torch.zeros_like(turns[:, :1]), turns], dim=1)   # (b, t, 2)
    return dict(video=render_arms(theta).transpose(1, 2),
                continuous_actions=actions[:, :-1].contiguous(),
                proprio=torch.cat([torch.sin(theta), torch.cos(theta)], dim=-1),
                rewards=torch.zeros((b, t), device=device))


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
    plain attention (`flag` off on every `cls_name`, then each put back as
    it was), each held against `ref_model` (the same weights in float32,
    plain attention): loss as |difference|, gradients as the relative L2
    distance. Returns {output: (kernel distance, plain distance)}."""
    kernel = step_grads(model, loss_fn, names)
    saved = [(m, getattr(m, flag)) for m in model.modules() if type(m).__name__ == cls_name]
    set_attention(model, cls_name, flag, False)
    try:
        plain = step_grads(model, loss_fn, names)
    finally:
        for m, value in saved:
            setattr(m, flag, value)
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
    step_s = host_time_s(one_step, reps=1)
    check_rl_outputs('timed dream step', out)

    def one_update():
        trainer.rl_state = trainer._update(trainer.rl_state, exp)[0]
    update_s = host_time_s(one_update, reps=3) * trainer.update_epochs
    env_steps = b * (T - P)
    log(f'dream step b{b} T{T} P{P}: {step_s * 1e3:.1f} ms/step (one after a warm step), '
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
    cases.append(('tokfull_time', bf16, 648, 16, 8, 64, 'causal', 50.0, True))   # 8 x 81 tokens
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
# bf16 cases of other main paths, reported in the kernels line beside the
# main case: the all-options tokenizer's time layers (B = 8 x 81)
SMALL_PATH_CASES = ('tokfull_time',)
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


def run_sim_step(trainer, label, full_model: bool, attention=SIM_ATTENTION) -> dict:
    """One `SimTrainer` step, its three parts (`step` runs exactly these:
    the rollout, the dynamics training, the RL epochs) each counted, timed
    and checked; the experience must give the time attention `attention`'s
    rows and length. Returns the parts' launches by path."""
    from dreamer4_torch.train.trainers import rl_param_labels

    model = trainer.model
    labels = rl_param_labels(model, full_model=full_model)
    torch.cuda.reset_peak_memory_stats()
    exp, roll_s, roll_n, roll_v = counted(trainer.rollout)
    b, t = exp.batch_size, exp.time_steps
    if (b * model.tokens_per_frame, t) != (attention['B'], attention['N']):
        raise SystemExit(f'{label}: the experience is b{b} x T{t} ({b * model.tokens_per_frame} '
                         f'time-attention rows), not the {attention["B"]} rows x '
                         f'{attention["N"]} of its kernel cases')
    fields = {name: getattr(exp, name) for name in
              ('latents', 'values', 'agent_embed', 'critic_state', 'rewards')}
    for pair in ('actions', 'log_probs'):
        fields.update({f'{pair}.{half}': x for half, x in getattr(exp, pair)._asdict().items()
                       if x is not None})
    check_finite(label, {f'experience.{name}': x for name, x in fields.items()})
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


# ---------------------------------------------------------------------- cli

def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def run_cli(*args, timeout=300) -> str:
    """`python -m dreamer4_torch.cli <args>` in a subprocess; its output."""
    proc = subprocess.run([sys.executable, '-m', 'dreamer4_torch.cli', *args],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                          timeout=timeout, check=False)
    if proc.returncode != 0:
        raise SystemExit(f'cli {args[0]} failed:\n{proc.stdout}\n{proc.stderr}')
    return proc.stdout


class CliServer:
    """A `python -m dreamer4_torch.cli` server in a subprocess, for the
    block: started, waited for on its port, stopped at the end."""

    def __init__(self, *args, log_path: Path):
        self.port = free_port()
        self.args, self.log_path = [*args, '--port', str(self.port)], log_path
        self.url = f'http://127.0.0.1:{self.port}'

    def __enter__(self):
        self.log_file = open(self.log_path, 'w')
        self.proc = subprocess.Popen([sys.executable, '-m', 'dreamer4_torch.cli', *self.args],
                                     cwd=Path(__file__).resolve().parent, stdout=self.log_file,
                                     stderr=subprocess.STDOUT)
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                self.__exit__()
                raise SystemExit(f'cli {self.args[0]} exited with {self.proc.returncode}:\n'
                                 + self.log_path.read_text())
            try:
                with socket.create_connection(('127.0.0.1', self.port), timeout=1):
                    return self
            except OSError:
                time.sleep(0.5)
        self.__exit__()
        raise SystemExit(f'cli {self.args[0]} did not open port {self.port}')

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self.log_file.close()

    def request(self, path, payload=None):
        """(answer, ms): JSON for a POST or an `/api` path, else text."""
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(self.url + path, data=data,
                                     method='GET' if data is None else 'POST',
                                     headers={'Content-Type': 'application/json'})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read()
        ms = (time.perf_counter() - t0) * 1e3
        return (body.decode() if data is None and not path.startswith('/api')
                else json.loads(body)), ms


def png_size(frame_b64: str) -> tuple[int, int]:
    """(width, height) from a PNG's IHDR chunk."""
    data = base64.b64decode(frame_b64)
    if data[:8] != b'\x89PNG\r\n\x1a\n' or data[12:16] != b'IHDR':
        raise SystemExit('served frame is not a PNG')
    return struct.unpack('>II', data[16:24])


def check_served_steps(server, label, size, steps, rng):
    """`/reset`, `steps` x `/step` and `/`: every frame a PNG of `size` x
    `size`, rewards finite, `done` and `steps_left` present. Returns the
    ms of the reset and of each step."""
    out, reset_ms = server.request('/reset', {})
    if png_size(out['frame']) != (size, size) or 'steps_left' not in out:
        raise SystemExit(f'{label}: /reset answered {sorted(out)}, frame {png_size(out["frame"])}')
    step_ms = []
    for _ in range(steps):
        out, ms = server.request('/step', {'action': int(rng.integers(4))})
        step_ms.append(ms)
        missing = {'frame', 'reward', 'terminated', 'truncated', 'done', 'steps_left'} - set(out)
        if missing or png_size(out['frame']) != (size, size) or not np.isfinite(out['reward']):
            raise SystemExit(f'{label}: /step answered {out.keys()} (missing {missing}), '
                             f'reward {out.get("reward")}')
    page, _ = server.request('/')
    if "post('/step'" not in page:
        raise SystemExit(f'{label}: / does not serve the play page')
    return reset_ms, step_ms


def step_seconds(logdir: Path) -> list[float]:
    """Seconds between consecutive step records of one run's
    `metrics.jsonl` (each logged right after its optimizer step, before
    any sample or checkpoint)."""
    records = [json.loads(line) for line in (logdir / 'metrics.jsonl').read_text().splitlines()]
    return [b['time'] - a['time'] for a, b in zip(records, records[1:])
            if b['step'] == a['step'] + 1]


def record_snake(folder: Path, seed: int):
    from dreamer4_torch.data.replay_buffer import ReplayBuffer
    from dreamer4_torch.envs.snake import SnakeEnv
    from dreamer4_torch.envs.wrappers import RecordToReplayBufferEnvWrapper

    env = SnakeEnv(**CLI_SNAKE, seed=seed)
    h = env.image_size
    buf = ReplayBuffer(folder, max_episodes=CLI_EPISODES,
                       max_timesteps=CLI_SNAKE['max_steps'] + 1,
                       fields=dict(video=('uint8', (3, h, h)), rewards='float',
                                   terminated='bool', discrete_actions='int'))
    wrapped = RecordToReplayBufferEnvWrapper(env, buf)
    rng = np.random.default_rng(seed)
    for ep in range(CLI_EPISODES):
        wrapped.reset(seed=seed + ep)
        while True:
            out = wrapped.step(int(rng.integers(4)))
            if out[2] or out[3]:
                break
    wrapped.close()
    return buf


def run_prefetch_check(buf, seed: int) -> dict:
    """The native `PrefetchSampler` against `sample_batch` under the same
    draws, and the ms the consumer waits in `next` per batch natively
    (the next batch is assembled while this one is checked) and on the
    synchronous path."""
    from dreamer4_torch.data import prefetch

    if not prefetch.available():
        raise SystemExit(f'the native prefetch library did not load: {prefetch.load_error()}')
    cfg = CLI_PREFETCH
    ms = {}
    for path in ('native', 'sync'):
        sampler = prefetch.PrefetchSampler(buf, cfg['batch_size'], cfg['seq_len'],
                                           rng=np.random.default_rng(seed),
                                           convert_uint8_fields=('video',))
        if path == 'sync':
            sampler.engine.close()   # no pool: the numpy path assembles each batch
        ref_rng = np.random.default_rng(seed)
        waited = 0.0
        for _ in range(cfg['batches']):
            t0 = time.perf_counter()
            got = next(sampler)
            waited += time.perf_counter() - t0
            ref = buf.sample_batch(ref_rng, cfg['batch_size'], cfg['seq_len'])
            ref['video'] = ref['video'].astype(np.float32) / 255.0
            for k, v in ref.items():
                if not np.allclose(got[k], v, rtol=1e-6, atol=0):
                    raise SystemExit(f'prefetch ({path}): {k} differs from sample_batch')
        ms[path] = waited * 1e3 / cfg['batches']
        sampler.close()
    return ms


def run_cli_phase(seed: int = 0) -> dict:
    """The data plane, the CLI and serving at the CLI's default widths;
    returns the (K1..K5) launches of its in-process parts."""
    import dreamer4_torch.cli as cli
    from dreamer4_torch.data import prefetch

    work = CLI_WORK_DIR
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # the servers below are processes of their own on this card: hand back
    # what earlier phases left in this process's allocator cache
    gc.collect()
    torch.cuda.empty_cache()
    buffer_dir, tok_dir, dyn_dir = work / 'snake_buffer', work / 'tokenizer', work / 'dynamics'
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    buf, sec = timed(lambda: record_snake(buffer_dir, seed))
    lengths = [buf.episode_length(i) for i in range(buf.num_episodes)]
    log(f'cli: recorded {buf.num_episodes} Snake episodes ({CLI_SNAKE}) in {sec:.2f} s, '
        f'lengths {lengths}')
    ms = run_prefetch_check(buf, seed)
    log(f'cli: native prefetch library {prefetch.library_path().name} loaded '
        f'(available() {prefetch.available()}); PrefetchSampler b{CLI_PREFETCH["batch_size"]} x '
        f'T{CLI_PREFETCH["seq_len"]} (uint8 -> float32) equal to sample_batch: '
        f'the consumer waits {ms["native"]:.3f} ms per batch native, {ms["sync"]:.3f} ms '
        'synchronous')

    stats = json.loads(run_cli('inspect-replay-buffer', '--buffer', str(buffer_dir)))
    want = dict(num_episodes=CLI_EPISODES, max_timesteps=CLI_SNAKE['max_steps'] + 1,
                mean_episode_length=float(np.mean(lengths)),
                fields={k: [str(np.dtype(d)), list(s)] for k, (d, s) in buf.fields.items()})
    if any(stats[k] != v for k, v in want.items()):
        raise SystemExit(f'inspect-replay-buffer printed {stats}, the buffer holds {want}')
    log(f'cli: inspect-replay-buffer: {stats["num_episodes"]} episodes, mean length '
        f'{stats["mean_episode_length"]}, fields {sorted(stats["fields"])}')

    launches = {}
    tok_args = ['train-video-tokenizer', '--dataset', str(buffer_dir), '--output', str(tok_dir),
                *CLI_TOKENIZER_ARGS]
    for steps in ('2', '3'):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            _, sec, counts, _ = counted(lambda: cli.main([*tok_args, '--num-steps', steps]))
        launches[f'cli_tokenizer_{steps}'] = counts
        log(f'cli: train-video-tokenizer --num-steps {steps}: {sec:.2f} s in all, (K1..K5) '
            f'launches {counts}; it printed: {printed.getvalue().splitlines()}')
        if steps == '2':   # the resumed run logs one step only
            tok_step_s = step_seconds(tok_dir / 'logs')
    if f'resumed from {tok_dir} at step 2' not in printed.getvalue():
        raise SystemExit('the second train-video-tokenizer run did not resume at step 2')
    steps_logged = [json.loads(line)['step'] for line in
                    (tok_dir / 'logs' / 'metrics.jsonl').read_text().splitlines()]
    if steps_logged != [1, 2, 3] or not (tok_dir / 'ckpt-3' / 'ema' / 'config.json').exists():
        raise SystemExit(f'the tokenizer logged steps {steps_logged}, or no EMA checkpoint at 3')

    _, sec, counts, _ = counted(lambda: cli.main([
        'train-dynamics', '--dataset', str(buffer_dir), '--tokenizer-checkpoint', str(tok_dir),
        '--output', str(dyn_dir), *CLI_DYNAMICS_ARGS]))
    launches['cli_dynamics'] = counts
    dyn_step_s = step_seconds(dyn_dir / 'logs')
    gifs = sorted(p.name for d in (tok_dir, dyn_dir) for p in (d / 'logs').glob('*.gif'))
    losses = [json.loads(line)['loss'] for line in
              (dyn_dir / 'logs' / 'metrics.jsonl').read_text().splitlines()]
    if not np.isfinite(losses).all() or gifs != ['dream_00000002.gif', 'recon_00000002.gif']:
        raise SystemExit(f'train-dynamics: losses {losses}, sample gifs {gifs}')
    log(f'cli: train-dynamics --num-steps 2: {sec:.2f} s in all, (K1..K5) launches {counts}, '
        f'losses {losses}; sample gifs written {gifs}')
    log(f'cli: s per optimizer step: tokenizer (b8 x T8, 2 micro-batches) {tok_step_s}, '
        f'dynamics (b8 x T8) {dyn_step_s} (from metrics.jsonl: step 1 -> 2 of one run)')

    # the served environment, built here as the server builds it, counted
    size = CLI_SNAKE['image_size']
    env = cli.world_model_env(str(dyn_dir), str(tok_dir))
    rng = np.random.default_rng(seed)
    env.reset()
    zero_counts()
    step_ms = []
    for _ in range(CLI_SERVE_STEPS):
        out, sec = timed(lambda: env.step(int(rng.integers(4))))
        step_ms.append(sec * 1e3)
    launches['cli_wrapper'] = read_counts()
    if out[0].shape != (1, 3, size, size) or not np.isfinite(out[0]).all():
        raise SystemExit(f'world-model env step gave {out[0].shape}')
    log(f'cli: DynamicsWorldModelWrapper step in this process: median '
        f'{np.median(step_ms):.2f} ms, max {max(step_ms):.2f} ms over {CLI_SERVE_STEPS}, '
        f'(K1..K5) launches {launches["cli_wrapper"]}')
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del env
    gc.collect()
    torch.cuda.empty_cache()

    with CliServer('serve-world-model', '--checkpoint', str(dyn_dir), '--tokenizer-checkpoint',
                   str(tok_dir), log_path=work / 'serve_world_model.log') as server:
        reset_ms, served_ms = check_served_steps(server, 'serve-world-model', size,
                                                 CLI_SERVE_STEPS, rng)
    log(f'cli: serve-world-model over HTTP: /reset {reset_ms:.2f} ms, /step median '
        f'{np.median(served_ms):.2f} ms, max {max(served_ms):.2f} ms over {CLI_SERVE_STEPS} '
        '(a dreamed frame, the tokenizer decode and the PNG; first requests included)')
    with CliServer('serve-world-model', log_path=work / 'serve_snake.log') as server:
        check_served_steps(server, 'serve-world-model (Snake)', 8, 4, rng)
    with CliServer('inspect-replay-buffer', '--buffer', str(buffer_dir), '--serve',
                   log_path=work / 'inspect.log') as server:
        served_stats, _ = server.request('/api/stats')
        episode, _ = server.request('/api/episode/0')
    if (served_stats != {k: v for k, v in stats.items() if k != 'folder'}
            or episode['length'] != lengths[0]
            or [png_size(f) for f in episode['frames']] != [(size, size)] * lengths[0]):
        raise SystemExit(f'inspect-replay-buffer --serve: {served_stats}, episode 0 length '
                         f'{episode["length"]}')
    log(f'cli: serve-world-model on Snake and inspect-replay-buffer --serve answered; '
        f'phase {time.perf_counter() - t_phase:.1f} s, peak memory in this process '
        f'{peak:.2f} GiB')
    for label, counts in launches.items():
        expect_launches(label, counts, (0, 0, 0, 0, 0))
    shutil.rmtree(work)
    return launches


# --------------------------------------------------------------- continuous

def reacher_latents(video: torch.Tensor, seed: int) -> torch.Tensor:
    """Latents (b, t, 16, 32) of reacher frames (b, 3, t, 32, 32) for the
    bench world model: a fixed projection drawn from `seed`, squashed into
    (-1, 1) by tanh. It stands in for a tokenizer, which this phase would
    only run untrained (the bench tokenizer takes 64 x 64 frames)."""
    b, c, t, h, w = video.shape
    g = torch.Generator(device=video.device).manual_seed(seed)
    proj = torch.randn((c * h * w, 16 * 32), generator=g, device=video.device)
    frames = video.transpose(1, 2).reshape(b, t, c * h * w)
    return torch.tanh(frames @ proj * (4.0 / (c * h * w) ** 0.5)).reshape(b, t, 16, 32)


def reacher_prompt(b: int, seed: int, device) -> dict:
    """A `PROMPT_LEN`-frame prompt of b reacher trajectories: latents, the
    actions taken from each frame, proprio."""
    data = reacher_trajectories(b, PROMPT_LEN + 1, torch.Generator(device=device).manual_seed(seed))
    return dict(prompt_latents=reacher_latents(data['video'][:, :, :PROMPT_LEN], seed),
                prompt_continuous_actions=data['continuous_actions'][:, :PROMPT_LEN],
                prompt_proprio=data['proprio'][:, :PROMPT_LEN])


def check_finite(label: str, named: dict):
    bad = [k for k, v in named.items() if v is not None and not bool(torch.isfinite(v.float()).all())]
    if bad:
        raise SystemExit(f'{label}: not finite: {bad}')


def check_continuous_experience(label, exp, b, T, prompt, model):
    """A continuous dream's record: shapes, finite values (proprio and the
    continuous log probs among them), Beta actions in (0, 1) after the
    prompt, the prompt kept."""
    P = PROMPT_LEN
    expect = dict(latents=(b, T, *model.latent_shape), proprio=(b, T, model.dim_proprio),
                  rewards=(b, T), values=(b, T), agent_embed=(b, T, model.dim))
    for name, shape in expect.items():
        if tuple(getattr(exp, name).shape) != shape:
            raise SystemExit(f'{label}: experience.{name} shape {tuple(getattr(exp, name).shape)}')
    check_finite(label, {**{n: getattr(exp, n) for n in expect},
                         'actions.continuous': exp.actions.continuous,
                         'log_probs.continuous': exp.log_probs.continuous[:, P:],
                         'old_action_unembeds': exp.old_action_unembeds[1]})
    if exp.actions.discrete is not None or tuple(exp.actions.continuous.shape) != (b, T, 6):
        raise SystemExit(f'{label}: experience.actions are not 6 continuous actions')
    if not torch.equal(exp.actions.continuous[:, :P], prompt['prompt_continuous_actions']):
        raise SystemExit(f'{label}: experience.actions do not keep the prompt actions')
    if not torch.equal(exp.proprio[:, :P], prompt['prompt_proprio']):
        raise SystemExit(f'{label}: experience.proprio does not keep the prompt')


def run_continuous_phase(seed: int = 0) -> dict:
    """Continuous actions, proprioception and the state-prediction head at
    the bench world model's width (29 tokens per frame), float32 master
    weights and bf16 compute: a. `BehaviorCloneTrainer` steps on reacher
    trajectories at b1 x T1024; b. the prompted b16 x T192 dream, sampled
    and with +-0.9 forced actions; c. a heads-only PMPO `DreamTrainer`
    step; d. a full-model update over b8 rows of the dream; e. a heads-only
    `SimTrainer` step with continuous actions and the state-entropy bonus;
    f. `DynamicsWorldModelWrapper` frames. Each part counted, timed and
    checked; returns the (K1..K5) launches by path."""
    from dreamer4_torch import (BehaviorCloneTrainer, DreamTrainer, DynamicsWorldModel,
                                SimTrainer, generate)
    from dreamer4_torch.data.experience import index_experience
    from dreamer4_torch.envs.mocks import MockStateEnv
    from dreamer4_torch.envs.world_model_env import DynamicsWorldModelWrapper
    from dreamer4_torch.train.trainers import (create_rl_state, make_rl_optimizer,
                                               make_rl_update_step, make_world_model_train_step,
                                               rl_param_labels)

    t_phase = time.perf_counter()
    torch.manual_seed(seed)
    model = DynamicsWorldModel(**CONT_MODEL, dtype=torch.bfloat16)
    if model.device.type != 'cuda':
        raise SystemExit(f'model built on {model.device}, not on the card')
    if model.tokens_per_frame != CONT_TOKENS:
        raise SystemExit(f'{model.tokens_per_frame} tokens per frame, not {CONT_TOKENS}')
    dev = model.device
    log(f'# continuous ({gpu_name_and_power_limit()}): '
        f'{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M params, '
        f'{model.tokens_per_frame} tokens/frame (proprio and state-prediction tokens)')
    launches = {}

    def part(label, fn, want, expect_sm90_k1=True):
        torch.cuda.reset_peak_memory_stats()
        out, sec, got, variants = counted(fn)
        expect_launches(label, got, want)
        if expect_sm90_k1:
            expect_sm90(label, got, variants)
        launches[label] = got
        return out, sec, got, torch.cuda.max_memory_allocated() / 2**30

    # a. behaviour cloning at b1 x T1024: continuous actions, proprio, rewards
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    data = reacher_trajectories(TRAIN['batch_size'], TRAIN['time_steps'], g)
    batch = dict(latents=reacher_latents(data['video'], seed + 3),
                 continuous_actions=data['continuous_actions'], proprio=data['proprio'],
                 rewards=data['rewards'])
    del data
    trainer = BehaviorCloneTrainer(model, learning_rate=3e-4, clip_grad_norm=1.0,
                                   with_ema=True, seed=seed)
    step_fn = make_world_model_train_step(model, trainer.optimizer, ema_decay=0.999)
    for shortcut in (False, True):
        label = f'cont_train_{"shortcut" if shortcut else "plain"}'

        def one_step():
            trainer.ts, loss, losses = step_fn(trainer.ts, batch, shortcut_train=shortcut,
                                               generator=trainer.generator)
            return loss, losses
        (loss, losses), sec, got, peak = part(label, one_step, LAUNCHES_PER_STEP[shortcut])
        check_finite(label, {'loss': loss, **losses._asdict()})
        if not (losses.state_pred > 0 and losses.continuous_actions.abs().sum() > 0):
            raise SystemExit(f'{label}: the state-prediction or action loss is not on')
        sec_warm = host_time_s(lambda: one_step(), reps=1)
        log(f'{label} b{TRAIN["batch_size"]} T{TRAIN["time_steps"]}: loss {loss.item():.4f} '
            f'(flow {losses.flow.item():.4f}, state_pred {losses.state_pred.item():.4f}, '
            f'continuous actions {losses.continuous_actions.sum().item():.4f}); '
            f'{sec * 1e3:.1f} ms first, {sec_warm * 1e3:.1f} ms warm; (K1..K5) {got}; '
            f'peak memory {peak:.2f} GiB')
    del batch

    # b. the prompted dream: sampled, then with +-0.9 forced actions
    b, T = PROMPTED['batch_size'], PROMPTED['time_steps']
    prompt = reacher_prompt(b, seed + 4, dev)
    gen = torch.Generator(device=dev)
    dreams = {}
    for label, forced in (('cont_dream', None), ('cont_dream_forced_pos', CONT_FORCED),
                          ('cont_dream_forced_neg', -CONT_FORCED)):
        kw = {} if forced is None else dict(
            forced_continuous_actions=torch.full((b, T, 6), forced, device=dev))
        gen.manual_seed(seed + 5)
        exp, sec, got, peak = part(label, lambda: generate(
            model, gen, num_steps=PROMPTED['num_steps'], batch_size=b, time_steps=T, **prompt,
            **kw), CONT_DREAM_LAUNCHES)
        check_continuous_experience(label, exp, b, T, prompt, model)
        acts = exp.actions.continuous[:, PROMPT_LEN:]
        if forced is not None and not bool((acts == forced).all()):
            raise SystemExit(f'{label}: the forced actions were not taken')
        if forced is None and not bool(((acts > 0) & (acts < 1)).all()):
            raise SystemExit(f'{label}: Beta samples outside (0, 1)')
        dreams[label] = exp
        log(f'{label} b{b} T{T} P{PROMPT_LEN}: {sec * 1e3:.1f} ms, '
            f'{b * (T - PROMPT_LEN) / sec:.1f} dreamed env-steps/s; (K1..K5) {got}; '
            f'peak memory {peak:.2f} GiB')
    pos, neg = (dreams[f'cont_dream_forced_{x}'].latents[:, PROMPT_LEN:] for x in ('pos', 'neg'))
    lat_div, lat_scale = (pos - neg).abs().mean().item(), pos.abs().mean().item()
    prop_div = (dreams['cont_dream_forced_pos'].proprio
                - dreams['cont_dream_forced_neg'].proprio)[:, PROMPT_LEN:].abs().mean().item()
    log(f'forced +-{CONT_FORCED} dreams: latent divergence {lat_div:.4f} (scale {lat_scale:.4f}, '
        f'bound {CONT_DIVERGENCE} x scale), proprio divergence {prop_div:.4f}')
    if not lat_div > CONT_DIVERGENCE * max(lat_scale, 1e-6):
        raise SystemExit('the forced-action dreams do not diverge')
    del dreams

    # c. a heads-only PMPO step of DreamTrainer over that dream
    dream_trainer = DreamTrainer(model, time_steps=T, num_steps=PROMPTED['num_steps'],
                                 batch_size=b, objective='pmpo',
                                 prompt_fn=lambda generator: prompt, seed=seed)
    labels = rl_param_labels(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    (exp, out), sec, got, peak = part('cont_dream_trainer', dream_trainer.step,
                                      CONT_DREAM_LAUNCHES)
    check_continuous_experience('cont_dream_trainer', exp, b, T, prompt, model)
    check_rl_outputs('cont_dream_trainer', out)
    check_moved('cont_dream_trainer', model, before,
                {n for n, l in labels.items() if l != 'frozen'}, moved=True)
    check_moved('cont_dream_trainer', model, before,
                {n for n, l in labels.items() if l == 'frozen'}, moved=False)
    del before
    log(f'cont_dream_trainer b{b} T{T} (heads-only pmpo): {sec * 1e3:.1f} ms/step; (K1..K5) '
        f'{got}; stats {", ".join(f"{k} {v.item():.4f}" for k, v in out.stats.items())}; '
        f'peak memory {peak:.2f} GiB; only the heads and the unembeddings moved')

    # d. a full-model update over b8 rows of the dream, proprio replayed
    rows = index_experience(exp, slice(0, CONT_RL_ROWS))
    del exp
    if CONT_RL_ROWS * model.tokens_per_frame != CONT_RL_FULL_ATTENTION['B']:
        raise SystemExit('the full-model update does not give the cont_rl_full kernel case')
    opt = make_rl_optimizer(model, **RL_LR)
    full_update = make_rl_update_step(model, opt, 'pmpo', only_learn_policy_value_heads=False)
    state = create_rl_state(model, opt)
    trunk_before = {n: p.detach().clone() for n, p in model.named_parameters()
                    if n.startswith('transformer.')}
    torch.cuda.empty_cache()
    (state, out), sec, got, peak = part('cont_rl_full', lambda: full_update(state, rows),
                                        LAUNCHES_PER_RL_FULL_UPDATE)
    check_rl_outputs('cont_rl_full', out)
    check_moved('cont_rl_full', model, trunk_before, set(trunk_before), moved=True)
    del trunk_before, rows, opt, state
    log(f'cont_rl_full b{CONT_RL_ROWS} T{T} ({CONT_RL_ROWS * T * CONT_TOKENS} tokens, pmpo): '
        f'{sec * 1e3:.1f} ms/update (first); (K1..K5) {got}; the trunk moved; peak memory '
        f'{peak:.2f} GiB')
    del trainer, dream_trainer, step_fn, model
    gc.collect()
    torch.cuda.empty_cache()

    # e. a heads-only SimTrainer step: continuous actions toward the env,
    # the state-entropy bonus in the rewards
    torch.manual_seed(seed + 6)
    sim_model = DynamicsWorldModel(**CONT_SIM_MODEL, dtype=torch.bfloat16)
    sim = SimTrainer(sim_model, MockStateEnv(**SIM_ENV, seed=seed), **SIM_TRAINER, seed=seed)
    if not sim_model.add_state_entropy_bonus:
        raise SystemExit('the sim model has no state-entropy bonus')
    for name, n in run_sim_step(sim, 'cont_sim', full_model=False,
                                attention=CONT_SIM_ATTENTION).items():
        launches[name] = n

    # f. the world model as an environment, 8 frames of continuous actions
    wrapper = DynamicsWorldModelWrapper(sim_model, batch_size=1,
                                        max_timesteps=CONT_WRAPPER_FRAMES, seed=seed)
    actions = torch.rand((CONT_WRAPPER_FRAMES, 6), generator=g, device=dev).cpu().numpy() * 2 - 1

    def frames():
        obs = [wrapper.reset()[0]]
        rewards = []
        for a in actions:
            o, r, _, _, _ = wrapper.step(a)
            obs.append(o)
            rewards.append(r)
        return np.stack(obs), np.asarray(rewards)
    (obs, rewards), sec, got, peak = part('cont_wrapper', frames, (0, 0, 0, 0, 0))
    if obs.shape != (CONT_WRAPPER_FRAMES + 1, 1, *sim_model.latent_shape) or not (
            np.isfinite(obs).all() and np.isfinite(rewards).all()):
        raise SystemExit(f'cont_wrapper: observations {obs.shape} or rewards not finite')
    log(f'cont_wrapper b1: reset and {CONT_WRAPPER_FRAMES} continuous steps {sec * 1e3:.1f} ms, '
        f'{sec * 1e3 / (CONT_WRAPPER_FRAMES + 1):.1f} ms/frame; (K1..K5) {got}; peak memory '
        f'{peak:.2f} GiB')
    del sim, sim_model, wrapper
    gc.collect()
    torch.cuda.empty_cache()
    log(f'# continuous phase: {time.perf_counter() - t_phase:.1f} s')
    return launches


# ------------------------------------------------------------------- recipe

def run_recipe_phase(seed: int = 0) -> dict:
    """The RL options of the imagination-only CartPole recipe at the bench
    world model's width (28 tokens per frame), float32 master weights and
    bf16 compute: a. a plain `BehaviorCloneTrainer` step at b1 x T1024 with
    the agent's state prediction; b. a heads-only PPO `DreamTrainer` step
    at the recipe's dream shape, the heads reading the latents; c. a
    full-model update of the latent-input heads on that dream, which
    replays no trunk; d. a heads-only `SimTrainer` step. Each part counted,
    timed and checked; returns the (K1..K5) launches by path."""
    from dreamer4_torch import BehaviorCloneTrainer, DreamTrainer, DynamicsWorldModel, SimTrainer
    from dreamer4_torch.envs.mocks import MockStateEnv
    from dreamer4_torch.train.trainers import (ADAMW, create_rl_state, make_rl_optimizer,
                                               make_rl_update_step, make_world_model_train_step,
                                               rl_param_labels)

    t_phase = time.perf_counter()
    torch.manual_seed(seed)
    model = DynamicsWorldModel(**RECIPE_MODEL, dtype=torch.bfloat16)
    if model.device.type != 'cuda':
        raise SystemExit(f'model built on {model.device}, not on the card')
    if model.tokens_per_frame != RECIPE_TOKENS:
        raise SystemExit(f'{model.tokens_per_frame} tokens per frame, not {RECIPE_TOKENS}')
    dev = model.device
    log(f'# recipe ({gpu_name_and_power_limit()}): '
        f'{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M params, '
        f'{model.tokens_per_frame} tokens/frame (agent state prediction, latent-input heads, '
        f'actor SPR over {model.actor_spr_module.num_rollouts} rollouts)')
    launches = {}

    def part(label, fn, want):
        torch.cuda.reset_peak_memory_stats()
        out, sec, got, variants = counted(fn)
        expect_launches(label, got, want)
        expect_sm90(label, got, variants)
        launches[label] = got
        return out, sec, got, torch.cuda.max_memory_allocated() / 2**30

    # a. the plain train step at b1 x T1024: the agent's state prediction on
    batch = train_batch(dev, seed + 2)
    trainer = BehaviorCloneTrainer(model, learning_rate=3e-4, clip_grad_norm=1.0,
                                   with_ema=True, seed=seed)
    step_fn = make_world_model_train_step(model, trainer.optimizer, ema_decay=0.999)

    def one_step():
        trainer.ts, loss, losses = step_fn(trainer.ts, batch, shortcut_train=False,
                                           generator=trainer.generator)
        return loss, losses
    (loss, losses), sec, got, peak = part('recipe_train_plain', one_step,
                                          LAUNCHES_PER_STEP[False])
    check_finite('recipe_train_plain', {'loss': loss, **losses._asdict()})
    if not (losses.agent_state_pred > 0 and losses.state_pred > 0):
        raise SystemExit('recipe_train_plain: the agent-state or state loss is not on')
    grad = model.agent_state_pred_net.Dense_0.weight.grad
    if grad is None or not bool(grad.any()):
        raise SystemExit('recipe_train_plain: no gradient reached agent_state_pred_net')
    sec_warm = host_time_s(lambda: one_step(), reps=1)
    log(f'recipe_train_plain b{TRAIN["batch_size"]} T{TRAIN["time_steps"]}: loss '
        f'{loss.item():.4f} (flow {losses.flow.item():.4f}, agent_state_pred '
        f'{losses.agent_state_pred.item():.4f}, state_pred {losses.state_pred.item():.4f}, '
        f'actions through the latent encoder {losses.discrete_actions.sum().item():.4f}); '
        f'{sec * 1e3:.1f} ms first, {sec_warm * 1e3:.1f} ms warm; (K1..K5) {got}; peak memory '
        f'{peak:.2f} GiB')
    del batch, trainer, step_fn
    model.zero_grad(set_to_none=True)

    # b. a heads-only PPO DreamTrainer step from a 3-frame prompt of the
    # state-vector latents
    b, T = RECIPE_DREAM['batch_size'], RECIPE_DREAM['time_steps']
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    P = RECIPE_PROMPT_LEN
    with torch.no_grad():
        prompt = dict(
            prompt_latents=model.state_to_latents(
                torch.randn((b, P, SIM_ENV['dim_state']), generator=g, device=dev)).float(),
            prompt_discrete_actions=torch.randint(0, SIM_ENV['num_actions'], (b, P, 1),
                                                  generator=g, device=dev),
            prompt_rewards=torch.ones((b, P), device=dev))
    dream_trainer = DreamTrainer(model, **RECIPE_DREAM, prompt_fn=lambda generator: prompt,
                                 generate_kwargs=dict(hard_terminals=False), seed=seed)
    labels = rl_param_labels(model)
    moving = {n for n, l in labels.items() if l != 'frozen'}
    if {n.partition('.')[0] for n in moving} != {
            'policy_head', 'value_head', 'action_embedder', 'actor_latent_encoder',
            'critic_latent_encoder', 'critic_state_embedder'}:
        raise SystemExit(f'recipe_dream_trainer: unexpected RL groups {sorted(moving)[:8]}')
    # a dream has no critic state: its embedding has no gradient, and AdamW
    # only decays it (its zero bias stays)
    learners = {n for n in moving if not n.startswith('critic_state_embedder.')}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    (exp, out), sec, got, peak = part('recipe_dream_trainer', dream_trainer.step,
                                      (0, 0, 0, 0, 0))
    check_experience(exp, b, T, P, model.dim, model.latent_shape)
    check_rl_outputs('recipe_dream_trainer', out)
    check_moved('recipe_dream_trainer', model, before, learners, moved=True)
    check_moved('recipe_dream_trainer', model, before, set(labels) - moving, moved=False)
    spr_grad = model.actor_spr_module.dynamics_mlp.Dense_0.weight.grad
    if spr_grad is None or not bool(spr_grad.any()):
        raise SystemExit('recipe_dream_trainer: the SPR loss gave actor_spr_module no gradient')
    del before
    log(f'recipe_dream_trainer b{b} T{T} P{P} (heads-only ppo, {RECIPE_DREAM["update_epochs"]} '
        f'epochs): {sec * 1e3:.1f} ms/step, {b * (T - P) / sec:.1f} dreamed env-steps/s; '
        f'(K1..K5) {got}; stats '
        f'{", ".join(f"{k} {v.item():.4f}" for k, v in out.stats.items())}; peak memory '
        f'{peak:.2f} GiB; the heads, the unembedding and the latent encoders moved, '
        f'actor_spr_module (a gradient, no optimizer group) and the trunk did not')

    # c. a full-model update of the latent-input heads on that dream: the
    # encoders, the heads and the SPR module learn; the trunk has a zero
    # gradient and moves by AdamW's decay alone
    opt = make_rl_optimizer(model, **RECIPE_RL_FULL_LR)
    full_update = make_rl_update_step(model, opt, RECIPE_DREAM['objective'],
                                      only_learn_policy_value_heads=False,
                                      latent_input_full_model_ok=True)
    state = create_rl_state(model, opt)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    (state, out), sec, got, peak = part('recipe_rl_full', lambda: full_update(state, exp),
                                        (0, 0, 0, 0, 0))
    check_rl_outputs('recipe_rl_full', out)
    learners |= {n for n in before if n.startswith('actor_spr_module.')}
    check_moved('recipe_rl_full', model, before, learners, moved=True)
    decay = 1.0 - RECIPE_RL_FULL_LR['trunk_lr'] * ADAMW['weight_decay']
    trunk = [(n, p) for n, p in model.named_parameters() if n.startswith('transformer.')]
    if any(p.grad is None or p.grad.any() for _, p in trunk):
        raise SystemExit('recipe_rl_full: the trunk has a nonzero gradient')
    # within one float32 rounding of w x decay
    not_decay = [n for n, p in trunk
                 if bool(((p - before[n] * decay).abs() > before[n].abs() * 2**-23).any())]
    if not_decay:
        raise SystemExit(f'recipe_rl_full: trunk weights moved by more than the decay: '
                         f'{not_decay[:4]}')
    moved_entries = sum(int((p != before[n]).sum()) for n, p in trunk)
    if moved_entries == 0:
        raise SystemExit('recipe_rl_full: the decay did not move the trunk')
    del before, opt, state
    log(f'recipe_rl_full b{b} T{T} (latent-input heads, full model): {sec * 1e3:.1f} ms/update '
        f'(first); (K1..K5) {got}; the encoders, the heads and actor_spr_module moved; the trunk '
        f'had a zero gradient and moved by the decay alone ({moved_entries} of '
        f'{sum(p.numel() for _, p in trunk)} weights changed, each to w x {decay}); peak '
        f'memory {peak:.2f} GiB')
    del dream_trainer, exp, prompt
    gc.collect()
    torch.cuda.empty_cache()

    # d. a heads-only SimTrainer step with the recipe's options
    sim = SimTrainer(model, MockStateEnv(**SIM_ENV, seed=seed), **SIM_TRAINER,
                     seed=RECIPE_SIM_SEED)
    launches.update(run_sim_step(sim, 'recipe_sim', full_model=False,
                                 attention=RECIPE_SIM_ATTENTION))
    expect_launches('recipe_sim_dynamics', launches['recipe_sim_dynamics'],
                    LAUNCHES_PER_STEP[False])
    del sim, model
    gc.collect()
    torch.cuda.empty_cache()
    log(f'# recipe phase: {time.perf_counter() - t_phase:.1f} s')
    return launches


# -------------------------------------------------------------- wm-options

def wmopt_batch(device, seed):
    """The train phase's b1 x T1024 batch with a task for each row."""
    batch = train_batch(device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    batch['tasks'] = torch.randint(0, WMOPT_MODEL['num_tasks'], (TRAIN['batch_size'],),
                                   generator=g, device=device)
    return batch


def run_wm_options_phase(seed: int = 0) -> dict:
    """The world model's remaining options at the bench model's width
    (28 tokens per frame), float32 master weights and bf16 compute: a. a
    plain and a shortcut `BehaviorCloneTrainer` step at b1 x T1024 with a
    task per row, the loss and the main and actor trunks' time-layer
    gradients through the kernels held against float32, every new loss term
    finite and nonzero, the critic trunk's gradient zero; c. the prompted
    b16 x T192 dream with a task and a latent gene per row, then a
    heads-only PPO `DreamTrainer` step on such dreams; d. a full-model
    update over the dream's first 4 rows; b. the bench model without the
    options, one plain step with self-flow (the head must move). Each part
    counted, timed and checked; returns the (K1..K5) launches by path."""
    from dreamer4_torch import BehaviorCloneTrainer, DreamTrainer, DynamicsWorldModel
    from dreamer4_torch.data.experience import index_experience
    from dreamer4_torch.models.generate import generate
    from dreamer4_torch.train.trainers import (create_rl_state, make_rl_optimizer,
                                               make_rl_update_step, make_world_model_train_step,
                                               rl_param_labels)

    t_phase = time.perf_counter()
    torch.manual_seed(seed)
    model = DynamicsWorldModel(**WMOPT_MODEL, dtype=torch.bfloat16)
    if model.device.type != 'cuda':
        raise SystemExit(f'model built on {model.device}, not on the card')
    if model.tokens_per_frame != WMOPT_TOKENS:
        raise SystemExit(f'{model.tokens_per_frame} tokens per frame, not {WMOPT_TOKENS}')
    dev = model.device
    log(f'# wm-options ({gpu_name_and_power_limit()}): '
        f'{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M params, '
        f'{model.tokens_per_frame} tokens/frame (tasks, latent genes, actor and critic trunks '
        f'of depth {model.actor_depth}, spatial and action pre-encoders, aug token, LAPO, TEM, '
        f'latent AR {model.latent_ar_layer})')
    launches = {}

    def part(label, fn):
        torch.cuda.reset_peak_memory_stats()
        out, sec, got, variants = counted(fn)
        expect_launches(label, got, WMOPT_LAUNCHES[label])
        expect_sm90(label, got, variants)
        launches[label] = got
        return out, sec, got, variants, torch.cuda.max_memory_allocated() / 2**30

    # a. the train steps at b1 x T1024; first the loss and the time layers'
    # gradients through the kernels against float32
    batch = wmopt_batch(dev, seed + 2)
    ref = DynamicsWorldModel(**{**WMOPT_MODEL, 'use_flash_attention': False})
    ref.load_state_dict(model.state_dict())
    names = [f'transformer.attn_{i}.{w}.weight' for i in TIME_LAYERS
             for w in ('to_q', 'to_k', 'to_v')]
    names += [f'actor_transformer.attn_3.{w}.weight' for w in ('to_q', 'to_k', 'to_v')]
    torch.cuda.reset_peak_memory_stats()
    check_grad_distances('wmopt train grads', compare_grads(
        model, ref, wm_plain_step_loss(batch, seed + 3), names, 'AxialSpaceTimeTransformer',
        'use_flash_attention'))
    del ref
    if model.spatial_pre_encoder.use_flash_attention or model.action_pre_encoder.use_flash_attention:
        raise SystemExit('wmopt: a pre-encoder has flash attention on')
    log(f'wmopt grad check peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    gc.collect()
    torch.cuda.empty_cache()

    trainer = BehaviorCloneTrainer(model, learning_rate=3e-4, clip_grad_norm=1.0,
                                   with_ema=True, seed=seed)
    step_fn = make_world_model_train_step(model, trainer.optimizer, ema_decay=0.999)
    for shortcut in (False, True):
        label = 'wmopt_train_shortcut' if shortcut else 'wmopt_train_plain'
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        ema_before = {n: e.clone() for n, e in trainer.ts.ema_params.items()}
        ts_before = trainer.ts

        def one_step():
            trainer.ts, loss, losses = step_fn(trainer.ts, batch, shortcut_train=shortcut,
                                               generator=trainer.generator)
            return loss, losses
        (loss, losses), sec, got, variants, peak = part(label, one_step)
        n_grad = check_step(model, ts_before, trainer.ts, loss, losses, before, ema_before, label)
        zero_terms = [f for f in WMOPT_NEW_LOSSES if not float(getattr(losses, f)) > 0]
        if zero_terms:
            raise SystemExit(f'{label}: loss terms not nonzero: {zero_terms}')
        critic = [n for n, p in model.critic_transformer.named_parameters()
                  if p.grad is not None and bool(p.grad.any())]
        if critic:
            raise SystemExit(f'{label}: the critic trunk has a gradient: {critic[:4]}')
        del before, ema_before
        sec_warm = host_time_s(lambda: one_step(), reps=1)
        log(f'{label} b{TRAIN["batch_size"]} T{TRAIN["time_steps"]}: loss {loss.item():.4f} '
            f'({", ".join(f"{f} {getattr(losses, f).item():.4f}" for f in WMOPT_NEW_LOSSES)}); '
            f'{n_grad} parameters with a gradient, all moved with their EMA, none of the critic '
            f'trunk; {sec * 1e3:.1f} ms first, {sec_warm * 1e3:.1f} ms warm; (K1..K5) {got}, K1 '
            f'by variant {variants}; peak memory {peak:.2f} GiB')
    del trainer, step_fn, batch
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()

    # c. the prompted dream with a task and a latent gene per row, then a
    # heads-only PPO DreamTrainer step
    b, T, P = DREAM['batch_size'], DREAM['time_steps'], PROMPT_LEN
    prompt = bench_prompt(model, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    cond = dict(tasks=torch.randint(0, WMOPT_MODEL['num_tasks'], (b,), generator=g, device=dev),
                latent_gene_ids=torch.randint(0, WMOPT_MODEL['num_latent_genes'], (b,),
                                              generator=g, device=dev))
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    exp, sec, got, variants, peak = part('wmopt_generate', lambda: generate(
        model, gen, time_steps=T, num_steps=DREAM['num_steps'], batch_size=b, **prompt, **cond))
    check_experience(exp, b, T, P, model.dim, model.latent_shape, prompt=prompt)
    log(f'wmopt_generate b{b} T{T} P{P} (tasks, latent genes): {sec * 1e3:.1f} ms (first), '
        f'{b * (T - P) / sec:.1f} dreamed env-steps/s; (K1..K5) {got}, K1 by variant {variants}; '
        f'peak memory {peak:.2f} GiB')

    dream_trainer = DreamTrainer(model, time_steps=T, num_steps=DREAM['num_steps'], batch_size=b,
                                 objective=DREAM['objective'], prompt_fn=lambda generator: prompt,
                                 generate_kwargs=cond, seed=seed)
    labels = rl_param_labels(model)
    moving = {n for n, l in labels.items() if l != 'frozen'}
    if {n.partition('.')[0] for n in moving} != {'policy_head', 'value_head', 'action_embedder'}:
        raise SystemExit(f'wmopt_dream_trainer: unexpected RL groups {sorted(moving)[:8]}')
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    (exp, out), sec, got, variants, peak = part('wmopt_dream_trainer', dream_trainer.step)
    check_experience(exp, b, T, P, model.dim, model.latent_shape, prompt=prompt)
    check_rl_outputs('wmopt_dream_trainer', out)
    check_moved('wmopt_dream_trainer', model, before, moving, moved=True)
    check_moved('wmopt_dream_trainer', model, before, set(labels) - moving, moved=False)
    del before
    # one step, timed: its dream follows the generate above on the same
    # path, so it is warm
    log(f'wmopt_dream_trainer b{b} T{T} P{P} (heads-only ppo): {sec * 1e3:.1f} ms, '
        f'{b * (T - P) / sec:.1f} dreamed env-steps/s; '
        f'(K1..K5) {got}, K1 by variant {variants}; only the policy head, the value head and '
        f'the unembedding moved; peak memory {peak:.2f} GiB')

    # d. a full-model update over the dream's first rows
    rows = index_experience(exp, slice(0, WMOPT_RL_ROWS))
    opt = make_rl_optimizer(model, **RL_LR)
    full_update = make_rl_update_step(model, opt, DREAM['objective'],
                                      only_learn_policy_value_heads=False)
    state = create_rl_state(model, opt)
    trunk_before = {n: p.detach().clone() for n, p in model.named_parameters()
                    if n.startswith('transformer.')}
    (state, out), sec, got, variants, peak = part('wmopt_rl_full',
                                                  lambda: full_update(state, rows))
    check_rl_outputs('wmopt_rl_full', out)
    check_moved('wmopt_rl_full', model, trunk_before, set(trunk_before), moved=True)
    del trunk_before

    def one_update():
        nonlocal state
        state = full_update(state, rows)[0]
    sec_warm = host_time_s(one_update, reps=2)
    log(f'wmopt_rl_full b{WMOPT_RL_ROWS} T{T} (full model): {sec * 1e3:.1f} ms first, '
        f'{sec_warm * 1e3:.1f} ms/update warm (mean of 2); (K1..K5) {got}, K1 by variant '
        f'{variants}; the trunk moved; peak memory {peak:.2f} GiB')
    del dream_trainer, exp, rows, opt, state, full_update, model
    gc.collect()
    torch.cuda.empty_cache()

    # b. the bench model with self-flow: one plain step
    torch.manual_seed(seed)
    model = DynamicsWorldModel(**BENCH_MODEL, dtype=torch.bfloat16)
    batch = train_batch(model.device, seed + 2)
    trainer = BehaviorCloneTrainer(model, learning_rate=3e-4, clip_grad_norm=1.0,
                                   with_ema=False, seed=seed, use_self_flow=True)
    if trainer.ts.ema_params is None:
        raise SystemExit('wmopt_self_flow: the trainer keeps no EMA teacher')
    head = {n: p.detach().clone() for n, p in trainer.self_flow_head.named_parameters()}

    def sf_step():
        trainer.ts, loss, losses = trainer._train_step(trainer.ts, batch, shortcut_train=False,
                                                       generator=trainer.generator)
        return loss
    loss, sec, got, variants, peak = part('wmopt_self_flow', sf_step)
    still = [n for n, p in trainer.self_flow_head.named_parameters() if torch.equal(p, head[n])]
    if still or not torch.isfinite(loss):
        raise SystemExit(f'wmopt_self_flow: loss {loss.item()}, head weights that did not '
                         f'move: {still}')
    sec_warm = host_time_s(lambda: sf_step(), reps=1)
    log(f'wmopt_self_flow b{TRAIN["batch_size"]} T{TRAIN["time_steps"]} (bench model, student '
        f'layer -3, teacher -1): loss {loss.item():.4f}; the head moved; {sec * 1e3:.1f} ms '
        f'first, {sec_warm * 1e3:.1f} ms warm; (K1..K5) {got}, K1 by variant {variants}; peak '
        f'memory {peak:.2f} GiB')
    del trainer, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f'# wm-options phase: {time.perf_counter() - t_phase:.1f} s')
    return launches


# ------------------------------------------------------------- tok-options

def run_tok_options_phase(seed: int = 0) -> dict:
    """The pixel CartPole recipe's tokenizer options and the remaining loss
    terms: a. two train steps of the bench tokenizer with every option on
    (`TOK_OPTIONS`, LPIPS through `TokenizerTrainer(use_lpips=True)`), the
    loss and time-layer gradients through K4/K5 held against float32;
    b. its streaming encode through the four cache parts against one
    uncached encode; c. the pixel recipe's own tokenizer (2 steps) and an
    `EnvInteractor` rollout through it; d. a b1 x T1024 step of the bench
    world model with the loss normalization. Returns the (K1..K5)
    launches by path."""
    from dreamer4_torch import (BehaviorCloneTrainer, DynamicsWorldModel, EnvInteractor,
                                TokenizerTrainer, VideoTokenizer)
    from dreamer4_torch.envs.mocks import MockEnv
    from dreamer4_torch.models.tokenizer import latent_consistency_loss
    from dreamer4_torch.nn.lpips import lpips_loss
    from dreamer4_torch.train.trainers import (make_tokenizer_train_step,
                                               make_world_model_train_step)

    t_phase = time.perf_counter()
    launches = {}

    def part(label, fn, want):
        torch.cuda.reset_peak_memory_stats()
        out, sec, got, variants = counted(fn)
        expect_launches(label, got, want)
        expect_sm90(label, got, variants)
        launches[label] = got
        return out, sec, got, torch.cuda.max_memory_allocated() / 2**30

    # a. the bench tokenizer with every option, float32 master weights and
    # bf16 trunks
    torch.manual_seed(seed)
    tok = VideoTokenizer(**TOK_OPTIONS, dtype=torch.bfloat16)
    if tok.device.type != 'cuda':
        raise SystemExit(f'tokenizer built on {tok.device}, not on the card')
    dev = tok.device
    b, t = TOK_VIDEO['batch_size'], TOK_VIDEO['time_steps']
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    video = torch.rand((b, 3, t, 64, 64), generator=gen, device=dev)
    trainer = TokenizerTrainer(tok, learning_rate=3e-4, clip_grad_norm=1.0, with_ema=True,
                               seed=seed, use_lpips=True)
    if {id(p) for p in trainer.lpips.parameters()} & {id(p) for p in tok.parameters()}:
        raise SystemExit('tok-options: the LPIPS trunk is among the tokenizer\'s parameters')
    log(f'# tok-options ({gpu_name_and_power_limit()}): the bench tokenizer with conv3d, SPT, '
        f'LPIPS (random VGG16), decorrelation, ortho, sigreg, consistency and loss '
        f'normalization: {sum(p.numel() for p in tok.parameters()) / 1e6:.2f}M params, b{b} x '
        f'T{t} video')

    lpips_fn = lambda recon, clean, g, lens: lpips_loss(trainer.lpips, recon, clean,
                                                        generator=g, time_lens=lens)

    terms = []   # each call's loss terms; the first call's are the kernels'

    def loss_fn(model):
        g = torch.Generator(device=dev).manual_seed(seed + 3)
        loss, interm = model(video, update_loss_ema=False, return_intermediates=True,
                             lpips_fn=lpips_fn, generator=g)
        consistency = latent_consistency_loss(model, interm.recon, interm.latents)
        terms.append(dict(interm.losses._asdict(), consistency=consistency.detach()))
        return loss + model.latent_consistency_loss_weight * consistency

    ref = VideoTokenizer(**{**TOK_OPTIONS, 'use_fused_small': False})
    ref.load_state_dict(tok.state_dict())
    names = [f'{layer}.{w}.weight' for layer in TOK_TIME_LAYERS for w in ('to_q', 'to_k', 'to_v')]
    check_grad_distances('tok-options grads', compare_grads(tok, ref, loss_fn, names,
                                                            'Attention', 'use_fused_small'))
    del ref
    parts = {k: terms[0][k].float() for k in ('recon', 'lpips', 'time_decorr', 'space_decorr',
                                                'latent_ortho', 'latent_sigreg', 'consistency')}
    check_finite('tok-options terms', parts)
    if any(v.item() == 0.0 for v in parts.values()):
        raise SystemExit(f'tok-options: a loss term is zero: {parts}')

    step_fn = make_tokenizer_train_step(tok, trainer.optimizer, ema_decay=0.999,
                                        lpips_fn=lpips_fn)
    before = {n: p.detach().clone() for n, p in tok.named_parameters()}
    ema_before = {n: e.clone() for n, e in trainer.ts.ema_params.items()}
    norms_before = {n: b.clone() for n, b in tok.named_buffers()}
    ts_before = trainer.ts

    def one_step():
        trainer.ts, loss, losses = step_fn(trainer.ts, video, generator=trainer.generator)
        return loss, losses
    (loss, losses), sec, got, peak = part('tok_options_step', one_step, TOK_OPTIONS_LAUNCHES)
    n_grad = check_step(tok, ts_before, trainer.ts, loss, losses, before, ema_before,
                        'tok_options_step')
    still = [n for n, v in tok.named_buffers() if torch.equal(v, norms_before[n])]
    if still:
        raise SystemExit(f'tok_options_step: normalizers that did not move: {still}')
    del before, ema_before
    (loss2, _), sec2, got2, _ = part('tok_options_train_on_batch',
                                     lambda: trainer.train_on_batch(video), TOK_OPTIONS_LAUNCHES)
    if not torch.isfinite(loss2) or trainer.ts.step != 2:
        raise SystemExit('tok_options_train_on_batch: loss not finite or step not counted')
    sec_warm = host_time_s(one_step, reps=3)
    plain_tok = VideoTokenizer(**BENCH_TOKENIZER, dtype=torch.bfloat16)
    plain_trainer = TokenizerTrainer(plain_tok, learning_rate=3e-4, seed=seed)
    plain_trainer.train_on_batch(video)
    sec_plain = host_time_s(lambda: plain_trainer.train_on_batch(video), reps=3)
    del plain_tok, plain_trainer
    log(f'tok_options_step b{b} T{t}: loss {loss.item():.5f}, then {loss2.item():.5f}; terms '
        + ', '.join(f'{k} {v.item():.4g}' for k, v in parts.items())
        + f'; {n_grad} parameters with a gradient, all moved with their EMA; every normalizer '
        f'moved; (K1..K5) {got} and {got2} (predicted {TOK_OPTIONS_LAUNCHES}); '
        f'{sec * 1e3:.1f} ms first, {sec_warm * 1e3:.1f} ms/step warm (mean of 3) against '
        f'{sec_plain * 1e3:.1f} ms for the bench tokenizer without the options (phase 6\'s '
        f'configuration, mean of 3, this run); peak memory {peak:.2f} GiB')

    # b. streaming encode over 16 frames through the four cache parts
    def stream():
        cache, frames = None, []
        for i in range(t):
            kw = dict(max_time=t) if cache is None else dict(cache=cache)
            latents, cache = tok.encode(video[:, :, i:i + 1], return_cache=True, **kw)
            frames.append(latents)
        return torch.cat(frames, dim=1), cache
    with torch.no_grad():
        (streamed, cache), sec_s, got_s, _ = part(
            'tok_options_stream', stream, TOK_OPTIONS_STREAM_LAUNCHES['tok_options_stream'])
        uncached, _, got_u, _ = part('tok_options_uncached', lambda: tok.encode(video),
                                     TOK_OPTIONS_STREAM_LAUNCHES['tok_options_uncached'])
        ref = VideoTokenizer(**{**TOK_OPTIONS, 'use_fused_small': False})
        ref.load_state_dict(tok.state_dict())
        f32 = ref.encode(video)
        del ref
    if None in (cache.spt, cache.pre_conv, cache.post_conv) or cache.transformer.token_count != t:
        raise SystemExit('tok_options_stream: a cache part is missing')
    err = (streamed - uncached).abs().max().item()
    err_f32 = (uncached - f32).abs().max().item()
    tol = PIXEL_TOL_FACTOR * err_f32
    ok = err <= tol
    log(f'tok_options_stream b{b} {t} frames: {sec_s * 1e3 / t:.2f} ms/frame; (K1..K5) '
        f'{got_s}, uncached {got_u}; streamed vs uncached max |diff| {err:.3e} (tol {tol:.3e}: '
        f'{PIXEL_TOL_FACTOR} x the uncached bf16 encode\'s distance from float32, '
        f'{err_f32:.3e})' + ('' if ok else '  FAIL'))
    if not ok:
        raise SystemExit('tok_options_stream: the streamed latents disagree with the uncached '
                         'encode')
    del tok, trainer, step_fn, video, streamed, uncached, f32, cache
    gc.collect()
    torch.cuda.empty_cache()

    # c. the pixel recipe's tokenizer and world model, float32
    torch.manual_seed(seed)
    rtok = VideoTokenizer(**PIXEL_RECIPE_TOKENIZER)
    rmodel = DynamicsWorldModel(**PIXEL_RECIPE_MODEL)
    if rmodel.latent_shape != rtok.latent_shape:
        raise SystemExit(f'latent shapes differ: {rmodel.latent_shape} vs {rtok.latent_shape}')
    rb, rt = PIXEL_RECIPE_TOK_VIDEO['batch_size'], PIXEL_RECIPE_TOK_VIDEO['time_steps']
    rvideo = torch.rand((rb, 3, rt, 64, 64), generator=gen, device=dev)
    rtrainer = TokenizerTrainer(rtok, learning_rate=3e-4, with_ema=True, seed=seed)
    for i in range(2):
        (rloss, rlosses), sec, got, peak = part(f'pixel_recipe_tok_step_{i}',
                                                lambda: rtrainer.train_on_batch(rvideo),
                                                (0, 0, 0, 0, 0))
        check_finite(f'pixel_recipe_tok_step_{i}', {'loss': rloss, **rlosses._asdict()})
        log(f'pixel_recipe_tok_step_{i} b{rb} T{rt}: loss {rloss.item():.5f}; {sec * 1e3:.1f} '
            f'ms; (K1..K5) {got}; peak memory {peak:.2f} GiB')
    interactor = EnvInteractor(rmodel, tokenizer=rtok)
    rgen = torch.Generator(device=dev).manual_seed(seed)
    run = lambda: interactor(MockEnv(**PIXEL_RECIPE_ENV, seed=seed), rgen,
                             max_timesteps=PIXEL_STEPS, num_steps=4)
    run()   # warm
    exp, sec, got, peak = part('pixel_recipe_rollout', run, (0, 0, 0, 0, 0))
    with torch.no_grad():
        uncached = rtok.encode(exp.video)
    streamed = exp.latents[:, :exp.video.shape[2]]
    err = (streamed - uncached).abs().max().item()
    ok = err <= PIXEL_RECIPE_STREAM_TOL and bool(torch.isfinite(exp.values).all())
    log(f'pixel_recipe_rollout b{PIXEL_RECIPE_ENV["batch"]} {exp.time_steps} frames '
        f'({exp.video.shape[2]} observed, 64 x 64 RGB): {sec * 1e3:.1f} ms, '
        f'{sec * 1e3 / exp.time_steps:.2f} ms/frame (second run); (K1..K5) {got}; streamed vs '
        f'uncached latents max |diff| {err:.3e} (tol {PIXEL_RECIPE_STREAM_TOL}); peak memory '
        f'{peak:.2f} GiB' + ('' if ok else '  FAIL'))
    if not ok:
        raise SystemExit('pixel_recipe_rollout: the streamed latents disagree with the '
                         'uncached encode')
    del rtok, rmodel, rtrainer, interactor, exp
    gc.collect()
    torch.cuda.empty_cache()

    # d. the bench world model with the loss normalization, one plain step
    torch.manual_seed(seed)
    model = DynamicsWorldModel(**BENCH_MODEL, use_loss_normalization=True, dtype=torch.bfloat16)
    batch = train_batch(model.device, seed + 2)
    wtrainer = BehaviorCloneTrainer(model, learning_rate=3e-4, clip_grad_norm=1.0,
                                    with_ema=True, seed=seed)
    wstep = make_world_model_train_step(model, wtrainer.optimizer, ema_decay=0.999)
    norms_before = {n: b.clone() for n, b in model.named_buffers()}

    def wm_step():
        wtrainer.ts, loss, losses = wstep(wtrainer.ts, batch, shortcut_train=False,
                                          generator=wtrainer.generator)
        return loss, losses
    (loss, losses), sec, got, peak = part('wm_loss_norm_step', wm_step, LAUNCHES_PER_STEP[False])
    check_finite('wm_loss_norm_step', {'loss': loss, **losses._asdict()})
    moved = sorted(n.partition('_loss_normalizer')[0] for n, v in model.named_buffers()
                   if not torch.equal(v, norms_before[n]))
    if moved != sorted(WM_NORMALIZED):
        raise SystemExit(f'wm_loss_norm_step: normalizers that moved {moved}, expected '
                         f'{sorted(WM_NORMALIZED)}')
    log(f'wm_loss_norm_step b{TRAIN["batch_size"]} T{TRAIN["time_steps"]}: loss '
        f'{loss.item():.5f} (flow {losses.flow.item():.5f}, normalized); normalizers moved: '
        f'{moved}; {sec * 1e3:.1f} ms (first); (K1..K5) {got}, every K1 on the wgmma kernel; '
        f'peak memory {peak:.2f} GiB')
    del model, wtrainer, wstep, batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f'# tok-options phase: {time.perf_counter() - t_phase:.1f} s')
    return launches


# ---------------------------------------------------------------- tok-full

def run_tok_full_phase(seed: int = 0) -> dict:
    """The tokenizer's remaining options, PoPE and MOSS, and SUGAR's
    backward: a. the bench tokenizer with every option (`TOK_FULL`) under
    `TokenizerTrainer` with its EMA: a step of the main decoder and one of
    the flow decoder through the step function, then two `train_on_batch`;
    the loss and the time-layer gradients through K4/K5 (the encoder's and
    the decoder's that trains) held against float32 for each decoder as in
    phase 6, the new loss terms finite and nonzero, the idle decoder's
    gradient zero, PoPE and slot attention moving; b. encode with two aug
    ids, a 4-step decode (step 0 on the main decoder, 1-3 on the flow
    decoder), the streaming encode over 16 frames through the four-part
    cache with the MOSS cache against one uncached encode, and
    `latent_disagreement`; c. two steps of the bench tokenizer with Beta
    flow times, the mean of the port's Beta draws, SUGAR's gradient against
    its closed form; d. the bench world model with time PoPE: a plain
    b1 x T1024 step (loss and time-layer gradients, PoPE's included,
    through K1-K3 against float32) timed beside the bench model's, and the
    prompted b16 x T192 dream, its prompt pass held against float32 as in
    phase 3. Returns the (K1..K5) launches by path."""
    from dreamer4_torch import (BehaviorCloneTrainer, DynamicsWorldModel, TokenizerTrainer,
                                VideoTokenizer, generate)
    from dreamer4_torch.models import tokenizer as tokenizer_module
    from dreamer4_torch.nn.activations import get_activation
    from dreamer4_torch.train.trainers import (make_tokenizer_train_step,
                                               make_world_model_train_step)

    t_phase = time.perf_counter()
    launches = {}

    def part(label, fn):
        torch.cuda.reset_peak_memory_stats()
        out, sec, got, variants = counted(fn)
        expect_launches(label, got, TOK_FULL_LAUNCHES[label])
        expect_sm90(label, got, variants)
        launches[label] = got
        return out, sec, got, torch.cuda.max_memory_allocated() / 2**30

    # a. the all-options tokenizer, float32 master weights and bf16 trunks
    torch.manual_seed(seed)
    tok = VideoTokenizer(**TOK_FULL, dtype=torch.bfloat16)
    if tok.device.type != 'cuda':
        raise SystemExit(f'tokenizer built on {tok.device}, not on the card')
    dev = tok.device
    b, t = TOK_VIDEO['batch_size'], TOK_VIDEO['time_steps']
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    video = torch.rand((b, 3, t, 64, 64), generator=gen, device=dev)
    trainer = TokenizerTrainer(tok, learning_rate=3e-4, clip_grad_norm=1.0, with_ema=True,
                               seed=seed)
    log(f'# tok-full ({gpu_name_and_power_limit()}): the bench tokenizer with the latent init '
        f'patch, slot attention (encoder and decoder), the separate flow decoder, aug token, '
        f'BYOL with SEM, latent AR, time and space PoPE and MOSS: '
        f'{sum(p.numel() for p in tok.parameters()) / 1e6:.2f}M params, {TOK_FULL_TOKENS} '
        f'tokens/frame, b{b} x T{t} video')
    with torch.no_grad():
        targets = tok.encode(video)   # a BYOL target for the gradient check

    ref = VideoTokenizer(**{**TOK_FULL, 'use_fused_small': False})
    ref.load_state_dict(tok.state_dict())
    for flow in (False, True):
        def loss_fn(model):
            g = torch.Generator(device=dev).manual_seed(seed + 3)
            return model(video, update_loss_ema=False, byol_target_latents=targets,
                         train_flow_decoder=flow, generator=g)
        dec = 'flow_decoder' if flow else 'decoder'
        names = [f'{layer}.{w}.weight' for layer in ('encoder_transformer.attn_3',
                                                     f'{dec}.transformer.attn_3')
                 for w in ('to_q', 'to_k', 'to_v')]
        check_grad_distances(f'tok-full grads ({dec})', compare_grads(
            tok, ref, loss_fn, names, 'Attention', 'use_fused_small'))
    del ref, targets
    gc.collect()
    torch.cuda.empty_cache()

    step_fn = make_tokenizer_train_step(tok, trainer.optimizer, ema_decay=0.999)
    watched = [n for n, _ in tok.named_parameters()
               if n.startswith('slot_attention.') or '_pope.' in n]
    start = {n: p.detach().clone() for n, p in tok.named_parameters() if n in watched}
    idle_of = {False: 'flow_decoder.', True: 'decoder.'}
    timings = {}
    for flow in (False, True):
        label = 'tokfull_step_flow' if flow else 'tokfull_step_main'
        before = {n: p.detach().clone() for n, p in tok.named_parameters()}
        ema_before = {n: e.clone() for n, e in trainer.ts.ema_params.items()}
        ts_before = trainer.ts

        def one_step():
            trainer.ts, loss, losses = step_fn(trainer.ts, video, generator=trainer.generator,
                                               train_flow_decoder=flow)
            return loss, losses
        (loss, losses), sec, got, peak = part(label, one_step)
        n_grad = check_step(tok, ts_before, trainer.ts, loss, losses, before, ema_before, label)
        recon = losses.flow_recon if flow else losses.recon
        terms = {f: getattr(losses, f) for f in TOK_FULL_NEW_LOSSES}
        check_finite(label, terms)
        if not all(float(v) != 0.0 for v in (*terms.values(), recon)):
            raise SystemExit(f'{label}: a loss term is zero: {losses}')
        idle = [n for n, p in tok.named_parameters() if n.startswith(idle_of[flow])
                and p.grad is not None and bool(p.grad.any())]
        if idle:
            raise SystemExit(f'{label}: the idle decoder has a gradient: {idle[:4]}')
        del before, ema_before
        sec_warm = host_time_s(one_step, reps=2)
        timings[label] = (sec, sec_warm)
        log(f'{label} b{b} T{t}: loss {loss.item():.5f} ({"flow_recon" if flow else "recon"} '
            f'{recon.item():.5f}, ' + ', '.join(f'{k} {v.item():.4g}' for k, v in terms.items())
            + f'); {n_grad} parameters with a gradient, all moved with their EMA, none of '
            f'{idle_of[flow][:-1]}; {sec * 1e3:.1f} ms first, {sec_warm * 1e3:.1f} ms/step warm '
            f'(mean of 2); (K1..K5) {got}; peak memory {peak:.2f} GiB')
    rng_state = trainer.rng.bit_generator.state
    flows = [bool(trainer.rng.random() < tok.flow_decoder_train_prob) for _ in range(2)]
    trainer.rng.bit_generator.state = rng_state
    for i in range(2):
        (loss, losses), sec, got, peak = part(f'tokfull_train_on_batch_{i}',
                                              lambda: trainer.train_on_batch(video))
        trained = 'flow_recon' if flows[i] else 'recon'
        if not torch.isfinite(loss) or not float(getattr(losses, trained)) > 0:
            raise SystemExit(f'tokfull_train_on_batch_{i}: loss {loss.item()}, {trained} '
                             f'{getattr(losses, trained).item()}')
        log(f'tokfull_train_on_batch_{i}: loss {loss.item():.5f} (the host draw chose the '
            f'{"flow" if flows[i] else "main"} decoder); {sec * 1e3:.1f} ms; (K1..K5) {got}; '
            f'peak memory {peak:.2f} GiB')
    still = [n for n, p in tok.named_parameters() if n in watched and torch.equal(p, start[n])]
    if still or not any('time_pope' in n for n in watched) or not any('space_pope' in n
                                                                       for n in watched):
        raise SystemExit(f'tok-full: PoPE or slot-attention parameters that did not move: '
                         f'{still}')
    plain_tok = VideoTokenizer(**BENCH_TOKENIZER, dtype=torch.bfloat16)
    plain_trainer = TokenizerTrainer(plain_tok, learning_rate=3e-4, seed=seed)
    plain_trainer.train_on_batch(video)
    sec_plain = host_time_s(lambda: plain_trainer.train_on_batch(video), reps=3)
    del plain_tok, plain_trainer
    log('tok-full step time: ' + ', '.join(
        f'{k} {v[1] * 1e3:.1f} ms warm ({v[1] / sec_plain:.2f} x)' for k, v in timings.items())
        + f' against {sec_plain * 1e3:.1f} ms for the bench tokenizer without the options '
        f'(phase 6\'s configuration, mean of 3, this run); {len(watched)} PoPE and slot '
        f'attention parameters, all moved')
    del step_fn, start
    tok.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()

    # b. inference on the same model
    with torch.no_grad():
        latents, sec, got, peak = part('tokfull_encode', lambda: tok.encode(video, aug_id=0))
        aug2 = tok.encode(video, aug_id=2)
        aug_diff = (latents - aug2).abs().max().item()
        if not aug_diff > 0:
            raise SystemExit('tokfull_encode: aug ids 0 and 2 give the same latents')
        calls = {'decoder': 0, 'flow_decoder': 0}
        hooks = [getattr(tok, name).register_forward_hook(
            lambda *a, name=name: calls.__setitem__(name, calls[name] + 1)) for name in calls]
        recon, sec_d, got_d, peak_d = part('tokfull_decode',
                                           lambda: tok.decode(latents, generator=gen))
        for hook in hooks:
            hook.remove()
        if calls != {'decoder': 1, 'flow_decoder': TOK_FULL['decoder_flow_steps'] - 1}:
            raise SystemExit(f'tokfull_decode: decoder calls {calls}')
        if tuple(recon.shape) != tuple(video.shape) or not bool(torch.isfinite(recon).all()):
            raise SystemExit('tokfull_decode: wrong shape or not finite')

        def stream():
            cache, frames = None, []
            for i in range(t):
                kw = dict(max_time=t) if cache is None else dict(cache=cache)
                frame, cache = tok.encode(video[:, :, i:i + 1], return_cache=True, **kw)
                frames.append(frame)
            return torch.cat(frames, dim=1), cache
        (streamed, cache), sec_s, got_s, _ = part('tokfull_stream', stream)
        uncached = tok.encode(video)
        ref = VideoTokenizer(**{**TOK_FULL, 'use_fused_small': False})
        ref.load_state_dict(tok.state_dict())
        f32 = ref.encode(video)
        del ref
        dis, sec_l, got_l, _ = part('tokfull_disagreement',
                                    lambda: tok.latent_disagreement(latents, generator=gen))
    sm = cache.transformer.spatial_modules
    if (cache.transformer.token_count != t or sm is None or len(sm) != 1
            or tuple(sm[0].shape) != (b, 2, 8, 8, TOK_FULL['dim'])):
        raise SystemExit('tokfull_stream: the trunk cache lacks its MOSS cache')
    err = (streamed - uncached).abs().max().item()
    err_f32 = (uncached - f32).abs().max().item()
    tol = PIXEL_TOL_FACTOR * err_f32
    ok = err <= tol
    if tuple(dis.shape) != (b, t) or not bool(torch.isfinite(dis).all()):
        raise SystemExit(f'tokfull_disagreement: shape {tuple(dis.shape)} or not finite')
    log(f'tokfull inference b{b} T{t}: encode {sec * 1e3:.1f} ms (aug 0 vs 2 max |diff| '
        f'{aug_diff:.3e}); decode (1 main + {calls["flow_decoder"]} flow-decoder steps) '
        f'{sec_d * 1e3:.1f} ms, peak memory {peak_d:.2f} GiB; streamed {t} frames '
        f'{sec_s * 1e3 / t:.2f} ms/frame, vs uncached max |diff| {err:.3e} (tol {tol:.3e}: '
        f'{PIXEL_TOL_FACTOR} x the uncached bf16 encode\'s distance from float32, '
        f'{err_f32:.3e}); latent_disagreement {sec_l * 1e3:.1f} ms, mean '
        f'{dis.mean().item():.4f}; (K1..K5) encode {got}, decode {got_d}, stream {got_s}, '
        f'disagreement {got_l}' + ('' if ok else '  FAIL'))
    if not ok:
        raise SystemExit('tokfull_stream: the streamed latents disagree with the uncached encode')
    del tok, trainer, video, streamed, uncached, f32, cache, latents, aug2, recon, dis
    gc.collect()
    torch.cuda.empty_cache()

    # c. Beta flow times on the bench tokenizer, the draws, SUGAR
    torch.manual_seed(seed)
    btok = VideoTokenizer(**BENCH_TOKENIZER, decoder_flow_times_beta=TOK_BETA,
                          dtype=torch.bfloat16)
    bvideo = torch.rand((b, 3, t, 64, 64), generator=gen, device=dev)
    btrainer = TokenizerTrainer(btok, learning_rate=3e-4, with_ema=True, seed=seed)
    for i in range(2):
        (loss, losses), sec, got, peak = part(f'tokbeta_train_on_batch_{i}',
                                              lambda: btrainer.train_on_batch(bvideo))
        check_finite(f'tokbeta_train_on_batch_{i}', {'loss': loss, **losses._asdict()})
        log(f'tokbeta_train_on_batch_{i} b{b} T{t} (Beta{TOK_BETA} flow times): loss '
            f'{loss.item():.5f}; {sec * 1e3:.1f} ms; (K1..K5) {got}; peak memory {peak:.2f} GiB')
    del btok, btrainer, bvideo
    u = tokenizer_module.draw('flow_times', (TOK_BETA_DRAWS,), generator=gen, device=dev,
                              concentration=TOK_BETA)
    want_mean = TOK_BETA[0] / (TOK_BETA[0] + TOK_BETA[1])
    mean = u.mean().item()
    x = torch.randn(SUGAR_SHAPE, generator=gen, device=dev)
    xg = x.clone().requires_grad_()
    y = get_activation('sugar_bsilu')(xg)
    y.sum().backward()
    x64 = x.double()
    s64 = torch.sigmoid(x64)
    sugar_err = (xg.grad.double() - (s64 + (x64 + 1.67) * s64 * (1 - s64))).abs().max().item()
    relu_ok = torch.equal(y.detach(), torch.relu(x))
    ok = abs(mean - want_mean) <= TOK_BETA_MEAN_TOL and sugar_err <= SUGAR_TOL and relu_ok
    log(f'Beta{TOK_BETA} flow-time draws: mean of {TOK_BETA_DRAWS} {mean:.5f} (want '
        f'{want_mean:.5f} +- {TOK_BETA_MEAN_TOL}); sugar_bsilu on {SUGAR_SHAPE} float32: forward '
        f'{"equals" if relu_ok else "differs from"} ReLU, gradient vs its float64 closed form '
        f'max |diff| {sugar_err:.3e} (tol {SUGAR_TOL})' + ('' if ok else '  FAIL'))
    if not ok:
        raise SystemExit('tok-full: the Beta draws or the SUGAR gradient are off')
    del u, x, xg, y

    # d. the bench world model with time PoPE
    torch.manual_seed(seed)
    pope_cfg = dict(BENCH_MODEL, time_attention_use_pope=True)
    model = DynamicsWorldModel(**pope_cfg, dtype=torch.bfloat16)
    batch = train_batch(model.device, seed + 2)
    ref = DynamicsWorldModel(**{**pope_cfg, 'use_flash_attention': False})
    ref.load_state_dict(model.state_dict())
    names = [f'transformer.attn_{i}.{w}.weight' for i in TIME_LAYERS
             for w in ('to_q', 'to_k', 'to_v')] + ['transformer.time_pope.inv_freq']
    check_grad_distances('pope wm grads', compare_grads(
        model, ref, wm_plain_step_loss(batch, seed + 3), names, 'AxialSpaceTimeTransformer',
        'use_flash_attention'))
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    wtrainer = BehaviorCloneTrainer(model, learning_rate=3e-4, clip_grad_norm=1.0,
                                    with_ema=True, seed=seed)
    wstep = make_world_model_train_step(model, wtrainer.optimizer, ema_decay=0.999)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ema_before = {n: e.clone() for n, e in wtrainer.ts.ema_params.items()}
    ts_before = wtrainer.ts

    def wm_step():
        wtrainer.ts, loss, losses = wstep(wtrainer.ts, batch, shortcut_train=False,
                                          generator=wtrainer.generator)
        return loss, losses
    (loss, losses), sec, got, peak = part('pope_wm_train_plain', wm_step)
    n_grad = check_step(model, ts_before, wtrainer.ts, loss, losses, before, ema_before,
                        'pope_wm_train_plain')
    if torch.equal(model.transformer.time_pope.inv_freq, before['transformer.time_pope.inv_freq']):
        raise SystemExit('pope_wm_train_plain: time_pope did not move')
    del before, ema_before
    sec_warm = host_time_s(wm_step, reps=3)
    wtrainer.optimizer.zero_grad(set_to_none=True)
    plain = DynamicsWorldModel(**BENCH_MODEL, dtype=torch.bfloat16)
    ptrainer = BehaviorCloneTrainer(plain, learning_rate=3e-4, clip_grad_norm=1.0,
                                    with_ema=True, seed=seed)
    pstep = make_world_model_train_step(plain, ptrainer.optimizer, ema_decay=0.999)

    def plain_step():
        ptrainer.ts = pstep(ptrainer.ts, batch, shortcut_train=False,
                            generator=ptrainer.generator)[0]
    plain_step()
    sec_plain = host_time_s(plain_step, reps=3)
    del plain, ptrainer, pstep
    gc.collect()
    torch.cuda.empty_cache()
    log(f'pope_wm_train_plain b{TRAIN["batch_size"]} T{TRAIN["time_steps"]}: loss '
        f'{loss.item():.5f}; {n_grad} parameters with a gradient, all moved with their EMA, '
        f'time_pope among them; {sec * 1e3:.1f} ms first, {sec_warm * 1e3:.1f} ms/step warm '
        f'(mean of 3) against {sec_plain * 1e3:.1f} ms for the bench model without PoPE '
        f'({sec_warm / sec_plain:.2f} x, this run); (K1..K5) {got}, every K1 on the wgmma '
        f'kernel; peak memory {peak:.2f} GiB')

    prompt = bench_prompt(model, seed)
    wgen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        exp, sec, got, peak = part('pope_wm_generate', lambda: generate(
            model, wgen, **PROMPTED, **prompt))
    check_experience(exp, PROMPTED['batch_size'], PROMPTED['time_steps'], PROMPT_LEN, model.dim,
                     model.latent_shape, prompt=prompt)
    errors, ms_k, ms_p = compare_prefill(model, prompt, PROMPTED['time_steps'], config=pope_cfg)
    ok = True
    for name, (e_kernel, e_plain, e_between) in errors.items():
        good = e_kernel <= PREFILL_TOL_FACTOR * e_plain
        ok = ok and good
        log(f'pope prompt pass {name:<5}: max |bf16 K1 - f32| {e_kernel:.3e} (tol '
            f'{PREFILL_TOL_FACTOR} x {e_plain:.3e}, max |bf16 plain - f32|); max |K1 - plain| '
            f'{e_between:.3e}' + ('' if good else '  FAIL'))
    b_w, T_w = PROMPTED['batch_size'], PROMPTED['time_steps']
    log(f'pope_wm_generate b{b_w} T{T_w} P{PROMPT_LEN}: {sec * 1e3:.1f} ms (first), '
        f'{b_w * (T_w - PROMPT_LEN) / sec:.1f} dreamed env-steps/s; prompt pass {ms_k:.2f} ms '
        f'with K1, {ms_p:.2f} ms plain; (K1..K5) {got}; peak memory {peak:.2f} GiB')
    if not ok:
        raise SystemExit('pope prompt pass: K1 is further from float32 than the plain attention')
    del model, wtrainer, wstep, batch, exp
    gc.collect()
    torch.cuda.empty_cache()
    log(f'# tok-full phase: {time.perf_counter() - t_phase:.1f} s')
    return launches


# ------------------------------------------------------------ wm-subsystems

def multiview_batch(device, seed, views):
    """The train phase's b1 x T1024 batch, its latents with `views` views."""
    batch = train_batch(device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 7)
    b, t = TRAIN['batch_size'], TRAIN['time_steps']
    batch['latents'] = torch.randn((b, t, views, 16, 32), generator=g, device=device) * 0.5
    batch['latent_has_view_dim'] = True
    return batch


def check_nonzero_grads(label, model, prefixes):
    """Fails unless the parameters under each prefix have a nonzero gradient."""
    flat = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
    zero = [x for x in prefixes if not any(bool(p.grad.any()) for n, p in flat
                                           if n.startswith(x))]
    if zero:
        raise SystemExit(f'{label}: no gradient reaches {zero}')


def gru_share_ms(model, rows: int, t: int) -> float:
    """The GRU time layers of `model`'s main trunk alone, forward and
    backward at the train step's shape ((rows, t, dim) in its compute
    dtype), in ms: the recurrence's part of the step."""
    layers = [m for n, m in model.transformer.named_children() if n.startswith('rnn_')]
    g = torch.Generator(device=model.device).manual_seed(0)
    x = torch.randn((rows, t, model.dim), generator=g, device=model.device).to(model.dtype)
    x.requires_grad_(True)

    def run():
        for layer in layers:
            out, _ = layer(x)
            out.float().sum().backward()
    run()
    ms = host_time_s(run, reps=2) * 1e3
    model.zero_grad(set_to_none=True)
    return ms


def compare_cached(model, prompt, config):
    """The subsystem model's cached frames against its parallel pass: a
    prefill of the prompt's first frames, then WMSUB_CACHED_FRAMES frames
    one at a time on the cache, in bf16, and one parallel pass over all of
    them in bf16 and in float32 (a model of `config`, plain attention, the
    weights upcast). Returns, per output, (|cached - f32|, |parallel bf16 -
    f32|)."""
    from dreamer4_torch import DynamicsWorldModel

    rows, n = WMSUB_CACHED_ROWS, WMSUB_CACHED_FRAMES
    P = PROMPT_LEN - n
    lat = prompt['prompt_latents'][:rows]
    acts = prompt['prompt_discrete_actions'][:rows]
    K = model.max_steps
    kw = dict(signal_levels=K - 1, step_sizes=K // PROMPTED['num_steps'], latent_is_noised=True,
              latent_has_view_dim=True, return_intermediates=True)
    outputs = lambda out: dict(flow=out[0].flow.float(), agent=out[1][0].agent.float())
    with torch.no_grad():
        parallel = outputs(model(latents=lat, discrete_actions=acts, **kw))
        out = model(latents=lat[:, :P], discrete_actions=acts[:, :P], max_time=PROMPT_LEN, **kw)
        cache, frames = out[1][1], []
        for i in range(P, PROMPT_LEN):
            # a frame on the cache takes the action before it
            out = model(latents=lat[:, i:i + 1], discrete_actions=acts[:, i - 1:i], cache=cache,
                        **kw)
            cache = out[1][1]
            frames.append(outputs(out))
        cached = {k: torch.cat([f[k] for f in frames], dim=1) for k in frames[0]}
        ref_model = DynamicsWorldModel(**{**config, 'use_flash_attention': False})
        ref_model.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
        ref = outputs(ref_model(latents=lat, discrete_actions=acts, **kw))
        del ref_model
    err = lambda a, b: (a - b).abs().max().item()
    return {k: (err(cached[k], ref[k][:, P:]), err(parallel[k][:, P:], ref[k][:, P:]))
            for k in ref}


def run_wm_subsystems_phase(seed: int = 0) -> dict:
    """The trunk's remaining subsystems at the bench model's width (the GRU
    time layer, MoT, a fixed H-Net after layer 3, two views; 43 tokens per
    frame), float32 master weights and bf16 compute: a. a plain and a
    shortcut `BehaviorCloneTrainer` step at b1 x T1024, the loss and the
    time layers' gradients (both MoT attentions) through K1-K3 held
    against float32, the GRU, the special attention, the view embedding
    and the H-Net's scores learning, the GRU's share of the step; b. the
    same plain step with the dynamic H-Net; c. the prompted b16 x T192
    dream from a (b, 96, 2, n, d) prompt, its prompt pass with K1 against
    float32, and cached frames against the parallel pass; d. FIRE with and
    without shrink-and-perturb and a latent-gene evolution on the trained
    model; e. a BC step on b8 x T16 video through the bench tokenizer and
    an aux encoder of 4 tokens. Returns the (K1..K5) launches by path."""
    from dreamer4_torch import BehaviorCloneTrainer, DynamicsWorldModel, VideoTokenizer
    from dreamer4_torch.models.generate import generate
    from dreamer4_torch.ops.fire import apply_fire, evolve_params
    from dreamer4_torch.train.trainers import make_world_model_train_step

    t_phase = time.perf_counter()
    torch.manual_seed(seed)
    model = DynamicsWorldModel(**WMSUB_MODEL, dtype=torch.bfloat16)
    if model.device.type != 'cuda':
        raise SystemExit(f'model built on {model.device}, not on the card')
    if model.tokens_per_frame != WMSUB_TOKENS:
        raise SystemExit(f'{model.tokens_per_frame} tokens per frame, not {WMSUB_TOKENS}')
    dev = model.device
    log(f'# wm-subsystems ({gpu_name_and_power_limit()}): '
        f'{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M params, '
        f'{model.tokens_per_frame} tokens/frame (GRU time layers, MoT, fixed H-Net after layer '
        f'{WMSUB_MODEL["h_net_layer"]}, {model.num_video_views} views)')
    launches = {}

    def part(label, fn):
        torch.cuda.reset_peak_memory_stats()
        out, sec, got, variants = counted(fn)
        expect_launches(label, got, WMSUB_LAUNCHES[label])
        expect_sm90(label, got, variants)
        launches[label] = got
        return out, sec, got, variants, torch.cuda.max_memory_allocated() / 2**30

    # a. the loss and the time layers' gradients through the kernels
    # against float32, then the steps
    batch = multiview_batch(dev, seed + 2, model.num_video_views)
    ref = DynamicsWorldModel(**{**WMSUB_MODEL, 'use_flash_attention': False})
    ref.load_state_dict(model.state_dict())
    names = [f'transformer.{a}_{i}.{w}.weight' for i in TIME_LAYERS
             for a in ('attn', 'special_attn') for w in ('to_q', 'to_k', 'to_v')]
    check_grad_distances('wmsub train grads', compare_grads(
        model, ref, wm_plain_step_loss(batch, seed + 3), names, 'AxialSpaceTimeTransformer',
        'use_flash_attention'))
    del ref
    gc.collect()
    torch.cuda.empty_cache()

    learners = ['view_emb', 'transformer.h_net.to_scores.'] + [
        f'transformer.{m}_{i}.' for i in TIME_LAYERS for m in ('rnn', 'special_attn')]
    trainer = BehaviorCloneTrainer(model, learning_rate=3e-4, clip_grad_norm=1.0,
                                   with_ema=True, seed=seed)
    step_fn = make_world_model_train_step(model, trainer.optimizer, ema_decay=0.999)
    step_ms = {}
    for shortcut in (False, True):
        label = 'wmsub_train_shortcut' if shortcut else 'wmsub_train_plain'
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        ema_before = {n: e.clone() for n, e in trainer.ts.ema_params.items()}
        ts_before = trainer.ts

        def one_step():
            trainer.ts, loss, losses = step_fn(trainer.ts, batch, shortcut_train=shortcut,
                                               generator=trainer.generator)
            return loss, losses
        (loss, losses), sec, got, variants, peak = part(label, one_step)
        n_grad = check_step(model, ts_before, trainer.ts, loss, losses, before, ema_before, label)
        check_nonzero_grads(label, model, learners)
        if not (torch.isfinite(losses.h_net) and losses.h_net.item() > 0):
            raise SystemExit(f'{label}: losses.h_net {losses.h_net.item()}')
        del before, ema_before
        sec_warm = host_time_s(lambda: one_step(), reps=1)
        step_ms[shortcut] = sec_warm * 1e3
        log(f'{label} b{TRAIN["batch_size"]} T{TRAIN["time_steps"]}: loss {loss.item():.4f} '
            f'(h_net {losses.h_net.item():.4f}); {n_grad} parameters with a gradient, all moved '
            f'with their EMA; the GRUs, the special attentions, view_emb and the H-Net\'s scores '
            f'learn; {sec * 1e3:.1f} ms first, {sec_warm * 1e3:.1f} ms warm; (K1..K5) {got}, K1 '
            f'by variant {variants}; peak memory {peak:.2f} GiB')
    rows = TRAIN['batch_size'] * WMSUB_TOKENS
    gru_ms = gru_share_ms(model, rows, TRAIN['time_steps'])
    log(f'wmsub GRU time layers alone (2 layers, forward and backward at {rows} x '
        f'{TRAIN["time_steps"]} x {model.dim}): {gru_ms:.1f} ms, '
        f'{100 * gru_ms / step_ms[False]:.1f}% of the plain step\'s {step_ms[False]:.1f} ms')
    del trainer, step_fn
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()

    # b. the dynamic H-Net: one plain step
    torch.manual_seed(seed)
    dyn = DynamicsWorldModel(**{**WMSUB_MODEL, 'h_net_dynamic': True}, dtype=torch.bfloat16)
    dtrainer = BehaviorCloneTrainer(dyn, learning_rate=3e-4, clip_grad_norm=1.0,
                                    with_ema=False, seed=seed)

    def dyn_step():
        dtrainer.ts, loss, losses = dtrainer._train_step(dtrainer.ts, batch, shortcut_train=False,
                                                         generator=dtrainer.generator)
        return loss, losses
    (loss, losses), sec, got, variants, peak = part('wmsub_dynamic_plain', dyn_step)
    check_nonzero_grads('wmsub_dynamic_plain', dyn, ['transformer.h_net.boundary_head.',
                                                     'view_emb'])
    if not (torch.isfinite(loss) and torch.isfinite(losses.h_net)):
        raise SystemExit(f'wmsub_dynamic_plain: loss {loss.item()}, h_net {losses.h_net.item()}')
    sec_warm = host_time_s(lambda: dyn_step(), reps=1)
    log(f'wmsub_dynamic_plain b{TRAIN["batch_size"]} T{TRAIN["time_steps"]} (dynamic H-Net): '
        f'loss {loss.item():.4f} (h_net {losses.h_net.item():.6f}); the boundary head learns; '
        f'{sec * 1e3:.1f} ms first, {sec_warm * 1e3:.1f} ms warm; (K1..K5) {got}; peak memory '
        f'{peak:.2f} GiB')
    del dyn, dtrainer, batch
    gc.collect()
    torch.cuda.empty_cache()

    # c. the prompted dream from a two-view prompt
    b, T, P = PROMPTED['batch_size'], PROMPTED['time_steps'], PROMPT_LEN
    prompt = bench_prompt(model, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    with torch.no_grad():
        exp, sec, got, variants, peak = part('wmsub_generate', lambda: generate(
            model, gen, **PROMPTED, **prompt))
    check_experience(exp, b, T, P, model.dim, model.latent_shape, prompt=prompt,
                     views=model.num_video_views)
    log(f'wmsub_generate b{b} T{T} P{P} (2 views): {sec * 1e3:.1f} ms (first), '
        f'{b * (T - P) / sec:.1f} dreamed env-steps/s; (K1..K5) {got}, K1 by variant '
        f'{variants}; peak memory {peak:.2f} GiB')
    errors, ms_k, ms_p = compare_prefill(model, prompt, T, config=WMSUB_MODEL)
    cached = compare_cached(model, prompt, WMSUB_MODEL)
    ok = True
    for name, (e_kernel, e_plain, e_between) in errors.items():
        good = e_kernel <= PREFILL_TOL_FACTOR * e_plain
        ok = ok and good
        log(f'wmsub prompt pass {name:<5}: max |bf16 K1 - f32| {e_kernel:.3e} (tol '
            f'{PREFILL_TOL_FACTOR} x {e_plain:.3e}, max |bf16 plain - f32|); max |K1 - plain| '
            f'{e_between:.3e}' + ('' if good else '  FAIL'))
    for name, (e_cached, e_parallel) in cached.items():
        good = e_cached <= PREFILL_TOL_FACTOR * e_parallel
        ok = ok and good
        log(f'wmsub cached frames {name:<5}: max |bf16 cached - f32 parallel| {e_cached:.3e} '
            f'(tol {PREFILL_TOL_FACTOR} x {e_parallel:.3e}, max |bf16 parallel - f32 parallel|)'
            + ('' if good else '  FAIL'))
    log(f'wmsub prompt pass: {ms_k:.2f} ms with K1, {ms_p:.2f} ms plain (the H-Net steps its '
        f'cache frame by frame in both)')
    if not ok:
        raise SystemExit('wmsub: the kernels or the cache are further from float32 than the '
                         'plain parallel pass')
    del exp, prompt
    gc.collect()
    torch.cuda.empty_cache()

    # d. FIRE, without and with shrink-and-perturb, then an evolution step
    def fire_all():
        norms = {n: p.detach().float().norm() for n, p in model.named_parameters()
                 if p.ndim == 2}
        apply_fire(model)
        torch.cuda.synchronize()
        drift = max(abs(p.detach().float().norm() / norms[n] - 1.0).item()
                    for n, p in model.named_parameters() if n in norms)
        fgen = torch.Generator(device=dev).manual_seed(seed + 6)
        apply_fire(model, generator=fgen, shrink_perturb=True)
        genes = model.latent_genes.detach().clone()
        fitness = torch.tensor([0.5, 2.0, -1.0, 1.0], device=dev)
        evolve_params(model, fitness, generator=fgen)
        return drift, len(norms), genes, fitness
    (drift, n_fired, genes, fitness), sec, got, _, _ = part('wmsub_fire', fire_all)
    bad = [n for n, p in model.named_parameters() if not bool(torch.isfinite(p).all())]
    kept = torch.equal(model.latent_genes[:2], genes[torch.tensor([1, 3], device=dev)])
    if drift > FIRE_NORM_TOL or bad or not kept:
        raise SystemExit(f'wmsub_fire: norm drift {drift:.2e}, non-finite {bad[:4]}, the fittest '
                         f'genes kept {kept}')
    log(f'wmsub_fire: FIRE over {n_fired} 2-D weights, largest Frobenius norm drift '
        f'{drift:.2e} (tol {FIRE_NORM_TOL:.0e}), then with shrink-and-perturb, then the latent '
        f'genes evolved (the 2 fittest kept first): {sec * 1e3:.1f} ms in all; (K1..K5) {got}')
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # e. BC on video: the bench tokenizer's latents and the aux encoder's
    torch.manual_seed(seed)
    tok = VideoTokenizer(**BENCH_TOKENIZER, dtype=torch.bfloat16)
    # one view: the tokenizer encodes one video
    aux_model = DynamicsWorldModel(
        **{**WMSUB_MODEL, 'num_video_views': 1, 'num_latent_tokens':
           BENCH_TOKENIZER['num_latent_tokens'] + WMSUB_AUX_TOKENS}, dtype=torch.bfloat16)
    wgen = torch.Generator(device=dev).manual_seed(seed + 8)
    w_aux = torch.randn((3, WMSUB_AUX_TOKENS * 32), generator=wgen, device=dev) * 0.1

    def aux_encoder(video):   # (b, c, t, h, w) -> (b, t, 4, 32)
        pooled = video.mean(dim=(-2, -1)).transpose(1, 2)
        return torch.tanh(pooled @ w_aux).reshape(*pooled.shape[:2], WMSUB_AUX_TOKENS, 32)
    bc = BehaviorCloneTrainer(aux_model, tokenizer=tok, aux_image_encoder_fn=aux_encoder,
                              learning_rate=3e-4, clip_grad_norm=1.0, with_ema=False, seed=seed)
    vb, vt = TOK_VIDEO['batch_size'], TOK_VIDEO['time_steps']
    video = torch.rand((vb, 3, vt, 64, 64), generator=wgen, device=dev)
    vbatch = dict(video=video, rewards=torch.zeros((vb, vt), device=dev),
                  discrete_actions=torch.zeros((vb, vt, 1), dtype=torch.long, device=dev))
    (loss, losses), sec, got, _, peak = part('wmsub_aux_bc', lambda: bc.train_on_batch(vbatch))
    if not torch.isfinite(loss):
        raise SystemExit(f'wmsub_aux_bc: loss {loss.item()}')
    log(f'wmsub_aux_bc b{vb} T{vt} video: {BENCH_TOKENIZER["num_latent_tokens"]} tokenizer + '
        f'{WMSUB_AUX_TOKENS} aux tokens per frame; loss {loss.item():.4f}; {sec * 1e3:.1f} ms '
        f'(first); (K1..K5) {got}; peak memory {peak:.2f} GiB')
    del bc, tok, aux_model, video, vbatch
    gc.collect()
    torch.cuda.empty_cache()
    log(f'# wm-subsystems phase: {time.perf_counter() - t_phase:.1f} s')
    return launches


# ----------------------------------------------------------- tok-subsystems

def run_tok_subsystems_phase(seed: int = 0) -> dict:
    """The bench tokenizer with the GRU time layer and a fixed H-Net in its
    encoder (`TOK_SUB`): the loss and the time layers' gradients through
    K4/K5 held against float32, a `TokenizerTrainer` step (the GRU and the
    H-Net's scores learning), an uncached encode, and the streamed encode
    frame by frame against it. Returns the (K1..K5) launches by path."""
    from dreamer4_torch import TokenizerTrainer, VideoTokenizer
    from dreamer4_torch.train.trainers import make_tokenizer_train_step

    t_phase = time.perf_counter()
    launches = {}

    def part(label, fn):
        out, sec, got, variants = counted(fn)
        expect_launches(label, got, TOK_SUB_LAUNCHES[label])
        launches[label] = got
        return out, sec, got

    torch.manual_seed(seed)
    tok = VideoTokenizer(**TOK_SUB, dtype=torch.bfloat16)
    if tok.device.type != 'cuda':
        raise SystemExit(f'tokenizer built on {tok.device}, not on the card')
    dev = tok.device
    b, t = TOK_VIDEO['batch_size'], TOK_VIDEO['time_steps']
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    video = torch.rand((b, 3, t, 64, 64), generator=gen, device=dev)
    log(f'# tok-subsystems ({gpu_name_and_power_limit()}): the bench tokenizer with the GRU time '
        f'layer and a fixed H-Net after encoder layer {TOK_SUB["h_net_layer"]}: '
        f'{sum(p.numel() for p in tok.parameters()) / 1e6:.2f}M params, b{b} x T{t} video')

    ref = VideoTokenizer(**{**TOK_SUB, 'use_fused_small': False})
    ref.load_state_dict(tok.state_dict())

    def loss_fn(model):
        g = torch.Generator(device=dev).manual_seed(seed + 3)
        return model(video, update_loss_ema=False, generator=g)

    names = [f'{layer}.{w}.weight' for layer in TOK_TIME_LAYERS for w in ('to_q', 'to_k', 'to_v')]
    check_grad_distances('tok-subsystems grads', compare_grads(tok, ref, loss_fn, names,
                                                               'Attention', 'use_fused_small'))
    del ref

    trainer = TokenizerTrainer(tok, learning_rate=3e-4, clip_grad_norm=1.0, with_ema=True,
                               seed=seed)
    step_fn = make_tokenizer_train_step(tok, trainer.optimizer, ema_decay=0.999)
    before = {n: p.detach().clone() for n, p in tok.named_parameters()}
    ema_before = {n: e.clone() for n, e in trainer.ts.ema_params.items()}
    ts_before = trainer.ts

    def one_step():
        trainer.ts, loss, losses = step_fn(trainer.ts, video, generator=trainer.generator)
        return loss, losses
    (loss, losses), sec, got = part('toksub_train_step', one_step)
    n_grad = check_step(tok, ts_before, trainer.ts, loss, losses, before, ema_before,
                        'toksub_train_step')
    check_nonzero_grads('toksub_train_step', tok, ['encoder_transformer.rnn_3.',
                                                   'encoder_transformer.h_net.to_scores.'])
    del before, ema_before
    sec_warm = host_time_s(lambda: one_step(), reps=2)
    log(f'toksub_train_step b{b} T{t}: loss {loss.item():.5f}; {n_grad} parameters with a '
        f'gradient, all moved with their EMA, the GRU and the H-Net\'s scores among them; '
        f'{sec * 1e3:.1f} ms first, {sec_warm * 1e3:.1f} ms/step warm (mean of 2); (K1..K5) '
        f'{got}')
    del trainer, step_fn

    # the streamed encode against one uncached encode, each against float32
    with torch.no_grad():
        uncached, sec_u, got_u = part('toksub_encode', lambda: tok.encode(video))

        def stream():
            cache, frames = None, []
            for i in range(t):
                kw = dict(max_time=t) if cache is None else {}
                lat, cache = tok.encode(video[:, :, i:i + 1], cache=cache, return_cache=True,
                                        **kw)
                frames.append(lat)
            return torch.cat(frames, dim=1), cache
        (streamed, cache), sec_s, got_s = part('toksub_stream', stream)
        f32 = VideoTokenizer(**{**TOK_SUB, 'use_fused_small': False})
        f32.load_state_dict(tok.state_dict())
        ref = f32.encode(video)
        del f32
    if cache.transformer.rnn is None or cache.transformer.h_net is None:
        raise SystemExit('toksub_stream: the cache carries no GRU or H-Net state')
    err = (streamed - uncached).abs().max().item()
    err_f32 = {'streamed': (streamed - ref).abs().max().item(),
               'uncached': (uncached - ref).abs().max().item()}
    tol = PIXEL_TOL_FACTOR * err_f32['uncached']
    ok = err_f32['streamed'] <= tol
    log(f'toksub stream b{b} x {t} frames: {sec_s * 1e3:.1f} ms ({got_s}), uncached encode '
        f'{sec_u * 1e3:.1f} ms ({got_u}); streamed vs uncached max |diff| {err:.3e}; the '
        f'streamed latents\' distance from float32 {err_f32["streamed"]:.3e} (tol {tol:.3e}: '
        f'{PIXEL_TOL_FACTOR} x the uncached bf16 encode\'s, {err_f32["uncached"]:.3e})'
        + ('' if ok else '  FAIL'))
    if not ok:
        raise SystemExit('toksub: the streamed latents disagree with the uncached encode')
    del tok, video
    gc.collect()
    torch.cuda.empty_cache()
    log(f'# tok-subsystems phase: {time.perf_counter() - t_phase:.1f} s')
    return launches


# ------------------------------------------------------------------- main

# ----------------------------------------------------------------- parallel

# the parallel phase. a: the flash ring's block math in one process at the
# train step's time attention (b1 x T1024, 27 tokens per frame, 8 heads of
# 64), causal, softclamp 50, for P virtual ranks; P = 8 puts 128 rows on a
# rank, the flash gate's floor. Every (rank, block) pair runs K1 forward and
# K2/K3 backward, so P^2 launches each, every K1 on the wgmma kernel.
# b: one data-parallel train step over NCCL at world size 1 (2/2/2, a plain
# step); c: the bench trunk's time layers as a ring over that group (P = 1:
# one block per layer, 2/2/2 over the two time layers).
RING_ATTENTION = dict(B=27, Hq=8, H=8, N=1024, D=64)
RING_SIZES = (4, 8)
RING_TOL_FACTOR = 2.0   # the repo's "within 2x" of the single call's distance
PARALLEL_LAUNCHES = {'parallel_ring_p4': (16, 16, 16, 0, 0),
                     'parallel_ring_p8': (64, 64, 64, 0, 0),
                     'parallel_dp_step': (2, 2, 2, 0, 0),
                     'parallel_trunk_ring': (2, 2, 2, 0, 0)}
# the data-parallel step against the plain one: the loss within float32
# summation order; a weight within one bf16 step of Muon's orthogonalized
# update (entries below 8) at the muon rate, 10 x 3e-4
DP_LOSS_RTOL = 1e-5
DP_WEIGHT_ATOL = 10 * 3e-4 * 8 * 2 ** -8


def rel_l2(x, ref):
    ref = ref.float()
    return ((x.float() - ref).norm() / ref.norm()).item()


def run_ring_blocks(seed: int) -> dict:
    """Part a: `flash_ring_blocks` at P = 4 and 8 against the single
    full-length K1/K2/K3 call, each held against float32 plain attention;
    a block no query sees checked alone; ring and single timed."""
    from dreamer4_torch.ops import flash_attention as fa
    from dreamer4_torch.ops.attention import naive_attend
    from dreamer4_torch.parallel.ring_attention import flash_ring_blocks

    B, Hq, H, N, D = (RING_ATTENTION[k] for k in ('B', 'Hq', 'H', 'N', 'D'))
    g = torch.Generator(device='cuda').manual_seed(seed)
    q, k, v, do = (torch.randn((B, h, N, D), generator=g, device='cuda', dtype=torch.bfloat16)
                   for h in (Hq, H, H, Hq))
    cfg = dict(causal=True, softclamp_value=50.0)

    # float32 plain attention and its gradients
    mask = torch.ones((N, N), dtype=torch.bool, device='cuda').tril()
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    ref = naive_attend(qf, kf, vf, mask=mask, softclamp_value=50.0)
    ref_grads = torch.autograd.grad((ref * do.float()).sum(), (qf, kf, vf))
    ref = ref.detach()
    del qf, kf, vf

    single_o, single_lse = fa.flash_attend(q, k, v, 0, N, return_lse=True, **cfg)
    single_grads = fa.flash_attend_bwd(q, k, v, single_o, single_lse, do, 0, N, **cfg)
    single = dict(out=rel_l2(single_o, ref), **{n: rel_l2(x, r) for n, x, r in
                                              zip(('dq', 'dk', 'dv'), single_grads, ref_grads)})

    # a block after every query of a rank: finite K1 rows, LSE near -1e30,
    # and zero K2/K3 from a finite LSE
    n = N // RING_SIZES[0]
    rows = lambda t, r: t[..., r * n:(r + 1) * n, :].contiguous()
    o_m, lse_m = fa.flash_attend(rows(q, 0), rows(k, 1), rows(v, 1), -n, n, return_lse=True,
                                 **cfg)
    zero_grads = fa.flash_attend_bwd(rows(q, 0), rows(k, 1), rows(v, 1), rows(single_o, 0),
                                     rows(single_lse[..., None], 0)[..., 0].contiguous(),
                                     rows(do, 0), -n, n, **cfg)
    if not (bool(torch.isfinite(o_m).all()) and bool((lse_m < -1e29).all())
            and all(not bool(t.any()) for t in zero_grads)):
        raise SystemExit('parallel: a block no query sees gave a non-finite output, an LSE '
                         'above -1e29 or a nonzero gradient')
    log(f'parallel ring: a block no query sees (offset -{n}): K1 finite, LSE max '
        f'{lse_m.max().item():.3e}; K2/K3 exactly zero')

    bound = {'fwd': attention_bound_ms(q, k, mask, 50.0, return_lse=True),
             'dq': backward_bound_ms(q, k, mask, 'dq', 50.0),
             'dkv': backward_bound_ms(q, k, mask, 'dkv', 50.0)}
    single_ms = {'fwd': cuda_time_ms(lambda: fa.flash_attend(q, k, v, 0, N, return_lse=True,
                                                             **cfg)),
                 'bwd': cuda_time_ms(lambda: fa.flash_attend_bwd(q, k, v, single_o, single_lse,
                                                                 do, 0, N, **cfg))}
    launches, results = {}, {}
    for P in RING_SIZES:
        label = f'parallel_ring_p{P}'
        (out, lse, grads), _, got, variants = counted(
            lambda: flash_ring_blocks(q, k, v, P, do, **cfg))
        expect_launches(label, got, PARALLEL_LAUNCHES[label])
        expect_sm90(label, got, variants)
        launches[label] = got
        dist = dict(out=rel_l2(out, ref), **{n_: rel_l2(x, r) for n_, x, r in
                                             zip(('dq', 'dk', 'dv'), grads, ref_grads)})
        for name, d in dist.items():
            good = d <= RING_TOL_FACTOR * single[name]
            log(f'{label} {name:<3}: |ring - f32| {d:.3e} (tol {RING_TOL_FACTOR} x '
                f'{single[name]:.3e}, |single call - f32|)' + ('' if good else '  FAIL'))
            if not good:
                raise SystemExit(f'{label}: the ring\'s {name} is further from float32 than '
                                 f'{RING_TOL_FACTOR} x the single call\'s')
        fwd_ms = cuda_time_ms(lambda: flash_ring_blocks(q, k, v, P, **cfg), iters=10)
        all_ms = cuda_time_ms(lambda: flash_ring_blocks(q, k, v, P, do, **cfg), iters=10)
        results[label] = dict(fwd_ms=fwd_ms, bwd_ms=all_ms - fwd_ms)
        log(f'{label} (B={B}, Hq={Hq}, N={N}, D={D}, {P} x {N // P} rows): forward '
            f'{fwd_ms:.3f} ms ({P * P} K1 + merges; single K1 {single_ms["fwd"]:.3f} ms, bound '
            f'{bound["fwd"][0]:.3f} ms), backward {all_ms - fwd_ms:.3f} ms ({P * P} K2 + K3; '
            f'single K2 + K3 {single_ms["bwd"]:.3f} ms, bound '
            f'{bound["dq"][0] + bound["dkv"][0]:.3f} ms) ({gpu_name_and_power_limit()})')
    print(json.dumps({'parallel_ring': dict(shape=RING_ATTENTION, single_ms=single_ms,
                                            bound_ms={k_: b[0] for k_, b in bound.items()},
                                            **results)}))
    return launches


def run_parallel_phase(seed: int = 0) -> dict:
    """a. the flash ring's block math in one process (`run_ring_blocks`);
    b. NCCL at world size 1 and one data-parallel `BehaviorCloneTrainer`
    step of the bench model through the mesh, against the plain step;
    c. the bench trunk's time layers as a ring over that group, its loss
    and time-layer gradients against float32 beside the plain step's.
    Returns the (K1..K5) launches by path."""
    import torch.distributed as tdist

    from dreamer4_torch import BehaviorCloneTrainer, DynamicsWorldModel
    from dreamer4_torch.parallel import distributed as pdist
    from dreamer4_torch.parallel.mesh import set_mesh

    t_phase = time.perf_counter()
    log(f'# parallel ({gpu_name_and_power_limit()})')
    launches = run_ring_blocks(seed)

    device = pdist.initialize(coordinator_address=f'localhost:{free_port()}', num_processes=1,
                              process_id=0, timeout=300)
    try:
        log(f'parallel: NCCL {".".join(map(str, torch.cuda.nccl.version()))} initialized on '
            f'{device} (backend {tdist.get_backend()}, world size {tdist.get_world_size()})')
        mesh = pdist.create_global_mesh(data=-1)
        if mesh.device_type != 'cuda' or tuple(mesh.shape) != (1, 1):
            raise SystemExit(f'parallel: mesh {mesh}, expected (1, 1) on the card')

        # b. one data-parallel step against the plain step on equal weights
        torch.manual_seed(seed)
        model = DynamicsWorldModel(**BENCH_MODEL, dtype=torch.bfloat16)
        plain = DynamicsWorldModel(**BENCH_MODEL, dtype=torch.bfloat16)
        plain.load_state_dict(model.state_dict())
        batch = train_batch(model.device, seed + 2)
        # a trainer seed whose first branch draw is the plain step
        tseed = next(s for s in range(100)
                     if np.random.default_rng(s).random() >= model.prob_shortcut_train)
        dp = BehaviorCloneTrainer(model, learning_rate=3e-4, clip_grad_norm=1.0, seed=tseed,
                                  mesh=mesh)
        ref = BehaviorCloneTrainer(plain, learning_rate=3e-4, clip_grad_norm=1.0, seed=tseed)
        label = 'parallel_dp_step'
        (dp_loss, _), _, got, variants = counted(lambda: dp.train_on_batch(batch))
        expect_launches(label, got, PARALLEL_LAUNCHES[label])
        expect_sm90(label, got, variants)
        launches[label] = got
        ref_loss, _ = ref.train_on_batch(batch)
        loss_rel = abs(dp_loss.item() - ref_loss.item()) / abs(ref_loss.item())
        w_diff = max((p.detach().float() - q.detach().float()).abs().max().item()
                     for p, q in zip(model.parameters(), plain.parameters()))
        log(f'{label}: loss {dp_loss.item():.6f} vs plain {ref_loss.item():.6f} (rel '
            f'{loss_rel:.2e}, tol {DP_LOSS_RTOL}); weights after it max |diff| {w_diff:.3e} '
            f'(tol {DP_WEIGHT_ATOL:.3e}); (K1..K5) {got}')
        if loss_rel > DP_LOSS_RTOL or w_diff > DP_WEIGHT_ATOL:
            raise SystemExit(f'{label}: the data-parallel step differs from the plain one')
        del dp, ref, plain

        # c. the trunk's plain time layers as a ring over the 1-rank group
        f32 = DynamicsWorldModel(**{**BENCH_MODEL, 'use_flash_attention': False})
        f32.load_state_dict(model.state_dict())
        names = [f'transformer.attn_{i}.{w}.weight' for i in TIME_LAYERS
                 for w in ('to_q', 'to_k', 'to_v')]
        loss_fn = wm_plain_step_loss(batch, seed + 3)
        label = 'parallel_trunk_ring'
        model.transformer.time_ring_axis = 'data'
        with set_mesh(mesh):
            ring, _, got, variants = counted(lambda: step_grads(model, loss_fn, names))
        expect_launches(label, got, PARALLEL_LAUNCHES[label])
        expect_sm90(label, got, variants)
        launches[label] = got
        model.transformer.time_ring_axis = None
        model.transformer.use_flash_attention = False
        bf16_plain = step_grads(model, loss_fn, names)
        model.transformer.use_flash_attention = True
        ref32 = step_grads(f32, loss_fn, names)
        distances = {'loss': (abs(ring[0] - ref32[0]), abs(bf16_plain[0] - ref32[0]))}
        for name, r in ref32[1].items():
            distances[name] = (rel_l2(ring[1][name], r), rel_l2(bf16_plain[1][name], r))
        check_grad_distances('parallel trunk ring grads', distances)
    finally:
        tdist.destroy_process_group()
    log(f'# parallel phase: {time.perf_counter() - t_phase:.1f} s')
    return launches


# ------------------------------------------------------------------ recipes

class MockRenderingEnv:
    """MockStateEnv that records a 64 x 64 RGB frame per observation, as the
    pixel recipe's `RenderingCartPoleAdapter` does (the frames are noise
    from a generator of their own)."""

    def __init__(self, seed: int, record: bool):
        from dreamer4_torch.envs.mocks import MockStateEnv

        self.env = MockStateEnv(**RECIPES_CARTPOLE_ENV, seed=seed)
        self.dim_state, self.num_actions = self.env.dim_state, self.env.num_actions
        self.record = record
        self.frame_rng = np.random.default_rng(seed + 1)
        self.frame_log: list[np.ndarray] = []

    def _snap(self):
        if self.record:
            self.frame_log.append(self.frame_rng.integers(
                0, 256, (RECIPES_CARTPOLE_ENV['batch'], 64, 64, 3), dtype=np.uint8))

    def reset(self, seed=None):
        out = self.env.reset(seed=seed)
        self.frame_log = []
        self._snap()
        return out

    def step(self, actions):
        out = self.env.step(actions)
        self._snap()
        return out

    def take_frames(self) -> np.ndarray:
        frames = np.stack(self.frame_log, axis=1)
        self.frame_log = []
        return frames


@contextlib.contextmanager
def watch_recipe_steps():
    """While the recipes run, every step of the trainers they drive is
    checked: its losses finite, the weights it trains moved (some of them)
    and those it must not train bitwise still: a world-model update with
    frozen heads (`examples.common.WorldModelUpdates`) the heads, a
    heads-only dream step (`DreamTrainer.step`) or RL epoch
    (`SimTrainer.update` without a trunk rate) everything but the heads.
    Yields the list of (step, loss) it records."""
    from dreamer4_torch.examples import common
    from dreamer4_torch.train import trainers

    record: list[tuple[str, float]] = []

    def snapshot(model):
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    def check(label, model, before, trained: set, losses: dict):
        for name, loss in losses.items():
            if not bool(torch.isfinite(loss)):
                raise SystemExit(f'{label}: {name} {loss}')
            record.append((f'{label} {name}', float(loss)))
        moved = {n for n, p in model.named_parameters() if not torch.equal(p, before[n])}
        if not moved & trained:
            raise SystemExit(f'{label}: none of the weights it trains moved')
        if moved - trained:
            raise SystemExit(f'{label}: frozen weights moved: {sorted(moved - trained)[:5]}')

    def all_names(model):
        return {n for n, _ in model.named_parameters()}

    def heads(model, full_model=False):
        labels = trainers.rl_param_labels(model, full_model=full_model)
        return {n for n, l in labels.items() if l != 'frozen'}

    real = dict(wm=common.WorldModelUpdates.__call__, dream=trainers.DreamTrainer.step,
                dyn=trainers.SimTrainer.train_dynamics_on, update=trainers.SimTrainer.update,
                tok=trainers.TokenizerTrainer.train_on_batch,
                bc=trainers.BehaviorCloneTrainer.train_on_batch)

    def wm(self, sample_batch):
        before = snapshot(self.model)
        loss = real['wm'](self, sample_batch)
        check('world-model update', self.model, before, set(self.optimizer.labels()),
              {'loss': loss})
        return loss

    def dream(self):
        before = snapshot(self.model)
        exp, out = real['dream'](self)
        check('dream step', self.model, before, heads(self.model),
              {'policy loss': out.policy_loss, 'value loss': out.value_loss})
        return exp, out

    def dyn(self, exp):
        before = snapshot(self.model)
        loss = real['dyn'](self, exp)
        check('dynamics step', self.model, before, all_names(self.model), {'loss': loss})
        return loss

    def update(self, exp):
        before = snapshot(self.model)
        outs = real['update'](self, exp)
        full_model = any(g.get('name') == 'trunk' for g in self.optimizer.param_groups)
        check('RL epochs', self.model, before, heads(self.model, full_model),
              {f'{kind} loss {i}': getattr(o, f'{kind}_loss')
               for i, o in enumerate(outs) for kind in ('policy', 'value')})
        return outs

    def tok(self, video, time_lens=None):
        before = snapshot(self.model)
        loss, losses = real['tok'](self, video, time_lens)
        check('tokenizer step', self.model, before, all_names(self.model), {'loss': loss})
        return loss, losses

    def bc(self, batch):
        before = snapshot(self.model)
        loss, losses = real['bc'](self, batch)
        check('behaviour-cloning step', self.model, before, all_names(self.model),
              {'loss': loss})
        return loss, losses

    patches = [(common.WorldModelUpdates, '__call__', wm), (trainers.DreamTrainer, 'step', dream),
               (trainers.SimTrainer, 'train_dynamics_on', dyn),
               (trainers.SimTrainer, 'update', update),
               (trainers.TokenizerTrainer, 'train_on_batch', tok),
               (trainers.BehaviorCloneTrainer, 'train_on_batch', bc)]
    for cls, name, fn in patches:
        setattr(cls, name, fn)
    try:
        yield record
    finally:
        for (cls, name, _), key in zip(patches, real):
            setattr(cls, name, real[key])


def run_recipe(label: str, fn):
    """One recipe under `watch_recipe_steps`, counted and timed: its
    launches must be 0 (the recipes build flash and the small path off, as
    the JAX ones do); -> (fn(), the steps it checked, seconds)."""
    with watch_recipe_steps() as steps:
        out, sec, launches, _ = counted(fn)
    expect_launches(f'recipes {label}', launches, (0, 0, 0, 0, 0))
    if not steps and label != 'snake_ppo':
        raise SystemExit(f'recipes {label}: no trainer step ran')
    log(f'recipes {label}: {sec:.1f} s, {len(steps)} steps checked (losses finite, trained '
        f'weights moved, frozen ones still), launches (K1..K5) {launches}')
    return out, steps, sec


def run_cartpole_flash_step(seed: int) -> dict:
    """The CartPole online model built with `use_flash_attention` and
    without it, from the same seed: one `SimTrainer` step of each from the
    same weights and draws, on the flash model's rollout: its launches by
    part (as `CARTPOLE_FLASH_LAUNCHES`, every K1 on the f32 kernel) and the
    dynamics loss within `CARTPOLE_FLASH_LOSS_RTOL` of flash-off's."""
    from dreamer4_torch.envs.mocks import MockStateEnv
    from dreamer4_torch.examples import train_cartpole_with_dynamics_rl as online

    args = online.parse_args(['--seed', str(seed)])
    device = torch.device('cuda', torch.cuda.current_device())
    trainers, models = {}, {}
    for flash in (True, False):
        env = MockStateEnv(**RECIPES_CARTPOLE_ENV, seed=seed)
        models[flash] = online.build_model(args, env, device, use_flash_attention=flash)
        trainers[flash] = online.build_trainer(args, models[flash], env, device)
    if not all(torch.equal(a, b) for a, b in zip(models[True].parameters(),
                                                 models[False].parameters())):
        raise SystemExit('recipes cartpole flash: the two models differ before the step')
    exp, roll_s, roll_n, _ = counted(trainers[True].rollout)
    b, t = exp.batch_size, exp.time_steps
    if (b * models[True].tokens_per_frame, t) != (CARTPOLE_ATTENTION['B'], CARTPOLE_ATTENTION['N']):
        raise SystemExit(f'recipes cartpole flash: b{b} x T{t} is not the cartpole_f32 case')
    rng = np.random.default_rng()
    rng.bit_generator.state = trainers[True].rng.bit_generator.state
    shortcut = bool(rng.random() < models[True].prob_shortcut_train)
    losses, parts = {}, {}
    for flash in (True, False):
        losses[flash], dyn_s, dyn_n, dyn_v = counted(
            lambda: trainers[flash].train_dynamics_on(exp))
        outs, upd_s, upd_n, _ = counted(lambda: trainers[flash].update(exp))
        check_finite(f'recipes cartpole flash={flash}',
                     {'dynamics loss': losses[flash],
                      **{f'policy loss {i}': o.policy_loss for i, o in enumerate(outs)}})
        if flash:
            parts = {'rollout': roll_n, 'dynamics': dyn_n, 'update': upd_n}
            want = dict(CARTPOLE_FLASH_LAUNCHES,
                        dynamics=CARTPOLE_FLASH_LAUNCHES['dynamics'][shortcut])
            for part in parts:
                expect_launches(f'recipes cartpole flash {part}', parts[part], want[part])
            if dyn_v != {'f32': dyn_n[0]}:
                raise SystemExit(f'recipes cartpole flash: K1 ran as {dyn_v}, not on f32')
            times = (roll_s, dyn_s, upd_s)
        else:
            times_off = (dyn_s, upd_s)
    on, off = losses[True].item(), losses[False].item()
    rel = abs(on - off) / abs(off)
    if rel > CARTPOLE_FLASH_LOSS_RTOL:
        raise SystemExit(f'recipes cartpole flash: dynamics loss {on} vs {off} flash off '
                         f'(rel {rel:.2e} > {CARTPOLE_FLASH_LOSS_RTOL:.0e})')
    log(f'recipes cartpole flash: b{b} T{t}, {"shortcut" if shortcut else "plain"} dynamics '
        f'step, loss {on:.6f} flash on vs {off:.6f} off (rel {rel:.2e}, tol '
        f'{CARTPOLE_FLASH_LOSS_RTOL:.0e}); rollout {times[0] * 1e3:.1f} ms, dynamics '
        f'{times[1] * 1e3:.1f} ms on vs {times_off[0] * 1e3:.1f} ms off, RL epochs '
        f'{times[2] * 1e3:.1f} ms vs {times_off[1] * 1e3:.1f} ms; (K1..K5) launches {parts} '
        f'(every K1 on f32)')
    return {f'recipes_cartpole_flash_{part}': n for part, n in parts.items()}


def run_recipes_phase(seed: int = 0) -> dict:
    """The port's recipes (`dreamer4_torch/examples`) through their own
    functions at their own widths, iterations and steps cut: the scripted
    Snake collector in full (200 episodes, its apple gate), 5 iterations of
    the learned Snake collector and a 16-episode collection, the sprites
    dataset (16 episodes), tokenizer (20 steps) and dynamics (20 steps, one
    sample GIF), the reacher (20 + 20 steps and the forced dreams), one
    iteration of each CartPole recipe on MockStateEnv (the pixel one through
    all six phases, its frames from `MockRenderingEnv`, its evaluation on
    64 x 64 MockEnv frames). Every trainer step is checked
    (`watch_recipe_steps`); no recipe launches a kernel. Then the flash-on
    CartPole step (`run_cartpole_flash_step`). Its files go to
    `smoke_work/recipes`, removed at its end."""
    from dreamer4_torch.envs.mocks import MockEnv, MockStateEnv
    from dreamer4_torch.examples import dataset_moving_sprites as sprites_data
    from dreamer4_torch.examples import train_cartpole_dream_rl as dream
    from dreamer4_torch.examples import train_cartpole_offline_dream_rl as offline
    from dreamer4_torch.examples import train_cartpole_pixels_dream_rl as pixels
    from dreamer4_torch.examples import train_cartpole_with_dynamics_rl as online
    from dreamer4_torch.examples import train_moving_sprites_dynamics as sprites_dyn
    from dreamer4_torch.examples import train_moving_sprites_tokenizer as sprites_tok
    from dreamer4_torch.examples import train_reacher_proprio_dynamics as reacher
    from dreamer4_torch.examples import train_snake_ppo as snake_ppo
    from dreamer4_torch.examples import train_snake_rl_collector as snake

    t_phase = time.perf_counter()
    device = torch.device('cuda', torch.cuda.current_device())
    work = RECIPES_DIR
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    dev = ['--device', 'cuda', '--seed', str(seed)]
    cartpole_env = lambda: MockStateEnv(**RECIPES_CARTPOLE_ENV, seed=seed)
    try:
        (_, apples), _, _ = run_recipe('snake_ppo', lambda: snake_ppo.collect(
            str(work / 'snake_scripted'), num_episodes=200))
        log(f'recipes snake_ppo: 200 episodes, mean apples {np.mean(apples):.2f} (gate 2.5)')

        args = snake.parse_args([*dev, '--max-iterations', str(RECIPES_SNAKE_ITERATIONS),
                                 '--target-apples', 'inf', '--num-episodes', '16',
                                 '--buffer', str(work / 'snake_rl')])

        def snake_run():
            model, gate = snake.train_collector(args, snake.make_env(args, seed), device)
            return snake.collect(args, model, snake.make_env(args, seed + 10_000, record=True),
                                 device), gate

        (apples, gate), _, _ = run_recipe('snake_rl_collector', snake_run)
        if gate is not None or len(apples) != 16:
            raise SystemExit(f'recipes snake_rl_collector: gate {gate}, {len(apples)} episodes')

        sprites_data.write_dataset(str(work / 'sprites'), num_episodes=RECIPES_SPRITES['episodes'])
        common_flags = [*dev, '--data', str(work / 'sprites'), '--log-every', '10']
        args = sprites_tok.parse_args([*common_flags, '--output', str(work / 'sprites_tok'),
                                       '--num-steps', str(RECIPES_SPRITES['tokenizer_steps'])])
        run_recipe('sprites_tokenizer', lambda: sprites_tok.train(args, device))
        steps = RECIPES_SPRITES['dynamics_steps']
        args = sprites_dyn.parse_args([*common_flags, '--output', str(work / 'sprites_dyn'),
                                       '--tokenizer-checkpoint', str(work / 'sprites_tok'),
                                       '--num-steps', str(steps),
                                       '--sample-every', str(steps - 1)])
        run_recipe('sprites_dynamics', lambda: sprites_dyn.train(args, device))
        gif = work / f'sample_{steps - 1}.gif'
        if not gif.exists():
            raise SystemExit(f'recipes sprites_dynamics: no sample GIF {gif}')

        args = reacher.parse_args([*dev, '--data', str(work / 'reacher'),
                                   '--steps', str(RECIPES_REACHER_STEPS),
                                   '--tokenizer-steps', str(RECIPES_REACHER_STEPS)])

        def reacher_run():
            ds, batches = reacher.load_data(args)
            tokenizer = reacher.train_tokenizer(args, batches, device)
            model = reacher.train_dynamics(args, tokenizer, batches, device)
            return reacher.forced_dreams(model, tokenizer, ds, device)

        run_recipe('reacher', reacher_run)

        args = online.parse_args([*dev, '--max-iterations', '1'])
        rc, _, _ = run_recipe('cartpole_online', lambda: online.train(args, cartpole_env(),
                                                                     device))
        args = dream.parse_args([*dev, '--max-iterations', '1', '--warmup-iters', '0',
                                 '--diag-every', '1', '--log-dir', str(work / 'dream_log'),
                                 '--save-dir', str(work / 'dream_save')])
        rc += run_recipe('cartpole_dream', lambda: dream.train(args, cartpole_env(),
                                                              device))[0]
        args = offline.parse_args([*dev, '--expert-iterations', '1',
                                   '--dataset-batches-expert', '1',
                                   '--dataset-batches-random', '1', '--wm-steps', '2',
                                   '--dream-updates', '1', '--eval-every', '1', '--window', '1'])
        rc += run_recipe('cartpole_offline', lambda: offline.run(args, cartpole_env(),
                                                                device))[0]
        args = pixels.parse_args([*dev, '--workdir', str(work / 'pixels'),
                                  '--expert-iterations', '1', '--batches-expert', '1',
                                  '--batches-random', '1', '--tok-steps', '2', '--wm-steps', '2',
                                  '--dream-updates', '1', '--eval-every', '1', '--window', '1'])
        make_pixel_env = lambda s: MockEnv(image_size=(64, 64), num_actions=2,
                                           batch=RECIPES_CARTPOLE_ENV['batch'], seed=s)
        rc += run_recipe('cartpole_pixels', lambda: pixels.run(
            args, device, lambda s, record: MockRenderingEnv(s, record), make_pixel_env))[0]
        if rc != 4:   # one iteration solves none of them
            raise SystemExit(f'recipes cartpole: exit codes sum to {rc}, not 4 (each 1)')
        launches = run_cartpole_flash_step(seed)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f'# recipes phase: {time.perf_counter() - t_phase:.1f} s')
    return launches


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
    launches = {}
    for phase in (run_model_phase, run_train_phase, run_dream_phase, run_tokenizer_phase,
                  run_wm_fused_phase, run_sim_phase, run_pixel_phase, run_cli_phase,
                  run_continuous_phase, run_recipe_phase, run_tok_options_phase,
                  run_wm_options_phase, run_tok_full_phase, run_wm_subsystems_phase,
                  run_tok_subsystems_phase, run_parallel_phase, run_recipes_phase):
        t_phase = time.perf_counter()
        launches.update(phase())
        log(f'# {phase.__name__}: {time.perf_counter() - t_phase:.1f} s')
    small_results = run_small_kernel_phase()
    forward_device_times(kernel_results, k1_device_calls)
    backward_device_times(train_shape, t1024_calls)
    small_shape = small_results[('tok_time', torch.bfloat16)]
    small_at = {which: {name: {x: small_results[(name, torch.bfloat16)][which][x]
                               for x in ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by')}
                        for name in SMALL_PATH_CASES}
                for which in ('fwd', 'bwd')}
    if small_shape['fwd']['library_ms'] is None or small_shape['bwd']['library_ms'] is None:
        raise SystemExit('no library yardstick for K4 / K5 at the tokenizer time shape')
    totals = [sum(c[i] for c in launches.values()) for i in range(5)]
    by_path = lambda i: {path: c[i] for path, c in launches.items() if c[i]}

    k1_at = {name: {x: kernel_results[(name, torch.bfloat16)][x]
                    for x in ('ms', 'device_ms', 'library_ms', 'library_device_ms', 'bound_ms')}
             for name in K1_SM90_CASES}
    k1_at_paths = {name: {x: kernel_results[(name, torch.bfloat16)][x]
                          for x in ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by')}
                   for name in K1_SM90_ONLY_CASES}
    fields = ('ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by')
    k1_at_f32 = {name: {x: kernel_results[(name, torch.float32)][x] for x in fields}
                 for name in F32_PATH_CASES}
    bwd_at_f32 = {which: {name: {x: bwd_results[(name, torch.float32)][which][x] for x in fields}
                          for name in F32_PATH_CASES}
                  for which in ('dq', 'dkv')}
    bwd_at = {which: {name: {x: bwd_results[(name, torch.bfloat16)][which][x]
                             for x in ('ms', 'plain_ms', 'library_ms', 'bound_ms')}
                      for name in BWD_LIBRARY_CASES if name != 't1024'}
              for which in ('dq', 'dkv')}
    kernels = [dict(name='K1 flash_attn_fwd', route='cuda',
                    source='dreamer4_torch/csrc/flash_attn_fwd.cu',
                    replaces='dreamer4_tpu/ops/flash_attention.py:86',
                    launches=totals[0], launches_by_path=by_path(0), **main_shape,
                    at_other_shapes=k1_at, at_path_shapes=k1_at_paths,
                    at_f32_path_shapes=k1_at_f32),
               dict(name='K2 flash_attn_bwd_dq', route='cuda',
                    source='dreamer4_torch/csrc/flash_attn_bwd_dq.cu',
                    replaces='dreamer4_tpu/ops/flash_attention.py:269',
                    launches=totals[1], launches_by_path=by_path(1), **train_shape['dq'],
                    library_covers='flex_attention backward: dq, dk and dv together',
                    at_other_shapes=bwd_at['dq'], at_f32_path_shapes=bwd_at_f32['dq']),
               dict(name='K3 flash_attn_bwd_dkv', route='cuda',
                    source='dreamer4_torch/csrc/flash_attn_bwd_dkv.cu',
                    replaces='dreamer4_tpu/ops/flash_attention.py:309',
                    launches=totals[2], launches_by_path=by_path(2), **train_shape['dkv'],
                    library_covers='flex_attention backward: dq, dk and dv together',
                    at_other_shapes=bwd_at['dkv'], at_f32_path_shapes=bwd_at_f32['dkv']),
               dict(name='K4 small_attn_fwd', route='cuda',
                    source='dreamer4_torch/csrc/small_attn_fwd.cu',
                    replaces='dreamer4_tpu/ops/small_attention.py:77',
                    launches=totals[3], launches_by_path=by_path(3), **small_shape['fwd'],
                    library_covers='compiled flex_attention, softclamp as score_mod',
                    at_path_shapes=small_at['fwd']),
               dict(name='K5 small_attn_bwd', route='cuda',
                    source='dreamer4_torch/csrc/small_attn_bwd.cu',
                    replaces='dreamer4_tpu/ops/small_attention.py:94',
                    launches=totals[4], launches_by_path=by_path(4), **small_shape['bwd'],
                    library_covers='flex_attention backward: dq, dk and dv together',
                    at_path_shapes=small_at['bwd'])]
    missing = [k['name'] for k in kernels if k['launches'] == 0]
    if missing:
        raise SystemExit(f'kernels never launched on the main paths: {missing}')
    log(f'# chip_smoke: {time.perf_counter() - t0:.1f} s from the kernels\' build')
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                            'kind': torch.cuda.get_device_name(0),
                                            'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
