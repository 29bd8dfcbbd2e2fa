"""CartPole from PIXELS: policy learned purely in imagination, with the
VideoTokenizer in the loop — the paper's actual setting (counterpart of
`examples/train_cartpole_pixels_dream_rl.py`).

This is the pixel-input counterpart of `train_cartpole_offline_dream_rl.py`.
Six phases, each cached in --workdir so restarts are cheap:

  1. EXPERT    (`expert_phase`): state-vector online RL (the proven
               SimTrainer recipe) until avg return >= --expert-target.
               Exists only to MAKE the offline dataset.
  2. COLLECT   (`dataset_phase`): expert + random rollouts on RENDERED
               CartPole; frames (64x64 RGB), actions, rewards, terminals.
  3. TOKENIZER (`tokenizer_phase`): VideoTokenizer trained on the collected
               frames (MAE masking + flow decoder), its EMA weights kept.
  4. TOKENIZE  (`tokenize_phase`): every episode's frames -> causal latents
               with the frozen EMA tokenizer.
  5. WORLD MODEL (`world_model_phase`): dynamics model trained offline on
               tokenizer latents (policy/value heads frozen).
  6. DREAM RL  (`DreamPhase`): the policy/value heads optimized with PPO on
               imagination rollouts only; the real env is used strictly for
               EVALUATION, observed THROUGH the tokenizer's streaming
               encode. With `--online-rounds`, phase 7: the dream policy
               collects fresh rollouts (acting only), the world model is
               fine-tuned on them, and dreaming goes on.

Success = eval return >= --target-return (reference gate: 70.0 at
max_timesteps 150) with zero real-env policy updates after phase 2.

Devices: the JAX recipe runs the phases that step a host env (1, 2, 6) on
its CPU backend and the training phases on the accelerator, with
`--env-device` to move the first onto the accelerator. Here every model
runs on `--device` (the card unless 'cpu' is asked for) and the
environment steps on the host, so that flag has no counterpart. The
phases take the environments as factories (`make_env(seed, record)`,
`make_pixel_env(seed)`); `main` builds gymnasium's, which need gymnasium
with CartPole's renderer and cv2, with no substitute.

Streams (JAX -> here): each model's initial weights, `PRNGKey(s)` -> the
global generator seeded with s inside `common.seeded_init` (the expert
and the pixel world model s = seed, the random collector seed + 5, the
tokenizer seed + 21); the expert's `fold_in(PRNGKey(seed), it)` ->
`SimTrainer(seed=--seed)`; its held-out evaluation's `fold_in(PRNGKey(seed
+ 555), 100 it + b)` -> `stream(seed + 555, 100 it + b)`; the collectors'
`fold_in(PRNGKey(seed + 100 | 200), b)` -> `stream(seed + 100 | 200, b)`;
the tokenizer trainer's chain -> `TokenizerTrainer(seed=--seed)`; the
world-model steps' split chain of `PRNGKey(seed + 7)` (a round's
fine-tune: `seed + 900 + round`) -> one generator of that seed in turn;
dream update u's `fold_in(PRNGKey(seed + 31), u)` -> `DreamTrainer(seed=
seed + 31)` in turn, its evaluations' and a round's collections' `fold_in(.,
10_000_000 + u)` and `fold_in(., 20_000_000 + 1000 round + b)` ->
`stream(seed + 31, ...)` alike; the clip, replay, prompt and shortcut
draws from numpy `default_rng(seed)` as in the JAX recipe; the recon
sample's decode `PRNGKey(0)` -> a generator seeded with 0.

Usage: python -m dreamer4_torch.examples.train_cartpole_pixels_dream_rl --workdir /tmp/cartpole_pixels
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..envs.interact import EnvInteractor
from ..models.tokenizer import VideoTokenizer
from ..models.world_model import DynamicsWorldModel
from ..train.checkpoint import load_model, save_model
from ..train.trainers import DreamTrainer, SimTrainer, TokenizerTrainer
from .common import WorldModelUpdates, pad_time, prompt_window, seeded_init, stream, to_batch
from .train_cartpole_with_dynamics_rl import GymnasiumVectorAdapter

T0 = time.time()


def log(msg):
    print(f'[{time.time() - T0:7.0f}s] {msg}', flush=True)


# --------------------------------------------------------------------- envs

FRAME_HW = 64
N_LAT, D_LAT = 4, 16
FRAME_KEYS = ('frames', 'rewards', 'terminals', 'discrete_actions', 'lens')


def render_small(env) -> np.ndarray:
    """600x400 rgb_array -> 64x64 uint8. Crop the vertical band that contains
    the track, cart and pole (rows ~80..360 of the 400-row frame) so the
    downsampled pixels spend resolution on the dynamics, not the empty sky."""
    import cv2

    f = env.render()
    f = f[80:360]
    return cv2.resize(f, (FRAME_HW, FRAME_HW), interpolation=cv2.INTER_AREA)


class RenderingCartPoleAdapter(GymnasiumVectorAdapter):
    """State-obs adapter that also renders every observation to a side
    buffer — the expert acts from state while the dataset records pixels."""

    def __init__(self, n_envs=16, max_timesteps=150, seed=0, record=True):
        import gymnasium

        self.envs = [gymnasium.make('CartPole-v1', render_mode='rgb_array')
                     for _ in range(n_envs)]
        self.n_envs = n_envs
        self.max_timesteps = max_timesteps
        self._seed = seed
        self.record = record
        self.frame_log: list[np.ndarray] = []

    def _snap(self):
        if self.record:
            self.frame_log.append(
                np.stack([render_small(e) for e in self.envs]))

    def reset(self, seed=None):
        out = super().reset(seed=seed)
        self.frame_log = []
        self._snap()
        return out

    def step(self, actions):
        out = super().step(actions)
        self._snap()
        return out

    def take_frames(self) -> np.ndarray:
        """(n_envs, steps+1, 64, 64, 3) uint8, aligned so frames[:, t] is the
        observation the agent saw at step t."""
        frames = np.stack(self.frame_log, axis=1)
        self.frame_log = []
        return frames


class PixelCartPoleAdapter:
    """Image-obs adapter for evaluation: obs = {'image': (n, 3, 64, 64)
    float32 in [0, 1]}. Finished envs latch until the batch rollout ends."""

    def __init__(self, n_envs=16, max_timesteps=150, seed=0):
        import gymnasium

        self.envs = [gymnasium.make('CartPole-v1', render_mode='rgb_array')
                     for _ in range(n_envs)]
        self.n_envs = n_envs
        self.max_timesteps = max_timesteps
        self._seed = seed

    def _obs(self):
        frames = np.stack([render_small(e) for e in self.envs])  # (n,h,w,3)
        img = frames.astype(np.float32).transpose(0, 3, 1, 2) / 255.0
        return {'image': img}

    def reset(self, seed=None):
        base = seed if seed is not None else self._seed
        self._seed += self.n_envs
        for i, env in enumerate(self.envs):
            env.reset(seed=base + i)
        self._done = np.zeros((self.n_envs,), bool)
        return self._obs(), {}

    def step(self, actions):
        actions = np.asarray(actions).reshape(self.n_envs)
        rewards = np.zeros((self.n_envs,), np.float32)
        terminated = np.zeros((self.n_envs,), bool)
        truncated = np.zeros((self.n_envs,), bool)
        for i, env in enumerate(self.envs):
            if self._done[i]:
                terminated[i] = True
                continue
            _, r, term, trunc, _ = env.step(int(actions[i]))
            rewards[i] = r
            terminated[i] = term
            truncated[i] = trunc
            self._done[i] |= term or trunc
        return self._obs(), rewards, terminated, truncated, {}


# --------------------------------------------------------------------- flags

def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--workdir', type=str, default='/tmp/cartpole_pixels')
    p.add_argument('--target-return', type=float, default=70.0)
    p.add_argument('--max-timesteps', type=int, default=150)
    p.add_argument('--n-envs', type=int, default=16)
    # phase 1
    p.add_argument('--expert-iterations', type=int, default=60)
    p.add_argument('--expert-target', type=float, default=80.0)
    p.add_argument('--expert-extend', action='store_true',
                   help='when an expert checkpoint exists, keep training it '
                        'toward --expert-target instead of using it as-is. '
                        'The offline state-vector gate was solved with an '
                        '~80-return expert dataset; a weaker expert caps the '
                        'world model (and thus the dream policy) below the '
                        'gate.')
    # phase 2
    p.add_argument('--batches-expert', type=int, default=30)
    p.add_argument('--batches-random', type=int, default=30)
    # phase 3
    p.add_argument('--tok-steps', type=int, default=4000)
    p.add_argument('--tok-lr', type=float, default=3e-4)
    p.add_argument('--tok-batch', type=int, default=8)
    p.add_argument('--tok-clip-t', type=int, default=8)
    # phase 5
    p.add_argument('--wm-steps', type=int, default=4000)
    p.add_argument('--wm-lr', type=float, default=3e-4)
    p.add_argument('--terminal-pos-weight', type=float, default=30.0)
    p.add_argument('--latched-terminal-frames', type=int, default=6,
                   help='post-termination latched frames (fallen pole, '
                        'reward 0) included in WM training; see the wm_lens '
                        'comment')
    # phase 6 (the proven offline dream-RL hyperparameters)
    p.add_argument('--dream-updates', type=int, default=3000)
    p.add_argument('--dream-batch', type=int, default=128)
    p.add_argument('--dream-timesteps', type=int, default=25)
    p.add_argument('--num-denoise-steps', type=int, default=4)
    p.add_argument('--prompt-len', type=int, default=3)
    p.add_argument('--ppo-epochs', type=int, default=2)
    p.add_argument('--policy-lr', type=float, default=6e-4)
    p.add_argument('--value-lr', type=float, default=6e-4)
    # 0.01 matches the solved ONLINE recipe (train_cartpole_dream_rl.py);
    # 0.001 collapsed to H~0.2 by update ~2500 in the first pixel run, so the
    # online rounds collected near-deterministic data and stopped climbing
    p.add_argument('--entropy-weight', type=float, default=0.01)
    p.add_argument('--eval-every', type=int, default=25)
    p.add_argument('--window', type=int, default=3)
    # phase 7: iterated online rounds — the full Dreamer recipe. The offline
    # dataset bounds what the world model knows; when the dream-trained
    # policy plateaus at the dataset's support, collect fresh rollouts WITH
    # the current policy (acting only — every policy-gradient update stays
    # inside imagination), fine-tune the world model on the extended dataset,
    # and keep dreaming.
    p.add_argument('--online-rounds', type=int, default=0)
    p.add_argument('--online-collect-batches', type=int, default=8)
    p.add_argument('--online-wm-steps', type=int, default=1500)
    p.add_argument('--online-dream-updates', type=int, default=600)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', type=str, default=None,
                   help='torch device for every model (default: the CUDA card; "cpu" runs '
                        'on the CPU); the environment steps on the host')
    p.add_argument('--stop-after', choices=('expert', 'dataset', 'tokenizer',
                                            'tokenize', 'wm'), default=None,
                   help='exit after this phase (stage the pipeline across '
                        'processes)')
    p.add_argument('--smoke', action='store_true',
                   help='tiny end-to-end pipeline check (minutes, no gate)')
    args = p.parse_args(argv)
    if args.smoke:
        args.n_envs, args.max_timesteps = 4, 20
        args.expert_iterations, args.expert_target = 2, 1e9
        args.batches_expert = args.batches_random = 2
        args.tok_steps, args.tok_clip_t, args.tok_batch = 20, 4, 4
        args.wm_steps = 20
        args.dream_updates, args.dream_timesteps = 4, 8
        args.dream_batch, args.eval_every, args.window = 8, 2, 1
    return args


# -------------------------------------------------------------------- models

def build_state_model(args, device, seed: int, **overrides) -> DynamicsWorldModel:
    """The proven state-vector recipe (examples/train_cartpole_pixels_dream_rl.py:
    287-294), its weights from `seed`."""
    kwargs = dict(
        dim=64, dim_latent=D_LAT, num_latent_tokens=N_LAT,
        num_spatial_tokens=4, max_steps=16, depth=2, time_block_every=2,
        attn_heads=4, attn_dim_head=16, num_discrete_actions=(2,),
        multi_token_pred_len=4, num_register_tokens=4,
        dim_state=4, dim_critic_state=4, predict_terminals=True,
        policy_entropy_weight=0.01, keep_reward_ema_stats=True,
        reward_range=(-args.max_timesteps * 1.2, args.max_timesteps * 1.2))
    with seeded_init(seed, device):
        return DynamicsWorldModel(**{**kwargs, **overrides}, device=device)


def pixel_model_kwargs(args) -> dict:
    """Same trunk, but latents come from the tokenizer: no state input, no
    asymmetric critic (pure pixels), action injection on so dreams are
    action-sensitive (examples/train_cartpole_pixels_dream_rl.py:300-315)."""
    return dict(
        dim=64, dim_latent=D_LAT, num_latent_tokens=N_LAT,
        num_spatial_tokens=4, max_steps=16, depth=2, time_block_every=2,
        attn_heads=4, attn_dim_head=16, num_discrete_actions=(2,),
        multi_token_pred_len=4, num_register_tokens=4,
        dim_state=None, dim_critic_state=None, predict_terminals=True,
        add_action_embed_to_spatial=True,
        # ~1/positive-rate: without it the terminal head converges to the
        # base rate (p_term 0.033 at TRUE terminal frames), dreams never
        # fail, the dream value saturates at the horizon ceiling, and the
        # policy plateaus at ~35 real return (measured)
        terminal_pos_weight=args.terminal_pos_weight,
        policy_entropy_weight=args.entropy_weight,
        keep_reward_ema_stats=True,
        reward_range=(-args.max_timesteps * 1.2, args.max_timesteps * 1.2))


def build_pixel_model(args, device, seed: int, **overrides) -> DynamicsWorldModel:
    with seeded_init(seed, device):
        return DynamicsWorldModel(**{**pixel_model_kwargs(args), **overrides}, device=device)


def build_tokenizer(args, device, **overrides) -> VideoTokenizer:
    """The reference pixel-CartPole tokenizer: 64x64 RGB, patch 8, causal
    conv3d + shifted patch tokenization, 2 flow decode steps, no LPIPS;
    sized to the proven WM latent space (4 tokens x 16 dims)
    (examples/train_cartpole_pixels_dream_rl.py:496-502), its weights from
    `args.seed + 21`."""
    kwargs = dict(
        dim=64, dim_latent=D_LAT, patch_size=8, image_height=FRAME_HW,
        image_width=FRAME_HW, channels=3, num_latent_tokens=N_LAT,
        encoder_depth=3, decoder_depth=3, time_block_every=2,
        attn_heads=4, attn_dim_head=16, decoder_flow_steps=2,
        use_causal_conv3d=True, use_shifted_patch_tokenization=True,
        lpips_loss_weight=0.0)
    with seeded_init(args.seed + 21, device):
        return VideoTokenizer(**{**kwargs, **overrides}, device=device)


def frames_to_video(frames: np.ndarray, device) -> torch.Tensor:
    """(b, t, h, w, c) uint8 -> (b, c, t, h, w) float32 in [0, 1] on `device`."""
    return torch.as_tensor(frames.transpose(0, 4, 1, 2, 3), device=device).float() / 255.0


# -------------------------------------------------------------------- phases

def expert_phase(args, work: Path, device, make_env) -> DynamicsWorldModel:
    """Phase 1: the expert from `work/expert_ckpt`, trained (further, with
    `--expert-extend`) where there is none. PPO on CartPole oscillates, so
    the best policy a held-out evaluation on a fresh env seed confirms is
    kept: the in-training window is a noisy overestimate while the policy
    moves (measured: window 82.1 at the stop, 53.8 collected after)."""
    expert_dir = work / 'expert_ckpt'
    loaded = (expert_dir / 'config.json').exists()
    if loaded:
        expert_model = load_model(expert_dir, DynamicsWorldModel, device=device)
        log(f'[expert] loaded checkpoint from {expert_dir}')
        if not args.expert_extend:
            return expert_model
    else:
        expert_model = build_state_model(args, device, args.seed)
    env = make_env(args.seed, False)
    sim = SimTrainer(expert_model, env, policy_lr=3e-4, value_lr=3e-4,
                     num_steps=args.num_denoise_steps, max_timesteps=args.max_timesteps,
                     update_epochs=4, dynamics_lr=1e-4, seed=args.seed, device=device)
    eval_interactor = EnvInteractor(expert_model, device=device)

    def held_out_eval(it):
        env_eval = make_env(args.seed + 777 + it, False)
        rets: list[float] = []
        for bi in range(2):
            exp = eval_interactor(env_eval, stream(args.seed + 555, 100 * it + bi, device=device),
                                  num_steps=args.num_denoise_steps,
                                  max_timesteps=args.max_timesteps)
            rets.extend(exp.episode_return.cpu().tolist())
        return float(np.mean(rets))

    best_ev, best_weights = -np.inf, None
    returns: list[float] = []
    for it in range(args.expert_iterations):
        experience, _ = sim.step()
        returns.extend(experience.episode_return.cpu().tolist())
        window = returns[-20:]
        avg = float(np.mean(window))
        if it % 5 == 0:
            log(f'[expert] iter {it}: avg return {avg:.1f}')
        if len(window) >= 20 and avg >= args.expert_target:
            ev = held_out_eval(it)
            log(f'[expert] window {avg:.1f} at iter {it}; held-out '
                f'eval {ev:.1f} (target {args.expert_target}, '
                f'best so far {best_ev:.1f})')
            if ev > best_ev:
                best_ev = ev
                best_weights = {k: v.detach().clone()
                                for k, v in expert_model.state_dict().items()}
            if ev >= args.expert_target:
                break
    if best_weights is not None:
        log(f'[expert] using best held-out policy ({best_ev:.1f})')
        expert_model.load_state_dict(best_weights)
    save_model(expert_dir, expert_model)
    log(f'[expert] saved checkpoint to {expert_dir}')
    return expert_model


def dataset_phase(args, work: Path, expert_model, device, make_env):
    """Phase 2: `work/frames_dataset.npz` from `--batches-expert` expert and
    `--batches-random` random batches on a recording env; the random
    collector acts through a fresh state model's policy (random at init)."""
    frames_cache = work / 'frames_dataset.npz'
    if frames_cache.exists():
        return
    T_fixed = args.max_timesteps + 1
    env = make_env(args.seed + 1000, True)
    rand_state_model = build_state_model(args, device, args.seed + 5)
    items: list[dict] = []

    def collect(model, n_batches, tag, seed):
        interactor = EnvInteractor(model, device=device)
        eps_returns = []
        for bi in range(n_batches):
            exp = interactor(env, stream(seed, bi, device=device),
                             num_steps=args.num_denoise_steps,
                             max_timesteps=args.max_timesteps)
            frames = pad_time(env.take_frames(), T_fixed)  # (n, T, 64, 64, 3) u8
            host = lambda t: t.cpu().numpy()
            items.append(dict(
                frames=frames,
                rewards=pad_time(host(exp.rewards), T_fixed),
                terminals=host(exp.terminals),
                discrete_actions=pad_time(host(exp.actions.discrete), T_fixed),
                lens=host(exp.lens)))
            eps_returns.extend(exp.episode_return.cpu().tolist())
        log(f'[dataset] {tag}: {n_batches * args.n_envs} episodes, '
            f'avg return {np.mean(eps_returns):.1f}')

    collect(expert_model, args.batches_expert, 'expert', args.seed + 100)
    collect(rand_state_model, args.batches_random, 'random', args.seed + 200)
    np.savez_compressed(
        frames_cache, n_items=len(items),
        **{f'{k}_{i}': item[k] for i, item in enumerate(items) for k in item})
    log(f'[dataset] cached {len(items)} batches to {frames_cache}')


def load_items(args, work: Path) -> list[dict]:
    """The cached dataset, with each item's `wm_lens`: the lens the world
    model trains on include the latched POST-termination frames. The env
    adapter latches a finished env's render, so frames[lens..] show the
    fallen pole with reward 0 — but with lens as-is every loss masks them
    out, and the world model learns "+1 reward forever" from episodes whose
    every VISIBLE frame paid +1 (measured: dream value saturated at the
    25-step ceiling for good and bad policies alike, real eval stuck at
    ~35). A few latched frames teach the reward head fallen->0 and the flow
    model that fallen is absorbing. Prompting and tokenizer clips keep the
    ORIGINAL lens (don't start dreams inside a fallen state)."""
    blob = np.load(work / 'frames_dataset.npz')
    n_items = int(blob['n_items'])
    items = [{k: blob[f'{k}_{i}'] for k in FRAME_KEYS} for i in range(n_items)]
    all_lens = np.concatenate([it['lens'] for it in items])
    log(f'[dataset] {n_items} batches, {len(all_lens)} episodes, '
        f'mean len {all_lens.mean():.1f}, frames '
        f'{sum(int(l) for l in all_lens)}')
    T_fixed = args.max_timesteps + 1
    for it in items:
        avail = int(it['lens'].max()) + 1          # snaps recorded per row
        ext = np.minimum(it['lens'] + args.latched_terminal_frames,
                         min(avail, T_fixed))
        it['wm_lens'] = np.where(it['terminals'], ext, it['lens'])
    return items


def tokenizer_phase(args, work: Path, items, rng, device) -> VideoTokenizer:
    """Phase 3: the tokenizer from `work/tokenizer_ckpt` (its EMA weights),
    trained on random clips of `--tok-clip-t` frames where there is none."""
    tok_dir = work / 'tokenizer_ckpt'
    T_fixed = args.max_timesteps + 1
    # valid (item, row, start) index for clip sampling
    clip_index = []
    for ii, it in enumerate(items):
        for r, ln in enumerate(it['lens']):
            n_frames = min(int(ln), T_fixed)
            for s in range(0, max(n_frames - args.tok_clip_t, 0) + 1):
                clip_index.append((ii, r, s))
    clip_index = np.asarray(clip_index, np.int64)
    log(f'[tokenizer] {len(clip_index)} clips of T={args.tok_clip_t}')

    def sample_clips(batch):
        rows = clip_index[rng.integers(0, len(clip_index), size=batch)]
        return frames_to_video(np.stack([
            items[ii]['frames'][r, s:s + args.tok_clip_t] for ii, r, s in rows]), device)

    if (tok_dir / 'config.json').exists():
        tokenizer = load_model(tok_dir, VideoTokenizer, device=device)
        log(f'[tokenizer] loaded checkpoint from {tok_dir}')
        return tokenizer

    tokenizer = build_tokenizer(args, device)
    sample_clips(2)   # the JAX recipe's init clips
    trainer = TokenizerTrainer(tokenizer, learning_rate=args.tok_lr, with_ema=True,
                               seed=args.seed, device=device)
    for step in range(args.tok_steps):
        loss, _ = trainer.train_on_batch(sample_clips(args.tok_batch))
        if step % 500 == 0 or step == args.tok_steps - 1:
            log(f'[tokenizer] step {step}: loss {float(loss):.4f}')
    tokenizer.load_state_dict({**tokenizer.state_dict(), **trainer.ts.model_ema()})
    save_model(tok_dir, tokenizer)
    log(f'[tokenizer] saved EMA checkpoint to {tok_dir}')

    # reconstruction sample for the evidence record
    try:
        import cv2

        sample = sample_clips(1)
        with torch.no_grad():
            recon = tokenizer.decode(tokenizer.encode(sample),
                                     generator=torch.Generator(device=device).manual_seed(0))
        orig = sample[0].cpu().numpy().transpose(1, 2, 3, 0)    # (t,h,w,c)
        rec = recon[0].float().cpu().numpy().transpose(1, 2, 3, 0)
        grid = np.concatenate([
            np.concatenate(list(orig), axis=1),
            np.concatenate(list(np.clip(rec, 0, 1)), axis=1)], axis=0)
        cv2.imwrite(str(work / 'tokenizer_recon.png'),
                    (grid[..., ::-1] * 255).astype(np.uint8))
        log(f'[tokenizer] recon grid -> {work / "tokenizer_recon.png"}')
    except (ImportError, OSError) as e:  # evidence only — never fail the run
        log(f'[tokenizer] recon grid failed: {e}')
    return tokenizer


def tokenize_phase(args, work: Path, items, tokenizer, device):
    """Phase 4: each item's `latents`, from `work/latents_dataset.npz` or
    the EMA tokenizer's encode of its frames."""
    latents_cache = work / 'latents_dataset.npz'
    if not latents_cache.exists():
        lat_items = []
        for ii, it in enumerate(items):
            with torch.no_grad():
                lat = tokenizer.encode(frames_to_video(it['frames'], device))
            lat_items.append(lat.float().cpu().numpy())
            if ii % 10 == 0:
                log(f'[tokenize] batch {ii}/{len(items)}')
        np.savez_compressed(latents_cache,
                            **{f'latents_{i}': lt for i, lt in enumerate(lat_items)})
        log(f'[tokenize] cached latents to {latents_cache}')
    lat_blob = np.load(latents_cache)
    for i, it in enumerate(items):
        it['latents'] = lat_blob[f'latents_{i}']
    log(f'[tokenize] latents ready: {items[0]["latents"].shape} per batch, '
        f'std {np.concatenate([i_["latents"] for i_ in items]).std():.3f}')


def world_model_phase(args, work: Path, items, rng, device) -> DynamicsWorldModel:
    """Phase 5: the world model from `work/wm_ckpt` (with the flags' RL
    settings), or trained offline on the items' latents, heads frozen."""
    wm_dir = work / 'wm_ckpt'
    if (wm_dir / 'config.json').exists():
        # RL-phase hyperparameters live on the model config but must track
        # the FLAGS, not the checkpoint
        saved = load_model(wm_dir, DynamicsWorldModel, device=device)
        model = DynamicsWorldModel(**{**saved.config,
                                      'policy_entropy_weight': args.entropy_weight,
                                      'terminal_pos_weight': args.terminal_pos_weight},
                                   device=device)
        model.load_state_dict(saved.state_dict())
        log(f'[wm] loaded checkpoint from {wm_dir} '
            f'(entropy weight {args.entropy_weight}, terminal pos weight '
            f'{args.terminal_pos_weight})')
        return model
    model = build_pixel_model(args, device, args.seed)
    updates = WorldModelUpdates(model, args.wm_lr, stream(args.seed + 7, device=device), rng)
    for step in range(args.wm_steps):
        wm_loss = updates(lambda: to_batch(items[rng.integers(len(items))], device,
                                           lens_key='wm_lens'))
        if step % 500 == 0 or step == args.wm_steps - 1:
            log(f'[wm] step {step}: loss {float(wm_loss):.3f}')
    save_model(wm_dir, model)
    log(f'[wm] saved checkpoint to {wm_dir}')
    return model


class DreamPhase:
    """Phases 6 and 7: heads-only PPO on dreams prompted from real latents
    (from the on-policy rounds' items half the time once there are any),
    evaluated every `--eval-every` updates on the pixel env through the
    tokenizer's streaming encode."""

    def __init__(self, args, work: Path, model, tokenizer, items, rng, device, make_pixel_env):
        self.args, self.work, self.model, self.items = args, work, model, items
        self.rng, self.device = rng, device
        self.fresh_items: list[dict] = []   # on-policy rounds, upweighted in fine-tuning
        self.make_pixel_env = make_pixel_env
        self.trainer = DreamTrainer(
            model,
            time_steps=args.dream_timesteps, num_steps=args.num_denoise_steps,
            batch_size=args.dream_batch, objective='ppo',
            policy_lr=args.policy_lr, value_lr=args.value_lr,
            update_epochs=args.ppo_epochs, prompt_fn=self.prompt_fn,
            generate_kwargs=dict(hard_terminals=False), seed=args.seed + 31, device=device)
        self.eval_env = make_pixel_env(args.seed + 9000)
        self.interactor = EnvInteractor(model, tokenizer=tokenizer, device=device)
        self.eval_history: list[float] = []
        self.update_no = 0

    def prompt_fn(self, generator):
        # on-policy rounds are prompt-relevant: draw from them half the time
        # once they exist
        pool = (self.fresh_items if self.fresh_items and self.rng.random() < 0.5
                else self.items)
        return prompt_window(pool[self.rng.integers(len(pool))], self.args.dream_batch,
                             self.args.prompt_len, self.rng, self.device)

    def rollout(self, env, path: int):
        return self.interactor(env, stream(self.args.seed + 31, path, device=self.device),
                               num_steps=self.args.num_denoise_steps,
                               max_timesteps=self.args.max_timesteps)

    def dream(self, budget: int) -> bool:
        """`budget` dream updates; -> whether the evaluations solved it."""
        args = self.args
        for _ in range(budget):
            self.update_no += 1
            _, out = self.trainer.step()
            if self.update_no % args.eval_every == 0:
                exp = self.rollout(self.eval_env, 10_000_000 + self.update_no)
                ret = float(exp.episode_return.float().mean())
                self.eval_history.append(ret)
                window = self.eval_history[-args.window:]
                avg = float(np.mean(window))
                log(f'[dream] update {self.update_no}: PIXEL eval return {ret:.1f} '
                    f'(window {avg:.1f}) H {float(out.stats["entropy"]):.2f} '
                    f'V {float(out.stats["mean_value"]):.1f}')
                (self.work / 'eval_history.json').write_text(json.dumps(self.eval_history))
                if len(window) >= args.window and avg >= args.target_return:
                    log(f'SOLVED FROM PIXELS IN IMAGINATION after {self.update_no} '
                        f'dream updates: eval return {avg:.1f} >= '
                        f'{args.target_return} (zero real-env policy updates; '
                        f'observations reach the policy only through the '
                        f'VideoTokenizer)')
                    return True
        return False

    def online_round(self, rnd: int):
        """Phase 7's round `rnd`: the dream policy collects (acting only;
        its streaming tokenizer latents ARE the dataset latents), then the
        world model is fine-tuned on the extended dataset, heads frozen, its
        trunk continuing from its current weights."""
        args, T_fixed = self.args, self.args.max_timesteps + 1
        collect_env = self.make_pixel_env(args.seed + 20_000 * rnd)
        rets = []
        for bi in range(args.online_collect_batches):
            exp = self.rollout(collect_env, 20_000_000 + 1000 * rnd + bi)
            host = lambda t: t.cpu().numpy()
            self.fresh_items.append(dict(
                latents=pad_time(host(exp.latents), T_fixed),
                rewards=pad_time(host(exp.rewards), T_fixed),
                terminals=host(exp.terminals),
                discrete_actions=pad_time(host(exp.actions.discrete), T_fixed),
                lens=host(exp.lens)))
            rets.extend(exp.episode_return.cpu().tolist())
        log(f'[online {rnd}] collected {args.online_collect_batches * args.n_envs} '
            f'episodes with the dream policy, avg return {np.mean(rets):.1f}')

        updates = WorldModelUpdates(self.model, args.wm_lr,
                                    stream(args.seed + 900 + rnd, device=self.device), self.rng)

        def sample_ft_batch():
            pool = self.fresh_items if self.rng.random() < 0.5 else self.items
            it = pool[self.rng.integers(len(pool))]
            # fresh (interactor-collected) items have no latched frames ->
            # no 'wm_lens'; fall back to lens
            return to_batch(it, self.device, lens_key='wm_lens' if 'wm_lens' in it else 'lens')

        for step in range(args.online_wm_steps):
            ft_loss = updates(sample_ft_batch)
            if step % 500 == 0 or step == args.online_wm_steps - 1:
                log(f'[online {rnd}] wm fine-tune step {step}: loss {float(ft_loss):.3f}')


def run(args, device, make_env, make_pixel_env) -> int:
    """The six phases (seven with `--online-rounds`), each cached in
    `--workdir`, stopping after `--stop-after`."""
    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    log(f'device: every model on {device}, the environment on the host')

    expert_model = expert_phase(args, work, device, make_env)
    if args.stop_after == 'expert':
        log('[stage] stop-after expert')
        return 0
    dataset_phase(args, work, expert_model, device, make_env)
    if args.stop_after == 'dataset':
        log('[stage] stop-after dataset')
        return 0
    items = load_items(args, work)
    rng = np.random.default_rng(args.seed)
    tokenizer = tokenizer_phase(args, work, items, rng, device)
    if args.stop_after == 'tokenizer':
        log('[stage] stop-after tokenizer')
        return 0
    tokenize_phase(args, work, items, tokenizer, device)
    if args.stop_after == 'tokenize':
        log('[stage] stop-after tokenize')
        return 0
    model = world_model_phase(args, work, items, rng, device)
    if args.stop_after == 'wm':
        log('[stage] stop-after wm')
        return 0

    phase = DreamPhase(args, work, model, tokenizer, items, rng, device, make_pixel_env)
    if phase.dream(args.dream_updates):
        return 0
    for rnd in range(1, args.online_rounds + 1):
        phase.online_round(rnd)
        if phase.dream(args.online_dream_updates):
            return 0
    final = (float(np.mean(phase.eval_history[-args.window:])) if phase.eval_history
             else 0.0)
    log(f'final pixel-dream eval avg {final:.1f} (random baseline ~22)')
    return 1


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    make_env = lambda seed, record: RenderingCartPoleAdapter(
        n_envs=args.n_envs, max_timesteps=args.max_timesteps, seed=seed, record=record)
    make_pixel_env = lambda seed: PixelCartPoleAdapter(
        n_envs=args.n_envs, max_timesteps=args.max_timesteps, seed=seed)
    return run(args, device, make_env, make_pixel_env)


if __name__ == '__main__':
    sys.exit(main())
