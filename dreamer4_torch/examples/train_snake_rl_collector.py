"""Snake-4x4 collector trained by the framework's OWN RL (counterpart of
`examples/train_snake_rl_collector.py`).

The reference trains an SB3 PPO policy on raw Snake pixels with SHAPED
rewards (collision -10, apple +5, aliveness -0.01), stops as soon as ONE
episode reaches `target_apples = 5.0`, then fills replay buffers with its
rollouts. Here the collection policy is LEARNED, through `SimTrainer`
(interact -> PPO, full-model with `--trunk-lr`) on the flattened grid
observation, with the reference's reward shaping and gate semantics (both
overridable: `--gate window-avg` gives the stricter rolling-average gate,
and the shaping flags can be zeroed for the sparse +1 task).

Phase 1 (`train_collector`): online RL until the gate passes (apples
         tracked from env info, not returns — shaped returns no longer
         count apples).
Phase 2 (`collect`): the learned policy fills a ReplayBuffer with (video,
         rewards, terminated, discrete_actions) episodes — the same schema
         the tokenizer/dynamics recipe consumes.

Streams (JAX -> here): the initial weights, `PRNGKey(seed)` -> the global
generator seeded with `--seed` inside `common.seeded_init`; phase 1's
`fold_in(PRNGKey(seed), it)` -> `SimTrainer(seed=--seed)` (rollouts from
one generator seeded with the seed, dynamics steps from seed + 13, host
draws from numpy `default_rng(seed)`, which is `default_rng(0)` in JAX);
phase 2's `fold_in(PRNGKey(seed + 77), batch)` -> `stream(seed + 77,
batch)`. The environments are the JAX recipe's, seeded alike.

Usage: python -m dreamer4_torch.examples.train_snake_rl_collector --buffer ./data/snake_buffer_rl
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from ..data.replay_buffer import ReplayBuffer
from ..device import resolve_device
from ..envs.interact import EnvInteractor
from ..envs.snake import SnakeEnv
from ..models.world_model import DynamicsWorldModel
from ..train.checkpoint import load_model, save_model
from ..train.trainers import SimTrainer
from .common import seeded_init, stream

T0 = time.time()


def log(msg):
    print(f'[{time.time() - T0:6.0f}s] {msg}', flush=True)


class SnakeVectorAdapter:
    """N parallel SnakeEnvs as one batched env. Observation = the grid-scale
    render flattened to a state vector (the reference's SB3 policy also reads
    the raw grid image); 2x-scale frames are kept in a side buffer for the
    collection phase's video field."""

    def __init__(self, n_envs=16, grid_size=4, max_steps=20, seed=0, record=False,
                 apple_reward=1.0, collision_penalty=0.0, aliveness_penalty=0.0):
        self.envs = [SnakeEnv(grid_size=grid_size, max_steps=max_steps,
                              image_size=grid_size, seed=seed + i,
                              apple_reward=apple_reward,
                              collision_penalty=collision_penalty,
                              aliveness_penalty=aliveness_penalty)
                     for i in range(n_envs)]
        self.big = [SnakeEnv(grid_size=grid_size, max_steps=max_steps,
                             image_size=2 * grid_size, seed=0)
                    for _ in range(n_envs)] if record else None
        self.n_envs = n_envs
        self.grid_size = grid_size
        self.max_steps = max_steps
        self._seed = seed
        self.record = record
        self.frame_log: list[np.ndarray] = []
        # apples of every episode that has ENDED, in completion order —
        # with shaped rewards the episode return no longer equals the
        # apple count, so the gate reads this instead
        self.finished_apples: list[int] = []
        # per-env apple count of the episode that last finished in that
        # slot (row-aligned with the interactor's batch rows, unlike the
        # completion-ordered list above)
        self.last_episode_apples = np.zeros((n_envs,), np.int64)

    @property
    def dim_state(self):
        return 3 * self.grid_size * self.grid_size

    def _state(self):
        return np.stack([e.render().reshape(-1) for e in self.envs]).astype(np.float32)

    def _snap(self):
        if self.record:
            # re-render each env at 2x for the stored video (same state,
            # bigger canvas — SnakeEnv.render is a pure function of state)
            frames = []
            for e, b in zip(self.envs, self.big):
                b.snake, b.direction, b.apple = list(e.snake), e.direction, e.apple
                frames.append((b.render() * 255).astype(np.uint8))
            self.frame_log.append(np.stack(frames))

    def reset(self, seed=None):
        base = seed if seed is not None else self._seed
        self._seed += self.n_envs
        for i, env in enumerate(self.envs):
            env.reset(seed=base + i)
        self._done = np.zeros((self.n_envs,), bool)
        self.frame_log = []
        self._snap()
        return {'state': self._state()}, {}

    def step(self, actions):
        actions = np.asarray(actions).reshape(self.n_envs)
        rewards = np.zeros((self.n_envs,), np.float32)
        terminated = np.zeros((self.n_envs,), bool)
        truncated = np.zeros((self.n_envs,), bool)
        for i, env in enumerate(self.envs):
            if self._done[i]:
                terminated[i] = True
                continue
            _, r, term, trunc, info = env.step(int(actions[i]))
            rewards[i] = r
            terminated[i] = term
            truncated[i] = trunc
            if (term or trunc) and not self._done[i]:
                self.finished_apples.append(int(info['apples']))
                self.last_episode_apples[i] = int(info['apples'])
            self._done[i] |= term or trunc
        self._snap()
        return {'state': self._state()}, rewards, terminated, truncated, {}

    def take_frames(self) -> np.ndarray:
        frames = np.stack(self.frame_log, axis=1)  # (n, steps+1, 3, H, W)
        self.frame_log = []
        return frames


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--buffer', type=str, default='./data/snake_buffer_rl')
    p.add_argument('--grid-size', type=int, default=4)
    p.add_argument('--max-steps', type=int, default=20)
    p.add_argument('--target-apples', type=float, default=5.0)
    p.add_argument('--max-iterations', type=int, default=600)
    p.add_argument('--n-envs', type=int, default=16)
    p.add_argument('--num-episodes', type=int, default=200,
                   help='episodes to collect after the gate')
    p.add_argument('--policy-lr', type=float, default=3e-4)
    p.add_argument('--value-lr', type=float, default=3e-4)
    p.add_argument('--dynamics-lr', type=float, default=1e-4)
    p.add_argument('--rollouts-per-step', type=int, default=1,
                   help='env batches per PPO update — sparse-reward Snake '
                        'needs more transitions per update than CartPole')
    p.add_argument('--trunk-lr', type=float, default=1e-4,
                   help='full-model RL rate: PPO gradients reach the trunk, '
                        'like the reference SB3 policy trains its CNN '
                        'features from the RL signal (0 disables — measured '
                        'flat at 0.15 apples after 2k heads-only updates)')
    p.add_argument('--update-epochs', type=int, default=4)
    p.add_argument('--entropy-weight', type=float, default=0.01)
    p.add_argument('--window', type=int, default=20)
    # the reference trains its SB3 policy on SHAPED rewards (collision -10,
    # apple +5, aliveness -0.01) and stops as soon as ONE episode reaches
    # target_apples — not on a window average. Defaults mirror that.
    p.add_argument('--apple-reward', type=float, default=5.0)
    p.add_argument('--collision-penalty', type=float, default=-10.0)
    p.add_argument('--aliveness-penalty', type=float, default=-0.01)
    p.add_argument('--gate', choices=('episode', 'window-avg'), default='episode',
                   help="'episode': reference semantics — a single episode "
                        "reaching target_apples passes; 'window-avg': the "
                        "stricter rolling-average gate")
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--checkpoint', type=str, default='',
                   help='save/reuse the trained collector policy here')
    p.add_argument('--device', type=str, default=None,
                   help='torch device (default: the CUDA card; "cpu" runs on the CPU)')
    return p.parse_args(argv)


def make_env(args, seed: int, record: bool = False) -> SnakeVectorAdapter:
    return SnakeVectorAdapter(n_envs=args.n_envs, grid_size=args.grid_size,
                              max_steps=args.max_steps, seed=seed, record=record,
                              apple_reward=args.apple_reward,
                              collision_penalty=args.collision_penalty,
                              aliveness_penalty=args.aliveness_penalty)


def build_model(args, env, device, **overrides) -> DynamicsWorldModel:
    """The recipe's world model (examples/train_snake_rl_collector.py:
    190-199), its weights from `args.seed`."""
    kwargs = dict(
        dim=64, dim_latent=16, num_latent_tokens=4, num_spatial_tokens=4,
        max_steps=16, depth=2, time_block_every=2, attn_heads=4,
        attn_dim_head=16, num_discrete_actions=(4,), multi_token_pred_len=4,
        num_register_tokens=4, dim_state=env.dim_state,
        dim_critic_state=env.dim_state, predict_terminals=True,
        policy_entropy_weight=args.entropy_weight, keep_reward_ema_stats=True,
        reward_range=(min(args.collision_penalty, -2.0) - 2.0,
                      2.0 + args.apple_reward * (args.grid_size ** 2)))
    with seeded_init(args.seed, device):
        return DynamicsWorldModel(**{**kwargs, **overrides}, device=device)


def gate(finished_apples: list[int], args) -> tuple[bool, float, int, int]:
    """-> (passed, window avg, window best, best ever) after an iteration.
    Reference semantics ('episode'): the FIRST episode ever to reach
    target_apples passes — a running max over every finished episode, not
    over the rolling window (an iteration can finish more than `window`
    episodes, evicting a qualifying one before the check); 'window-avg'
    needs a full window whose mean reaches it."""
    window = finished_apples[-args.window:]
    avg = float(np.mean(window)) if window else 0.0
    best = max(window) if window else 0
    best_ever = max(finished_apples) if finished_apples else 0
    if args.gate == 'episode':
        return best_ever >= args.target_apples, avg, best, best_ever
    return len(window) >= args.window and avg >= args.target_apples, avg, best, best_ever


def train_collector(args, env: SnakeVectorAdapter, device):
    """Phase 1: -> (model, iteration the gate passed at, or None)."""
    model = build_model(args, env, device)
    trainer = SimTrainer(model, env, objective='ppo',
                         policy_lr=args.policy_lr, value_lr=args.value_lr,
                         rl_trunk_lr=args.trunk_lr or None,
                         num_steps=4, max_timesteps=args.max_steps,
                         num_rollouts_per_step=args.rollouts_per_step,
                         update_epochs=args.update_epochs,
                         dynamics_lr=args.dynamics_lr, seed=args.seed, device=device)
    for it in range(args.max_iterations):
        trainer.step()
        passed, avg, best, best_ever = gate(env.finished_apples, args)
        if it % 10 == 0:
            window = env.finished_apples[-args.window:]
            log(f'[rl] iter {it}: apples/episode (last {len(window)}) '
                f'avg {avg:.2f}, best {best}')
        if passed:
            if args.gate == 'episode':
                log(f'[rl] GATE REACHED at iteration {it}: an episode ate '
                    f'{best_ever} apples >= {args.target_apples} (reference '
                    f'semantics; window avg {avg:.2f})')
            else:
                log(f'[rl] GATE REACHED at iteration {it}: window avg '
                    f'{avg:.2f} >= {args.target_apples}')
            return model, it
    w = env.finished_apples[-args.window:]
    log(f'[rl] gate NOT reached: final window avg '
        f'{float(np.mean(w)) if w else 0.0:.2f}, '
        f'best {max(w) if w else 0}')
    return model, None


def collect(args, model: DynamicsWorldModel, record_env: SnakeVectorAdapter,
            device) -> list[float]:
    """Phase 2: the learned policy's episodes into `args.buffer`; -> apples
    per collected episode."""
    h = 2 * args.grid_size
    buffer = ReplayBuffer(
        args.buffer, max_episodes=args.num_episodes,
        max_timesteps=args.max_steps + 1,
        fields=dict(video=('uint8', (3, h, h)), rewards='float',
                    terminated='bool', discrete_actions='int'))
    interactor = EnvInteractor(model, device=device)
    collected, apple_counts = 0, []
    batch_idx = 0
    while collected < args.num_episodes:
        exp = interactor(record_env, stream(args.seed + 77, batch_idx, device=device),
                         num_steps=4, max_timesteps=args.max_steps)
        frames = record_env.take_frames()
        lens = exp.lens.cpu().numpy()
        terminals = exp.terminals.cpu().numpy()
        acts = exp.actions.discrete.cpu().numpy()
        rews = exp.rewards.cpu().numpy()
        batch_idx += 1
        for row in range(frames.shape[0]):
            if collected >= args.num_episodes:
                break
            n = int(lens[row])
            with buffer.one_episode():
                for t in range(n):
                    buffer.store(
                        video=frames[row, t],
                        rewards=float(rews[row, t]),
                        terminated=bool(terminals[row]) and t == n - 1,
                        discrete_actions=int(acts[row, t, 0]))
            collected += 1
            # apples from the env's exact counter (row-aligned), not from
            # thresholding shaped rewards (which breaks when the shaping
            # flags are zeroed, e.g. --apple-reward 0)
            apple_counts.append(float(record_env.last_episode_apples[row]))

    mean_apples = float(np.mean(apple_counts))
    log(f'collected {len(buffer)} episodes with the LEARNED policy, '
        f'mean apples/episode = {mean_apples:.2f} (gate: {args.target_apples})')
    return apple_counts


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    env = make_env(args, args.seed)
    ckpt_dir = Path(args.checkpoint) if args.checkpoint else None
    if ckpt_dir is not None and (ckpt_dir / 'config.json').exists():
        model = load_model(ckpt_dir, DynamicsWorldModel, device=device)
        log(f'[rl] loaded collector policy from {ckpt_dir}')
    else:
        model, gate_iteration = train_collector(args, env, device)
        if gate_iteration is None:
            return 1
        if ckpt_dir is not None:  # only a gate-passing policy is worth keeping
            save_model(ckpt_dir, model)
            log(f'[rl] saved collector policy to {ckpt_dir}')
    collect(args, model, make_env(args, args.seed + 10_000, record=True), device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
