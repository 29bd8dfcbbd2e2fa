"""CartPole online RL through the dynamics world model (counterpart of
`examples/train_cartpole_with_dynamics_rl.py`): state-vector CartPole
(gymnasium), a `DynamicsWorldModel` with `dim_state` -> latents and an
asymmetric critic over the raw state, the online `SimTrainer` loop
(rollout -> dynamics step -> PPO/PMPO/SPO epochs), stopping when the
20-episode average return reaches `--target-return` (the reference gate
is 70.0 at max_timesteps 150).

Streams (JAX -> here): the initial weights, `PRNGKey(seed)` -> the global
generator seeded with `--seed` inside `common.seeded_init`; iteration
`it`'s `fold_in(PRNGKey(seed), it)` -> `SimTrainer(seed=--seed)`, whose
rollouts draw in turn from one generator seeded with the seed and whose
dynamics steps draw from one seeded with seed + 13; the trainer's host
draws (shortcut flags, minibatch permutations), numpy `default_rng(0)` in
the JAX recipe (the trainer's default) -> `default_rng(--seed)`.

gymnasium must be installed: the adapter imports it, with no substitute.

Usage: python -m dreamer4_torch.examples.train_cartpole_with_dynamics_rl --target-return 70
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..device import resolve_device
from ..models.world_model import DynamicsWorldModel
from ..train.trainers import SimTrainer
from .common import seeded_init


class GymnasiumVectorAdapter:
    """N parallel gymnasium envs as one batched env with dict state obs.
    Finished envs latch (zero reward, terminated=True) until the batch
    rollout ends — the interactor's `lens` bookkeeping masks them."""

    def __init__(self, name: str = 'CartPole-v1', n_envs: int = 16,
                 max_timesteps: int = 150, seed: int = 0):
        import gymnasium

        self.envs = [gymnasium.make(name) for _ in range(n_envs)]
        self.n_envs = n_envs
        self.max_timesteps = max_timesteps
        self._seed = seed

    @property
    def dim_state(self):
        return int(np.prod(self.envs[0].observation_space.shape))

    @property
    def num_actions(self):
        return int(self.envs[0].action_space.n)

    def reset(self, seed=None):
        base = seed if seed is not None else self._seed
        self._seed += self.n_envs
        obs = []
        for i, env in enumerate(self.envs):
            o, _ = env.reset(seed=base + i)
            obs.append(np.asarray(o, np.float32))
        self._done = np.zeros((self.n_envs,), bool)
        self._last_obs = np.stack(obs)
        return {'state': self._last_obs.copy()}, {}

    def step(self, actions):
        actions = np.asarray(actions).reshape(self.n_envs)
        rewards = np.zeros((self.n_envs,), np.float32)
        terminated = np.zeros((self.n_envs,), bool)
        truncated = np.zeros((self.n_envs,), bool)
        for i, env in enumerate(self.envs):
            if self._done[i]:
                terminated[i] = True
                continue
            o, r, term, trunc, _ = env.step(int(actions[i]))
            self._last_obs[i] = np.asarray(o, np.float32)
            rewards[i] = r
            terminated[i] = term
            truncated[i] = trunc
            self._done[i] |= term or trunc
        return ({'state': self._last_obs.copy()}, rewards, terminated, truncated, {})


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--target-return', type=float, default=70.0)
    p.add_argument('--max-timesteps', type=int, default=150)
    p.add_argument('--max-iterations', type=int, default=300)
    p.add_argument('--objective', choices=('ppo', 'pmpo', 'spo'), default='ppo')
    p.add_argument('--dim', type=int, default=64)
    p.add_argument('--depth', type=int, default=2)
    p.add_argument('--policy-lr', type=float, default=3e-4)
    p.add_argument('--value-lr', type=float, default=3e-4)
    p.add_argument('--update-epochs', type=int, default=4)
    p.add_argument('--rollouts-per-step', type=int, default=1)
    p.add_argument('--n-envs', type=int, default=16)
    p.add_argument('--dynamics-lr', type=float, default=1e-4)
    p.add_argument('--delight', action='store_true',
                   help='enable delight gating (measured to slow CartPole: the '
                        'gate sigmoid(-logpi*A) dampens positive-advantage '
                        'updates ~3x for near-uniform policies; without it the '
                        '70-return gate is hit in ~9 iterations, with it the '
                        'policy plateaus near 35)')
    p.add_argument('--entropy-weight', type=float, default=0.01)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--window', type=int, default=20)
    p.add_argument('--device', type=str, default=None,
                   help='torch device (default: the CUDA card; "cpu" runs on the CPU)')
    return p.parse_args(argv)


def build_model(args, env, device, **overrides) -> DynamicsWorldModel:
    """The recipe's world model (examples/train_cartpole_with_dynamics_rl.py:
    108-125), its weights from `args.seed`; `overrides` replace keywords."""
    kwargs = dict(
        dim=args.dim,
        dim_latent=16,
        num_latent_tokens=4,
        num_spatial_tokens=4,
        max_steps=16,
        depth=args.depth,
        time_block_every=2,
        attn_heads=4,
        attn_dim_head=16,
        num_discrete_actions=(env.num_actions,),
        multi_token_pred_len=4,
        num_register_tokens=4,
        dim_state=env.dim_state,
        dim_critic_state=env.dim_state,
        predict_terminals=True,
        use_delight_gating=args.delight,
        policy_entropy_weight=args.entropy_weight,
        keep_reward_ema_stats=True,
        reward_range=(-args.max_timesteps * 1.2, args.max_timesteps * 1.2),
    )
    with seeded_init(args.seed, device):
        return DynamicsWorldModel(**{**kwargs, **overrides}, device=device)


def build_trainer(args, model, env, device) -> SimTrainer:
    return SimTrainer(model, env,
                      objective=args.objective,
                      policy_lr=args.policy_lr, value_lr=args.value_lr,
                      num_steps=4, max_timesteps=args.max_timesteps,
                      num_rollouts_per_step=args.rollouts_per_step,
                      update_epochs=args.update_epochs,
                      dynamics_lr=args.dynamics_lr, seed=args.seed, device=device)


def train(args, env, device) -> int:
    """The online loop until the gate or `--max-iterations`; 0 when the
    window average reaches `--target-return`, else 1."""
    trainer = build_trainer(args, build_model(args, env, device), env, device)
    returns = []
    t0 = time.time()
    for it in range(args.max_iterations):
        experience, _ = trainer.step()
        returns.extend(experience.episode_return.cpu().tolist())

        window = returns[-args.window:]
        avg = float(np.mean(window))
        if it % 5 == 0:
            print(f'iter {it}: avg return (last {len(window)}) = {avg:.1f} '
                  f'[{time.time() - t0:.0f}s]', flush=True)
        if len(window) >= args.window and avg >= args.target_return:
            print(f'SOLVED at iteration {it}: avg return {avg:.1f} >= {args.target_return}')
            return 0

    print(f'did not reach target_return={args.target_return}; final avg '
          f'{float(np.mean(returns[-args.window:])):.1f}')
    return 1


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    env = GymnasiumVectorAdapter(n_envs=args.n_envs, max_timesteps=args.max_timesteps,
                                 seed=args.seed)
    return train(args, env, device)


if __name__ == '__main__':
    sys.exit(main())
