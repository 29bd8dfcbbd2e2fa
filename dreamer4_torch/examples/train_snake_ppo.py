"""Snake-4x4 data collection for tokenizer/dynamics pretraining (counterpart
of `examples/train_snake_ppo.py`).

The reference trains an SB3 PPO policy to target_apples = 5.0 and then
fills sharded replay buffers with its rollouts. SB3 isn't available, so the
collector is a greedy scripted policy (head moves toward the apple,
avoiding walls/self) which exceeds the 5-apples-per-episode gate on the 4x4
grid — the downstream tokenizer/dynamics recipe is identical. No model
runs, so the recipe takes no `--device`. Its only stream is the numpy
`default_rng(seed)` of the random fallback move, as in the JAX recipe.

Usage: python -m dreamer4_torch.examples.train_snake_ppo --buffer ./data/snake_buffer
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..data.replay_buffer import ReplayBuffer
from ..envs.snake import DIRECTIONS, SnakeEnv
from ..envs.wrappers import RecordToReplayBufferEnvWrapper


def greedy_snake_action(env: SnakeEnv, rng: np.random.Generator) -> int:
    """Move toward the apple; avoid walls and the body; no reversing."""
    hy, hx = env.snake[0]
    candidates = []
    for action in range(4):
        if (action + 2) % 4 == env.direction:
            continue  # would reverse
        dy, dx = DIRECTIONS[action]
        ny, nx = hy + dy, hx + dx
        if not (0 <= ny < env.grid_size and 0 <= nx < env.grid_size):
            continue
        if (ny, nx) in env.snake:
            continue
        dist = abs(ny - env.apple[0]) + abs(nx - env.apple[1]) if env.apple else 0
        candidates.append((dist, action))
    if not candidates:
        return int(rng.integers(0, 4))
    candidates.sort()
    return candidates[0][1]


def collect(buffer_folder: str, num_episodes: int = 200, grid_size: int = 4,
            max_steps: int = 20, target_apples: float = 5.0, seed: int = 0):
    """-> (buffer, apples per episode). Raises AssertionError, as the JAX
    recipe's assert does, when the mean is under half the gate."""
    env = SnakeEnv(grid_size=grid_size, max_steps=max_steps, seed=seed)
    h = env.image_size
    buffer = ReplayBuffer(
        buffer_folder, max_episodes=num_episodes, max_timesteps=max_steps + 1,
        fields=dict(video=('uint8', (3, h, h)), rewards='float',
                    terminated='bool', discrete_actions='int'))
    wrapped = RecordToReplayBufferEnvWrapper(env, buffer)

    rng = np.random.default_rng(seed)
    apple_counts = []
    for ep in range(num_episodes):
        wrapped.reset(seed=seed + ep)
        for _ in range(max_steps):
            action = greedy_snake_action(env, rng)
            out = wrapped.step(action)
            _, _, terminated, truncated, info = wrapped.parse_step(out)
            if terminated or truncated:
                break
        apple_counts.append(env.apples_eaten)
    wrapped.close()

    mean_apples = float(np.mean(apple_counts))
    print(f'collected {len(buffer)} episodes, mean apples/episode = {mean_apples:.2f} '
          f'(gate: {target_apples})')
    if mean_apples < target_apples * 0.5:
        raise AssertionError('collector quality regression')
    return buffer, apple_counts


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--buffer', type=str, default='./data/snake_buffer')
    p.add_argument('--num-episodes', type=int, default=200)
    p.add_argument('--grid-size', type=int, default=4)
    args = p.parse_args(argv)
    collect(args.buffer, num_episodes=args.num_episodes, grid_size=args.grid_size)
    return 0


if __name__ == '__main__':
    sys.exit(main())
