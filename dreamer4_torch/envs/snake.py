"""Snake environment (a copy of `dreamer4_tpu/envs/snake.py`) — the toy
workload for the end-to-end recipe (reference `web_env/env.py:3-101`): numpy
grid snake with directional head rendering, gym 5-tuple API. Used by the Snake-4x4 quality gate
(`train_snake_ppo.py`)."""
from __future__ import annotations

import numpy as np

# action -> (dy, dx): up, right, down, left
DIRECTIONS = np.array([[-1, 0], [0, 1], [1, 0], [0, -1]])


class SnakeEnv:
    num_actions = 4

    def __init__(self, grid_size: int = 4, max_steps: int = 20, image_size: int | None = None,
                 seed: int = 0, apple_reward: float = 1.0,
                 collision_penalty: float = 0.0, aliveness_penalty: float = 0.0):
        """Reward shaping mirrors the reference env's knobs
        (`train_snake_ppo.py:266-269` passes collision_penalty=-10,
        apple_reward=5, aliveness_penalty=-0.01 into its SnakeEnv); the
        defaults here keep the original sparse +1-per-apple behavior."""
        self.grid_size = grid_size
        self.max_steps = max_steps
        self.image_size = image_size if image_size is not None else grid_size * 2
        self.rng = np.random.default_rng(seed)
        self.apple_reward = apple_reward
        self.collision_penalty = collision_penalty
        self.aliveness_penalty = aliveness_penalty

    def _place_apple(self):
        free = [(y, x) for y in range(self.grid_size) for x in range(self.grid_size)
                if (y, x) not in self.snake]
        if not free:
            return None
        return free[int(self.rng.integers(0, len(free)))]

    def reset(self, seed=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        c = self.grid_size // 2
        self.snake = [(c, c)]
        self.direction = 1
        self.apple = self._place_apple()
        self.steps = 0
        self.apples_eaten = 0
        return self.render(), {}

    def render(self) -> np.ndarray:
        """(3, H, W) float image: snake green, head white-ish directional,
        apple red."""
        g = self.grid_size
        img = np.zeros((3, g, g), np.float32)
        for y, x in self.snake:
            img[1, y, x] = 1.0
        hy, hx = self.snake[0]
        img[:, hy, hx] = [0.5, 1.0, 0.5 + 0.125 * self.direction]
        if self.apple is not None:
            ay, ax = self.apple
            img[0, ay, ax] = 1.0
        if self.image_size != g:
            scale = self.image_size // g
            img = np.repeat(np.repeat(img, scale, axis=1), scale, axis=2)
        return img

    def step(self, action: int):
        action = int(action)
        # disallow reversing
        if (action + 2) % 4 != self.direction:
            self.direction = action

        dy, dx = DIRECTIONS[self.direction]
        hy, hx = self.snake[0]
        ny, nx = hy + dy, hx + dx

        self.steps += 1
        terminated = False
        reward = self.aliveness_penalty

        out_of_bounds = not (0 <= ny < self.grid_size and 0 <= nx < self.grid_size)
        hits_self = (ny, nx) in self.snake
        if out_of_bounds or hits_self:
            terminated = True
            reward = self.collision_penalty
        else:
            self.snake.insert(0, (ny, nx))
            if self.apple is not None and (ny, nx) == self.apple:
                reward = self.apple_reward
                self.apples_eaten += 1
                self.apple = self._place_apple()
                if self.apple is None:
                    terminated = True  # board full — win
            else:
                self.snake.pop()

        truncated = self.steps >= self.max_steps and not terminated
        return self.render(), reward, terminated, truncated, {'apples': self.apples_eaten}
