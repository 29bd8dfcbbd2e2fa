"""Mock environments for tests (reference `dreamer4/mocks.py`)."""
from __future__ import annotations

import numpy as np


class MockEnv:
    """Random-pixel env with probabilistic terminate/truncate; gym 5-tuple API.
    Vectorized when batch is not None."""

    def __init__(self, image_size=(32, 32), channels=3, num_actions=4, batch=None,
                 terminate_prob=0.1, truncate_prob=0.05, seed=0):
        self.image_size = image_size
        self.channels = channels
        self.num_actions = num_actions
        self.batch = batch
        self.terminate_prob = terminate_prob
        self.truncate_prob = truncate_prob
        self.rng = np.random.default_rng(seed)

    @property
    def is_vectorized(self):
        return self.batch is not None

    def _obs(self):
        h, w = self.image_size
        shape = (self.batch, self.channels, h, w) if self.is_vectorized else (self.channels, h, w)
        return self.rng.random(shape, dtype=np.float32)

    def reset(self, seed=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        return self._obs(), {}

    def step(self, action):
        b = self.batch if self.is_vectorized else ()
        shape = (self.batch,) if self.is_vectorized else ()
        reward = self.rng.random(shape, dtype=np.float32)
        terminated = self.rng.random(shape) < self.terminate_prob
        truncated = self.rng.random(shape) < self.truncate_prob
        if not self.is_vectorized:
            reward = float(reward)
            terminated = bool(terminated)
            truncated = bool(truncated)
        return self._obs(), reward, terminated, truncated, {}


class MockDictEnv(MockEnv):
    """Dict observations with image + proprio (reference MockDictEnv)."""

    def __init__(self, dim_proprio=4, **kwargs):
        super().__init__(**kwargs)
        self.dim_proprio = dim_proprio

    def _proprio(self):
        shape = (self.batch, self.dim_proprio) if self.is_vectorized else (self.dim_proprio,)
        return self.rng.standard_normal(shape).astype(np.float32)

    def reset(self, seed=None):
        obs, info = super().reset(seed=seed)
        return {'image': obs, 'proprio': self._proprio()}, info

    def step(self, action):
        obs, reward, terminated, truncated, info = super().step(action)
        return {'image': obs, 'proprio': self._proprio()}, reward, terminated, truncated, info


class MockStateEnv:
    """State-vector env (for the asymmetric-critic / state_to_latents path)."""

    def __init__(self, dim_state=4, num_actions=2, batch=None, max_steps=20, seed=0):
        self.dim_state = dim_state
        self.num_actions = num_actions
        self.batch = batch
        self.max_steps = max_steps
        self.rng = np.random.default_rng(seed)
        self._t = 0

    def _obs(self):
        shape = (self.batch, self.dim_state) if self.batch else (self.dim_state,)
        return self.rng.standard_normal(shape).astype(np.float32)

    def reset(self, seed=None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        self._t += 1
        shape = (self.batch,) if self.batch else ()
        reward = self.rng.random(shape, dtype=np.float32)
        terminated = self.rng.random(shape) < 0.05
        truncated = np.full(shape, self._t >= self.max_steps)
        if not self.batch:
            reward = float(reward)
            terminated = bool(terminated)
            truncated = bool(truncated)
        return self._obs(), reward, terminated, truncated, {}
