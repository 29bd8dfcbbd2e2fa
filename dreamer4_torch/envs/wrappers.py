"""Environment record wrappers (host-side; a copy of
`dreamer4_tpu/envs/wrappers.py`).

Equivalents of the reference `env.py:37-349`:
- BaseRecordEnvWrapper: robust 1-5-tuple step parsing, image extraction,
  innermost-wrapper injection
- RecordToFolderEnvWrapper: per-episode .npy (+frames) dumps
- RecordToReplayBufferEnvWrapper: streams transitions into a ReplayBuffer
- ActionTransformWrapper: action rescale + clip for bounded distributions
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np

from ..data.replay_buffer import ReplayBuffer


def extract_image(obs) -> np.ndarray | None:
    """Pull an image out of an observation (reference `env.py:66-105`)."""
    if isinstance(obs, dict):
        obs = obs.get('image', obs.get('pixels'))
        if obs is None:
            return None
    obs = np.asarray(obs)
    if obs.ndim < 3:
        return None
    if obs.dtype == np.uint8:
        obs = obs.astype(np.float32) / 255.0
    if obs.shape[-1] in (1, 3) and obs.shape[0] not in (1, 3):
        obs = np.moveaxis(obs, -1, 0)  # HWC -> CHW
    return obs.astype(np.float32)


class BaseEnvWrapper:
    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    def wrap_innermost(self, wrapper_cls, **kwargs):
        """Inject a wrapper around the innermost env (reference
        `env.py:141-153`)."""
        inner = self
        while isinstance(getattr(inner, 'env', None), BaseEnvWrapper):
            inner = inner.env
        inner.env = wrapper_cls(inner.env, **kwargs)
        return self

    @staticmethod
    def parse_step(step_out):
        """1-5 tuple -> (obs, reward, terminated, truncated, info)."""
        if not isinstance(step_out, tuple):
            return step_out, 0.0, False, False, {}
        n = len(step_out)
        obs = step_out[0]
        reward = step_out[1] if n >= 2 else 0.0
        terminated = step_out[2] if n >= 3 else False
        truncated = step_out[3] if n >= 4 else False
        info = step_out[4] if n >= 5 else {}
        return obs, reward, terminated, truncated, info


class ActionTransformWrapper(BaseEnvWrapper):
    """Transform (and optionally clip) actions before env.step (reference
    `env.py:314-349`)."""

    def __init__(self, env, transform_fn: Callable, clip: tuple[float, float] | None = None):
        super().__init__(env)
        self.transform_fn = transform_fn
        self.clip = clip

    def reset(self, **kwargs):
        return self.env.reset(**kwargs)

    def step(self, action):
        action = self.transform_fn(action)
        if self.clip is not None:
            lo, hi = self.clip
            if isinstance(action, tuple):
                d, c = action
                action = (d, np.clip(c, lo, hi))
            else:
                action = np.clip(action, lo, hi)
        return self.env.step(action)


class RecordToReplayBufferEnvWrapper(BaseEnvWrapper):
    """Streams each episode into a ReplayBuffer (reference `env.py:279-312`)."""

    def __init__(self, env, buffer: ReplayBuffer):
        super().__init__(env)
        self.buffer = buffer
        self._episode_ctx = None
        self._pending = None

    def _begin_episode(self):
        self._episode_ctx = self.buffer.one_episode()
        self._episode_ctx.__enter__()

    def _end_episode(self):
        if self._episode_ctx is not None:
            self._episode_ctx.__exit__(None, None, None)
            self._episode_ctx = None

    def reset(self, **kwargs):
        self._end_episode()
        out = self.env.reset(**kwargs)
        obs = out[0] if isinstance(out, tuple) else out
        self._begin_episode()
        self._pending = obs
        return out

    def step(self, action):
        out = self.env.step(action)
        obs, reward, terminated, truncated, info = self.parse_step(out)

        record = {}
        image = extract_image(self._pending)
        if image is not None and 'video' in self.buffer.fields:
            dtype = self.buffer.fields['video'][0]
            record['video'] = ((image * 255).astype(np.uint8)
                               if dtype == np.uint8 else image)
        if 'rewards' in self.buffer.fields:
            record['rewards'] = float(reward)
        if 'terminated' in self.buffer.fields:
            record['terminated'] = bool(terminated)
        if 'discrete_actions' in self.buffer.fields:
            record['discrete_actions'] = (action[0] if isinstance(action, tuple) else action)
        if 'continuous_actions' in self.buffer.fields:
            record['continuous_actions'] = (action[1] if isinstance(action, tuple) else action)
        if isinstance(self._pending, dict) and 'proprio' in self._pending \
                and 'proprio' in self.buffer.fields:
            record['proprio'] = self._pending['proprio']

        self.buffer.store(**record)
        self._pending = obs

        if terminated or truncated:
            self._end_episode()
        return out

    def close(self):
        self._end_episode()
        if hasattr(self.env, 'close'):
            self.env.close()


class RecordToFolderEnvWrapper(BaseEnvWrapper):
    """Per-episode episode dumps: frames (.npy lossless, or .mp4/.avi via
    `video_format`) + actions + rewards + terminated sidecars (reference
    `env.py:243-277`, which writes mp4 + npy)."""

    def __init__(self, env, folder: str | Path, video_format: str = 'npy'):
        super().__init__(env)
        assert video_format in ('npy', 'mp4', 'avi'), video_format
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self.video_format = video_format
        self._episode_idx = len(list(self.folder.glob('episode_*')))
        self._frames = []
        self._actions = []
        self._rewards = []
        self._terminated = []
        self._pending = None

    def _flush(self):
        if not self._frames:
            return
        stem = self.folder / f'episode_{self._episode_idx:05d}'
        video = np.stack(self._frames, axis=1)                        # (c, t, h, w)
        if self.video_format == 'npy':
            np.save(f'{stem}.video.npy', video)
        else:
            from ..data.video_io import save_video

            save_video(f'{stem}.{self.video_format}', video)
        np.save(f'{stem}.actions.npy', np.asarray(self._actions))
        np.save(f'{stem}.rewards.npy', np.asarray(self._rewards, np.float32))
        np.save(f'{stem}.terminated.npy', np.asarray(self._terminated, bool))
        self._episode_idx += 1
        self._frames, self._actions, self._rewards, self._terminated = [], [], [], []

    def reset(self, **kwargs):
        self._flush()
        out = self.env.reset(**kwargs)
        obs = out[0] if isinstance(out, tuple) else out
        self._pending = obs
        return out

    def step(self, action):
        out = self.env.step(action)
        obs, reward, terminated, truncated, info = self.parse_step(out)
        image = extract_image(self._pending)
        if image is not None:
            self._frames.append(image)
        self._actions.append(action if not isinstance(action, tuple) else action[0])
        self._rewards.append(float(reward))
        self._terminated.append(bool(terminated))
        self._pending = obs
        if terminated or truncated:
            self._flush()
        return out

    def close(self):
        self._flush()
        if hasattr(self.env, 'close'):
            self.env.close()
