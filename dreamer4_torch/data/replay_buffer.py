"""On-disk memmapped episodic replay buffer (a copy of
`dreamer4_tpu/data/replay_buffer.py`: the same files and `buffer_meta.json`,
so a buffer written by either package opens in the other).

Host-side equivalent of the reference's `memmap_replay_buffer.ReplayBuffer`
dependency (used at `dreamer4.py:5299-5323`, `trainers.py:351-408`,
`env.py:279-312`). Pure numpy — the device never touches this; batches are
assembled on host and fed to the device as padded arrays.

Layout on disk (one .npy memmap per field):
  fields:      (max_episodes, max_timesteps, *shape)
  meta_fields: (max_episodes, *shape)
  lengths:     (max_episodes,) int64
"""
from __future__ import annotations

import json
from contextlib import contextmanager
from pathlib import Path

import numpy as np

_DTYPES = {
    'float': np.float32,
    'int': np.int64,
    'bool': np.bool_,
    'uint8': np.uint8,
}


def _normalize_field(spec):
    """'float' | ('float', shape) -> (np.dtype, shape tuple)."""
    if isinstance(spec, str):
        return _DTYPES[spec], ()
    dtype, shape = spec
    if isinstance(shape, int):
        shape = (shape,)
    return _DTYPES[dtype], tuple(shape)


class ReplayBuffer:
    def __init__(
        self,
        folder: str | Path,
        max_episodes: int,
        max_timesteps: int,
        fields: dict,
        meta_fields: dict | None = None,
        circular: bool = True,
    ):
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self.max_episodes = max_episodes
        self.max_timesteps = max_timesteps
        self.circular = circular

        self.fields = {k: _normalize_field(v) for k, v in fields.items()}
        self.meta_fields = {k: _normalize_field(v) for k, v in (meta_fields or {}).items()}

        meta_path = self.folder / 'buffer_meta.json'
        spec = dict(
            max_episodes=max_episodes,
            max_timesteps=max_timesteps,
            fields={k: [str(np.dtype(d)), list(s)] for k, (d, s) in self.fields.items()},
            meta_fields={k: [str(np.dtype(d)), list(s)] for k, (d, s) in self.meta_fields.items()},
        )
        fresh = not meta_path.exists() or json.loads(meta_path.read_text()) != spec
        if fresh:
            meta_path.write_text(json.dumps(spec))

        mode = 'w+' if fresh else 'r+'
        self._data = {}
        for k, (dtype, shape) in self.fields.items():
            self._data[k] = np.lib.format.open_memmap(
                self.folder / f'{k}.npy', mode=mode, dtype=dtype,
                shape=(max_episodes, max_timesteps, *shape))
        self._meta = {}
        for k, (dtype, shape) in self.meta_fields.items():
            self._meta[k] = np.lib.format.open_memmap(
                self.folder / f'meta.{k}.npy', mode=mode, dtype=dtype,
                shape=(max_episodes, *shape))
        self._lengths = np.lib.format.open_memmap(
            self.folder / 'lengths.npy', mode=mode, dtype=np.int64, shape=(max_episodes,))
        self._counter = np.lib.format.open_memmap(
            self.folder / 'counter.npy', mode=mode, dtype=np.int64, shape=(2,))
        if fresh:
            self._lengths[:] = 0
            self._counter[:] = 0  # [next_slot, total_written]

    @classmethod
    def open(cls, folder: str | Path) -> 'ReplayBuffer':
        """Reopen an existing buffer from its saved spec."""
        folder = Path(folder)
        spec = json.loads((folder / 'buffer_meta.json').read_text())

        def denorm(d):
            return {k: (v[0], tuple(v[1])) for k, v in d.items()}

        inv_dtypes = {str(np.dtype(v)): k for k, v in _DTYPES.items()}
        fields = {k: (inv_dtypes[v[0]], tuple(v[1])) for k, v in spec['fields'].items()}
        meta_fields = {k: (inv_dtypes[v[0]], tuple(v[1])) for k, v in spec['meta_fields'].items()}
        return cls(folder, spec['max_episodes'], spec['max_timesteps'],
                   fields=fields, meta_fields=meta_fields)

    # ---------------------------------------------------------- properties

    @property
    def num_episodes(self) -> int:
        return int(min(self._counter[1], self.max_episodes))

    def __len__(self) -> int:
        return self.num_episodes

    def episode_length(self, idx: int) -> int:
        return int(self._lengths[idx])

    def clear(self):
        self._lengths[:] = 0
        self._counter[:] = 0

    # -------------------------------------------------------------- writing

    def _allocate(self, count: int = 1) -> np.ndarray:
        start = int(self._counter[0])
        slots = (np.arange(count) + start) % self.max_episodes
        if not self.circular:
            assert start + count <= self.max_episodes, 'replay buffer full'
        self._counter[0] = (start + count) % self.max_episodes
        self._counter[1] = self._counter[1] + count
        self._lengths[slots] = 0
        return slots

    @contextmanager
    def one_episode(self, **meta):
        slot = int(self._allocate(1)[0])
        for k, v in meta.items():
            self._meta[k][slot] = v
        state = {'slot': slot, 'step': 0}
        self._episode_state = state
        try:
            yield slot
        finally:
            self._lengths[slot] = state['step']
            self._episode_state = None
            self._flush()

    @contextmanager
    def batched_episode(self, batch_size: int, **meta):
        slots = self._allocate(batch_size)
        for k, v in meta.items():
            v = np.asarray(v)
            self._meta[k][slots] = v
        state = {'slots': slots, 'step': 0}
        self._batch_state = state
        try:
            yield slots
        finally:
            self._lengths[slots] = state['step']
            self._batch_state = None
            self._flush()

    def store(self, **step_data):
        state = self._episode_state
        slot, step = state['slot'], state['step']
        assert step < self.max_timesteps, 'episode exceeds max_timesteps'
        for k, v in step_data.items():
            self._data[k][slot, step] = v
        state['step'] = step + 1

    def store_batch(self, **step_data):
        state = self._batch_state
        slots, step = state['slots'], state['step']
        assert step < self.max_timesteps, 'episode exceeds max_timesteps'
        for k, v in step_data.items():
            self._data[k][slots, step] = np.asarray(v)
        state['step'] = step + 1

    def _flush(self):
        for m in self._data.values():
            m.flush()
        for m in self._meta.values():
            m.flush()
        self._lengths.flush()
        self._counter.flush()

    # -------------------------------------------------------------- reading

    def get_episode(self, idx: int, truncate: bool = True) -> dict:
        length = self.episode_length(idx)
        out = {k: np.array(v[idx, :length] if truncate else v[idx]) for k, v in self._data.items()}
        out.update({k: np.array(v[idx]) for k, v in self._meta.items()})
        out['_length'] = length
        return out

    def sample_batch(self, rng: np.random.Generator, batch_size: int, seq_len: int | None = None) -> dict:
        """Sample episodes; optionally crop a random window of seq_len frames.
        Returns padded arrays plus 'lens'. The frame-window slicing mirrors
        `sample_video_and_actions` (trainers.py:203-253)."""
        n = self.num_episodes
        assert n > 0, 'replay buffer is empty'
        idxs = rng.integers(0, n, size=batch_size)
        lengths = self._lengths[idxs]

        if seq_len is None:
            seq_len = int(lengths.max())

        batch = {k: np.zeros((batch_size, seq_len, *shape), dtype=dtype)
                 for k, (dtype, shape) in self.fields.items()}
        lens = np.zeros((batch_size,), np.int64)

        for i, (ep, ep_len) in enumerate(zip(idxs, lengths)):
            ep_len = int(ep_len)
            take = min(ep_len, seq_len)
            start = int(rng.integers(0, ep_len - take + 1)) if ep_len > take else 0
            for k in self.fields:
                batch[k][i, :take] = self._data[k][ep, start:start + take]
            lens[i] = take

        batch['lens'] = lens
        for k in self.meta_fields:
            batch[k] = np.array(self._meta[k][idxs])
        return batch

    def dataset(self, slice_by_episode_len: bool = True):
        """Indexable view over stored episodes (torch-Dataset-shaped for the
        trainer layer)."""
        buffer = self

        class _Dataset:
            def __len__(self):
                return buffer.num_episodes

            def __getitem__(self, idx):
                return buffer.get_episode(idx, truncate=slice_by_episode_len)

        return _Dataset()
