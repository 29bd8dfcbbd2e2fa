"""Experience — the trajectory record (counterpart of
`dreamer4_tpu/data/experience.py`): the container, `index_experience`,
`pad_experience_time`, `combine_experiences` and the replay-buffer bridge
(`experience_buffer_fields`, `create_experience_replay_buffer`,
`add_experience_to_buffer`, `experience_from_batch`).
Tensors are padded to a static length, with `lens` marking validity. Every
tensor is batch-first with time on axis 1, but `video` (b, c, t, h, w),
whose time axis is 2.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..nn.action_embedder import Actions
from .replay_buffer import ReplayBuffer


@dataclass
class Experience:
    latents: torch.Tensor | None = None            # (b, t, n, d)
    video: torch.Tensor | None = None              # (b, c, t, h, w)
    proprio: torch.Tensor | None = None            # (b, t, dp)
    critic_state: torch.Tensor | None = None       # (b, t, ds)
    agent_embed: torch.Tensor | None = None        # (b, t, d)
    rewards: torch.Tensor | None = None            # (b, t)
    terminals: torch.Tensor | None = None          # (b,) or (b, t)
    terminal_probs: torch.Tensor | None = None     # (b, t)
    actions: Actions | None = None
    log_probs: Actions | None = None
    old_action_unembeds: Any | None = None         # (discrete_logits_tuple, cont_params)
    values: torch.Tensor | None = None             # (b, t)
    step_size: int | None = None
    lens: torch.Tensor | None = None               # (b,)
    is_truncated: torch.Tensor | None = None       # (b,)
    agent_index: int = 0
    is_from_world_model: bool = True
    prompt_len: int = 0
    episode_return: torch.Tensor | None = None     # (b,)

    @property
    def payload(self):
        for t in (self.latents, self.video, self.critic_state):
            if t is not None:
                return t
        return None

    @property
    def batch_size(self):
        return self.payload.shape[0]

    @property
    def time_steps(self):
        payload = self.payload
        return payload.shape[2] if payload is self.video else payload.shape[1]


def _map_tensors(fn, value):
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, tuple):
        items = [_map_tensors(fn, v) for v in value]
        return type(value)(*items) if hasattr(value, '_fields') else tuple(items)
    return value


def index_experience(exp: Experience, idx) -> Experience:
    """Row-select every tensor (all are batch-first; the static fields pass
    through): a minibatch, or the rows of a check."""
    return replace(exp, **{f.name: _map_tensors(lambda t: t[idx], getattr(exp, f.name))
                           for f in fields(exp)})


def _pad_to(t: torch.Tensor, length: int, dim: int) -> torch.Tensor:
    """Zero-pad `t` at the end of `dim` to `length` (no-op when longer)."""
    amount = length - t.shape[dim]
    if amount <= 0:
        return t
    pad = [0, 0] * (t.ndim - 1 - dim % t.ndim) + [0, amount]
    return torch.nn.functional.pad(t, pad)


def _with_lens(exp: Experience) -> Experience:
    """`lens` (full length) and `is_truncated` (all) where they are None."""
    b, t = exp.batch_size, exp.time_steps
    device = exp.payload.device
    if exp.lens is None:
        exp = replace(exp, lens=torch.full((b,), t, dtype=torch.long, device=device))
    if exp.is_truncated is None:
        exp = replace(exp, is_truncated=torch.ones((b,), dtype=torch.bool, device=device))
    return exp


def _pad_time(exp: Experience, length: int) -> Experience:
    """Every time-indexed tensor zero-padded to `length`: those of two or
    more dimensions at axis 1, `video` at axis 2."""
    pad = lambda t: _pad_to(t, length, 1) if t.ndim >= 2 else t
    padded = {f.name: _map_tensors(pad, getattr(exp, f.name)) for f in fields(exp)
              if f.name != 'video'}
    if exp.video is not None:
        padded['video'] = _pad_to(exp.video, length, 2)
    return replace(exp, **padded)


def pad_experience_time(exp: Experience, length: int) -> Experience:
    """Zero-pad every time-indexed tensor to a fixed `length` and fill in
    `lens` / `is_truncated`, so that the padding is masked out downstream
    and every rollout, whatever its longest episode, has one shape."""
    t = exp.time_steps
    if t > length:
        raise ValueError(f'experience time dim {t} exceeds pad length {length}')
    exp = _with_lens(exp)
    return exp if t == length else _pad_time(exp, length)


def combine_experiences(exps: list[Experience]) -> Experience:
    """Pad the time dims to the longest, then concatenate along the batch.
    `video` is padded at its time axis (2); the counterpart pads it at axis
    1, its channels, and so cannot combine video of unequal lengths."""
    if not exps:
        raise ValueError('no experiences to combine')
    exps = [_with_lens(e) for e in exps]
    max_t = max(e.time_steps for e in exps)
    exps = [_pad_time(e, max_t) for e in exps]

    def cat(*values):
        first = values[0]
        if isinstance(first, torch.Tensor):
            return torch.stack(values) if first.ndim == 0 else torch.cat(values, dim=0)
        if isinstance(first, tuple):
            items = [cat(*parts) for parts in zip(*values)]
            return type(first)(*items) if hasattr(first, '_fields') else tuple(items)
        return first

    return replace(exps[0], **{f.name: cat(*(getattr(e, f.name) for e in exps))
                               for f in fields(Experience)})


# ------------------------------------------------------- replay-buffer bridge

BUFFER_META_FIELDS = ('step_size', 'lens', 'is_truncated', 'terminals',
                      'agent_index', 'is_from_world_model', 'episode_return')


def _dtype_name(x: torch.Tensor) -> str:
    if x.dtype == torch.bool:
        return 'bool'
    return 'float' if x.is_floating_point() else 'int'


def _experience_dicts(exp: Experience) -> tuple[dict, dict]:
    """(per-frame fields, per-episode meta fields) of `exp`, by buffer name."""
    data, meta = {}, {}
    for name in ('latents', 'video', 'proprio', 'critic_state', 'agent_embed',
                 'rewards', 'values'):
        v = getattr(exp, name)
        if v is not None:
            data[name] = v
    for pair_name in ('actions', 'log_probs'):
        pair = getattr(exp, pair_name)
        if pair is not None:
            if pair.discrete is not None:
                data[f'{pair_name}_discrete'] = pair.discrete
            if pair.continuous is not None:
                data[f'{pair_name}_continuous'] = pair.continuous
    for name in BUFFER_META_FIELDS:
        v = getattr(exp, name)
        if v is not None:
            meta[name] = v
    return data, meta


def experience_buffer_fields(exp: Experience) -> tuple[dict, dict]:
    """Infer (fields, meta_fields) specs for `ReplayBuffer` from a template
    experience (reference `Experience.create_memmap_replay_buffer`,
    `dreamer4.py:187-205`). A `video` frame is stored as (c, h, w); the
    counterpart sizes it from (t, h, w), the shape after the batch and
    channel axes, so it cannot store video."""
    fields, meta = {}, {}
    data_dict, meta_dict = _experience_dicts(exp)
    for k, v in data_dict.items():
        frame = (v.shape[1], *v.shape[3:]) if k == 'video' else v.shape[2:]
        fields[k] = (_dtype_name(v), tuple(frame))
    for k, v in meta_dict.items():
        meta[k] = (_dtype_name(v), tuple(v.shape[1:])) if isinstance(v, torch.Tensor) \
            else ('int', ())
    return fields, meta


def create_experience_replay_buffer(template: Experience, folder, max_episodes,
                                    max_timesteps, **kwargs):
    fields, meta = experience_buffer_fields(template)
    return ReplayBuffer(folder, max_episodes, max_timesteps,
                        fields=fields, meta_fields=meta, **kwargs)


def add_experience_to_buffer(exp: Experience, buffer):
    """Store each batch row as one episode (reference `add_to_memmap_buffer`,
    `dreamer4.py:207-215`); video stored as (t, c, h, w)."""
    data, meta = _experience_dicts(exp)
    data = {k: v.detach().cpu().numpy() for k, v in data.items()}
    if 'video' in data:  # (b, c, t, h, w) -> (b, t, c, h, w)
        data['video'] = np.moveaxis(data['video'], 1, 2)

    b = exp.batch_size
    lens = (exp.lens.cpu().numpy() if exp.lens is not None
            else np.full((b,), exp.time_steps))

    meta_np = {}
    for k, v in meta.items():
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        meta_np[k] = np.full((b,), v) if v.ndim == 0 else v

    with buffer.batched_episode(batch_size=b, **meta_np) as slots:
        for t in range(int(lens.max())):
            buffer.store_batch(**{k: v[:, t] for k, v in data.items()})
    # correct per-episode lengths (batched_episode records the common count)
    buffer._lengths[slots] = lens
    buffer._flush()


def experience_from_batch(batch: dict, step_size: int | None = None,
                          device=None) -> Experience:
    """Rebuild an Experience from a `ReplayBuffer.sample_batch` dict
    (reference `from_buffer_dict`, `dreamer4.py:217-236`), its tensors on
    `device` (CUDA unless 'cpu' is asked for, as every entry point). Every
    tensor is a copy: a `PrefetchSampler` reuses its batch's arrays."""
    device = resolve_device(device)

    def get(k):
        v = batch.get(k)
        return torch.tensor(np.asarray(v), device=device) if v is not None else None

    actions = None
    if 'actions_discrete' in batch or 'actions_continuous' in batch:
        actions = Actions(get('actions_discrete'), get('actions_continuous'))
    log_probs = None
    if 'log_probs_discrete' in batch or 'log_probs_continuous' in batch:
        log_probs = Actions(get('log_probs_discrete'), get('log_probs_continuous'))

    video = get('video')
    if video is not None and video.ndim == 5:
        video = video.movedim(1, 2)  # (b, t, c, h, w) -> (b, c, t, h, w)

    ss = batch.get('step_size', step_size)
    if ss is not None and hasattr(ss, '__len__'):
        ss = int(np.asarray(ss).reshape(-1)[0])

    return Experience(
        latents=get('latents'),
        video=video,
        proprio=get('proprio'),
        critic_state=get('critic_state'),
        agent_embed=get('agent_embed'),
        rewards=get('rewards'),
        terminals=get('terminals'),
        actions=actions,
        log_probs=log_probs,
        values=get('values'),
        step_size=int(ss) if ss is not None else None,
        lens=get('lens'),
        is_truncated=get('is_truncated'),
        episode_return=get('episode_return'),
    )
