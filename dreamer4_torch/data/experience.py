"""Experience — the trajectory record (counterpart of
`dreamer4_tpu/data/experience.py`: the container, `index_experience`,
`pad_experience_time` and `combine_experiences`; no replay-buffer I/O).
Tensors are padded to a static length, with `lens` marking validity. Every
tensor is batch-first with time on axis 1, but `video` (b, c, t, h, w),
whose time axis is 2.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any

import torch

from ..nn.action_embedder import Actions


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
