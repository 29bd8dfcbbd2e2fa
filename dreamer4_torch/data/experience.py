"""Experience — the trajectory record (counterpart of
`dreamer4_tpu/data/experience.py`: the container and `index_experience`; no
replay-buffer I/O). Tensors are padded to a static length, with `lens` marking validity.
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
        return self.payload.shape[1]


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
