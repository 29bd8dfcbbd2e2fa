"""Experience — the trajectory record (counterpart of
`dreamer4_tpu/data/experience.py`, the container only: no replay-buffer
I/O). Tensors are padded to a static length, with `lens` marking validity.
"""
from __future__ import annotations

from dataclasses import dataclass
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
