"""Loss normalizer (counterpart of `dreamer4_tpu/nn/loss_normalizer.py`).

The counterpart keeps the EMA of squared losses in flax's 'state'
collection and threads it through the train step; here it is the buffer
`exp_avg_sq`, updated in place when `update_ema` is set, so it moves on
every training forward (every micro-step under gradient accumulation, as
there).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.losses import apply_loss_normalizer


class LossNormalizer(nn.Module):
    def __init__(self, num_losses: int = 1, beta: float = 0.95, device=None):
        super().__init__()
        self.beta = beta
        self.register_buffer('exp_avg_sq', torch.ones(num_losses, device=device))

    def forward(self, losses: torch.Tensor, update_ema: bool = True) -> torch.Tensor:
        normed, new_state = apply_loss_normalizer(self.exp_avg_sq, losses, update_ema=update_ema,
                                                  beta=self.beta)
        if update_ema:
            with torch.no_grad():
                self.exp_avg_sq.copy_(new_state)
        return normed.reshape(losses.shape)
