"""Loss-side utilities (counterpart of `dreamer4_tpu/ops/losses.py`): the
EMA loss normalization. Signature regularization and the decorrelation
loss are not ported yet."""
from __future__ import annotations

import torch


def apply_loss_normalizer(state: torch.Tensor, losses: torch.Tensor, update_ema: bool = True,
                          beta: float = 0.95, eps: float = 1e-6):
    """-> (normalized_losses, new_state): the losses divided by the RMS of
    the EMA of their squares taken *before* this value is folded in (the
    counterpart's order). The new state carries no gradient."""
    losses = losses.reshape(state.shape)
    rms = torch.sqrt(state)
    new_state = state
    if update_ema:
        new_state = state + (1.0 - beta) * (losses.detach().square() - state)
    return losses / torch.clamp(rms, min=eps), new_state
