"""EMA shadow parameters (counterpart of `dreamer4_tpu/train/ema.py`).

The counterpart maps a lerp over an immutable pytree; here the shadow is a
dict of tensors updated in place, which keeps one copy of the weights.
"""
from __future__ import annotations

from typing import Mapping

import torch


def init_ema(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {name: p.detach().clone() for name, p in params.items()}


@torch.no_grad()
def update_ema(ema_params: dict[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               decay: float = 0.999) -> dict[str, torch.Tensor]:
    """ema <- ema * decay + p * (1 - decay), in place, in the counterpart's
    order of operations. Returns `ema_params`."""
    for name, e in ema_params.items():
        e.mul_(decay).add_(params[name] * (1.0 - decay))
    return ema_params
