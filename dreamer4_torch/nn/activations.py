"""Activation registry (counterpart of `dreamer4_tpu/nn/activations.py`).

`sugar_bsilu`'s straight-through (SUGAR) gradient is not ported: it
computes its forward and refuses inputs that require grad, so that no
training step takes ReLU's gradient in its place.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def relu_squared(x):
    return F.relu(x).square()


def sugar_bsilu(x):
    """Forward of B-SiLU with the SUGAR gradient (ReLU forward)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("sugar_bsilu's SUGAR backward is not ported to "
                                  'dreamer4_torch yet')
    return F.relu(x)


ACTIVATIONS: dict[str, Callable] = {
    'silu': F.silu,
    'relu_squared': relu_squared,
    'sugar_bsilu': sugar_bsilu,
    'relu': F.relu,
    'gelu': lambda x: F.gelu(x, approximate='tanh'),   # jax.nn.gelu's default
}


def get_activation(act) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(act):
        return act
    if act not in ACTIVATIONS:
        raise ValueError(f'activation {act} not found in {list(ACTIVATIONS)}')
    return ACTIVATIONS[act]
