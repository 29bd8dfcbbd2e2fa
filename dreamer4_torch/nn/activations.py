"""Activation registry (counterpart of `dreamer4_tpu/nn/activations.py`).

Forward only: `sugar_bsilu`'s straight-through gradient belongs to the
training slice.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def relu_squared(x):
    return F.relu(x).square()


ACTIVATIONS: dict[str, Callable] = {
    'silu': F.silu,
    'relu_squared': relu_squared,
    'sugar_bsilu': F.relu,          # forward of B-SiLU with the SUGAR gradient
    'relu': F.relu,
    'gelu': lambda x: F.gelu(x, approximate='tanh'),   # jax.nn.gelu's default
}


def get_activation(act) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(act):
        return act
    if act not in ACTIVATIONS:
        raise ValueError(f'activation {act} not found in {list(ACTIVATIONS)}')
    return ACTIVATIONS[act]
