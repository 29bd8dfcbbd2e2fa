"""Activation registry (counterpart of `dreamer4_tpu/nn/activations.py`).

`sugar_bsilu` is B-SiLU with a SUGAR straight-through gradient: ReLU in the
forward, the derivative of B-SiLU(x) = (x + a) sigmoid(x) - a / 2 in the
backward (the counterpart's `custom_vjp`).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def relu_squared(x):
    return F.relu(x).square()


_BSILU_ALPHA = 1.67


class _SugarBSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.relu(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = torch.sigmoid(x)
        return g * (s + (x + _BSILU_ALPHA) * s * (1.0 - s))


def sugar_bsilu(x):
    """ReLU forward, B-SiLU's derivative as the gradient (SUGAR)."""
    return _SugarBSiLU.apply(x)


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
