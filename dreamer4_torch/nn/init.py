"""Initialisers mirroring flax's defaults, so a model made from a seed on a
machine without JAX has weights of the same scale as the reference's."""
from __future__ import annotations

import math

import torch

# std of a unit normal truncated to [-2, 2] (flax's truncated_normal fix-up)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator | None = None):
    """flax `lecun_normal`: truncated normal with variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                                       generator=generator)


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, generator: torch.Generator | None = None):
    """flax `normal(std)`."""
    return t.normal_(0.0, std, generator=generator)


@torch.no_grad()
def embed_normal_(t: torch.Tensor, generator: torch.Generator | None = None):
    """flax `nn.Embed`'s default: normal with variance 1 / features."""
    return t.normal_(0.0, 1.0 / math.sqrt(t.shape[-1]), generator=generator)
