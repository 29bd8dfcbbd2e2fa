"""MLP building blocks (counterpart of `dreamer4_tpu/nn/mlp.py`).

Submodules keep flax's automatic names (`RMSNorm_0`, `Dense_0`, ...) so the
weight converter maps them by name.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from .activations import get_activation
from .dense import Dense
from .init import lecun_normal_
from .norms import RMSNorm


class MLP(nn.Module):
    """dim_in -> hidden dims -> dim_out with the activation between."""

    def __init__(self, dim_in: int, hidden_dims: Sequence[int], dim_out: int,
                 activation: str | Callable = 'silu', use_rmsnorm: bool = False,
                 final_bias: bool = True, device=None):
        super().__init__()
        self.act = get_activation(activation)
        self.use_rmsnorm = use_rmsnorm
        if use_rmsnorm:
            self.RMSNorm_0 = RMSNorm(dim_in, device=device)
        dims = [dim_in, *hidden_dims]
        self.num_layers = len(hidden_dims) + 1
        for i, (a, b) in enumerate(zip(dims, dims[1:])):
            setattr(self, f'Dense_{i}', Dense(a, b, device=device))
        setattr(self, f'Dense_{len(hidden_dims)}',
                Dense(dims[-1], dim_out, bias=final_bias, device=device))

    def forward(self, x):
        if self.use_rmsnorm:
            x = self.RMSNorm_0(x)
        for i in range(self.num_layers - 1):
            x = self.act(getattr(self, f'Dense_{i}')(x))
        return getattr(self, f'Dense_{self.num_layers - 1}')(x)


def create_mlp(dim_in: int, dim: int, depth: int, dim_out: int, activation='silu',
               use_rmsnorm: bool = True, device=None) -> MLP:
    """Normed MLP factory. Unlike flax, torch needs the input width."""
    return MLP(dim_in, (dim,) * depth, dim_out, activation=activation,
               use_rmsnorm=use_rmsnorm, device=device)


class EnsembleHead(nn.Module):
    """num_heads independent (RMSNorm -> Linear) heads over the same input,
    as one einsum. Output: (num_heads, ..., dim_out)."""

    def __init__(self, dim: int, num_heads: int, dim_out: int, use_rmsnorm: bool = True,
                 device=None):
        super().__init__()
        self.use_rmsnorm = use_rmsnorm
        if use_rmsnorm:
            self.norm_scale = nn.Parameter(torch.ones(num_heads, dim, device=device))
        self.kernel = nn.Parameter(torch.empty(num_heads, dim, dim_out, device=device))
        # flax's fan-in of an (e, d, o) kernel counts e * d inputs
        lecun_normal_(self.kernel, num_heads * dim)

    def forward(self, x):   # (..., d)
        e = self.kernel.shape[0]
        if self.use_rmsnorm:
            # the statistic stays in the input dtype, as in the counterpart
            normed = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6)
            x_e = normed[None] * self.norm_scale.reshape(e, *(1,) * (x.ndim - 1), -1)
        else:
            x_e = x[None].expand(e, *x.shape)
        dt = torch.promote_types(x_e.dtype, self.kernel.dtype)
        return torch.einsum('e...d,edo->e...o', x_e.to(dt), self.kernel.to(dt))
