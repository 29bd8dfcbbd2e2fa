"""MOSS-style spatial video module with a streaming time cache (counterpart
of `dreamer4_tpu/nn/moss.py`): a causal depthwise spatiotemporal conv, then
a gated channel MLP with a residual, on the grid tokens of a trunk layer.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .conv import CausalDepthwiseConv3d
from .dense import Dense
from .norms import RMSNorm


class MOSS(nn.Module):
    """The conv (k^3, causal in time), then RMSNorm, `proj_in` to 2 x 2 x
    dim, a SiLU-gated half and `proj_out` back, residual."""

    def __init__(self, dim: int, kernel_size: int = 3, device=None):
        super().__init__()
        device = resolve_device(device)
        inner = 2 * dim
        self.conv = CausalDepthwiseConv3d(dim, kernel_size, device=device)
        self.norm = RMSNorm(dim, device=device)
        self.proj_in = Dense(dim, inner * 2, device=device)
        self.proj_out = Dense(inner, dim, device=device)

    def forward(self, x, cache=None, return_cache: bool = False):
        """x (b, t, h, w, d); cache: the conv's time cache (b, k-1, h, w, d)
        or None. -> the output, and with `return_cache` the next cache."""
        x, next_cache = self.conv(x, time_cache=cache, return_time_cache=True)
        a, g = self.proj_in(self.norm(x)).chunk(2, dim=-1)
        x = x + self.proj_out(a * F.silu(g))
        if return_cache:
            return x, next_cache
        return x
