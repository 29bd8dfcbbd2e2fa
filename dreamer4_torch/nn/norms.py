"""Normalization layers (counterpart of `dreamer4_tpu/nn/norms.py`).

The statistic is computed in float32 and applied in the stream dtype, so a
bf16 stream is never materialized as float32.
"""
from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        inv = torch.rsqrt(x.float().square().mean(dim=-1, keepdim=True) + 1e-6)
        return x * inv.to(x.dtype) * self.scale.to(x.dtype)


class MultiHeadRMSNorm(nn.Module):
    """Per-head QK norm: l2-normalize per head, then scale by
    (gamma + 1) * sqrt(dim_head). x: (..., h, n, d)."""

    def __init__(self, dim_head: int, heads: int, device=None):
        super().__init__()
        self.dim_head = dim_head
        self.gamma = nn.Parameter(torch.zeros(heads, dim_head, device=device))

    def forward(self, x):
        return self._normalize(x, self._scale()[:, None, :])

    def flat(self, x):
        """The same norm in the flat (B, n*h, dh) layout, row i = head i % h."""
        return self._normalize(x, self._scale().repeat(x.shape[-2] // self.gamma.shape[0], 1))

    def _scale(self):
        return (self.gamma + 1.0) * (self.dim_head ** 0.5)

    @staticmethod
    def _normalize(x, scale):
        inv = torch.rsqrt(x.float().square().sum(dim=-1, keepdim=True) + 1e-12)
        return x * inv.to(x.dtype) * scale.to(x.dtype)


class LayerNorm(nn.Module):
    """flax's `nn.LayerNorm(use_bias=False)`: a scale and no bias, eps 1e-6,
    float32 mean and variance (the fast form E[x^2] - E[x]^2, clipped at
    0), the result in the promoted type of the input and the scale."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        return y.to(torch.promote_types(x.dtype, self.scale.dtype))
