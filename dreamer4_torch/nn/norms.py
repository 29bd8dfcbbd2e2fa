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
        inv = torch.rsqrt(x.float().square().sum(dim=-1, keepdim=True) + 1e-12)
        scale = (self.gamma + 1.0) * (self.dim_head ** 0.5)
        return x * inv.to(x.dtype) * scale[:, None, :].to(x.dtype)
