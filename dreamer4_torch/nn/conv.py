"""Causal depthwise 3-D convolution with a streaming time cache
(counterpart of `dreamer4_tpu/nn/conv.py`).

RMSNorm -> depthwise k^3 convolution (causal in time, same-padded in
space) -> activation -> `proj` Dense -> residual, on channels-last video
(b, t, h, w, c). The time cache is the last k - 1 normed frames; with no
cache the past is zeros. The counterpart unrolls the convolution into k^3
shifted multiply-adds (a TPU layout choice); here it is one grouped
`F.conv3d`. The `kernel` parameter keeps the counterpart's (k, k, k, dim)
layout (time, height, width, channel), so the converter copies it as is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .activations import get_activation
from .dense import Dense
from .init import lecun_normal_
from .norms import RMSNorm


class CausalDepthwiseConv3d(nn.Module):
    def __init__(self, dim: int, kernel_size: int = 3, activation: str = 'silu', device=None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f'kernel_size must be odd, got {kernel_size}')
        self.kernel_size = kernel_size
        self.activation = get_activation(activation)
        self.norm = RMSNorm(dim, device=device)
        self.kernel = nn.Parameter(torch.empty((kernel_size,) * 3 + (dim,), device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        lecun_normal_(self.kernel, kernel_size ** 3)   # flax's fan-in of a (k, k, k, dim) kernel
        self.proj = Dense(dim, dim, device=device)

    def forward(self, x, time_cache=None, return_time_cache: bool = False):
        """x (b, t, h, w, c); time_cache (b, k-1, h, w, c) or None. -> the
        output (b, t, h, w, c), and with `return_time_cache` the cache for
        the next call."""
        k = self.kernel_size
        res = x
        x = self.norm(x)
        if time_cache is not None:
            x = torch.cat([time_cache, x], dim=1)
        else:
            x = F.pad(x, (0, 0, 0, 0, 0, 0, k - 1, 0))
        next_time_cache = x[:, -(k - 1):] if return_time_cache else None

        # flax promotes the normed stream to the float32 parameters
        dt = torch.promote_types(x.dtype, self.kernel.dtype)
        weight = self.kernel.permute(3, 0, 1, 2)[:, None].to(dt)   # (dim, 1, k, k, k)
        out = F.conv3d(x.permute(0, 4, 1, 2, 3).to(dt), weight, self.bias.to(dt),
                       padding=(0, k // 2, k // 2), groups=x.shape[-1])
        out = self.proj(self.activation(out.permute(0, 2, 3, 4, 1)))
        out = out + res
        if return_time_cache:
            return out, next_time_cache
        return out
