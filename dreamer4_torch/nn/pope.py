"""Polar positional embeddings (PoPE): rotary angles whose frequencies are
learned per attention head (counterpart of `dreamer4_tpu/nn/pope.py`).

`PoPE` makes the (heads, seq, dim_head) angle table of the time axis,
`AxialPoPE` the (heads, H*W + num_special, dim_head) table of a spatial grid,
half of each rotated half per axis. The frequencies are float32 parameters,
and the angles are computed in each forward, so that a training step's
gradient reaches them; `ops.rotary` casts only their cos and sin to the
stream dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device


# the counterpart's frequency bases: the time axis's, and each grid axis's
TIME_THETA = 10000.0
AXIAL_THETA = 100.0


def _init_inv_freq(dim_half: int, heads: int, theta: float, device) -> torch.Tensor:
    freqs = 1.0 / (theta ** (torch.arange(0, dim_half, dtype=torch.float32, device=device)
                             / dim_half))
    return freqs.expand(heads, dim_half).clone()


class PoPE(nn.Module):
    """1-D learned rotary angles: forward(seq_len, offset) -> (heads,
    seq_len, dim_head) for positions offset .. offset + seq_len - 1."""

    def __init__(self, dim_head: int, heads: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.inv_freq = nn.Parameter(_init_inv_freq(dim_head // 2, heads, TIME_THETA, device))

    def forward(self, seq_len: int, offset: int = 0) -> torch.Tensor:
        t = torch.arange(seq_len, dtype=torch.float32, device=self.inv_freq.device) + offset
        freqs = torch.einsum('n,hf->hnf', t, self.inv_freq)
        return torch.cat([freqs, freqs], dim=-1)


class AxialPoPE(nn.Module):
    """2-D axial learned rotary angles over an (H, W) grid, laid out per
    position as [fy, fx, fy, fx] (each dim_head // 4 wide), zero-padded up
    to dim_head, with zero angles (no rotation) for `num_special` trailing
    tokens: forward(height, width, num_special) -> (heads, H*W +
    num_special, dim_head)."""

    def __init__(self, dim_head: int, heads: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dim_head, self.heads = dim_head, heads
        dim_axis = dim_head // 4
        self.inv_freq_y = nn.Parameter(_init_inv_freq(dim_axis, heads, AXIAL_THETA, device))
        self.inv_freq_x = nn.Parameter(_init_inv_freq(dim_axis, heads, AXIAL_THETA, device))

    def forward(self, height: int, width: int, num_special: int = 0) -> torch.Tensor:
        device = self.inv_freq_y.device
        ys = torch.arange(height, dtype=torch.float32, device=device)
        xs = torch.arange(width, dtype=torch.float32, device=device)
        fy = torch.einsum('n,hf->hnf', ys, self.inv_freq_y)           # (h, H, da)
        fx = torch.einsum('n,hf->hnf', xs, self.inv_freq_x)           # (h, W, da)
        da = fy.shape[-1]
        fy = fy[:, :, None].expand(self.heads, height, width, da)
        fx = fx[:, None, :].expand(self.heads, height, width, da)
        angles = torch.cat([fy, fx], dim=-1).reshape(self.heads, height * width, 2 * da)
        angles = torch.cat([angles, angles], dim=-1)
        return F.pad(angles, (0, self.dim_head - angles.shape[-1], 0, num_special))
