"""Shifted patch tokenization with a streaming time cache (counterpart of
`dreamer4_tpu/nn/spt.py`).

Per patch, the original video and four copies shifted by one pixel, in the
order (dy, dx) = (1, 0), (-1, 0), (0, 1), (0, -1) (a shift of +1 moves
content down or right, zeros entering), then, with `temporal_shift`, the
previous frame (zeros before the first, or the cache's frame), are
concatenated along channels; each patch is flattened as (p, p, c *
segments), projected by `proj` and normed by a bias-free LayerNorm.
Channels-last video (b, t, h, w, c) in, tokens (b, t, hp, wp, dim) out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .dense import Dense
from .norms import LayerNorm

SHIFTS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift the spatial dims (2 = h, 3 = w) of (b, t, h, w, c) by one pixel,
    zero-padded: out[y, x] = in[y - dy, x - dx]."""
    h, w = x.shape[2], x.shape[3]
    x = F.pad(x, (0, 0, 1, 1, 1, 1))
    return x[:, :, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]


class ShiftedPatchTokenization(nn.Module):
    def __init__(self, dim: int, patch_size: int, channels: int = 3,
                 temporal_shift: bool = True, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.temporal_shift = temporal_shift
        segments = 1 + len(SHIFTS) + int(temporal_shift)
        self.proj = Dense(patch_size * patch_size * channels * segments, dim, device=device)
        self.norm = LayerNorm(dim, device=device)

    def forward(self, video, time_cache=None, return_time_cache: bool = False):
        """video (b, t, h, w, c); time_cache (b, 1, h, w, c), the frame
        before this call's, or None. -> tokens (b, t, hp, wp, dim), and with
        `return_time_cache` the cache for the next call (None without the
        temporal shift)."""
        b, t, h, w, _ = video.shape
        p = self.patch_size
        segments = [video] + [shift2d(video, dy, dx) for dy, dx in SHIFTS]
        next_time_cache = None
        if self.temporal_shift:
            if time_cache is not None:
                padded = torch.cat([time_cache, video], dim=1)
            else:
                padded = F.pad(video, (0, 0, 0, 0, 0, 0, 1, 0))
            next_time_cache = padded[:, -1:]
            segments.append(padded[:, :-1])
        x = torch.cat(segments, dim=-1)   # (b, t, h, w, c * segments)
        cs = x.shape[-1]
        x = x.reshape(b, t, h // p, p, w // p, p, cs).permute(0, 1, 2, 4, 3, 5, 6)
        x = self.norm(self.proj(x.reshape(b, t, h // p, w // p, p * p * cs)))
        if return_time_cache:
            return x, next_time_cache
        return x
