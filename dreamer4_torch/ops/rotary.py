"""1-D rotary position embeddings for the time axis (counterpart of
`dreamer4_tpu/ops/rotary.py`)."""
from __future__ import annotations

import torch


def rotary_frequencies(dim_head: int, seq_len: int, offset: int = 0, theta: float = 10000.0,
                       device=None) -> torch.Tensor:
    """-> (seq_len, dim_head) float32 angles, duplicated across the halves."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim_head, 2, dtype=torch.float32,
                                             device=device) / dim_head))
    t = torch.arange(seq_len, dtype=torch.float32, device=device) + offset
    freqs = torch.outer(t, inv_freq)
    return torch.cat([freqs, freqs], dim=-1)


def _rotate(t: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(rot).to(t.dtype)
    sin = torch.sin(rot).to(t.dtype)
    half = t.shape[-1] // 2
    x1, x2 = t[..., :half], t[..., half:]
    rotated_half = torch.cat([-x2, x1], dim=-1)
    return t * cos + rotated_half * sin


def apply_rotations(rotations: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """rotations: (n, d) angles; t: (..., h, n, d). A table longer than the
    sequence is tail-aligned (cached decode). The tables are float32; the
    multiply-add runs in the stream dtype."""
    seq_len = t.shape[-2]
    if rotations.shape[-2] > seq_len:
        rotations = rotations[..., -seq_len:, :]
    return _rotate(t, rotations)


def apply_rotations_flat(rotations: torch.Tensor, t: torch.Tensor, heads: int) -> torch.Tensor:
    """`apply_rotations` for the flat (..., n*h, d) layout of the small
    attention path (row i is position i // heads of head i % heads): the
    table is expanded to (n*h, d) so the multiply-add runs in the flat
    layout. Same table semantics: (n, d) shared or (heads', n, d) per head,
    tail-aligned when longer than the sequence."""
    n = t.shape[-2] // heads
    if rotations.shape[-2] > n:
        rotations = rotations[..., -n:, :]
    if rotations.ndim == 3:                             # (h', n, d) per head
        if rotations.shape[0] != heads:
            rotations = rotations.repeat_interleave(heads // rotations.shape[0], dim=0)
        rot = rotations.transpose(0, 1).reshape(n * heads, rotations.shape[-1])
    else:                                               # (n, d) shared
        rot = rotations.repeat_interleave(heads, dim=0)
    return _rotate(t, rot)
