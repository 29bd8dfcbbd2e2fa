"""Attention compute core (counterpart of `dreamer4_tpu/ops/attention.py`).

`naive_attend` is the plain PyTorch attention: grouped-query, logit
softclamp, boolean mask. Scores and softmax run in float32; the PV product
runs in the stream dtype, so a bf16 stream stays bf16.
"""
from __future__ import annotations

import torch

from .utils import softclamp

NEG_INF = -1e30


def naive_attend(q: torch.Tensor,   # (b, hq, i, d)
                 k: torch.Tensor,   # (b, h,  j, d)
                 v: torch.Tensor,   # (b, h,  j, d)
                 mask: torch.Tensor | None = None,   # broadcastable to (b, h, g, i, j)
                 softclamp_value: float | None = None,
                 scale: float | None = None) -> torch.Tensor:
    hq, hk = q.shape[-3], k.shape[-3]
    assert hq % hk == 0
    groups = hq // hk
    if scale is None:
        scale = q.shape[-1] ** -0.5

    q = q.reshape(*q.shape[:-3], hk, groups, *q.shape[-2:])            # (b, h, g, i, d)
    # bf16 products are exact in float32, so this equals a bf16 matmul
    # with a float32 result
    sim = torch.einsum('...hgid,...hjd->...hgij', q.float(), k.float()) * scale
    if softclamp_value is not None:
        sim = softclamp(sim, softclamp_value)
    if mask is not None:
        sim = sim.masked_fill(~mask, NEG_INF)
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    out = torch.einsum('...hgij,...hjd->...hgid', attn, v)
    return out.reshape(*out.shape[:-4], hq, *out.shape[-2:])
