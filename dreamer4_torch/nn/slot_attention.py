"""Slot attention and inverted cross-attention (counterpart of
`dreamer4_tpu/nn/slot_attention.py`).

The slots (queries) compete for each context token: the softmax runs over
the query axis, then each slot's weights are L1-normalized over the keys
(`inverted_attention`; else the usual softmax over the keys), with a
sigmoid gate on the output. `SlotAttention` iterates it with a
feedforward and an optional mixer over the slot axis. The tokenizer uses it
to initialize the encoder's latents or the decoder's spatial tokens from
content. Plain einsum attention, as in the counterpart.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.utils import l1norm
from .attention import FeedForward
from .dense import Dense
from .norms import RMSNorm


class InvertedCrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 inverted_attention: bool = True, device=None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.inverted_attention = inverted_attention
        self.norm = RMSNorm(dim, device=device)
        self.to_qg = Dense(dim, inner * 2, bias=False, device=device)
        self.to_kv = Dense(dim, inner * 2, bias=False, device=device)
        self.to_out = Dense(inner, dim, bias=False, device=device)

    def forward(self, x, context):
        """x (B, n, d) queries, pre-RMSNormed here; context (B, m, d) -> (B,
        n, d)."""
        x = self.norm(x)
        q, gate = self.to_qg(x).chunk(2, dim=-1)
        k, v = self.to_kv(context).chunk(2, dim=-1)
        split = lambda t: t.reshape(*t.shape[:-1], self.heads, self.dim_head).transpose(-3, -2)
        q, gate, k, v = split(q), split(gate), split(k), split(v)

        sim = torch.einsum('...hid,...hjd->...hij', q, k) * self.dim_head ** -0.5
        if self.inverted_attention:
            attn = l1norm(torch.softmax(sim, dim=-2), dim=-1)   # slots compete
        else:
            attn = torch.softmax(sim, dim=-1)
        out = torch.einsum('...hij,...hjd->...hid', attn, v) * torch.sigmoid(gate)
        out = out.transpose(-3, -2).reshape(*x.shape[:-1], self.heads * self.dim_head)
        return self.to_out(out)


class SlotAttention(nn.Module):
    """latents (..., n, d) <- context (..., m, d), `iters` rounds of the
    gated inverted cross-attention, the slot mixer (`spatial_mix`: RMSNorm,
    then dense layers over the slot axis to max(1, num_slots // 2) and
    back, SiLU between) and the feedforward (4x), each residual."""

    def __init__(self, dim: int, iters: int = 2, num_slots: int | None = None,
                 spatial_mix: bool = False, inverted_attention: bool = True, heads: int = 8,
                 dim_head: int = 64, device=None):
        super().__init__()
        device = resolve_device(device)
        self.iters = iters
        self.attn = InvertedCrossAttention(dim, heads=heads, dim_head=dim_head,
                                           inverted_attention=inverted_attention, device=device)
        self.ff = FeedForward(dim, expansion_factor=4.0, device=device)
        self.spatial_mix = spatial_mix
        if spatial_mix:
            if num_slots is None:
                raise ValueError('the slot mixer needs num_slots')
            hidden_slots = max(1, int(num_slots * 0.5))
            self.mixer_norm = RMSNorm(dim, device=device)
            self.mixer_down = Dense(num_slots, hidden_slots, device=device)
            self.mixer_up = Dense(hidden_slots, num_slots, device=device)

    def _mix(self, x):   # (B, n, d): dense layers over the slot axis
        h = self.mixer_norm(x).transpose(-1, -2)
        return self.mixer_up(F.silu(self.mixer_down(h))).transpose(-1, -2)

    def forward(self, latents, context):
        lead = latents.shape[:-2]
        latents = latents.reshape(-1, *latents.shape[-2:])
        context = context.reshape(-1, *context.shape[-2:])
        for _ in range(self.iters):
            latents = latents + self.attn(latents, context)
            if self.spatial_mix:
                latents = latents + self._mix(latents)
            latents = latents + self.ff(latents)
        return latents.reshape(*lead, *latents.shape[-2:])
