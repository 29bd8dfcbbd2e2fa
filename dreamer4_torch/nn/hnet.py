"""Hierarchical temporal transformers, the trunk's H-Net splice
(counterpart of `dreamer4_tpu/nn/hnet.py`).

`HierarchicalTemporalTransformer` (fixed stride): time is cut into chunks of
`compression_ratio` frames, each chunk summarized by a content softmax over
its frames, a small causal transformer (the repo's `Attention` with rotary
over the chunk axis) runs over the summaries, and every frame reads, through
a sigmoid gate, the inner output of the latest chunk completed strictly
before it. The ratio loss is the selection softmax's normalized entropy.

`DynamicChunkingTemporalTransformer` (learned boundaries): a boundary head
gives p_t per frame, frame t joins chunk floor(cumsum(p)_t) (slot budget
2 * ceil(T / R), the mass clipped below it), chunks are summarized by a
segment softmax carrying a straight-through factor (1 + m - detach(m)) to
the boundary head, and the inner transformer (NoPE, plain attention) masks
each row's own chunk count. The ratio loss anchors mean(p) at 1/R. The
segment sums are matmuls of the (B, T, C) one-hot weights with the frames.

Both compute in float32 whatever the stream's dtype (their layers have no
compute dtype, as the counterpart's), and keep float32 caches. Streaming
(one frame per call) carries a partial-chunk buffer (fixed; its frame count
is a host int, so the inner transformer runs only when a chunk completes)
or an online softmax with per-row commits (dynamic).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.masks import build_attend_mask
from ..ops.rotary import rotary_frequencies
from .attention import Attention, FeedForward, KVCache
from .dense import Dense
from .norms import RMSNorm

NEG_INF = -1e30


class HNetCache(NamedTuple):
    inner_kv: tuple               # per inner layer, a KVCache over the chunk axis
    partial: torch.Tensor         # (B, R, d) frames of the chunk in progress
    partial_count: int            # frames in the partial buffer (host int)
    last_summary: torch.Tensor    # (B, d) inner output of the latest completed chunk
    has_summary: float            # 1.0 once a chunk has completed


class DynamicHNetCache(NamedTuple):
    """Boundaries are per row, so every field has a batch axis."""
    inner_k: tuple                # per inner layer (B, heads, C_max, dh)
    inner_v: tuple
    chunk_counts: torch.Tensor    # (B,) int64 completed chunks
    mass: torch.Tensor            # (B,) cumulative boundary mass
    acc_x: torch.Tensor           # (B, d) online-softmax weighted frame sum
    acc_w: torch.Tensor           # (B,) online-softmax weight sum
    acc_max: torch.Tensor         # (B,) running max score
    last_summary: torch.Tensor    # (B, d)
    has_summary: torch.Tensor     # (B,) 0/1


def _float(x):
    return x.to(torch.promote_types(x.dtype, torch.float32))


class HierarchicalTemporalTransformer(nn.Module):
    def __init__(self, dim: int, depth: int = 2, heads: int = 4, dim_head: int = 32,
                 compression_ratio: int = 4, device=None):
        super().__init__()
        self.dim, self.depth, self.heads, self.dim_head = dim, depth, heads, dim_head
        self.compression_ratio = compression_ratio
        self.to_scores = Dense(dim, 1, device=device)
        self.score_norm = RMSNorm(dim, device=device)
        self.out_gate = Dense(dim, dim, device=device)
        self.summary_out = Dense(dim, dim, device=device)
        for i in range(depth):
            setattr(self, f'inner_attn_{i}', Attention(dim, dim_head=dim_head, heads=heads,
                                                       value_residual=False, belief_attn=False,
                                                       device=device))
            setattr(self, f'inner_ff_{i}', FeedForward(dim, device=device))

    def blocks(self):
        return [(getattr(self, f'inner_attn_{i}'), getattr(self, f'inner_ff_{i}'))
                for i in range(self.depth)]

    def init_cache(self, batch: int, max_chunks: int, device=None) -> HNetCache:
        f32 = dict(dtype=torch.float32, device=device)
        return HNetCache(
            inner_kv=tuple(KVCache.create(batch, self.heads, max_chunks, self.dim_head, **f32)
                           for _ in range(self.depth)),
            partial=torch.zeros((batch, self.compression_ratio, self.dim), **f32),
            partial_count=0, last_summary=torch.zeros((batch, self.dim), **f32),
            has_summary=0.0)

    def forward(self, x, cache: HNetCache | None = None):
        """x (B, T, d) -> (out, ratio_loss, next_cache). Without a cache any
        T (training, the parallel pass); with one, T == 1."""
        x = _float(x)
        B, T, d = x.shape
        R = self.compression_ratio
        if cache is None:
            pad = (-T) % R
            xp = F.pad(x, (0, 0, 0, pad))
            C = xp.shape[1] // R
            chunks = xp.reshape(B, C, R, d)
            scores = self.to_scores(self.score_norm(chunks))[..., 0]          # (B, C, R)
            if pad > 0:
                valid = torch.arange(C * R, device=x.device).reshape(C, R) < T
                scores = torch.where(valid, scores, NEG_INF)
            weights = torch.softmax(scores, dim=-1)
            summaries = torch.einsum('bcr,bcrd->bcd', weights, chunks)
            # keep the selection decisive: its entropy, normalized
            entropy = -(weights * torch.log(weights.clamp_min(1e-9))).sum(dim=-1)
            ratio_loss = entropy.mean() / math.log(float(R))

            h = summaries
            rot = rotary_frequencies(self.dim_head, C, device=x.device)
            mask = build_attend_mask(C, C, causal=True, device=x.device)
            for attn, ff in self.blocks():
                h = h + attn(h, rotary=rot, mask=mask).out
                h = h + ff(h)
            h = self.summary_out(h)                                           # (B, C, d)

            # each frame reads the latest chunk completed before it
            prev = torch.arange(T, device=x.device) // R - 1
            gathered = torch.where(prev[None, :, None] >= 0, h[:, prev.clamp_min(0)], 0.0)
            return x + torch.sigmoid(self.out_gate(x)) * gathered, ratio_loss, None

        if T != 1:
            raise ValueError('the streaming H-Net takes one frame per call')
        idx = cache.partial_count
        partial = cache.partial.clone()
        partial[:, idx] = x[:, 0].to(partial.dtype)
        count = idx + 1
        complete = count >= R

        inner_kv, last_summary, has_summary = cache.inner_kv, cache.last_summary, cache.has_summary
        if complete:
            # the full chunk's summary steps the inner transformer, whose
            # caches commit (the counterpart runs it every frame and keeps
            # it only here)
            weights = torch.softmax(self.to_scores(self.score_norm(partial))[..., 0], dim=-1)
            h = torch.einsum('br,brd->bd', weights, partial)[:, None]
            chunk_count = cache.inner_kv[0].length
            max_chunks = cache.inner_kv[0].k.shape[-2]
            rot = rotary_frequencies(self.dim_head, 1, offset=chunk_count, device=x.device)
            mask = torch.arange(max_chunks, device=x.device)[None, :] <= chunk_count
            new_kv = []
            for (attn, ff), kv in zip(self.blocks(), cache.inner_kv):
                a = attn(h, kv_cache=kv, rotary=rot, mask=mask)
                h = h + a.out
                h = h + ff(h)
                new_kv.append(a.cache)
            inner_kv = tuple(new_kv)
            last_summary = self.summary_out(h[:, 0])
            has_summary = 1.0
            partial = torch.zeros_like(partial)

        # the output reads the latest chunk completed strictly before this frame
        gathered = cache.last_summary * cache.has_summary
        out = x + torch.sigmoid(self.out_gate(x)) * gathered[:, None]
        next_cache = HNetCache(inner_kv=inner_kv, partial=partial,
                               partial_count=0 if complete else count,
                               last_summary=last_summary, has_summary=has_summary)
        return out, torch.zeros((), device=x.device), next_cache


class DynamicChunkingTemporalTransformer(nn.Module):
    # the counterpart's `setup` list of dicts flattens to
    # `inner_layers_{j}_{norm,to_q,to_k,to_v,to_out,ff}`, the names used here
    _INNER = ('norm', 'to_q', 'to_k', 'to_v', 'to_out', 'ff')

    def __init__(self, dim: int, depth: int = 2, heads: int = 4, dim_head: int = 32,
                 compression_ratio: int = 4, device=None):
        super().__init__()
        self.dim, self.depth, self.heads, self.dim_head = dim, depth, heads, dim_head
        self.compression_ratio = compression_ratio
        self.boundary_head = Dense(dim, 1, device=device)
        self.score_head = Dense(dim, 1, device=device)
        self.score_norm = RMSNorm(dim, device=device)
        self.gate_head = Dense(dim, dim, device=device)
        self.proj_out = Dense(dim, dim, device=device)
        inner = heads * dim_head
        for j in range(depth):
            for name, module in (('norm', RMSNorm(dim, device=device)),
                                 ('to_q', Dense(dim, inner, bias=False, device=device)),
                                 ('to_k', Dense(dim, inner, bias=False, device=device)),
                                 ('to_v', Dense(dim, inner, bias=False, device=device)),
                                 ('to_out', Dense(inner, dim, bias=False, device=device)),
                                 ('ff', FeedForward(dim, device=device))):
                setattr(self, f'inner_layers_{j}_{name}', module)

    def layers(self):
        return [{name: getattr(self, f'inner_layers_{j}_{name}') for name in self._INNER}
                for j in range(self.depth)]

    def init_cache(self, batch: int, max_chunks: int, device=None) -> DynamicHNetCache:
        f32 = dict(dtype=torch.float32, device=device)
        kv = lambda: tuple(torch.zeros((batch, self.heads, max_chunks, self.dim_head), **f32)
                           for _ in range(self.depth))
        return DynamicHNetCache(
            inner_k=kv(), inner_v=kv(),
            chunk_counts=torch.zeros((batch,), dtype=torch.long, device=device),
            mass=torch.zeros((batch,), **f32), acc_x=torch.zeros((batch, self.dim), **f32),
            acc_w=torch.zeros((batch,), **f32), acc_max=torch.full((batch,), NEG_INF, **f32),
            last_summary=torch.zeros((batch, self.dim), **f32),
            has_summary=torch.zeros((batch,), **f32))

    def boundary_probs(self, x):
        """(B, T, d) -> (B, T) boundary probabilities."""
        return torch.sigmoid(self.boundary_head(self.score_norm(x))[..., 0])

    def _split_heads(self, t):
        B, n, _ = t.shape
        return t.reshape(B, n, self.heads, self.dim_head).transpose(1, 2)

    def _inner_kv(self, layer, h):
        hn = layer['norm'](h)
        return self._split_heads(layer['to_k'](hn)), self._split_heads(layer['to_v'](hn))

    def _inner_attend(self, layer, h, k, v, mask):
        """h (B, n, d) queries; k, v (B, heads, m, dh); mask (B, n, m). A row
        with nothing to attend to reads zeros."""
        B, n, _ = h.shape
        q = self._split_heads(layer['to_q'](layer['norm'](h)))
        s = torch.einsum('bhnd,bhmd->bhnm', q, k) * self.dim_head ** -0.5
        s = torch.where(mask[:, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        p = torch.where(mask[:, None].any(dim=-1, keepdim=True), p, 0.0)
        o = torch.einsum('bhnm,bhmd->bhnd', p, v).transpose(1, 2).reshape(B, n, -1)
        return layer['to_out'](o)

    def forward(self, x, cache: DynamicHNetCache | None = None):
        """x (B, T, d) -> (out, ratio_loss, next_cache); with a cache T == 1."""
        x = _float(x)
        B, T, d = x.shape
        R = self.compression_ratio
        dev = x.device
        if cache is None:
            C = 2 * ((T + R - 1) // R)                                        # slot budget
            p_bound = self.boundary_probs(x)                                  # (B, T)
            mass = torch.cumsum(p_bound, dim=1).clamp_max(C - 1e-3)
            chunk_id = torch.floor(mass).long()                               # (B, T)

            scores = self.score_head(self.score_norm(x))[..., 0]              # (B, T)
            onehot = F.one_hot(chunk_id, C).to(x.dtype)                       # (B, T, C)
            seg_max = torch.where(onehot > 0, scores[..., None], NEG_INF).amax(dim=1)
            e = torch.exp(scores - seg_max.gather(1, chunk_id))
            # straight-through: equal to 1, its gradient reaches the boundaries
            w = e * (1.0 + mass - mass.detach())
            weighted = onehot * w[..., None]                                  # (B, T, C)
            seg_wsum = weighted.sum(dim=1)                                    # (B, C)
            seg_xsum = weighted.transpose(1, 2) @ x                           # (B, C, d)
            # empty slots: `where` keeps both branches of the division finite
            nonempty = (seg_wsum > 0)[..., None]
            summaries = torch.where(
                nonempty, seg_xsum / torch.where(nonempty, seg_wsum[..., None], 1.0), 0.0)

            slots = torch.arange(C, device=dev)
            chunk_valid = slots[None, :] < (chunk_id[:, -1] + 1)[:, None]
            ratio_loss = ((p_bound.mean(dim=1) - 1.0 / R) ** 2).mean()

            causal = slots[:, None] >= slots[None, :]
            mask = causal[None] & chunk_valid[:, None, :]
            h = summaries
            for layer in self.layers():
                k, v = self._inner_kv(layer, h)
                h = h + self._inner_attend(layer, h, k, v, mask)
                h = h + layer['ff'](h)
            h = self.proj_out(h)                                              # (B, C, d)

            # frame t reads chunk c_t - 1, which holds only earlier frames
            prev = chunk_id - 1
            picked = h.gather(1, prev.clamp_min(0)[..., None].expand(B, T, d))
            gathered = torch.where(prev[..., None] >= 0, picked, 0.0)
            return x + torch.sigmoid(self.gate_head(x)) * gathered, ratio_loss, None

        if T != 1:
            raise ValueError('the streaming H-Net takes one frame per call')
        xt = x[:, 0]
        C_max = cache.inner_k[0].shape[-2]
        p_t = self.boundary_probs(xt[:, None])[:, 0]
        mass = (cache.mass + p_t).clamp_max(C_max - 1e-3)
        c_new = torch.floor(mass).long()
        c_old = torch.floor(cache.mass).long()
        complete = (c_new > c_old) & (cache.acc_w > 0)                        # (B,)

        # the old chunk's summary from the online softmax
        has_mass = (cache.acc_w > 0)[:, None]
        finalized = torch.where(
            has_mass, cache.acc_x / torch.where(has_mass, cache.acc_w[:, None], 1.0), 0.0)

        # the inner step on it; rows whose chunk completed commit slot c_old
        h = finalized[:, None]
        slots = torch.arange(C_max, device=dev)[None, :]
        write = complete[:, None] & (slots == c_old[:, None])                # (B, C_max)
        kv_valid = (slots <= c_old[:, None])[:, None, :]                      # (B, 1, C_max)
        new_k, new_v = [], []
        for layer, k_buf, v_buf in zip(self.layers(), cache.inner_k, cache.inner_v):
            k_new, v_new = self._inner_kv(layer, h)                           # (B, H, 1, dh)
            commit = write[:, None, :, None]
            k_all = torch.where(commit, k_new, k_buf)
            v_all = torch.where(commit, v_new, v_buf)
            h = h + self._inner_attend(layer, h, k_all, v_all, kv_valid)
            h = h + layer['ff'](h)
            new_k.append(k_all)
            new_v.append(v_all)
        h = self.proj_out(h[:, 0])

        last_summary = torch.where(complete[:, None], h, cache.last_summary)
        has_summary = torch.maximum(cache.has_summary, complete.float())
        chunk_counts = torch.where(complete, cache.chunk_counts + 1, cache.chunk_counts)

        # reset or continue the accumulator, then add this frame to chunk c_new
        acc_x = torch.where(complete[:, None], 0.0, cache.acc_x)
        acc_w = torch.where(complete, 0.0, cache.acc_w)
        acc_max = torch.where(complete, NEG_INF, cache.acc_max)
        score_t = self.score_head(self.score_norm(xt))[..., 0]
        new_max = torch.maximum(acc_max, score_t)
        rescale = torch.exp(acc_max - new_max)
        e_t = torch.exp(score_t - new_max)
        acc_x = acc_x * rescale[:, None] + e_t[:, None] * xt
        acc_w = acc_w * rescale + e_t

        gathered = last_summary * has_summary[:, None]
        out = (xt + torch.sigmoid(self.gate_head(xt)) * gathered)[:, None]
        next_cache = DynamicHNetCache(
            inner_k=tuple(new_k), inner_v=tuple(new_v), chunk_counts=chunk_counts, mass=mass,
            acc_x=acc_x, acc_w=acc_w, acc_max=new_max, last_summary=last_summary,
            has_summary=has_summary)
        return out, torch.zeros((), device=dev), next_cache
