"""The axial space-time transformer, plainly: tokens (b, t, s, d).

Layer i attends over time (causal, rotary) when (i + 1) is a multiple of
`time_every`, else over the s tokens of each frame. Each attention has a
pre-RMSNorm, key-only per-head QK norm ((gamma + 1) sqrt(dh) on the unit
key), values mixed with the value residual (one projection of the normed
entry tokens, shared by every layer) by a per-head sigmoid, a logit
softclamp, the BeliefFormer step (the output's component along the unit
value removed) and per-head sigmoid gates. Each layer's feedforward is a
pre-RMSNorm SiLU GLU. After every layer but the last, an attention pool: each
token attends, by itself, over the stack of its own hiddens so far (the entry
tokens and each attention's and feedforward's output), RMS-normalized. At the
end the special tokens cross-attend over the frame's other tokens (unless they
attend only to themselves), a final pool reads all the hiddens, and an
optional RMSNorm closes.

Under grad each layer is recomputed in the backward (`checkpoint`), so the
float32 reference fits at the timed sizes.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .ops import (Precision, attend, causal_mask, l2norm, linear, rms_normalize, rmsnorm,
                  rotary_angles, rotate, silu_mlp, softclamp, space_mask)

POOL_HEADS, POOL_DIM_HEAD = 4, 64


def _heads(x, h):            # (B, n, h*dh) -> (B, h, n, dh)
    return x.reshape(*x.shape[:-1], h, -1).transpose(-3, -2)


def _merge(x):               # (B, h, n, dh) -> (B, n, h*dh)
    return x.transpose(-3, -2).reshape(*x.shape[:-3], x.shape[-2], -1)


def attention(prec: Precision, P: dict, pre: str, x, heads: int, *, rv=None, angles=None,
              mask=None, context=None, softclamp_value=50.0):
    """One attention block on (B, n, d) tokens; rv (B, n, h, dh) the value
    residual; `context` (B, m, d) makes it a cross-attention."""
    xn = rmsnorm(x, P[pre + 'norm.scale'])
    ctx = xn if context is None else rmsnorm(context, P[pre + 'norm_context.scale'])
    q = _heads(linear(prec, xn, P[pre + 'to_q.weight']), heads)
    k = _heads(linear(prec, ctx, P[pre + 'to_k.weight']), heads)
    v = _heads(linear(prec, ctx, P[pre + 'to_v.weight']), heads)
    dh = q.shape[-1]
    if rv is not None:
        mix = torch.sigmoid(linear(prec, xn, P[pre + 'to_value_residual_mix.weight'],
                                   P[pre + 'to_value_residual_mix.bias']))
        v = v + (rv.transpose(-3, -2) - v) * mix.transpose(-1, -2)[..., None]
    k = l2norm(k) * ((P[pre + 'k_norm.gamma'] + 1.0) * math.sqrt(dh))[:, None, :]
    if angles is not None:
        q, k = rotate(q, angles), rotate(k, angles)
    out = attend(prec, q, k, v, mask, softclamp_value)
    if context is None:
        vn = l2norm(v)
        out = out - (out * vn).sum(dim=-1, keepdim=True) * vn
    gates = torch.sigmoid(linear(prec, xn, P[pre + 'to_gates.weight']))
    out = out * gates.transpose(-1, -2)[..., None]
    return linear(prec, _merge(out), P[pre + 'to_out.weight'])


def feedforward(prec: Precision, P: dict, pre: str, x):
    h = linear(prec, rmsnorm(x, P[pre + 'norm.scale']), P[pre + 'proj_in.weight'],
               P[pre + 'proj_in.bias'])
    a, gates = h.chunk(2, dim=-1)
    return linear(prec, a * torch.nn.functional.silu(gates), P[pre + 'proj_out.weight'],
                  P[pre + 'proj_out.bias'])


def pool(prec: Precision, P: dict, pre: str, x, normed_hiddens):
    """Each token of x (..., d) attends over its own L normed hiddens
    (L, ..., d)."""
    pre = pre + 'attn.'
    h, dh = POOL_HEADS, POOL_DIM_HEAD
    tn = rmsnorm(x, P[pre + 'norm.scale'])
    q = linear(prec, tn, P[pre + 'to_q.weight']).reshape(*x.shape[:-1], h, dh)
    ctx = normed_hiddens * P[pre + 'norm_context.scale']
    k = prec.mm(ctx, P[pre + 'to_k.kernel']).reshape(*ctx.shape[:-1], h, dh)
    v = prec.mm(ctx, P[pre + 'to_v.kernel']).reshape(*ctx.shape[:-1], h, dh)
    k = l2norm(k) * ((P[pre + 'k_norm.gamma'] + 1.0) * math.sqrt(dh))
    # (..., h, 1, dh) @ (..., h, dh, L): every token's query against its stack
    qt = q[..., None, :]
    kt = k.movedim(0, -1)                                  # (..., h, dh, L)
    sim = softclamp(prec.mm(qt, kt) / math.sqrt(dh), 50.0)
    attn = torch.softmax(sim, dim=-1)
    out = prec.mm(attn, v.movedim(0, -2))[..., 0, :]       # (..., h, dh)
    out = out * torch.sigmoid(linear(prec, tn, P[pre + 'to_gates.weight']))[..., None]
    return linear(prec, out.reshape(*x.shape[:-1], h * dh), P[pre + 'to_out.weight'])


class Trunk:
    def __init__(self, P: dict, prefix: str, *, depth: int, heads: int, time_every: int,
                 num_special: int, special_only_itself: bool = False, final_norm: bool,
                 prec: Precision):
        self.P, self.pre, self.prec = P, prefix, prec
        self.depth, self.heads, self.time_every = depth, heads, time_every
        self.num_special, self.only_itself = num_special, special_only_itself
        self.final_norm = final_norm

    def _layer(self, i, x, rv, angles, smask, *normed):
        """Layer i's attention and feedforward, and its pool when it has one.
        -> (tokens after the pool, hidden after attention, after feedforward)."""
        P, pre, prec = self.P, self.pre, self.prec
        b, t, s, d = x.shape
        attn = f'{pre}attn_{i}.'
        if (i + 1) % self.time_every == 0:
            xt = x.transpose(1, 2).reshape(b * s, t, d)
            rvt = rv.transpose(1, 2).reshape(b * s, t, *rv.shape[-2:])
            out = attention(prec, P, attn, xt, self.heads, rv=rvt, angles=angles,
                            mask=causal_mask(t, x.device))
            x = x + out.reshape(b, s, t, d).transpose(1, 2)
        else:
            out = attention(prec, P, attn, x.reshape(b * t, s, d), self.heads,
                            rv=rv.reshape(b * t, s, *rv.shape[-2:]), mask=smask)
            x = x + out.reshape(b, t, s, d)
        h_attn = x
        x = x + feedforward(prec, P, f'{pre}ff_{i}.', x)
        h_ff = x
        if i < self.depth - 1:
            stack = torch.stack([*normed, rms_normalize(h_attn), rms_normalize(h_ff)])
            x = x + pool(prec, P, f'{pre}attn_pool_{i}.', x, stack)
        return x, h_attn, h_ff

    def __call__(self, x):
        P, pre, prec = self.P, self.pre, self.prec
        b, t, s, d = x.shape
        rv = linear(prec, rmsnorm(x, P[pre + 'value_residual_norm.scale']),
                    P[pre + 'to_value_residual.weight'])
        rv = rv.reshape(b, t, s, self.heads, -1)
        angles = rotary_angles(rv.shape[-1], t, x.device)
        smask = space_mask(s, self.num_special, self.only_itself, x.device)
        normed = [rms_normalize(x)]
        for i in range(self.depth):
            if torch.is_grad_enabled():
                x, h_attn, h_ff = checkpoint(self._layer, i, x, rv, angles, smask, *normed,
                                             use_reentrant=False)
            else:
                x, h_attn, h_ff = self._layer(i, x, rv, angles, smask, *normed)
            normed += [rms_normalize(h_attn), rms_normalize(h_ff)]
        ns = self.num_special
        if ns > 0 and not self.only_itself:
            other, special = x[:, :, :-ns], x[:, :, -ns:]
            cross = attention(prec, P, pre + 'final_special_cross_attn.',
                              special.reshape(b * t, ns, d), self.heads,
                              context=other.reshape(b * t, s - ns, d))
            special = special + cross.reshape(b, t, ns, d)
            special = special + feedforward(prec, P, pre + 'final_special_ff.', special)
            x = torch.cat([other, special], dim=2)
        x = x + pool(prec, P, pre + 'final_attn_pool.', x, torch.stack(normed))
        if self.final_norm:
            x = rmsnorm(x, P[pre + 'final_norm.scale'])
        return x


__all__ = ['Trunk', 'attention', 'feedforward', 'pool', 'silu_mlp']
