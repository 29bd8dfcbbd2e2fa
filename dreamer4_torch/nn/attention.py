"""Attention with static-shape KV caching (counterpart of
`dreamer4_tpu/nn/attention.py`).

Same capabilities as the reference module: GQA, per-head sigmoid output
gates, key-only QK-RMSNorm, learned value-residual mixing, BeliefFormer
output orthogonalization, logit softclamp, rotary. The KV cache is a
preallocated (B, heads, max_len, dim_head) buffer pair that calls write into
in place; its length is a host int, so the flash kernel's offset and
kv_len need no device-to-host sync. With `use_fused_small`, uncached
self-attention with a static 2-D mask takes `_small_path`, which runs the
whole block in the flat (B, n*h, dh) layout around K4/K5
(`ops/small_attention.py`). With `ring_axis`, an uncached self-attention
runs causal ring attention over that axis of the ambient mesh
(`parallel/ring_attention.py`): global tokens in and out, each rank of the
ring attending its slice of the time rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..ops import attn_pool, glu_ff
from ..ops.attention import naive_attend
from ..ops.flash_attention import flash_attend
from ..ops.rotary import apply_rotations, apply_rotations_flat
from ..ops.small_attention import small_attend_flat, small_attention_viable
from ..parallel.ring_attention import process_group, ring_attention_global
from ..ops.utils import l2norm, softclamp
from ..tracing import span
from .activations import get_activation
from .dense import Dense
from .init import lecun_normal_, normal_
from .norms import MultiHeadRMSNorm, RMSNorm


class KVCache(NamedTuple):
    """Cache of one attention layer: k, v (B, heads, max_len, dim_head)
    buffers and the host-int write index `length`."""

    k: torch.Tensor
    v: torch.Tensor
    length: int

    @classmethod
    def create(cls, batch: int, heads: int, max_len: int, dim_head: int,
               dtype=torch.float32, device=None) -> 'KVCache':
        shape = (batch, heads, max_len, dim_head)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor) -> 'KVCache':
        """Writes the new keys/values IN PLACE at `length` and returns a
        cache over the same buffers whose length counts them. The old cache
        object keeps its length: a caller that discards the returned cache
        (a denoise step) leaves rows at and beyond its length that the next
        call overwrites and that no query reads before then."""
        n = k_new.shape[-2]
        end = self.length + n
        if end > self.k.shape[-2]:
            raise ValueError(f'KV cache overflow: {end} > {self.k.shape[-2]}')
        self.k[:, :, self.length:end].copy_(k_new)
        self.v[:, :, self.length:end].copy_(v_new)
        return KVCache(self.k, self.v, end)


class FlashSpec(NamedTuple):
    """Static mask description for the fused kernel (offset and kv length
    are supplied alongside)."""
    causal: bool = False
    num_special: int = 0
    special_seq_len: int = 0
    special_attend_only_itself: bool = False


class AttentionOut(NamedTuple):
    out: torch.Tensor
    cache: KVCache | None
    normed_inputs: torch.Tensor


class Attention(nn.Module):
    """Operates on (B, n, d) token blocks; the axial transformer supplies
    B = b*s (time) or b*t (space) plus masks and rotary."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 query_heads: int | None = None, dim_kv_input: int | None = None,
                 pre_rmsnorm: bool = True, pre_context_rmsnorm: bool = False,
                 gate_values: bool = True, rmsnorm_query: bool = False,
                 rmsnorm_key: bool = True, value_residual: bool = True,
                 belief_attn: bool = True, softclamp_value: float | None = 50.0,
                 use_fused_small: bool = False, dtype=None, device=None):
        super().__init__()
        q_heads = query_heads if query_heads is not None else heads
        if q_heads < heads or q_heads % heads != 0:
            raise ValueError(f'query heads {q_heads} must be a multiple of heads {heads}')
        self.dim_head, self.heads, self.q_heads = dim_head, heads, q_heads
        self.pre_rmsnorm = pre_rmsnorm
        self.pre_context_rmsnorm = pre_context_rmsnorm
        self.gate_values = gate_values
        self.value_residual = value_residual
        self.belief_attn = belief_attn
        self.softclamp_value = softclamp_value
        self.use_fused_small = use_fused_small
        self.dtype = dtype
        dim_kv = dim_kv_input if dim_kv_input is not None else dim

        dense = lambda a, b: Dense(a, b, bias=False, dtype=dtype, device=device)
        if pre_rmsnorm:
            self.norm = RMSNorm(dim, device=device)
        if pre_context_rmsnorm:
            self.norm_context = RMSNorm(dim_kv, device=device)
        self.to_q = dense(dim, q_heads * dim_head)
        self.to_k = dense(dim_kv, heads * dim_head)
        self.to_v = dense(dim_kv, heads * dim_head)
        if value_residual:
            self.to_value_residual_mix = Dense(dim, heads, dtype=dtype, device=device)
        if rmsnorm_query:
            self.q_norm = MultiHeadRMSNorm(dim_head, q_heads, device=device)
        if rmsnorm_key:
            self.k_norm = MultiHeadRMSNorm(dim_head, heads, device=device)
        if gate_values:
            self.to_gates = dense(dim, q_heads)
        self.to_out = dense(q_heads * dim_head, dim)

    def _split(self, t, h):   # (B, n, h*d) -> (B, h, n, d)
        return t.reshape(*t.shape[:-1], h, self.dim_head).transpose(-3, -2)

    def forward(self, tokens, context=None, kv_cache: KVCache | None = None, rotary=None,
                mask=None, residual_values=None, flash_spec: FlashSpec | None = None,
                flash_offset: int = 0, allow_small: bool = True, ring_axis=None,
                ring_use_flash: bool = False) -> AttentionOut:
        """`allow_small=False` keeps the call off the small path (the trunk
        passes it for cached calls, whose masks are not static). `ring_axis`
        (a mesh axis name or a process group) runs causal ring attention
        over it instead of `mask` / `flash_spec`, with the kernels when
        `ring_use_flash` holds (`ring_attend_centered`). The call is one
        span, `dreamer4.attention.<path>` (`tracing`)."""
        path = self._path(tokens, context, kv_cache, mask, flash_spec, allow_small, ring_axis)
        with span('dreamer4.attention.' + path):
            return self._attend(path, tokens, context, kv_cache, rotary, mask, residual_values,
                                flash_spec, flash_offset, ring_axis, ring_use_flash)

    def _path(self, tokens, context, kv_cache, mask, flash_spec, allow_small,
              ring_axis) -> str:
        """The path a call takes: 'ring' over a ring axis, 'flash' with a
        flash spec, 'small' where K4/K5 take an uncached self-attention with
        a static 2-D mask at a shape they fit, else 'plain'."""
        if ring_axis is not None:
            return 'ring'
        if flash_spec is not None:
            return 'flash'
        if (self.use_fused_small and allow_small and kv_cache is None and context is None
                and self.q_heads == self.heads and tokens.ndim == 3
                and (mask is None or mask.ndim == 2)):
            dtype = self.dtype if self.dtype is not None else tokens.dtype
            if small_attention_viable(tokens.shape[-2], self.heads, self.dim_head, dtype):
                return 'small'
        return 'plain'

    def _attend(self, path, tokens, context, kv_cache, rotary, mask, residual_values,
                flash_spec, flash_offset, ring_axis, ring_use_flash) -> AttentionOut:
        if self.pre_rmsnorm:
            tokens = self.norm(tokens)
        normed_inputs = tokens

        has_context = context is not None
        if has_context:
            if self.pre_context_rmsnorm:
                context = self.norm_context(context)
        else:
            context = tokens

        if path == 'small':
            return self._small_path(tokens, normed_inputs, mask, rotary, residual_values)

        q = self._split(self.to_q(tokens), self.q_heads)
        k = self._split(self.to_k(context), self.heads)
        v = self._split(self.to_v(context), self.heads)

        if residual_values is not None:
            if not self.value_residual:
                raise ValueError('residual_values given to an attention without value_residual')
            mix = torch.sigmoid(self.to_value_residual_mix(tokens))
            mix = mix.transpose(-1, -2)[..., None]                  # (B, h, n, 1)
            rv = residual_values.transpose(-3, -2)                  # (B, h, n, d)
            v = v + (rv - v) * mix

        if hasattr(self, 'q_norm'):
            q = self.q_norm(q)
        if hasattr(self, 'k_norm'):
            k = self.k_norm(k)

        if rotary is not None:
            q = apply_rotations(rotary, q)
            k = apply_rotations(rotary, k)

        v_for_belief = v   # belief values are the current block's (pre-cache)

        new_cache = None
        kv_len = k.shape[-2]
        if kv_cache is not None:
            new_cache = kv_cache.append(k, v)
            k, v, kv_len = new_cache.k, new_cache.v, new_cache.length

        if path == 'ring':
            if kv_cache is not None or has_context:
                raise ValueError('ring attention is uncached self-attention')
            out = ring_attend_centered(q, k, v, ring_axis, softclamp_value=self.softclamp_value,
                                       use_flash=ring_use_flash)
        elif path == 'flash':
            out = flash_attend_centered(
                q, k, v, int(flash_offset), int(kv_len),
                softclamp_value=self.softclamp_value, causal=flash_spec.causal,
                num_special=flash_spec.num_special,
                special_seq_len=flash_spec.special_seq_len,
                special_attend_only_itself=flash_spec.special_attend_only_itself)
        else:
            out = naive_attend(q, k, v, mask=mask, softclamp_value=self.softclamp_value)

        # BeliefFormer: remove the component of out parallel to the values
        if self.belief_attn and not has_context:
            v_normed = l2norm(v_for_belief)
            if self.q_heads > self.heads:
                v_normed = v_normed.repeat_interleave(self.q_heads // self.heads, dim=-3)
            out = out - (out * v_normed).sum(dim=-1, keepdim=True) * v_normed

        if self.gate_values:
            gates = torch.sigmoid(self.to_gates(tokens))
            out = out * gates.transpose(-1, -2)[..., None]

        out = out.transpose(-3, -2).reshape(*out.shape[:-3], -1, self.q_heads * self.dim_head)
        return AttentionOut(self.to_out(out), new_cache, normed_inputs)

    def _small_path(self, tokens, normed_inputs, mask, rotary, residual_values):
        """Self-attention through K4/K5 with every op in the flat
        (B, n*h, dh) layout (row i = position i // h, head i % h: the
        projections' own memory order, so the reshapes are free). The value
        residual mix, the head norms, rotary, BeliefFormer and the gates
        apply in that layout with tables expanded to (n*h, ...). Same
        parameters and function as the generic path."""
        h, dh = self.heads, self.dim_head
        B, n, _ = tokens.shape
        nh = n * h
        flat = lambda x: x.reshape(B, nh, dh)

        q = flat(self.to_q(tokens))
        k = flat(self.to_k(tokens))
        v = flat(self.to_v(tokens))

        if residual_values is not None:                    # (B, n, h, dh)
            if not self.value_residual:
                raise ValueError('residual_values given to an attention without value_residual')
            mix = torch.sigmoid(self.to_value_residual_mix(tokens))
            v = v + (flat(residual_values) - v) * mix.reshape(B, nh, 1)

        if hasattr(self, 'q_norm'):
            q = self.q_norm.flat(q)
        if hasattr(self, 'k_norm'):
            k = self.k_norm.flat(k)

        if rotary is not None:
            q = apply_rotations_flat(rotary, q, h)
            k = apply_rotations_flat(rotary, k, h)

        out = small_attend_flat(q.contiguous(), k.contiguous(), v.contiguous(), mask, h,
                                softclamp_value=self.softclamp_value)

        if self.belief_attn:
            v_normed = l2norm(v)
            out = out - (out * v_normed).sum(dim=-1, keepdim=True) * v_normed

        if self.gate_values:
            gates = torch.sigmoid(self.to_gates(tokens))
            out = out * gates.reshape(B, nh, 1)

        return AttentionOut(self.to_out(out.reshape(B, n, h * dh)), None, normed_inputs)


def attend_centered(attend, q, k, v, kv_len: int | None = None):
    """`attend(q, k, v - c) + c`, c the values' float32 mean over the
    first `kv_len` keys (all by default). Each query's weights sum to 1
    (every query of the trunk's masks sees a key), so this is
    `attend(q, k, v)`. The kernels' bf16 output, and the backward's
    delta = rowsum(dO * O) taken from it, then carry the values' variation
    instead of their mean: a token whose values barely change over time
    (MoT's special token) keeps its gradient. The counterpart takes delta
    from the bf16 output as is (ROADMAP queue 3)."""
    c = v[..., :kv_len, :].float().mean(dim=-2, keepdim=True)
    out = attend(q, k, (v.float() - c).to(v.dtype))
    groups = q.shape[-3] // k.shape[-3]
    if groups > 1:
        c = c.repeat_interleave(groups, dim=-3)
    return (out.float() + c).to(out.dtype)


def flash_attend_centered(q, k, v, offset: int, kv_len: int, **cfg):
    """`flash_attend` (K1, and K2/K3 under grad) on the values centered
    on their mean over the valid keys (`attend_centered`)."""
    return attend_centered(
        lambda q, k, v: flash_attend(q.contiguous(), k.contiguous(), v.contiguous(), offset,
                                     kv_len, **cfg), q, k, v, kv_len)


def ring_attend_centered(q, k, v, ring_axis, *, softclamp_value, use_flash: bool):
    """Causal ring attention of whole (B, h, T, d) q, k, v over `ring_axis`
    (the counterpart's `shard_map` of `ring_attend`, `mask=None`): each
    rank of the ring attends its T / P time rows and the output is gathered
    whole. The kernels run per block when `use_flash` holds and a rank's
    slice is at least 128 rows (one tile), as in the counterpart; then the
    values are centered on their mean over all T keys, which every rank
    holds (`attend_centered`), as off the ring."""
    group = process_group(ring_axis)
    use_flash = use_flash and q.shape[-2] // torch.distributed.get_world_size(group) >= 128
    if not use_flash:
        return ring_attention_global(q, k, v, group, causal=True,
                                     softclamp_value=softclamp_value)
    return attend_centered(
        lambda q, k, v: ring_attention_global(q, k, v, group, causal=True,
                                              softclamp_value=softclamp_value, use_flash=True),
        q, k, v)


class FeedForward(nn.Module):
    """Pre-RMSNorm (GLU) feedforward. On CUDA a GLU runs as
    `ops.glu_ff.glu_feedforward` (its hidden in 16-byte rows, the GLU one
    kernel each way; silu or gelu in float32 or bf16, anything else raises);
    on the CPU, and without a GLU, the plain code."""

    def __init__(self, dim: int, expansion_factor: float = 4.0, activation: str = 'silu',
                 use_glu: bool | None = None, pre_rmsnorm: bool = True, dtype=None,
                 device=None):
        super().__init__()
        self.activation = activation
        self.act = get_activation(activation)
        self.use_glu = use_glu if use_glu is not None else activation in ('silu', 'gelu')
        dim_inner = int(dim * expansion_factor * (2 / 3 if self.use_glu else 1))
        self.pre_rmsnorm = pre_rmsnorm
        if pre_rmsnorm:
            self.norm = RMSNorm(dim, device=device)
        self.proj_in = Dense(dim, dim_inner * (2 if self.use_glu else 1), dtype=dtype,
                             device=device)
        self.proj_out = Dense(dim_inner, dim, dtype=dtype, device=device)

    def forward(self, x):
        with span('dreamer4.feedforward'):
            if self.pre_rmsnorm:
                x = self.norm(x)
            if self.use_glu and x.is_cuda:
                return self._kernels(x)
            return self._plain(x)

    def _kernels(self, x):
        p_in, p_out = self.proj_in, self.proj_out
        dt = p_in.compute_dtype or torch.promote_types(x.dtype, p_in.weight.dtype)
        return glu_ff.glu_feedforward(x, p_in.weight, p_in.bias, p_out.weight, p_out.bias,
                                      self.activation, dt)

    def _plain(self, x):
        x = self.proj_in(x)
        if self.use_glu:
            x, gates = x.chunk(2, dim=-1)
            x = x * self.act(gates)
        else:
            x = self.act(x)
        return self.proj_out(x)


def rms_normalize(x, eps: float = 1e-6, out: torch.Tensor | None = None):
    """RMSNorm without the learned scale: float32 statistic, stream-dtype
    apply. The trunk computes it once per hidden for all pools. On CUDA one
    kernel (`ops.attn_pool.rms_normalize`), on the CPU the plain code. `out`
    (x's shape; no grad) receives the result, cast to its dtype, and is
    returned: the trunk's slot of its stack of normalized hiddens."""
    if not x.is_cuda:
        return rms_normalize_plain(x, eps, out)
    if out is None or out.dtype == x.dtype:
        return attn_pool.rms_normalize(x, eps, out=out)
    return out.copy_(attn_pool.rms_normalize(x, eps))


def rms_normalize_plain(x, eps: float = 1e-6, out: torch.Tensor | None = None):
    """`rms_normalize`'s plain code, which its kernel computes on CUDA."""
    inv = torch.rsqrt(x.float().square().mean(dim=-1, keepdim=True) + eps)
    y = x * inv.to(x.dtype)
    return y if out is None else out.copy_(y)


class _Kernel(nn.Module):
    """Raw (dim_in, features) weight, flax layout, named like a Dense kernel
    so the pool can fold a scale into it."""

    def __init__(self, dim_in: int, features: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(dim_in, features, device=device))
        lecun_normal_(self.kernel, dim_in)


class _Scale(nn.Module):
    """Raw RMSNorm scale holder."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))


class _Gamma(nn.Module):
    """Raw MultiHeadRMSNorm gamma holder."""

    def __init__(self, heads: int, dim_head: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(heads, dim_head, device=device))


class _StreamingPoolAttention(nn.Module):
    """Single-query attention over the stack of per-layer hiddens, which the
    caller passes already `rms_normalize`d. The pool folds its context-norm
    scale into the k/v weights after casting them to the compute dtype (the
    counterpart's order; folding first drifts in bf16) and runs one wide
    matmul per projection over the (L, B, d) stack."""

    def __init__(self, dim: int, heads: int, dim_head: int, softclamp_value: float | None = 50.0,
                 dtype=None, device=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.softclamp_value = softclamp_value
        self.dtype = dtype
        dense = lambda a, b: Dense(a, b, bias=False, dtype=dtype, device=device)
        self.norm = RMSNorm(dim, device=device)
        self.to_q = dense(dim, heads * dim_head)
        self.norm_context = _Scale(dim, device=device)
        self.to_k = _Kernel(dim, heads * dim_head, device=device)
        self.to_v = _Kernel(dim, heads * dim_head, device=device)
        self.k_norm = _Gamma(heads, dim_head, device=device)
        self.to_gates = dense(dim, heads)
        self.to_out = dense(heads * dim_head, dim)

    def forward(self, x, normed_hiddens):
        # x: (B, d); normed_hiddens: (L, B, d) stack or a list of (B, d)
        dh = self.dim_head
        cdt = self.dtype if self.dtype is not None else x.dtype

        tn = self.norm(x)
        q = self.to_q(tn)

        cscale = self.norm_context.scale.to(cdt)[:, None]
        w_k = cscale * self.to_k.kernel.to(cdt)
        w_v = cscale * self.to_v.kernel.to(cdt)

        n = (normed_hiddens if isinstance(normed_hiddens, torch.Tensor)
             else torch.stack(list(normed_hiddens)))
        n = n.to(torch.promote_types(n.dtype, cdt))
        k = n @ w_k.to(n.dtype)                                           # (L, B, h*dh)
        v = n @ w_v.to(n.dtype)

        scale = (self.k_norm.gamma + 1.0) * dh ** 0.5
        gate_logits = self.to_gates(tn)
        if q.is_cuda:
            # the attention, the head norm and the gates in one kernel
            # forward and one backward (`ops.attn_pool.pool_attend`), in the
            # dtype the plain code's output would take
            dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), gate_logits.dtype)
            out = attn_pool.pool_attend(q.to(dt), k.to(dt), v.to(dt), scale, gate_logits.to(dt),
                                        self.softclamp_value)
        else:
            out = pool_attend_plain(q, k, v, scale.to(cdt), gate_logits, self.softclamp_value)
        return self.to_out(out)


def pool_attend_plain(q, k, v, scale, gate_logits, softclamp_value: float | None = 50.0):
    """The pools' plain code after the projections, the function of
    `ops.attn_pool.pool_attend`: q (B, h*dh), k and v (L, B, h*dh), the
    head-norm scale (h, dh) and the gate logits (B, h); the key statistic
    and the scores in float32, the rest in the inputs' dtype."""
    L, B, _ = k.shape
    h, dh = scale.shape
    q = q.reshape(B, h, dh)
    k, v = k.reshape(L, B, h, dh), v.reshape(L, B, h, dh)
    inv = torch.rsqrt(k.float().square().sum(dim=-1, keepdim=True) + 1e-12)
    k = k * inv.to(k.dtype) * scale.to(k.dtype)

    sim = torch.einsum('bhd,lbhd->bhl', q.float(), k.float()) * dh ** -0.5
    if softclamp_value is not None:
        sim = softclamp(sim, softclamp_value)
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    out = torch.einsum('bhl,lbhd->bhd', attn, v)
    return (out * torch.sigmoid(gate_logits)[..., None]).reshape(B, h * dh)


class AttentionPool(nn.Module):
    """Each token cross-attends over the stack of its own per-layer hiddens."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 64, dtype=None, device=None):
        super().__init__()
        self.attn = _StreamingPoolAttention(dim, heads, dim_head, dtype=dtype, device=device)

    def forward(self, x, hiddens, normed_hiddens=None):
        """One span, `dreamer4.attention_pool` (`tracing`), from the first op
        to the return; the backward runs outside it."""
        with span('dreamer4.attention_pool'):
            lead_shape = x.shape[:-1]
            flat = lambda t: t.reshape(-1, t.shape[-1])
            if normed_hiddens is None:
                normed_hiddens = [rms_normalize(h) for h in hiddens]
            if not isinstance(normed_hiddens, torch.Tensor):
                normed_hiddens = [flat(h) for h in normed_hiddens]
            out = self.attn(flat(x), normed_hiddens)
            return out.reshape(*lead_shape, x.shape[-1])


class LearnedQueriesAttentionPool(nn.Module):
    """Perceiver-style resampler between latent-token and spatial-token
    counts: (..., n, d_in) -> (..., num_queries, dim)."""

    def __init__(self, num_queries: int, dim: int, dim_kv_input: int | None = None,
                 heads: int = 8, dim_head: int = 64, dtype=None, device=None):
        super().__init__()
        self.queries = nn.Parameter(torch.empty(num_queries, dim, device=device))
        normal_(self.queries, 1e-2)
        self.attn = Attention(dim, dim_head=dim_head, heads=heads, dim_kv_input=dim_kv_input,
                              gate_values=True, value_residual=False, belief_attn=False,
                              pre_rmsnorm=True, pre_context_rmsnorm=True, dtype=dtype,
                              device=device)

    def forward(self, x):
        lead_shape = x.shape[:-2]
        x = x.reshape(-1, *x.shape[-2:])
        queries = self.queries.expand(x.shape[0], *self.queries.shape)
        out = self.attn(queries, context=x).out
        return out.reshape(*lead_shape, *out.shape[-2:])
