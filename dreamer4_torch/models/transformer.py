"""Axial space-time transformer, the trunk of the dynamics world model
(counterpart of `dreamer4_tpu/models/transformer.py`, core only).

Token layout is (b, t, s, d). Every `time_block_every`-th layer attends over
time (causal, rotary, KV-cached, batch folded to b*s); the others attend over
space (special-token masking, batch folded to b*t). Ported: the value
residual, per-head gates, QK norm, the attention pools over the shared
normed-hidden buffer, the final special cross-attend, `init_cache`,
`token_count`, the flash gate and the small-attention path
(`use_fused_small`, uncached calls only). Not ported yet, and refused when
set: the GRU time layer, MoT, MOSS spatial modules, H-Net, PoPE and ring
attention.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from ..nn.attention import (Attention, AttentionPool, FeedForward, FlashSpec, KVCache,
                            rms_normalize)
from ..nn.dense import Dense
from ..nn.norms import RMSNorm
from ..ops.masks import build_attend_mask
from ..ops.rotary import rotary_frequencies


class TransformerCache(NamedTuple):
    kv: tuple           # one KVCache per time layer
    token_count: int    # frames already in the cache (host int)


class TransformerOutputs(NamedTuple):
    tokens: torch.Tensor
    cache: TransformerCache | None
    normed_time_inputs: torch.Tensor | None   # (num_time_layers, b*s, t, d)
    normed_space_inputs: torch.Tensor | None  # (num_space_layers, b*t, s, d)
    layer_hiddens: list
    token_count: int


def _to_time_major(x):
    # (b, t, s, ...) -> (b*s, t, ...)
    x = x.transpose(1, 2)
    return x.reshape(-1, *x.shape[2:]), x.shape[:2]


def _from_time_major(x, bs_shape):
    return x.reshape(*bs_shape, *x.shape[1:]).transpose(1, 2)


def _to_space_major(x):
    # (b, t, s, ...) -> (b*t, s, ...)
    return x.reshape(-1, *x.shape[2:]), x.shape[:2]


def _from_space_major(x, bt_shape):
    return x.reshape(*bt_shape, *x.shape[1:])


_NOT_PORTED = ('rnn_time', 'mot_temporal', 'time_attention_use_pope',
               'space_attention_use_pope', 'spatial_module_layers', 'time_ring_axis',
               'h_net_layer')


class AxialSpaceTimeTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, attn_heads: int = 8, attn_dim_head: int = 64,
                 query_heads: int | None = None, attn_softclamp_value: float | None = 50.0,
                 time_block_every: int = 4, num_special_tokens: int = 1,
                 special_attend_only_itself: bool = False, full_spatial_attn: bool = False,
                 final_norm: bool = True, value_residual: bool = True,
                 use_attn_pool: bool = True, use_flash_attention: bool = False,
                 flash_min_scores: int = 128 * 128, use_fused_small: bool | None = None,
                 ff_expansion_factor: float = 4.0,
                 ff_activation: str = 'silu', gate_values: bool = True,
                 rmsnorm_query: bool = False, rmsnorm_key: bool = True,
                 belief_attn: bool = True, dtype=None, device=None, **not_ported):
        super().__init__()
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f'unexpected argument {name}')
            if value:
                raise NotImplementedError(f'{name} is not ported to dreamer4_torch yet')
        device = resolve_device(device)
        self.dim, self.depth = dim, depth
        self.attn_heads, self.attn_dim_head = attn_heads, attn_dim_head
        self.time_block_every = time_block_every
        self.num_special_tokens = num_special_tokens
        self.special_attend_only_itself = special_attend_only_itself
        self.full_spatial_attn = full_spatial_attn
        self.value_residual = value_residual
        self.use_attn_pool = use_attn_pool
        self.use_flash_attention = use_flash_attention
        self.flash_min_scores = flash_min_scores
        self.dtype = dtype

        if value_residual:
            self.value_residual_norm = RMSNorm(dim, device=device)
            self.to_value_residual = Dense(dim, attn_heads * attn_dim_head, bias=False,
                                           dtype=dtype, device=device)
        attn_common = dict(dim=dim, heads=attn_heads, dim_head=attn_dim_head,
                           query_heads=query_heads, softclamp_value=attn_softclamp_value,
                           gate_values=gate_values, rmsnorm_query=rmsnorm_query,
                           rmsnorm_key=rmsnorm_key, belief_attn=belief_attn,
                           use_fused_small=bool(use_fused_small), dtype=dtype, device=device)
        ff_kwargs = dict(dim=dim, expansion_factor=ff_expansion_factor,
                         activation=ff_activation, dtype=dtype, device=device)
        for i in range(depth):
            setattr(self, f'attn_{i}', Attention(**attn_common, value_residual=value_residual))
            setattr(self, f'ff_{i}', FeedForward(**ff_kwargs))
            if use_attn_pool and i < depth - 1:
                setattr(self, f'attn_pool_{i}', AttentionPool(dim, dtype=dtype, device=device))
        if self.should_special_cross_attend:
            self.final_special_cross_attn = Attention(**attn_common, value_residual=False,
                                                      pre_context_rmsnorm=True)
            self.final_special_ff = FeedForward(**ff_kwargs)
        if use_attn_pool:
            self.final_attn_pool = AttentionPool(dim, dtype=dtype, device=device)
        self.final_norm = RMSNorm(dim, device=device) if final_norm else None

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def is_time_layer(self) -> tuple[bool, ...]:
        return tuple((i + 1) % self.time_block_every == 0 for i in range(self.depth))

    @property
    def num_time_layers(self) -> int:
        return sum(self.is_time_layer)

    @property
    def should_special_cross_attend(self) -> bool:
        return (self.num_special_tokens > 0 and not self.special_attend_only_itself
                and not self.full_spatial_attn)

    def init_cache(self, batch: int, space_len: int, max_time: int, dtype=torch.float32,
                   device=None) -> TransformerCache:
        """Preallocated decode cache buffers, on the trunk's device unless
        `device` is given."""
        kv = tuple(KVCache.create(batch * space_len, self.attn_heads, max_time,
                                  self.attn_dim_head, dtype=dtype,
                                  device=self.device if device is None else device)
                   for _ in range(self.num_time_layers))
        return TransformerCache(kv=kv, token_count=0)

    def forward(self, tokens, cache: TransformerCache | None = None, max_time: int | None = None,
                return_intermediates: bool = False, collect_normed_inputs: bool = True):
        b, t_full, s, d = tokens.shape
        device = tokens.device
        # the trunk owns the compute dtype: cast once at entry
        if self.dtype is not None:
            tokens = tokens.to(self.dtype)

        continuing = cache is not None
        if cache is None and max_time is not None:
            cache = self.init_cache(b, s, max_time, dtype=tokens.dtype, device=device)
        has_cache = cache is not None
        token_count = cache.token_count if has_cache else 0

        # when continuing, only the newest frame is processed
        past_tokens = tokens[:, :0]
        if continuing and t_full > 1:
            past_tokens, tokens = tokens[:, :-1], tokens[:, -1:]
        t = tokens.shape[1]

        num_spatial_special = 0 if self.full_spatial_attn else self.num_special_tokens
        # time attention's k length is the cache buffer's when cached
        time_k_len = cache.kv[0].k.shape[-2] if has_cache and self.num_time_layers > 0 else t

        # the flash gate, on the same static sizes as the counterpart
        use_flash_time = self.use_flash_attention and t * time_k_len >= self.flash_min_scores
        use_flash_space = self.use_flash_attention and s * s >= self.flash_min_scores

        space_mask = time_mask = space_flash = time_flash = None
        if use_flash_space:
            space_flash = FlashSpec(causal=False, num_special=num_spatial_special,
                                    special_seq_len=s,
                                    special_attend_only_itself=self.special_attend_only_itself)
        else:
            space_mask = build_attend_mask(
                s, s, num_special=num_spatial_special, block_size_per_special=s,
                special_attend_only_itself=self.special_attend_only_itself, device=device)
        if use_flash_time:
            time_flash = FlashSpec(causal=True)
        elif has_cache:
            j = torch.arange(time_k_len, device=device)
            i = torch.arange(t, device=device)
            time_mask = j[None, :] <= (token_count + i[:, None])
        else:
            time_mask = build_attend_mask(t, t, causal=True, device=device)

        time_rotary = rotary_frequencies(self.attn_dim_head, t, offset=token_count,
                                         device=device)

        residual_values = None
        if self.value_residual:
            rv = self.to_value_residual(self.value_residual_norm(tokens))
            residual_values = rv.reshape(b, t, s, self.attn_heads, self.attn_dim_head)

        new_kv_caches = []
        normed_time_inputs, normed_space_inputs = [], []
        layer_hiddens = []

        # every pool reads the stack of the (unscaled) normalized hiddens so
        # far. Without grad they are written once each, in place, into ONE
        # preallocated buffer whose prefix each pool reads. Under grad an
        # in-place write would bump the version of a prefix an earlier pool
        # saved for its backward, so each pool stacks the list instead (the
        # counterpart's functional `.at[].set` has no such conflict).
        in_place = not torch.is_grad_enabled()
        normed = []
        normed_stack = None
        if self.use_attn_pool and in_place:
            normed_stack = torch.empty((1 + 2 * self.depth, b * t * s, d), dtype=tokens.dtype,
                                       device=device)

        def append_hidden(tok):
            layer_hiddens.append(tok)
            if not self.use_attn_pool:
                return
            n = rms_normalize(tok).reshape(-1, d)
            if in_place:
                normed_stack[len(normed)].copy_(n)
            normed.append(n)

        def pool_inputs():
            return normed_stack[:len(normed)] if in_place else torch.stack(normed)

        append_hidden(tokens)

        time_layer_idx = 0
        for i, layer_is_time in enumerate(self.is_time_layer):
            attn = getattr(self, f'attn_{i}')
            if layer_is_time:
                x_tm, bs_shape = _to_time_major(tokens)
                rv_tm = (_to_time_major(residual_values)[0]
                         if residual_values is not None else None)
                layer_cache = cache.kv[time_layer_idx] if has_cache else None
                attn_out = attn(x_tm, kv_cache=layer_cache, rotary=time_rotary,
                                mask=time_mask, residual_values=rv_tm, flash_spec=time_flash,
                                flash_offset=token_count, allow_small=not has_cache)
                tokens = tokens + _from_time_major(attn_out.out, bs_shape)
                if attn_out.cache is not None:
                    new_kv_caches.append(attn_out.cache)
                normed_time_inputs.append(attn_out.normed_inputs)
                time_layer_idx += 1
            else:
                x_sm, bt_shape = _to_space_major(tokens)
                rv_sm = (_to_space_major(residual_values)[0]
                         if residual_values is not None else None)
                attn_out = attn(x_sm, mask=space_mask, residual_values=rv_sm,
                                flash_spec=space_flash, allow_small=not has_cache)
                tokens = tokens + _from_space_major(attn_out.out, bt_shape)
                normed_space_inputs.append(attn_out.normed_inputs)

            append_hidden(tokens)
            tokens = tokens + getattr(self, f'ff_{i}')(tokens)
            append_hidden(tokens)

            if self.use_attn_pool and i < self.depth - 1:
                tokens = tokens + getattr(self, f'attn_pool_{i}')(
                    tokens, layer_hiddens, normed_hiddens=pool_inputs())

        # final cross-attend: special tokens read the spatial tokens once
        if self.should_special_cross_attend:
            ns = self.num_special_tokens
            non_special, special = tokens[:, :, :-ns], tokens[:, :, -ns:]
            sp_sm, bt_shape = _to_space_major(special)
            nsp_sm, _ = _to_space_major(non_special)
            cross = self.final_special_cross_attn(sp_sm, context=nsp_sm)
            special = special + _from_space_major(cross.out, bt_shape)
            special = special + self.final_special_ff(special)
            tokens = torch.cat([non_special, special], dim=2)

        if self.use_attn_pool:
            tokens = tokens + self.final_attn_pool(tokens, layer_hiddens,
                                                   normed_hiddens=pool_inputs())
        if self.final_norm is not None:
            tokens = self.final_norm(tokens)

        out = tokens
        if continuing and past_tokens.shape[1] > 0:
            out = torch.cat([past_tokens, out], dim=1)

        new_cache = None
        if has_cache:
            new_cache = TransformerCache(kv=tuple(new_kv_caches), token_count=token_count + t)

        if not return_intermediates:
            return out, new_cache
        collect = collect_normed_inputs
        return out, TransformerOutputs(
            tokens=out, cache=new_cache,
            normed_time_inputs=(torch.stack(normed_time_inputs)
                                if collect and normed_time_inputs else None),
            normed_space_inputs=(torch.stack(normed_space_inputs)
                                 if collect and normed_space_inputs else None),
            layer_hiddens=layer_hiddens, token_count=token_count + t)
