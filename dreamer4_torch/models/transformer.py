"""Axial space-time transformer, the trunk of the dynamics world model
(counterpart of `dreamer4_tpu/models/transformer.py`, core only).

Token layout is (b, t, s, d). Every `time_block_every`-th layer attends over
time (causal, rotary, KV-cached, batch folded to b*s); the others attend over
space (special-token masking, batch folded to b*t). Ported: the value
residual, per-head gates, QK norm, the attention pools over the shared
normed-hidden buffer, the final special cross-attend, `init_cache`,
`token_count`, the flash gate and the small-attention path
(`use_fused_small`, uncached calls only), learned per-head rotary (PoPE)
on the time layers (`time_pope`) and axial PoPE on the space layers
(`space_pope`, over the leading sh*sw grid tokens; the rest get no
rotation), and MOSS spatial modules (`spatial_module_{i}`, after layer i's
feedforward on the grid tokens, with a conv time cache each in
`TransformerCache.spatial_modules`), the GRU time layer (`rnn_{i}` before
each time layer's attention, its carry in `TransformerCache.rnn`), MoT
(`mot_temporal`: on time layers the last `num_special_tokens` tokens get
their own attention and feedforward, `special_attn_{i}` /
`special_ff_{i}`, and their own KV cache, so `TransformerCache.kv[i]` is a
(main, special) pair), and the H-Net splice after layer `h_net_layer`'s
attention (`nn/hnet.py`, fixed-stride or with `h_net_dynamic` learned
boundaries; its streaming cache in `TransformerCache.h_net`, its ratio loss
in `TransformerOutputs.h_net_loss`), and ring attention over time
(`time_ring_axis`: the plain time layers' uncached attention runs as a ring
over that axis of the ambient mesh, `parallel.mesh.set_mesh`; the MoT time
layers and cached calls stay dense, as in the counterpart).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from ..nn.attention import (Attention, AttentionPool, FeedForward, FlashSpec, KVCache,
                            rms_normalize)
from ..nn.dense import Dense
from ..nn.gru import GRUCell
from ..nn.hnet import DynamicChunkingTemporalTransformer, HierarchicalTemporalTransformer
from ..nn.moss import MOSS
from ..nn.norms import RMSNorm
from ..nn.pope import AxialPoPE, PoPE
from ..ops.masks import build_attend_mask
from ..ops.rotary import rotary_frequencies


class TransformerCache(NamedTuple):
    kv: tuple           # one KVCache per time layer; a (main, special) pair under MoT
    token_count: int    # frames already in the cache (host int)
    spatial_modules: tuple | None = None   # one conv time cache per MOSS layer
    rnn: tuple | None = None               # one GRU carry (b*s, d) per time layer
    h_net: object | None = None            # HNetCache / DynamicHNetCache


class TransformerOutputs(NamedTuple):
    tokens: torch.Tensor
    cache: TransformerCache | None
    normed_time_inputs: torch.Tensor | None   # (num_time_layers, b*s, t, d)
    normed_space_inputs: torch.Tensor | None  # (num_space_layers, b*t, s, d)
    layer_hiddens: list
    token_count: int
    h_net_loss: torch.Tensor | float = 0.0


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


class GRUTimeLayer(nn.Module):
    """RMSNorm, then a GRU over time from the given carry (zeros when none),
    in flax's layout (`GRUCell_0`, the name flax gives the cell inside the
    counterpart's `nn.RNN`). x (B, t, d) -> (outputs, last carry). The cell
    computes in the promoted type of its input and float32 weights; the
    outputs return in the input's dtype and the carry in the carry's."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.dim = dim
        self.norm = RMSNorm(dim, device=device)
        self.GRUCell_0 = GRUCell(dim, dim, device=device)

    def forward(self, x, carry=None):
        x = self.norm(x)
        if carry is None:
            carry = torch.zeros((x.shape[0], self.dim), dtype=x.dtype, device=x.device)
        out = self.GRUCell_0.scan(carry, x)
        return out.to(x.dtype), out[:, -1].to(carry.dtype)


class AxialSpaceTimeTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, attn_heads: int = 8, attn_dim_head: int = 64,
                 query_heads: int | None = None, attn_softclamp_value: float | None = 50.0,
                 time_block_every: int = 4, num_special_tokens: int = 1,
                 special_attend_only_itself: bool = False, full_spatial_attn: bool = False,
                 final_norm: bool = True, value_residual: bool = True,
                 use_attn_pool: bool = True, use_flash_attention: bool = False,
                 flash_min_scores: int = 128 * 128, use_fused_small: bool | None = None,
                 time_attention_use_pope: bool = False, space_attention_use_pope: bool = False,
                 space_height: int | None = None, space_width: int | None = None,
                 spatial_module_layers: tuple = (), spatial_module_kernel_size: int = 3,
                 rnn_time: bool = False, mot_temporal: bool = False,
                 h_net_layer: int | None = None, h_net_depth: int = 2, h_net_heads: int = 4,
                 h_net_dim_head: int = 32, h_net_compression_ratio: int = 4,
                 h_net_dynamic: bool = False, ff_expansion_factor: float = 4.0,
                 ff_activation: str = 'silu', gate_values: bool = True,
                 rmsnorm_query: bool = False, rmsnorm_key: bool = True,
                 belief_attn: bool = True, time_ring_axis: str | None = None, dtype=None,
                 device=None):
        config = {k: v for k, v in locals().items()
                  if k not in ('self', '__class__', 'device')}
        super().__init__()
        self.config = config
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
        self.space_height, self.space_width = space_height, space_width
        self.spatial_module_layers = tuple(spatial_module_layers)
        self.spatial_module_kernel_size = spatial_module_kernel_size
        self.rnn_time = rnn_time
        self.use_mot = mot_temporal and num_special_tokens > 0
        self.h_net_layer = h_net_layer
        self.h_net_compression_ratio = h_net_compression_ratio
        self.h_net_dynamic = h_net_dynamic
        self.time_ring_axis = time_ring_axis
        self.dtype = dtype

        if time_attention_use_pope:
            self.time_pope = PoPE(attn_dim_head, attn_heads, device=device)
        if space_attention_use_pope:
            self.space_pope = AxialPoPE(attn_dim_head, attn_heads, device=device)

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
        for i, is_time in enumerate(self.is_time_layer):
            if is_time and rnn_time:
                setattr(self, f'rnn_{i}', GRUTimeLayer(dim, device=device))
            setattr(self, f'attn_{i}', Attention(**attn_common, value_residual=value_residual))
            setattr(self, f'ff_{i}', FeedForward(**ff_kwargs))
            if is_time and self.use_mot:
                setattr(self, f'special_attn_{i}',
                        Attention(**attn_common, value_residual=value_residual))
                setattr(self, f'special_ff_{i}', FeedForward(**ff_kwargs))
            if i in self.spatial_module_layers:
                setattr(self, f'spatial_module_{i}',
                        MOSS(dim, spatial_module_kernel_size, device=device))
            if use_attn_pool and i < depth - 1:
                setattr(self, f'attn_pool_{i}', AttentionPool(dim, dtype=dtype, device=device))
        if self.should_special_cross_attend:
            self.final_special_cross_attn = Attention(**attn_common, value_residual=False,
                                                      pre_context_rmsnorm=True)
            self.final_special_ff = FeedForward(**ff_kwargs)
        if use_attn_pool:
            self.final_attn_pool = AttentionPool(dim, dtype=dtype, device=device)
        self.final_norm = RMSNorm(dim, device=device) if final_norm else None
        if h_net_layer is not None:
            cls = (DynamicChunkingTemporalTransformer if h_net_dynamic
                   else HierarchicalTemporalTransformer)
            self.h_net = cls(dim, depth=h_net_depth, heads=h_net_heads, dim_head=h_net_dim_head,
                             compression_ratio=h_net_compression_ratio, device=device)

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
        `device` is given: the KV caches ((main, special) pairs under MoT),
        each MOSS layer's conv time cache and each GRU carry of zeros (the
        past before the first frame), and the H-Net's streaming cache
        (float32, its chunk budget from `max_time`)."""
        device = self.device if device is None else device

        def kv_cache(rows):
            return KVCache.create(rows, self.attn_heads, max_time, self.attn_dim_head,
                                  dtype=dtype, device=device)

        ns = self.num_special_tokens
        kv = tuple(((kv_cache(batch * (space_len - ns)), kv_cache(batch * ns)) if self.use_mot
                    else kv_cache(batch * space_len)) for _ in range(self.num_time_layers))
        spatial = None
        if self.spatial_module_layers:
            sh, sw = self._grid()
            spatial = tuple(torch.zeros((batch, self.spatial_module_kernel_size - 1, sh, sw,
                                         self.dim), dtype=dtype, device=device)
                            for _ in self.spatial_module_layers)
        rnn = None
        if self.rnn_time:
            rnn = tuple(torch.zeros((batch * space_len, self.dim), dtype=dtype, device=device)
                        for _ in range(self.num_time_layers))
        h_net = None
        if self.h_net_layer is not None:
            max_chunks = -(-max_time // self.h_net_compression_ratio)
            if self.h_net_dynamic:
                max_chunks *= 2   # the parallel path's slot budget
            h_net = self.h_net.init_cache(batch * space_len, max_chunks, device=device)
        return TransformerCache(kv=kv, token_count=0, spatial_modules=spatial, rnn=rnn,
                                h_net=h_net)

    def _grid(self):
        if self.space_height is None or self.space_width is None:
            raise ValueError('space PoPE and MOSS need space_height and space_width '
                             '(the grid tokens lead each frame)')
        return self.space_height, self.space_width

    def forward(self, tokens, cache: TransformerCache | None = None, max_time: int | None = None,
                return_intermediates: bool = False, collect_normed_inputs: bool = True):
        """tokens (b, t, s, d) -> (tokens, cache), or with
        `return_intermediates` (tokens, TransformerOutputs). `cache`
        continues a decode with the newest frame; `max_time` without one
        builds a fresh cache for later calls."""
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
        time_k_len = t
        if has_cache and self.num_time_layers > 0:
            first_kv = cache.kv[0]
            time_k_len = (first_kv if isinstance(first_kv, KVCache) else first_kv[0]).k.shape[-2]

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

        if hasattr(self, 'time_pope'):
            time_rotary = self.time_pope(t, offset=token_count)
        else:
            time_rotary = rotary_frequencies(self.attn_dim_head, t, offset=token_count,
                                             device=device)
        space_rotary = None
        if hasattr(self, 'space_pope'):
            sh, sw = self._grid()
            space_rotary = self.space_pope(sh, sw, num_special=s - sh * sw)

        residual_values = None
        if self.value_residual:
            rv = self.to_value_residual(self.value_residual_norm(tokens))
            residual_values = rv.reshape(b, t, s, self.attn_heads, self.attn_dim_head)

        new_kv_caches, new_spatial_caches, new_rnn_carries = [], [], []
        normed_time_inputs, normed_space_inputs = [], []
        layer_hiddens = []
        h_net_loss = torch.zeros((), device=device)
        new_h_net_cache = None

        # every pool reads the stack of the (unscaled) normalized hiddens so
        # far. Without grad they are written once each, in place, into ONE
        # preallocated buffer whose prefix each pool reads. Under grad an
        # in-place write would bump the version of a prefix an earlier pool
        # saved for its backward, so each pool stacks the list instead (the
        # counterpart's functional `.at[].set` has no such conflict).
        # The stack keeps the entry dtype, as the counterpart's buffer
        # does, when a MOSS layer's float32 output promotes the stream.
        in_place = not torch.is_grad_enabled()
        normed = []
        normed_stack = None
        stack_dtype = tokens.dtype
        if self.use_attn_pool and in_place:
            n_hiddens = 1 + 2 * self.depth + (self.num_time_layers if self.rnn_time else 0)
            normed_stack = torch.empty((n_hiddens, b * t * s, d), dtype=stack_dtype,
                                       device=device)

        def append_hidden(tok):
            layer_hiddens.append(tok)
            if not self.use_attn_pool:
                return
            n = rms_normalize(tok).reshape(-1, d).to(stack_dtype)
            if in_place:
                normed_stack[len(normed)].copy_(n)
            normed.append(n)

        def pool_inputs():
            return normed_stack[:len(normed)] if in_place else torch.stack(normed)

        append_hidden(tokens)

        def time_attend(attn, x, rv, layer_cache, ring_axis=None):
            """(b, t, s', d) tokens -> (their update, the time attention's
            output); with `ring_axis`, causal ring attention over it."""
            x_tm, bs_shape = _to_time_major(x)
            rv_tm = _to_time_major(rv)[0] if rv is not None else None
            ring = ring_axis is not None
            out = attn(x_tm, kv_cache=layer_cache, rotary=time_rotary,
                       mask=None if ring else time_mask, residual_values=rv_tm,
                       flash_spec=None if ring else time_flash, flash_offset=token_count,
                       allow_small=not has_cache, ring_axis=ring_axis,
                       ring_use_flash=self.use_flash_attention)
            return _from_time_major(out.out, bs_shape), out

        ns = self.num_special_tokens
        time_layer_idx = 0
        for i, layer_is_time in enumerate(self.is_time_layer):
            attn = getattr(self, f'attn_{i}')
            use_mot = layer_is_time and self.use_mot
            if layer_is_time and self.rnn_time:
                # the GRU over time, before the attention
                x_tm, bs_shape = _to_time_major(tokens)
                carry = cache.rnn[time_layer_idx] if has_cache and cache.rnn is not None else None
                out_tm, carry = getattr(self, f'rnn_{i}')(x_tm, carry)
                tokens = tokens + _from_time_major(out_tm, bs_shape)
                new_rnn_carries.append(carry)
                append_hidden(tokens)

            if use_mot:
                # separate weights and caches for the special tokens
                lc_m, lc_s = cache.kv[time_layer_idx] if has_cache else (None, None)
                rv = residual_values
                delta_m, out_m = time_attend(attn, tokens[:, :, :-ns],
                                             rv[:, :, :-ns] if rv is not None else None, lc_m)
                delta_s, out_s = time_attend(getattr(self, f'special_attn_{i}'),
                                             tokens[:, :, -ns:],
                                             rv[:, :, -ns:] if rv is not None else None, lc_s)
                tokens = tokens + torch.cat([delta_m, delta_s], dim=2)
                if out_m.cache is not None:
                    new_kv_caches.append((out_m.cache, out_s.cache))
                normed_time_inputs.append(out_m.normed_inputs)
                time_layer_idx += 1
            elif layer_is_time:
                layer_cache = cache.kv[time_layer_idx] if has_cache else None
                delta, attn_out = time_attend(attn, tokens, residual_values, layer_cache,
                                              ring_axis=None if has_cache else self.time_ring_axis)
                tokens = tokens + delta
                if attn_out.cache is not None:
                    new_kv_caches.append(attn_out.cache)
                normed_time_inputs.append(attn_out.normed_inputs)
                time_layer_idx += 1
            else:
                x_sm, bt_shape = _to_space_major(tokens)
                rv_sm = (_to_space_major(residual_values)[0]
                         if residual_values is not None else None)
                attn_out = attn(x_sm, rotary=space_rotary, mask=space_mask,
                                residual_values=rv_sm, flash_spec=space_flash,
                                allow_small=not has_cache)
                tokens = tokens + _from_space_major(attn_out.out, bt_shape)
                normed_space_inputs.append(attn_out.normed_inputs)

            if i == self.h_net_layer:
                x_tm, bs_shape = _to_time_major(tokens)
                if continuing:
                    x_tm, _, new_h_net_cache = self.h_net(x_tm, cache=cache.h_net)
                elif has_cache:
                    # a fresh-cache prefill steps the streaming path per
                    # frame, so the cache it returns continues the decode
                    hn_cache, outs = cache.h_net, []
                    for ti in range(t):
                        o, _, hn_cache = self.h_net(x_tm[:, ti:ti + 1], cache=hn_cache)
                        outs.append(o)
                    x_tm, new_h_net_cache = torch.cat(outs, dim=1), hn_cache
                else:
                    x_tm, h_net_loss, _ = self.h_net(x_tm)
                tokens = _from_time_major(x_tm, bs_shape)

            append_hidden(tokens)
            if use_mot:
                main, special = tokens[:, :, :-ns], tokens[:, :, -ns:]
                tokens = torch.cat([main + getattr(self, f'ff_{i}')(main),
                                    special + getattr(self, f'special_ff_{i}')(special)], dim=2)
            else:
                tokens = tokens + getattr(self, f'ff_{i}')(tokens)

            if i in self.spatial_module_layers:
                sh, sw = self._grid()
                sm_idx = self.spatial_module_layers.index(i)
                sm_cache = (cache.spatial_modules[sm_idx]
                            if has_cache and cache.spatial_modules is not None else None)
                grid = tokens[:, :, :sh * sw].reshape(b, t, sh, sw, d)
                grid, sm_next = getattr(self, f'spatial_module_{i}')(grid, cache=sm_cache,
                                                                    return_cache=True)
                tokens = torch.cat([grid.reshape(b, t, sh * sw, d), tokens[:, :, sh * sw:]],
                                   dim=2)
                new_spatial_caches.append(sm_next)
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
            new_cache = TransformerCache(
                kv=tuple(new_kv_caches), token_count=token_count + t,
                spatial_modules=tuple(new_spatial_caches) if self.spatial_module_layers else None,
                rnn=tuple(new_rnn_carries) if self.rnn_time else None, h_net=new_h_net_cache)

        if not return_intermediates:
            return out, new_cache
        collect = collect_normed_inputs
        return out, TransformerOutputs(
            tokens=out, cache=new_cache,
            normed_time_inputs=(torch.stack(normed_time_inputs)
                                if collect and normed_time_inputs else None),
            normed_space_inputs=(torch.stack(normed_space_inputs)
                                 if collect and normed_space_inputs else None),
            layer_hiddens=layer_hiddens, token_count=token_count + t, h_net_loss=h_net_loss)
