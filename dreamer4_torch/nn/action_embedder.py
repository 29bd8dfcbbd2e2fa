"""ActionEmbedder (counterpart of `dreamer4_tpu/nn/action_embedder.py`):
embedding of discrete and continuous actions into one sum-pooled token,
multi-token-prediction unembedding, sampling, log probs, entropies and KL
divergences.

Discrete action types share one embedding table, indexed with per-type
offsets; a continuous action embeds as its type's embedding times the
(normalized) scalar. Unembedding gives per-type logits and per-type
continuous params (..., na, 2), read by `ops.dists`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..ops import dists
from .init import embed_normal_, normal_


class Actions(NamedTuple):
    discrete: torch.Tensor | None
    continuous: torch.Tensor | None


class ActionEmbedder(nn.Module):
    def __init__(self, dim: int, num_discrete_actions: tuple[int, ...] = (),
                 num_continuous_actions: int = 0,
                 continuous_norm_stats: tuple[tuple[float, float], ...] | None = None,
                 continuous_dist_type: str = 'beta',
                 continuous_target_action_range: tuple[float, float] | None = None,
                 can_unembed: bool = False, unembed_dim: int | None = None,
                 num_unembed_preds: int = 1, beta_log_prob_eps: float = 1e-5, device=None):
        super().__init__()
        if continuous_dist_type not in ('gaussian', 'squashed_gaussian', 'beta'):
            raise ValueError(f'unknown continuous dist type {continuous_dist_type}')
        self.discrete_sizes = tuple(n for n in num_discrete_actions if n > 0)
        self.num_continuous_actions = num_continuous_actions
        self.continuous_dist_type = continuous_dist_type
        self.continuous_target_action_range = continuous_target_action_range
        self.num_unembed_preds = num_unembed_preds
        self.can_unembed = can_unembed
        self.beta_log_prob_eps = beta_log_prob_eps
        udim = unembed_dim if unembed_dim is not None else dim
        total = sum(self.discrete_sizes)
        offsets = [0]
        for n in self.discrete_sizes[:-1]:
            offsets.append(offsets[-1] + n)
        self.register_buffer('discrete_offsets',
                             torch.tensor(offsets, dtype=torch.long, device=device),
                             persistent=False)
        if self.has_discrete:
            self.discrete_action_embed = nn.Embedding(total, dim, device=device)
            embed_normal_(self.discrete_action_embed.weight)
            if can_unembed:
                self.discrete_action_unembed = nn.Parameter(
                    torch.empty(total, num_unembed_preds, udim, device=device))
                normal_(self.discrete_action_unembed, 1e-2)
        norm_stats = None
        if self.has_continuous and continuous_norm_stats is not None:
            norm_stats = torch.tensor(continuous_norm_stats, dtype=torch.float32, device=device)
        self.register_buffer('continuous_norm_stats', norm_stats, persistent=False)
        if self.has_continuous:
            self.continuous_action_embed = nn.Embedding(num_continuous_actions, dim,
                                                        device=device)
            embed_normal_(self.continuous_action_embed.weight)
            if can_unembed:
                self.continuous_action_unembed = nn.Parameter(
                    torch.empty(num_continuous_actions, num_unembed_preds, udim, 2,
                                device=device))
                normal_(self.continuous_action_unembed, 1e-2)

    @property
    def has_discrete(self) -> bool:
        return len(self.discrete_sizes) > 0

    @property
    def has_continuous(self) -> bool:
        return self.num_continuous_actions > 0

    @property
    def target_action_range(self) -> tuple[float, float] | None:
        """The environment's range of a bounded distribution's actions."""
        if self.continuous_dist_type in ('beta', 'squashed_gaussian'):
            return self.continuous_target_action_range or (-1.0, 1.0)
        return None

    # ----------------------------------------------------------------- embed

    def forward(self, discrete_actions=None, continuous_actions=None):
        """-> (..., dim) sum-pooled action token."""
        pooled = 0.0
        if discrete_actions is not None and self.has_discrete:
            emb = self.discrete_action_embed(discrete_actions.long() + self.discrete_offsets)
            pooled = pooled + emb.sum(dim=-2)
        if continuous_actions is not None and self.has_continuous:
            scaled = continuous_actions
            if self.continuous_norm_stats is not None:
                mean, std = self.continuous_norm_stats[:, 0], self.continuous_norm_stats[:, 1]
                scaled = (scaled - mean) / std.clamp_min(1e-6)
            type_emb = self.continuous_action_embed.weight                    # (na, dim)
            pooled = pooled + (type_emb * scaled[..., None].to(type_emb.dtype)).sum(dim=-2)
        return pooled

    embed = forward

    # --------------------------------------------------------------- unembed

    def unembed(self, embeds, pred_head_index: int | None = None):
        """embeds (..., udim) -> (discrete_logits_tuple or None, continuous
        params (..., na, 2) or None). With pred_head_index=None and several
        prediction heads, the outputs carry a leading mtp axis."""
        if not self.can_unembed:
            raise ValueError('this ActionEmbedder cannot unembed')

        def head(w, single: str, multi: str):
            dt = torch.promote_types(embeds.dtype, w.dtype)
            if pred_head_index is not None:
                return torch.einsum(single, embeds.to(dt), w[:, pred_head_index].to(dt))
            out = torch.einsum(multi, embeds.to(dt), w.to(dt))
            return out[0] if self.num_unembed_preds == 1 else out

        discrete_logits = continuous_params = None
        if self.has_discrete:
            flat = head(self.discrete_action_unembed, '...d,nd->...n', '...d,nmd->m...n')
            discrete_logits = tuple(torch.split(flat, list(self.discrete_sizes), dim=-1))
        if self.has_continuous:
            continuous_params = head(self.continuous_action_unembed, '...d,ndp->...np',
                                     '...d,nmdp->m...np')
        return discrete_logits, continuous_params

    # ---------------------------------------------------------------- sample

    def sample(self, embeds, gumbels=None, continuous_noise=None, pred_head_index: int = 0,
               discrete_temperature: float = 1.0, continuous_temperature: float = 1.0):
        """Sample actions with caller-drawn noise: `gumbels`, one tensor per
        discrete action type (`dists.multi_categorical_sample`), and
        `continuous_noise` for the continuous types (`dists.continuous_sample`).
        -> (discrete (..., na_d) or None, continuous (..., na_c) or None),
        the continuous ones in the distribution's native range."""
        discrete_logits, continuous_params = self.unembed(embeds, pred_head_index=pred_head_index)
        sampled_d = sampled_c = None
        if discrete_logits is not None:
            sampled_d = dists.multi_categorical_sample(discrete_logits, gumbels,
                                                       discrete_temperature)
        if continuous_params is not None:
            sampled_c = dists.continuous_sample(continuous_params, self.continuous_dist_type,
                                                continuous_noise, continuous_temperature)
        return sampled_d, sampled_c

    def continuous_noise(self, draw, shape):
        """The `continuous_noise` argument of `sample`: `draw(shape)`, normal
        noise, for the Gaussian types; for Beta, a sampler that asks
        `draw(alpha.shape, concentration=(alpha, beta))` for its draws."""
        if self.continuous_dist_type == 'beta':
            return lambda alpha, beta: draw(alpha.shape, concentration=(alpha, beta))
        return draw(shape)

    def rescale_for_env(self, actions):
        """Native distribution range -> the environment's range."""
        rng = self.target_action_range
        if rng is None:
            raise ValueError(f'{self.continuous_dist_type} actions have no target range')
        return dists.rescale_from_native(actions, self.continuous_dist_type, rng)

    # ------------------------------------------------------------- log probs

    def log_probs(self, embeds, discrete_targets=None, continuous_targets=None,
                  pred_head_index: int | None = None, return_entropies: bool = False,
                  soft_validate_range: bool = False):
        """Log probs of the targets, Actions((..., na_d), (..., na_c)), and
        with `return_entropies` also the entropies of the distributions in
        the same layout. `soft_validate_range` clips Beta targets into
        [beta_log_prob_eps, 1 - beta_log_prob_eps]."""
        discrete_logits, continuous_params = self.unembed(embeds, pred_head_index=pred_head_index)
        multi_head = pred_head_index is None and self.num_unembed_preds > 1

        d_lp = d_ent = None
        if discrete_targets is not None and discrete_logits is not None:
            tgt = discrete_targets
            if multi_head and tgt.ndim == discrete_logits[0].ndim - 1:
                tgt = tgt[None]
            d_lp = dists.multi_categorical_log_prob(discrete_logits, tgt)
            if return_entropies:
                d_ent = dists.multi_categorical_entropy(discrete_logits)

        c_lp = c_ent = None
        if continuous_targets is not None and continuous_params is not None:
            tgt = continuous_targets
            if multi_head and tgt.ndim == continuous_params.ndim - 2:
                tgt = tgt[None]
            if soft_validate_range and self.continuous_dist_type == 'beta':
                tgt = tgt.clamp(self.beta_log_prob_eps, 1.0 - self.beta_log_prob_eps)
            c_lp = dists.continuous_log_prob(continuous_params, tgt, self.continuous_dist_type,
                                             eps=self.beta_log_prob_eps)
            if return_entropies:
                c_ent = dists.continuous_entropy(continuous_params, self.continuous_dist_type)

        if not return_entropies:
            return Actions(d_lp, c_lp)
        return Actions(d_lp, c_lp), Actions(d_ent, c_ent)

    # -------------------------------------------------------------------- kl

    def kl_div(self, src, tgt, reduce_across_num_actions: bool = True):
        """src, tgt: (discrete_logits_tuple or None, continuous_params or
        None), as `unembed` returns them. -> (KL(src || tgt) of the discrete
        part, of the continuous part), each summed over the action types
        unless `reduce_across_num_actions` is False."""
        (src_logits, src_params), (tgt_logits, tgt_params) = src, tgt
        discrete_kl = continuous_kl = None
        if src_logits is not None and tgt_logits is not None:
            discrete_kl = dists.multi_categorical_kl(src_logits, tgt_logits)
            if reduce_across_num_actions:
                discrete_kl = discrete_kl.sum(dim=-1)
        if src_params is not None and tgt_params is not None:
            continuous_kl = dists.continuous_kl(src_params, tgt_params, self.continuous_dist_type)
            if reduce_across_num_actions:
                continuous_kl = continuous_kl.sum(dim=-1)
        return discrete_kl, continuous_kl
