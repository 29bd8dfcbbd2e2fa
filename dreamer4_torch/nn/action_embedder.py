"""ActionEmbedder (counterpart of `dreamer4_tpu/nn/action_embedder.py`,
discrete actions): embedding, multi-token-prediction unembedding, sampling
and log probs. Continuous actions are not ported yet and are refused.
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
                 num_continuous_actions: int = 0, can_unembed: bool = False,
                 unembed_dim: int | None = None, num_unembed_preds: int = 1, device=None):
        super().__init__()
        if num_continuous_actions > 0:
            raise NotImplementedError('continuous actions are not ported yet')
        self.discrete_sizes = tuple(n for n in num_discrete_actions if n > 0)
        self.num_unembed_preds = num_unembed_preds
        self.can_unembed = can_unembed
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
                udim = unembed_dim if unembed_dim is not None else dim
                self.discrete_action_unembed = nn.Parameter(
                    torch.empty(total, num_unembed_preds, udim, device=device))
                normal_(self.discrete_action_unembed, 1e-2)

    @property
    def has_discrete(self) -> bool:
        return len(self.discrete_sizes) > 0

    def forward(self, discrete_actions=None, continuous_actions=None):
        """-> (..., dim) sum-pooled action token."""
        if continuous_actions is not None:
            raise NotImplementedError('continuous actions are not ported yet')
        pooled = 0.0
        if discrete_actions is not None and self.has_discrete:
            emb = self.discrete_action_embed(discrete_actions.long() + self.discrete_offsets)
            pooled = pooled + emb.sum(dim=-2)
        return pooled

    embed = forward

    def unembed(self, embeds, pred_head_index: int | None = None):
        """embeds (..., udim) -> (discrete_logits_tuple, None). With
        pred_head_index=None and several prediction heads, the logits carry a
        leading mtp axis."""
        if not self.can_unembed:
            raise ValueError('this ActionEmbedder cannot unembed')
        discrete_logits = None
        if self.has_discrete:
            w = self.discrete_action_unembed                       # (total, mtp, udim)
            dt = torch.promote_types(embeds.dtype, w.dtype)
            if pred_head_index is not None:
                flat = torch.einsum('...d,nd->...n', embeds.to(dt), w[:, pred_head_index].to(dt))
            else:
                flat = torch.einsum('...d,nmd->m...n', embeds.to(dt), w.to(dt))
                if self.num_unembed_preds == 1:
                    flat = flat[0]
            discrete_logits = tuple(torch.split(flat, list(self.discrete_sizes), dim=-1))
        return discrete_logits, None

    def sample(self, embeds, gumbels, pred_head_index: int = 0,
               discrete_temperature: float = 1.0):
        """Sample actions with caller-drawn Gumbel noise, one tensor per
        discrete action type (see `dists.multi_categorical_sample`)."""
        discrete_logits, _ = self.unembed(embeds, pred_head_index=pred_head_index)
        sampled = None
        if discrete_logits is not None:
            sampled = dists.multi_categorical_sample(discrete_logits, gumbels,
                                                     discrete_temperature)
        return sampled, None

    def log_probs(self, embeds, discrete_targets=None, pred_head_index: int | None = None):
        discrete_logits, _ = self.unembed(embeds, pred_head_index=pred_head_index)
        multi_head = pred_head_index is None and self.num_unembed_preds > 1
        log_probs = None
        if discrete_targets is not None and discrete_logits is not None:
            tgt = discrete_targets
            if multi_head and tgt.ndim == discrete_logits[0].ndim - 1:
                tgt = tgt[None]
            log_probs = dists.multi_categorical_log_prob(discrete_logits, tgt)
        return Actions(log_probs, None)
