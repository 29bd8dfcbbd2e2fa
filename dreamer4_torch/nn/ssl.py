"""Self-supervised auxiliary modules (counterpart of `dreamer4_tpu/nn/ssl.py`).

Ported: `ActorSPR`. The counterpart's LAPO and TEM come with a later slice.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..ops.losses import sigreg
from ..ops.utils import masked_mean, smooth_l1_loss
from .mlp import MLP
from .norms import RMSNorm


def _detach_tree(x):
    """Detach every tensor of a nest of tuples (an unembedding's output)."""
    if isinstance(x, (tuple, list)):
        return type(x)(_detach_tree(v) for v in x)
    return x.detach() if isinstance(x, torch.Tensor) else x


class ActorSPR(nn.Module):
    """Self-predictive rollout of the policy embedding: an MLP dynamics
    model rolls the (normed) embedding `num_rollouts` steps forward under
    the actions taken, each step held by a smooth-L1 loss against the
    embedding that many steps later, and by the KL between the policies the
    frozen unembedding reads from the two. The action embedder enters as
    the injected `unembed_fn` / `kl_fn`, so the module holds none of its
    parameters.

    `dim` is the policy embedding's width (dim * 4 in the world model),
    `dim_action_embed` the action embedding's (the world model's dim). A
    nonzero `sigreg_loss_weight` adds `sigreg` over the normed embeddings
    inside `mask` (256 slices, drawn through `ops.losses.draw` from
    `generator`); the world model builds the module with 0."""

    def __init__(self, dim: int, num_rollouts: int = 1, spr_loss_weight: float = 1.0,
                 kl_loss_weight: float = 1.0, sigreg_loss_weight: float = 0.0,
                 dynamics_num_layers: int = 3, dim_action_embed: int | None = None,
                 device=None):
        super().__init__()
        self.num_rollouts = num_rollouts
        self.spr_loss_weight = spr_loss_weight
        self.kl_loss_weight = kl_loss_weight
        self.sigreg_loss_weight = sigreg_loss_weight
        da = dim_action_embed if dim_action_embed is not None else dim
        self.norm = RMSNorm(dim, device=device)
        self.dynamics_mlp = MLP(dim + da, (dim,) * dynamics_num_layers, dim, use_rmsnorm=True,
                                device=device)

    def forward(self, policy_embed, action_embeds, unembed_fn: Callable | None = None,
                kl_fn: Callable | None = None, mask=None,
                generator: torch.Generator | None = None):
        """policy_embed: (b, t, dim); action_embeds: (b, t, da), the action
        taken at each position; mask: (b, t) bool, the positions that count
        as targets. unembed_fn(embeds) -> (discrete logits, continuous
        params); kl_fn(src, tgt) -> (discrete KL, continuous KL).
        -> (total, (spr, kl, sigreg))."""
        zero = torch.zeros((), device=policy_embed.device)
        b, seq = policy_embed.shape[:2]
        R = self.num_rollouts
        if seq <= R:
            raise ValueError(f'ActorSPR needs more than num_rollouts={R} time steps, got {seq}')
        policy_embed = self.norm(policy_embed)
        if mask is None:
            mask = torch.ones((b, seq), dtype=torch.bool, device=policy_embed.device)

        # the K-step rollout: step k from position i takes the action taken
        # at i + k (zero past the end)
        actions = action_embeds.detach()
        preds, pred = [], policy_embed[:, :-1]
        for step in range(R):
            a = nn.functional.pad(actions[:, step:], (0, 0, 0, step))[:, :seq - 1]
            pred = pred + self.dynamics_mlp(torch.cat([pred, a.to(pred.dtype)], dim=-1))
            preds.append(pred)
        preds = torch.stack(preds)                                   # (R, b, seq-1, dim)

        # targets: the embedding step + 1 positions later, padded with zeros
        # that the padded mask leaves out
        targets = torch.stack([nn.functional.pad(policy_embed[:, 1 + k:], (0, 0, 0, k))
                               for k in range(R)])
        target_masks = torch.stack([nn.functional.pad(mask[:, 1 + k:], (0, k))
                                    for k in range(R)])
        weight = 1.0 / R

        spr_loss = zero
        if self.spr_loss_weight > 0.0:
            l1 = smooth_l1_loss(preds, targets.detach()) * weight
            spr_loss = masked_mean(l1, target_masks[..., None], dim=(1, 2, 3)).sum()

        kl_loss = zero
        if self.kl_loss_weight > 0.0 and unembed_fn is not None and kl_fn is not None:
            target_unembeds = _detach_tree(unembed_fn(targets.detach()))
            d_kl, c_kl = kl_fn(target_unembeds, unembed_fn(preds))
            step_kl = sum(kl for kl in (d_kl, c_kl) if kl is not None) * weight
            kl_loss = masked_mean(step_kl, target_masks, dim=(1, 2)).sum()

        sigreg_loss = zero
        if self.sigreg_loss_weight > 0.0:
            sigreg_loss = sigreg(policy_embed[None], mask=mask[None], num_slices=256,
                                 generator=generator)

        total = (spr_loss * self.spr_loss_weight + kl_loss * self.kl_loss_weight
                 + sigreg_loss * self.sigreg_loss_weight)
        return total, (spr_loss, kl_loss, sigreg_loss)
