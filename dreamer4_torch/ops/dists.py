"""Action distributions (counterpart of `dreamer4_tpu/ops/dists.py`,
discrete part): sampling, log probs, entropies and KL divergences.
Continuous distributions are not ported yet.

Discrete logits are a tuple of tensors, one per action type, (..., n_i);
targets are (..., na) integer indices.
"""
from __future__ import annotations

from typing import Sequence

import torch


def gumbel(shape, generator: torch.Generator | None = None, device=None) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u uniform in (0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def multi_categorical_sample(logits: Sequence[torch.Tensor], gumbels: Sequence[torch.Tensor],
                             temperature: float = 1.0) -> torch.Tensor:
    """Sample each action type independently by the Gumbel-max trick (as
    `jax.random.categorical`): argmax(logits / temperature + gumbel).
    The caller draws the noise, one tensor per action type shaped like its
    logits. -> (..., na) int64."""
    samples = [torch.argmax(l / max(temperature, 1e-10) + g.to(l.dtype), dim=-1)
               for l, g in zip(logits, gumbels)]
    return torch.stack(samples, dim=-1)


def multi_categorical_log_prob(logits: Sequence[torch.Tensor],
                               targets: torch.Tensor) -> torch.Tensor:
    """-> (..., na) per-action-type log probs."""
    out = []
    for i, l in enumerate(logits):
        logp = torch.log_softmax(l, dim=-1)
        idx = targets[..., i:i + 1].long()
        # targets broadcast against the logits (a leading mtp axis of one)
        batch = torch.broadcast_shapes(logp.shape[:-1], idx.shape[:-1])
        out.append(torch.gather(logp.expand(*batch, logp.shape[-1]), -1,
                                idx.expand(*batch, 1))[..., 0])
    return torch.stack(out, dim=-1)


def multi_categorical_entropy(logits: Sequence[torch.Tensor]) -> torch.Tensor:
    """-> (..., na) per-action-type entropies."""
    out = []
    for l in logits:
        logp = torch.log_softmax(l, dim=-1)
        out.append(-(logp.exp() * logp).sum(dim=-1))
    return torch.stack(out, dim=-1)


def multi_categorical_kl(src_logits: Sequence[torch.Tensor],
                         tgt_logits: Sequence[torch.Tensor]) -> torch.Tensor:
    """KL(src || tgt) -> (..., na)."""
    out = []
    for s, t in zip(src_logits, tgt_logits):
        sp = torch.log_softmax(s, dim=-1)
        tp = torch.log_softmax(t, dim=-1)
        out.append((sp.exp() * (sp - tp)).sum(dim=-1))
    return torch.stack(out, dim=-1)
