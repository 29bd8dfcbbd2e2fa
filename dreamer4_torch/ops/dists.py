"""Action distributions (counterpart of `dreamer4_tpu/ops/dists.py`):
sampling, log probs, entropies and KL divergences, discrete and continuous.

Discrete logits are a tuple of tensors, one per action type, (..., n_i);
targets are (..., na) integer indices.

Continuous params are (..., na, 2) raw outputs per action type, read per
distribution type:
    gaussian / squashed_gaussian : (mean, log_var)
    beta                         : alpha = 1 + softplus(p0), beta = 1 + softplus(p1)
Native supports: gaussian R, squashed_gaussian (-1, 1), beta (0, 1). The
continuous terms are computed in float32 whatever the params' type: at
bf16, 1 - 1e-6 rounds to 1 and a Beta log prob of it is -inf.

Sampling takes its noise from the caller, as the discrete half takes its
Gumbel noise: standard-normal noise for the Gaussian types, and for Beta a
function of (alpha, beta) that returns Beta draws (`beta_sample` over a
generator, or a replay of recorded draws).
"""
from __future__ import annotations

from typing import Callable, Literal, Sequence

import torch
import torch.nn.functional as F

ContinuousDistType = Literal['gaussian', 'squashed_gaussian', 'beta']

LOG_2PI = 1.8378770664093453


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


# ---------------------------------------------------------------- continuous

def _gaussian_params(params):
    params = params.float()
    mean, log_var = params[..., 0], params[..., 1]
    return mean, torch.exp(0.5 * log_var)


def _beta_params(params):
    params = params.float()
    return 1.0 + F.softplus(params[..., 0]), 1.0 + F.softplus(params[..., 1])


def _log_beta_fn(alpha, beta):
    return torch.lgamma(alpha) + torch.lgamma(beta) - torch.lgamma(alpha + beta)


def beta_sample(alpha: torch.Tensor, beta: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Beta(alpha, beta) draws as X / (X + Y), X ~ Gamma(alpha) and
    Y ~ Gamma(beta), from `generator` (on the tensors' device)."""
    x = torch._standard_gamma(alpha, generator=generator)
    y = torch._standard_gamma(beta, generator=generator)
    return x / (x + y)


def continuous_sample(params: torch.Tensor, dist_type: ContinuousDistType,
                      noise: torch.Tensor | Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                      temperature: float = 1.0) -> torch.Tensor:
    """One draw per action type -> (..., na). `noise`: standard-normal
    noise shaped like params[..., 0] for the Gaussian types; for Beta, a
    function (alpha, beta) -> Beta draws of their shape. A temperature
    other than 1 scales a Gaussian's spread and, for Beta, the excess
    concentration (alpha - 1, beta - 1) by 1 / temperature."""
    if dist_type in ('gaussian', 'squashed_gaussian'):
        mean, std = _gaussian_params(params)
        sample = mean + std * temperature * noise.to(mean.dtype)
        return torch.tanh(sample) if dist_type == 'squashed_gaussian' else sample
    if dist_type == 'beta':
        alpha, beta = _beta_params(params)
        if temperature != 1.0:
            # sharpen/flatten around the mode by scaling the excess concentration
            alpha = 1.0 + (alpha - 1.0) / max(temperature, 1e-10)
            beta = 1.0 + (beta - 1.0) / max(temperature, 1e-10)
        return noise(alpha, beta)
    raise ValueError(f'unknown continuous dist type {dist_type}')


def continuous_log_prob(params: torch.Tensor, targets: torch.Tensor,
                        dist_type: ContinuousDistType, eps: float = 1e-5) -> torch.Tensor:
    """-> (..., na) log densities of `targets` (clipped eps inside a bounded
    support)."""
    targets = targets.float()
    if dist_type == 'gaussian':
        mean, std = _gaussian_params(params)
        return -0.5 * ((targets - mean).square() / std.square() + 2.0 * torch.log(std) + LOG_2PI)
    if dist_type == 'squashed_gaussian':
        mean, std = _gaussian_params(params)
        t = targets.clamp(-1.0 + eps, 1.0 - eps)
        u = torch.atanh(t)
        base = -0.5 * ((u - mean).square() / std.square() + 2.0 * torch.log(std) + LOG_2PI)
        return base - torch.log(1.0 - t.square())
    if dist_type == 'beta':
        alpha, beta = _beta_params(params)
        t = targets.clamp(eps, 1.0 - eps)
        return ((alpha - 1.0) * torch.log(t) + (beta - 1.0) * torch.log1p(-t)
                - _log_beta_fn(alpha, beta))
    raise ValueError(f'unknown continuous dist type {dist_type}')


def continuous_entropy(params: torch.Tensor, dist_type: ContinuousDistType) -> torch.Tensor:
    """-> (..., na). The squashed Gaussian has no closed form: its base
    Gaussian's entropy stands in, as in the counterpart."""
    if dist_type in ('gaussian', 'squashed_gaussian'):
        _, std = _gaussian_params(params)
        return 0.5 * (1.0 + LOG_2PI) + torch.log(std)
    if dist_type == 'beta':
        alpha, beta = _beta_params(params)
        return (_log_beta_fn(alpha, beta) - (alpha - 1.0) * torch.digamma(alpha)
                - (beta - 1.0) * torch.digamma(beta)
                + (alpha + beta - 2.0) * torch.digamma(alpha + beta))
    raise ValueError(f'unknown continuous dist type {dist_type}')


def continuous_kl(src_params: torch.Tensor, tgt_params: torch.Tensor,
                  dist_type: ContinuousDistType) -> torch.Tensor:
    """KL(src || tgt) -> (..., na). The tanh of the squashed Gaussian is a
    shared bijection, so its base KL is exact."""
    if dist_type in ('gaussian', 'squashed_gaussian'):
        m0, s0 = _gaussian_params(src_params)
        m1, s1 = _gaussian_params(tgt_params)
        return torch.log(s1 / s0) + (s0.square() + (m0 - m1).square()) / (2.0 * s1.square()) - 0.5
    if dist_type == 'beta':
        a0, b0 = _beta_params(src_params)
        a1, b1 = _beta_params(tgt_params)
        return (_log_beta_fn(a1, b1) - _log_beta_fn(a0, b0) + (a0 - a1) * torch.digamma(a0)
                + (b0 - b1) * torch.digamma(b0) + (a1 - a0 + b1 - b0) * torch.digamma(a0 + b0))
    raise ValueError(f'unknown continuous dist type {dist_type}')


def native_range(dist_type: ContinuousDistType) -> tuple[float, float] | None:
    if dist_type == 'beta':
        return (0.0, 1.0)
    if dist_type == 'squashed_gaussian':
        return (-1.0, 1.0)
    return None  # unbounded gaussian


def rescale(t: torch.Tensor, src_range: tuple[float, float],
            tgt_range: tuple[float, float]) -> torch.Tensor:
    """Linear map from src_range to tgt_range."""
    (s_lo, s_hi), (t_lo, t_hi) = src_range, tgt_range
    return (t - s_lo) / (s_hi - s_lo) * (t_hi - t_lo) + t_lo


def rescale_from_native(t: torch.Tensor, dist_type: ContinuousDistType,
                        target_range: tuple[float, float]) -> torch.Tensor:
    src = native_range(dist_type)
    if src is None:
        raise ValueError(f'{dist_type} is unbounded and cannot be rescaled')
    return rescale(t, src, target_range)
