"""Loss-side utilities (counterpart of `dreamer4_tpu/ops/losses.py`): the
EMA loss normalization, signature regularization (`sigreg`) and the
feature-decorrelation loss. Their random draws go through the module-level
`draw`, so a test can replay the counterpart's."""
from __future__ import annotations

import torch

from .utils import l2norm, masked_mean


def draw(kind: str, shape, *, generator: torch.Generator | None, device) -> torch.Tensor:
    """One random draw of a loss.

    kind: 'slices'      — standard normal projections of `sigreg`;
          'permutation' — a random permutation of range(shape[0]), the rows
                          `decorrelation_loss` samples.
    """
    if kind == 'slices':
        return torch.randn(shape, generator=generator, device=device)
    if kind == 'permutation':
        return torch.randperm(shape[0], generator=generator, device=device)
    raise ValueError(f'unknown draw {kind}')


def apply_loss_normalizer(state: torch.Tensor, losses: torch.Tensor, update_ema: bool = True,
                          beta: float = 0.95, eps: float = 1e-6):
    """-> (normalized_losses, new_state): the losses divided by the RMS of
    the EMA of their squares taken *before* this value is folded in (the
    counterpart's order). The new state carries no gradient."""
    losses = losses.reshape(state.shape)
    rms = torch.sqrt(state)
    new_state = state
    if update_ema:
        new_state = state + (1.0 - beta) * (losses.detach().square() - state)
    return losses / torch.clamp(rms, min=eps), new_state


def sigreg(x: torch.Tensor, num_slices: int = 1024, domain: tuple[float, float] = (-5.0, 5.0),
           num_knots: int = 17, mask: torch.Tensor | None = None,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """LeJEPA signature regularization: the empirical characteristic
    function of x (k, ..., d) along `num_slices` random unit directions,
    matched to the standard normal's under a Gaussian window and integrated
    by the trapezoid rule over `num_knots` points of `domain`; the mean over
    the k leading subspaces and the slices. `mask` (k, ...) keeps rows. The
    complex exponential is computed as its cosine and sine, in float32."""
    dim = x.shape[-1]
    projs = l2norm(draw('slices', (num_slices, dim), generator=generator,
                        device=x.device).to(x.dtype))
    t = torch.linspace(domain[0], domain[1], num_knots, dtype=x.dtype, device=x.device)
    exp_f = torch.exp(-0.5 * t.square())   # the N(0, 1) characteristic function

    k = x.shape[0]
    x_t = (torch.einsum('knd,md->knm', x.reshape(k, -1, dim), projs)[..., None] * t).float()
    parts = torch.cos(x_t), torch.sin(x_t)   # (k, n, m, knots)
    if mask is not None:
        mask_flat = mask.reshape(k, -1)[:, :, None, None]
        re, im = (masked_mean(p, mask_flat, dim=1) for p in parts)
    else:
        re, im = (p.mean(dim=1) for p in parts)   # (k, m, knots)
    err = ((re - exp_f).square() + im.square()) * exp_f
    return torch.trapezoid(err, t, dim=-1).mean()


def decorrelation_loss(x: torch.Tensor, sample_frac: float = 0.25,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """Feature decorrelation of token rows x (..., d): a random
    `sample_frac` of the rows (at least 2), standardized per feature; the
    mean square of the off-diagonal entries of their correlation matrix."""
    d = x.shape[-1]
    rows = x.reshape(-1, d)
    n = rows.shape[0]
    num_sampled = max(2, int(n * sample_frac))
    idx = draw('permutation', (n,), generator=generator, device=x.device)[:num_sampled]
    sampled = rows[idx]
    sampled = sampled - sampled.mean(dim=0, keepdim=True)
    sampled = sampled / torch.sqrt(sampled.square().mean(dim=0, keepdim=True) + 1e-6)
    corr = (sampled.T @ sampled) / num_sampled
    off_diag = corr - torch.diag(torch.diag(corr))
    return off_diag.square().mean()
