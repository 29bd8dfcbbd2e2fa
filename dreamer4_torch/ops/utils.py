"""Small pure helpers (counterpart of `dreamer4_tpu/ops/utils.py`)."""
from __future__ import annotations

import torch
from torch import nn


def l2norm(t: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return t * torch.rsqrt(t.square().sum(dim=dim, keepdim=True) + eps)


def l1norm(t: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """t over the sum of its absolute values along `dim` (at least eps)."""
    return t / t.abs().sum(dim=dim, keepdim=True).clamp_min(eps)


def softclamp(t: torch.Tensor, value: float = 50.0) -> torch.Tensor:
    """Gemma-style logit soft clamp."""
    return torch.tanh(t / value) * value


def frac_gradient(t: torch.Tensor, frac) -> torch.Tensor:
    """t in the forward; only `frac` of its gradient flows back."""
    sg = t.detach()
    return sg + (t - sg) * frac


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber / smooth-L1 loss, as `F.smooth_l1_loss(...,
    reduction='none')`."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff.square() / beta, diff - 0.5 * beta)


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(x.abs()) - 1.0)


def lens_to_mask(lens: torch.Tensor, total_len: int) -> torch.Tensor:
    """(b,) lengths -> (b, total_len) bool mask, True inside the length."""
    return torch.arange(total_len, device=lens.device)[None, :] < lens[..., None]


def masked_mean(t: torch.Tensor, mask: torch.Tensor | None = None, dim=None) -> torch.Tensor:
    """Mean over `dim` (or all) counting only positions where `mask`
    (broadcast against t) is True, or weighting each by a float mask; the
    weights' sum is taken as at least 1, so an all-False mask gives 0.
    `parallel.distributed.batch_mean` is its mean over the global batch."""
    if mask is None:
        return t.mean() if dim is None else t.mean(dim=dim)
    maskf = mask.broadcast_to(t.shape).to(t.dtype)
    if dim is None:
        return (t * maskf).sum() / maskf.sum().clamp_min(1.0)
    return (t * maskf).sum(dim=dim) / maskf.sum(dim=dim).clamp_min(1.0)


def z_score(t: torch.Tensor, mask: torch.Tensor | None = None, eps: float = 1e-5,
            mean=masked_mean) -> torch.Tensor:
    """Standardize over all positions, or over those `mask` weights (a bool
    or float mask, as in `masked_mean`); `mean` takes the statistics (loss
    code passes `parallel.distributed.batch_mean`)."""
    mu = mean(t, mask)
    var = mean((t - mu).square(), mask)
    return (t - mu) / var.clamp_min(eps).sqrt()


def cosine_distance(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor | None = None,
                    mean=masked_mean) -> torch.Tensor:
    """The mean of 1 - cos(x, y) over the rows of the last dim, counting
    the positions `mask` keeps (as in `masked_mean`, or `mean`)."""
    num = (x * y).sum(dim=-1)
    den = torch.linalg.vector_norm(x, dim=-1) * torch.linalg.vector_norm(y, dim=-1)
    return mean(1.0 - num / den.clamp_min(1e-12), mask)


def ramp_weight(times: torch.Tensor, slope: float = 0.9, intercept: float = 0.1) -> torch.Tensor:
    """Ramp loss weighting, eq (8) of the paper."""
    return slope * times + intercept


def orthogonal_loss(x: torch.Tensor, mean=masked_mean) -> torch.Tensor:
    """Push the rows of x (over dim -2), centred and unit-normed, towards
    orthogonality: the mean (`mean`) over leading dims of the summed
    squared off-diagonal cosine similarities."""
    n = x.shape[-2]
    if n == 1:
        return torch.zeros((), device=x.device)
    x = l2norm(x - x.mean(dim=-2, keepdim=True))
    sim = x @ x.transpose(-1, -2)
    sim = sim.masked_fill(torch.eye(n, dtype=torch.bool, device=x.device), 0.0)
    return mean(sim.square().sum(dim=(-1, -2)))


def cast_params_for_inference(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast the float32 parameters of `module` to `dtype` for serving, in
    place (the counterpart casts a variables pytree); every forward then
    reads half the weight bytes. Non-float32 parameters pass through
    unchanged."""
    with torch.no_grad():
        for p in module.parameters():
            if p.dtype == torch.float32:
                p.data = p.data.to(dtype)
    return module
