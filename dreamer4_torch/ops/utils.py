"""Small pure helpers (counterpart of `dreamer4_tpu/ops/utils.py`)."""
from __future__ import annotations

import torch
from torch import nn


def l2norm(t: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return t * torch.rsqrt(t.square().sum(dim=dim, keepdim=True) + eps)


def softclamp(t: torch.Tensor, value: float = 50.0) -> torch.Tensor:
    """Gemma-style logit soft clamp."""
    return torch.tanh(t / value) * value


def frac_gradient(t: torch.Tensor, frac) -> torch.Tensor:
    """t in the forward; only `frac` of its gradient flows back."""
    sg = t.detach()
    return sg + (t - sg) * frac


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(x.abs()) - 1.0)


def lens_to_mask(lens: torch.Tensor, total_len: int) -> torch.Tensor:
    """(b,) lengths -> (b, total_len) bool mask, True inside the length."""
    return torch.arange(total_len, device=lens.device)[None, :] < lens[..., None]


def masked_mean(t: torch.Tensor, mask: torch.Tensor | None = None, dim=None) -> torch.Tensor:
    """Mean over `dim` (or all) counting only positions where `mask`
    (broadcast against t) is True; an all-False mask gives 0."""
    if mask is None:
        return t.mean() if dim is None else t.mean(dim=dim)
    maskf = mask.broadcast_to(t.shape).to(t.dtype)
    if dim is None:
        return (t * maskf).sum() / maskf.sum().clamp_min(1.0)
    return (t * maskf).sum(dim=dim) / maskf.sum(dim=dim).clamp_min(1.0)


def ramp_weight(times: torch.Tensor, slope: float = 0.9, intercept: float = 0.1) -> torch.Tensor:
    """Ramp loss weighting, eq (8) of the paper."""
    return slope * times + intercept


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
