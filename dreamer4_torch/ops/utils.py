"""Small pure helpers (counterpart of `dreamer4_tpu/ops/utils.py`)."""
from __future__ import annotations

import torch
from torch import nn


def l2norm(t: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return t * torch.rsqrt(t.square().sum(dim=dim, keepdim=True) + eps)


def softclamp(t: torch.Tensor, value: float = 50.0) -> torch.Tensor:
    """Gemma-style logit soft clamp."""
    return torch.tanh(t / value) * value


def symexp(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * (torch.exp(x.abs()) - 1.0)


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
