"""Scalar <-> distribution codecs for rewards and values (counterpart of
`dreamer4_tpu/ops/codecs.py`): SymExpTwoHot and HLGauss.

    encode(values)          -> (..., num_bins) target distribution
    decode(logits_or_probs) -> (...,) scalar expectation
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .utils import symexp


def _linspace(lo: float, hi: float, n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.linspace(lo, hi, n, dtype=torch.float32, device=like.device)


@dataclass(frozen=True)
class SymExpTwoHot:
    """Two-hot encoding over a symexp-spaced support."""

    reward_range: tuple[float, float] = (-20.0, 20.0)
    num_bins: int = 255

    def bin_values(self, like: torch.Tensor) -> torch.Tensor:
        return symexp(_linspace(*self.reward_range, self.num_bins, like))

    def encode(self, values: torch.Tensor) -> torch.Tensor:
        bins = self.bin_values(values)
        values = values.clamp(bins[0], bins[-1])
        idx = torch.searchsorted(bins, values.contiguous())   # first bin >= value
        left = (idx - 1).clamp(0, self.num_bins - 1)
        right = (left + 1).clamp(0, self.num_bins - 1)
        left_val, right_val = bins[left], bins[right]
        total = (right_val - left_val).clamp_min(1e-20)
        left_weight = (right_val - values) / total
        right_weight = 1.0 - left_weight
        one_hot = lambda i: torch.nn.functional.one_hot(i, self.num_bins).to(values.dtype)
        return one_hot(left) * left_weight[..., None] + one_hot(right) * right_weight[..., None]

    def decode(self, logits: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        probs = torch.softmax(logits, dim=-1) if normalize else logits
        return torch.einsum('...l,l->...', probs, self.bin_values(probs).to(probs.dtype))


@dataclass(frozen=True)
class HLGauss:
    """Histogram-Gaussian codec: a scalar is encoded as the mass a Gaussian
    centred at it puts in each bin."""

    reward_range: tuple[float, float] = (-20.0, 20.0)
    num_bins: int = 255
    sigma: float | None = None
    sigma_to_bin_ratio: float = 2.0
    clamp_to_range: bool = True
    eps: float = 1e-10

    def support(self, like: torch.Tensor) -> torch.Tensor:
        return _linspace(*self.reward_range, self.num_bins + 1, like)

    def bin_values(self, like: torch.Tensor) -> torch.Tensor:
        support = self.support(like)
        return (support[:-1] + support[1:]) * 0.5

    @property
    def _sigma(self) -> float:
        if self.sigma is not None:
            return float(self.sigma)
        lo, hi = self.reward_range
        return self.sigma_to_bin_ratio * (hi - lo) / self.num_bins

    def encode(self, values: torch.Tensor) -> torch.Tensor:
        if self.clamp_to_range:
            values = values.clamp(*self.reward_range)
        z_support = (self.support(values) - values[..., None]) / self._sigma
        cdf = 0.5 * (1.0 + torch.erf(z_support / math.sqrt(2.0)))
        z = (cdf[..., -1] - cdf[..., 0]).clamp_min(self.eps)
        return (cdf[..., 1:] - cdf[..., :-1]) / z[..., None]

    def decode(self, logits: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        probs = torch.softmax(logits, dim=-1) if normalize else logits
        return torch.einsum('...l,l->...', probs, self.bin_values(probs).to(probs.dtype))


REWARD_ENCODERS = {
    'symexp_two_hot': SymExpTwoHot,
    'hl_gauss': HLGauss,
}


def get_reward_encoder(name: str, **kwargs):
    if name not in REWARD_ENCODERS:
        raise ValueError(f'unknown reward encoder type {name}')
    return REWARD_ENCODERS[name](**kwargs)
