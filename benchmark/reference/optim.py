"""The optimizer of both trainers plainly: the gradients clipped by their
global norm, then Muon for the 2-D weights of the attention's value and
output projections and the feedforward's projections, Adam-atan2 for every
other parameter.

Muon: momentum 0.95 with a Nesterov step; the update, as the (in, out) matrix
of the linear map, Frobenius-normalized and taken through 5 quintic
Newton-Schulz iterations (3.4445, -4.7750, 2.0315) on its wide orientation,
scaled by sqrt(max(1, in / out)) at 10x the base rate. Adam-atan2: b1 0.9,
b2 0.99, bias-corrected moments, update a * atan2(m, b * sqrt(v)), a 1.27,
b 1.
"""
from __future__ import annotations

import math

import torch

MUON_MODULES = frozenset({'to_v', 'to_out', 'proj_in', 'proj_out'})
NS_COEFFS = (3.4445, -4.7750, 2.0315)


def is_muon(name: str, p: torch.Tensor) -> bool:
    return p.ndim == 2 and bool(MUON_MODULES & set(name.split('.')))


def as_in_out(name: str, t: torch.Tensor) -> torch.Tensor:
    """A linear map's (in, out) matrix: '.weight' is stored (out, in), a pool's
    '.kernel' (in, out)."""
    return t.t() if name.endswith('.weight') else t


def orthogonalize(g: torch.Tensor, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    wide = g.t() if g.shape[0] > g.shape[1] else g
    x = wide / (wide.norm() + eps)
    a, b, c = NS_COEFFS
    for _ in range(steps):
        A = x @ x.t()
        x = a * x + (b * A + c * (A @ A)) @ x
    return x.t() if g.shape[0] > g.shape[1] else x


class MuonAdamAtan2:
    def __init__(self, params: dict, lr: float = 3e-4, clip: float = 1.0, b1: float = 0.9,
                 b2: float = 0.99, momentum: float = 0.95, a: float = 1.27, b: float = 1.0):
        self.params = params
        self.lr, self.clip, self.b1, self.b2, self.mom, self.a, self.b = lr, clip, b1, b2, momentum, a, b
        self.state = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items() if not is_muon(n, p)}
        self.count = 0

    @torch.no_grad()
    def clipped(self, grads: dict) -> dict:
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.clamp(self.clip / norm.clamp_min(1e-16), max=1.0)
        return {n: g * scale for n, g in grads.items()}

    @torch.no_grad()
    def step(self, grads: dict):
        """grads: the clipped gradient of every parameter."""
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for n, p in self.params.items():
            g = grads[n]
            if is_muon(n, p):
                m = self.state[n].mul_(self.mom).add_(g)
                u = as_in_out(n, m * self.mom + g)
                fan_in, fan_out = u.shape
                o = orthogonalize(u) * (-10.0 * self.lr * math.sqrt(max(1.0, fan_in / fan_out)))
                p.add_(as_in_out(n, o))
            else:
                mu = self.state[n].mul_(self.b1).add_((1.0 - self.b1) * g)
                nu = self.nu[n].mul_(self.b2).add_((1.0 - self.b2) * g.square())
                p.add_(-self.lr * self.a * torch.atan2(mu / c1, self.b * (nu / c2).sqrt()))
