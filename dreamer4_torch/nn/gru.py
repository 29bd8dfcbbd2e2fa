"""A GRU cell in flax's layout (counterpart of `flax.linen.GRUCell`), run
over time as a loop of `F.linear` calls.

flax keeps six Denses: `ir`, `iz` and `in` over the input, with bias, and
`hr`, `hz` (without bias) and `hn` (with bias) over the hidden state:
  r = sigmoid(ir(x) + hr(h)), z = sigmoid(iz(x) + hz(h)),
  n = tanh(in(x) + r * hn(h)), h' = (1 - z) * n + z * h.
`torch.nn.GRU` puts a bias on every hidden projection, so it is not used.
`in` is a Python keyword: the Dense is registered under that name with
`add_module`, which keeps the state_dict keys equal to flax's paths.
"""
from __future__ import annotations

import torch
from torch import nn

from .dense import Dense


class GRUCell(nn.Module):
    def __init__(self, dim_in: int, features: int, device=None):
        super().__init__()
        for name in ('ir', 'iz', 'in'):
            self.add_module(name, Dense(dim_in, features, device=device))
        for name, bias in (('hr', False), ('hz', False), ('hn', True)):
            dense = Dense(features, features, bias=bias, device=device)
            # flax's recurrent kernels start orthogonal
            with torch.no_grad():
                nn.init.orthogonal_(dense.weight)
            self.add_module(name, dense)

    def dense(self, name: str) -> Dense:
        return self._modules[name]

    def step(self, h, xr, xz, xn):
        """One step from the input's projections xr, xz, xn."""
        d = self.dense
        r = torch.sigmoid(xr + d('hr')(h))
        z = torch.sigmoid(xz + d('hz')(h))
        n = torch.tanh(xn + r * d('hn')(h))
        return (1.0 - z) * n + z * h

    def forward(self, h, x):
        """One step: (h (..., features), x (..., dim_in)) -> h'."""
        return self.step(h, *(self.dense(name)(x) for name in ('ir', 'iz', 'in')))

    def scan(self, h, xs):
        """Over time: (h0 (b, features), xs (b, t, dim_in)) -> the hidden
        states after each step, (b, t, features). The input projections of
        all steps are taken at once, the recurrence one step at a time."""
        xr, xz, xn = (self.dense(name)(xs) for name in ('ir', 'iz', 'in'))
        outs = []
        for i in range(xs.shape[1]):
            h = self.step(h, xr[:, i], xz[:, i], xn[:, i])
            outs.append(h)
        return torch.stack(outs, dim=1)
