"""`Dense`: the counterpart of flax's `nn.Dense`, as an `nn.Linear`.

flax computes a Dense layer in its `dtype` when one is given, else in the
promoted type of input and parameters; weights are cast to that type after
they are read. The weight keeps torch's (out, in) layout; `convert.py`
transposes flax's (in, out) kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .init import lecun_normal_


class Dense(nn.Linear):
    def __init__(self, dim_in: int, dim_out: int, bias: bool = True, dtype=None, device=None):
        super().__init__(dim_in, dim_out, bias=bias, device=device)
        self.compute_dtype = dtype
        lecun_normal_(self.weight, dim_in)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), bias)
