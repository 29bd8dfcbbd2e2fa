"""Simplicial embeddings (counterpart of `dreamer4_tpu/nn/sem.py`): a
grouped softmax bottleneck."""
from __future__ import annotations

import torch
from torch import nn

from .dense import Dense
from .norms import LayerNorm


class SEM(nn.Module):
    """Softmax over groups of `dim_simplex` features at `temperature`,
    between an optional projection in (`embedder`, dim_in -> dim) and out
    (`project_out`, dim -> dim_in), both without bias; each defaults to
    on when dim_in differs from dim. `pre_layernorm` adds a LayerNorm
    without bias before the softmax."""

    def __init__(self, dim: int, dim_in: int | None = None, project_in: bool | None = None,
                 project_out: bool | None = None, temperature: float = 0.1,
                 dim_simplex: int = 8, pre_layernorm: bool = False, device=None):
        super().__init__()
        if dim % dim_simplex != 0:
            raise ValueError(f'dim {dim} must be a multiple of dim_simplex {dim_simplex}')
        dim_in = dim_in if dim_in is not None else dim
        project_in = project_in if project_in is not None else dim_in != dim
        project_out = project_out if project_out is not None else dim_in != dim
        self.temperature, self.dim_simplex = temperature, dim_simplex
        self.embedder = Dense(dim_in, dim, bias=False, device=device) if project_in else None
        self.norm = LayerNorm(dim, device=device) if pre_layernorm else None
        self.project_out = Dense(dim, dim_in, bias=False, device=device) if project_out else None

    def forward(self, t):
        if self.embedder is not None:
            t = self.embedder(t)
        if self.norm is not None:
            t = self.norm(t)
        shape = t.shape
        t = t.reshape(*shape[:-1], shape[-1] // self.dim_simplex, self.dim_simplex)
        t = torch.softmax(t / self.temperature, dim=-1).reshape(shape)
        if self.project_out is not None:
            t = self.project_out(t)
        return t
