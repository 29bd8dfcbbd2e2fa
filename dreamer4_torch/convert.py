"""Convert a flax parameter tree of the counterpart into a torch state_dict.

The port keeps flax's submodule names, so conversion is a walk over names:
`transformer/attn_0/to_q/kernel` is `transformer.attn_0.to_q.weight`. Dense
kernels are (in, out) in flax and (out, in) in torch; `nn.Embed`'s
`embedding` is `nn.Embedding`'s `weight`; every other leaf (the pools' raw
`_Kernel` / `_Scale` / `_Gamma` holders, ensemble kernels, learned tokens)
keeps its name and layout. Leaves of flax's `state` collection (the loss
normalizers' `exp_avg_sq`) are the torch module's buffers of the same
names. A leftover or missing key raises.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = (*prefix, str(key))
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def flax_params_to_torch(params: Mapping[str, Any], model: nn.Module,
                         state: Mapping[str, Any] | None = None) -> dict[str, torch.Tensor]:
    """params: the flax `variables['params']` tree (numpy or jax arrays);
    state: its `variables['state']` tree, if the model has one. Returns a
    state_dict for `model`, on the model's devices and dtypes: every
    parameter, and every buffer when `state` is given."""
    target = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    leaves = list(_flatten(params).items())
    if state is not None:
        leaves += list(_flatten(state).items())
    for path, value in leaves:
        module = model
        for name in path[:-1]:
            child = module._modules.get(name)
            if child is None:
                raise KeyError(f'flax parameter {"/".join(path)} has no torch module '
                               f'(no submodule {name!r})')
            module = child
        leaf = path[-1]
        if isinstance(module, nn.Linear) and leaf == 'kernel':
            leaf, value = 'weight', value.T
        elif isinstance(module, nn.Embedding) and leaf == 'embedding':
            leaf = 'weight'
        key = '.'.join((*path[:-1], leaf))
        if key not in target:
            raise KeyError(f'flax parameter {"/".join(path)} maps to {key}, which the torch '
                           'model does not have')
        ref = target[key]
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f'{key}: flax shape {value.shape} != torch shape '
                             f'{tuple(ref.shape)}')
        out[key] = torch.from_numpy(np.array(value, copy=True)).to(ref.dtype).to(ref.device)
    expected = set(target) if state is not None else {n for n, _ in model.named_parameters()}
    missing = sorted(expected - set(out))
    if missing:
        raise KeyError(f'torch parameters with no flax counterpart: {missing}')
    return out
