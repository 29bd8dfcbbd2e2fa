"""Optimizers (counterpart of `dreamer4_tpu/train/optim.py`): Muon
(Newton-Schulz orthogonalized momentum) for the 2-D trunk weights,
Adam-atan2 for everything else, after a clip by the global gradient norm.

`MuonAdamAtan2` is a `torch.optim.Optimizer` over a model's parameters that
computes the counterpart's `muon_adam_atan2` chain: clip, optional decayed
weights, then per parameter either Muon or Adam-atan2. Muon works on each
weight in flax's (in, out) orientation, the counterpart's, whatever its
torch layout: `nn.Linear` keeps (out, in) and is transposed for the update,
the attention pools' raw `_Kernel` holders keep flax's layout already. So
the Newton-Schulz iteration and the shape scale `sqrt(max(1, in / out))`
see the same matrix as in the counterpart. `MultiSteps` accumulates
gradients over micro-steps (`optax.MultiSteps`).

A parameter split over a mesh (a DTensor, `parallel.mesh.shard_params`)
is updated on this rank's shard, its optimizer state kept as shards: the
clip reads the global norm over all shards, and Muon gathers the weight's
update whole to orthogonalize it, then keeps the shard of the result.
"""
from __future__ import annotations

import math
from collections.abc import Collection

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..parallel.mesh import local, shard_of, whole, whole_of_shard

NS_COEFFS = (3.4445, -4.7750, 2.0315)

# The Newton-Schulz iterates are Frobenius-normalized up front, so bf16 is
# precision enough for the iteration itself (as in the counterpart)
NS_DTYPE = torch.bfloat16

MUON_NAMES = frozenset({'to_v', 'to_out', 'proj_in', 'proj_out'})


def _ns_iterate(X: torch.Tensor, steps: int) -> torch.Tensor:
    """Quintic Newton-Schulz on (..., m, n) with m <= n, each matrix
    Frobenius-normalized."""
    a, b, c = NS_COEFFS
    for _ in range(steps):
        A = X @ X.transpose(-1, -2)
        B = b * A + c * (A @ A)
        X = a * X + B @ X
    return X


def batched_orthogonalize(mats: list[torch.Tensor], steps: int = 5, eps: float = 1e-7,
                          ns_dtype=NS_DTYPE) -> list[torch.Tensor]:
    """Approximate orthogonal factors of 2-D matrices: each is turned to
    m <= n, same-shaped ones are stacked and iterated together."""
    groups: dict[tuple, list[int]] = {}
    oriented = []
    for i, g in enumerate(mats):
        transposed = g.shape[0] > g.shape[1]
        X = g.T if transposed else g
        oriented.append((X, transposed))
        groups.setdefault(tuple(X.shape), []).append(i)
    out: list = [None] * len(mats)
    for idxs in groups.values():
        X = torch.stack([oriented[i][0] for i in idxs]).float()            # (k, m, n)
        norm = X.square().sum(dim=(-2, -1), keepdim=True).sqrt()
        X = _ns_iterate((X / (norm + eps)).to(ns_dtype), steps)
        for pos, i in enumerate(idxs):
            o = X[pos].T if oriented[i][1] else X[pos]
            out[i] = o.to(mats[i].dtype)
    return out


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """The float32 sum of squares of a whole gradient, over every shard of
    a DTensor."""
    return whole(g.float().square().sum())


def muon_label(name: str, param: torch.Tensor) -> str:
    """'muon' for 2-D trunk weights (attention v/out and feedforward
    projections), 'adam' otherwise: the counterpart's `muon_label_fn` on
    the same module names."""
    return 'muon' if param.ndim == 2 and MUON_NAMES & set(name.split('.')) else 'adam'


def _as_prefixed(modules: nn.Module | dict[str, nn.Module]) -> dict[str, nn.Module]:
    return {'': modules} if isinstance(modules, nn.Module) else modules


def transposed_from_flax(modules: nn.Module | dict[str, nn.Module]) -> set[str]:
    """Names of the parameters whose torch layout is the transpose of
    flax's: the weights of `nn.Linear` modules (see convert.py), named as
    `named_train_parameters` names them."""
    return {f'{mod_name}.weight' if mod_name else 'weight'
            for prefix, module in _as_prefixed(modules).items()
            for mod_name, mod in module.named_modules(prefix=prefix)
            if isinstance(mod, nn.Linear)}


def named_train_parameters(modules: nn.Module | dict[str, nn.Module]):
    """(name, parameter) of one module, under the parameters' own names,
    or of a dict of modules, each under its key as a prefix ('' for none:
    the counterpart keeps such a module's parameters under that top-level
    key of its parameter tree)."""
    for prefix, module in _as_prefixed(modules).items():
        yield from module.named_parameters(prefix=prefix)


class MuonAdamAtan2(torch.optim.Optimizer):
    """The counterpart's `muon_adam_atan2(learning_rate, muon_learning_rate,
    weight_decay, clip_grad_norm, b1, b2, momentum)` over the parameters
    of `model`: one module, or a dict of modules by the prefix of their
    parameters' names (see `named_train_parameters`). A parameter without
    a gradient counts as a zero gradient, as every parameter has one in
    the counterpart.

    `only`: the names of the parameters it trains; the others are in no
    group, so they neither move (no decay, no Muon) nor count in the
    clip's norm: the counterpart's `optax.multi_transform` with this
    chain on those labels and `optax.set_to_zero()` on the rest."""

    def __init__(self, model: nn.Module | dict[str, nn.Module], learning_rate: float = 3e-4,
                 muon_learning_rate: float | None = None, weight_decay: float = 0.0,
                 clip_grad_norm: float | None = None, b1: float = 0.9, b2: float = 0.99,
                 momentum: float = 0.95, ns_steps: int = 5, a: float = 1.27, b: float = 1.0,
                 only: Collection[str] | None = None):
        transposed = transposed_from_flax(model)
        named = {'muon': [], 'adam': []}
        for name, p in named_train_parameters(model):
            if only is None or name in only:
                named[muon_label(name, p)].append((name, p))
        muon_lr = muon_learning_rate if muon_learning_rate is not None else learning_rate * 10.0
        groups = [dict(params=[p for _, p in named['muon']], kind='muon', lr=muon_lr,
                       names=[n for n, _ in named['muon']],
                       transposed=[n in transposed for n, _ in named['muon']]),
                  dict(params=[p for _, p in named['adam']], kind='adam', lr=learning_rate,
                       names=[n for n, _ in named['adam']], count=0)]
        defaults = dict(weight_decay=weight_decay, clip_grad_norm=clip_grad_norm, b1=b1, b2=b2,
                        momentum=momentum, ns_steps=ns_steps, a=a, b=b)
        super().__init__([g for g in groups if g['params']], defaults)

    def labels(self) -> dict[str, str]:
        """Parameter name -> 'muon' or 'adam'."""
        return {n: g['kind'] for g in self.param_groups for n in g['names']}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError('MuonAdamAtan2 takes no closure')
        grads = {p: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for g in self.param_groups for p in g['params']}
        max_norm = self.defaults['clip_grad_norm']
        if max_norm is not None:
            norm = torch.stack([_square_sum(g) for g in grads.values()]).sum().sqrt()
            scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-16), max=1.0)
            grads = {p: (local(g) * scale).to(g.dtype) for p, g in grads.items()}
        grads = {p: local(g) for p, g in grads.items()}
        wd = self.defaults['weight_decay']
        if wd > 0.0:
            grads = {p: g + wd * local(p) for p, g in grads.items()}
        for group in self.param_groups:
            if group['kind'] == 'muon':
                self._muon(group, grads)
            else:
                self._adam_atan2(group, grads)

    def _muon(self, group, grads):
        mom = group['momentum']
        use = []
        for p in group['params']:
            state = self.state[p]
            if 'momentum' not in state:
                state['momentum'] = torch.zeros_like(local(p))
            g = grads[p]
            m = state['momentum'].mul_(mom).add_(g)
            u = m * mom + g                              # Nesterov
            if isinstance(p, DTensor):                   # the whole update
                u = whole_of_shard(u, p)
            use.append(u)
        # the update in flax's orientation, then back to the torch layout
        flax = [u.T if t else u for u, t in zip(use, group['transposed'])]
        orthed = batched_orthogonalize(flax, group['ns_steps'], 1e-7)
        for p, o, t in zip(group['params'], orthed, group['transposed']):
            fan_in, fan_out = (p.shape[1], p.shape[0]) if t else (p.shape[0], p.shape[1])
            scale = math.sqrt(max(1.0, fan_in / fan_out))
            update = -group['lr'] * scale * o
            update = update.T if t else update
            if isinstance(p, DTensor):                   # this rank's shard of it
                update = shard_of(update, p)
            local(p).add_(update)

    def _adam_atan2(self, group, grads):
        group['count'] += 1
        b1, b2 = group['b1'], group['b2']
        count = torch.tensor(float(group['count']))
        c1 = float(1 - torch.tensor(b1) ** count)
        c2 = float(1 - torch.tensor(b2) ** count)
        for p in group['params']:
            state = self.state[p]
            if 'mu' not in state:
                state['mu'] = torch.zeros_like(local(p))
                state['nu'] = torch.zeros_like(local(p))
            g = grads[p]
            mu = state['mu'].mul_(b1).add_((1 - b1) * g)
            nu = state['nu'].mul_(b2).add_((1 - b2) * g.square())
            local(p).add_(-group['lr'] * group['a']
                           * torch.atan2(mu / c1, group['b'] * (nu / c2).sqrt()))


class MultiSteps:
    """`optax.MultiSteps` over an optimizer: each `step()` folds the
    parameters' gradients into a running mean (`acc + (g - acc) / (n + 1)`,
    optax's form) and only every `every_k`-th applies the inner optimizer
    to that mean, then starts a new mean. `mini_step` is 0 right after an
    applied step. Its state (the inner optimizer's, the mean and
    `mini_step`) round-trips through `state_dict`."""

    def __init__(self, optimizer: torch.optim.Optimizer, every_k: int):
        if every_k < 2:
            raise ValueError('MultiSteps accumulates over every_k >= 2 steps')
        self.optimizer = optimizer
        self.every_k = every_k
        self.mini_step = 0
        self.params = [p for g in optimizer.param_groups for p in g['params']]
        self.acc = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self, set_to_none: bool = True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self):
        for p, acc in zip(self.params, self.acc):
            if p.grad is not None:
                acc.add_((p.grad - acc) / (self.mini_step + 1))
            else:   # a missing gradient counts as zero, as in MuonAdamAtan2
                acc.sub_(acc / (self.mini_step + 1))
        self.mini_step += 1
        if self.mini_step < self.every_k:
            return
        for p, acc in zip(self.params, self.acc):
            p.grad = acc.clone()
        self.optimizer.step()
        for acc in self.acc:
            acc.zero_()
        self.mini_step = 0

    def state_dict(self) -> dict:
        return dict(inner=self.optimizer.state_dict(), mini_step=self.mini_step,
                    acc=[a.clone() for a in self.acc])

    def load_state_dict(self, state: dict):
        self.optimizer.load_state_dict(state['inner'])
        self.mini_step = state['mini_step']
        with torch.no_grad():
            for acc, saved in zip(self.acc, state['acc']):
                acc.copy_(saved)


def with_grad_accum(optimizer: torch.optim.Optimizer, grad_accum: int):
    """The optimizer as it is for `grad_accum <= 1`, else wrapped in
    `MultiSteps` (the counterpart's `with_grad_accum`)."""
    return optimizer if grad_accum <= 1 else MultiSteps(optimizer, grad_accum)
