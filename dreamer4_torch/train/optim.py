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

Two paths compute the same step, chosen by what the parameters are. When
every parameter is a plain CUDA float32 tensor, the step runs the
multi-tensor kernels of `ops/multi_tensor.py`: the clip scale, Adam-atan2,
Muon's momentum with the Newton-Schulz input and Muon's update each in one
launch over all of their parameters (a few where the tables are long), and
Newton-Schulz as batched bf16 matmuls, some 70 launches a world-model step
in place of some 3,600, and no synchronize. Otherwise the step is the
plain loop over the parameters (`_step_plain`), the kernels' plain version
and what the CPU tests hold against optax: on CPU tensors, and on
parameters split over a mesh (a DTensor, `parallel.mesh.shard_params`),
which are updated on this rank's shard with their optimizer state kept as
shards: the clip reads the global norm over all shards, and Muon gathers
the weight's update whole to orthogonalize it, then keeps the shard of the
result. A CUDA parameter of another dtype, or parameters on several
devices, raise.
"""
from __future__ import annotations

import math
from collections.abc import Collection
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..ops import multi_tensor
from ..parallel.mesh import local, shard_of, whole, whole_of_shard

NS_COEFFS = (3.4445, -4.7750, 2.0315)

# The Newton-Schulz iterates are Frobenius-normalized up front, so bf16 is
# precision enough for the iteration itself (as in the counterpart)
NS_DTYPE = torch.bfloat16
NS_EPS = 1e-7

MUON_NAMES = frozenset({'to_v', 'to_out', 'proj_in', 'proj_out'})


def _ns_iterate(Y: torch.Tensor, steps: int) -> torch.Tensor:
    """Quintic Newton-Schulz on a (k, n, m) stack with n >= m, each matrix
    Frobenius-normalized: the iteration on the wide X = Y^T (A = X X^T,
    B = b A + c A A, X = a X + B X) written for Y: A = Y^T Y, Y = a Y + Y B
    (B is symmetric). Three products an iteration, the last two one
    `baddbmm` each; cuBLAS runs the tall layout's products on the card at
    two to five times the wide layout's speed (PERF.md)."""
    a, b, c = NS_COEFFS
    for _ in range(steps):
        A = Y.mT @ Y
        B = torch.baddbmm(A, A, A, beta=b, alpha=c)
        Y = torch.baddbmm(Y, Y, B, beta=a)
    return Y


def _is_tall(shape) -> bool:
    """Newton-Schulz takes such a matrix as it is, any other as its
    transpose (n >= m, a square one transposed)."""
    return shape[0] > shape[1]


def ns_stacks(shapes: list[tuple[int, int]]) -> list[tuple[tuple[int, int], list[int]]]:
    """How Newton-Schulz stacks 2-D matrices of these shapes: each taken as
    n >= m (`_is_tall`), those of one such shape in one stack in their
    order, the stacks in the order of their first matrix. [((n, m),
    indices), ...]."""
    stacks: dict[tuple[int, int], list[int]] = {}
    for i, (r, c) in enumerate(shapes):
        stacks.setdefault((max(r, c), min(r, c)), []).append(i)
    return list(stacks.items())


def batched_orthogonalize(mats: list[torch.Tensor], steps: int = 5, eps: float = NS_EPS,
                          ns_dtype=NS_DTYPE) -> list[torch.Tensor]:
    """Approximate orthogonal factors of 2-D matrices, stacked and iterated
    as `ns_stacks` says."""
    tall = lambda t: t if _is_tall(t.shape) else t.T
    out: list = [None] * len(mats)
    for _, idxs in ns_stacks([tuple(g.shape) for g in mats]):
        Y = torch.stack([tall(mats[i]) for i in idxs]).float()             # (k, n, m)
        norm = Y.square().sum(dim=(-2, -1), keepdim=True).sqrt()
        Y = _ns_iterate((Y / (norm + eps)).to(ns_dtype), steps)
        for pos, i in enumerate(idxs):
            o = Y[pos] if _is_tall(mats[i].shape) else Y[pos].T
            out[i] = o.to(mats[i].dtype)
    return out


class MuonStacks(NamedTuple):
    """Where the kernels keep the Muon group's updates: one flat buffer of
    `size` elements holds the Newton-Schulz stacks, stack s at `stacks[s]` =
    (offset, k, n, m) viewed (k, n, m); parameter i's update is matrix
    `slots[i]` = (stack, position) of it, in the parameter's torch layout or,
    where `flips[i]`, its transpose. The stacks are `batched_orthogonalize`'s
    of the updates in flax's orientation."""
    stacks: list[tuple[int, int, int, int]]
    slots: list[tuple[int, int]]
    flips: list[bool]
    size: int

    def offset(self, i: int) -> int:
        """The element offset of parameter i's matrix in the buffer."""
        s, pos = self.slots[i]
        off, _, n, m = self.stacks[s]
        return off + pos * n * m


def muon_stacks(shapes: list[tuple[int, int]], transposed: list[bool]) -> MuonStacks:
    """`MuonStacks` of 2-D parameters of these torch shapes, each the
    transpose of flax's layout where `transposed` says so."""
    flax = [(c, r) if t else (r, c) for (r, c), t in zip(shapes, transposed)]
    stacks, slots, size = [], [None] * len(shapes), 0
    for s, ((n, m), idxs) in enumerate(ns_stacks(flax)):
        stacks.append((size, len(idxs), n, m))
        size += len(idxs) * n * m
        for pos, i in enumerate(idxs):
            slots[i] = (s, pos)
    # the stack holds flax's layout where it is tall, else its transpose
    flips = [t == _is_tall(f) for f, t in zip(flax, transposed)]
    return MuonStacks(stacks, slots, flips, size)


def muon_shape_scale(shape: tuple[int, int], transposed: bool) -> float:
    """Muon's `sqrt(max(1, fan_in / fan_out))` of a parameter of this torch
    shape, fans taken in flax's (in, out) layout."""
    fan_in, fan_out = (shape[1], shape[0]) if transposed else shape
    return math.sqrt(max(1.0, fan_in / fan_out))


def bias_correction(beta: float, count: int) -> float:
    """1 - beta ** count, computed in float32 as the counterpart does."""
    return float(np.float32(1) - np.float32(beta) ** np.float32(count))


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


class _KernelBuffers(NamedTuple):
    """The kernels' device memory, made at the first step on a device: the
    clip scale and its scratch, the Muon stacks (float32 updates and their
    bf16 Newton-Schulz inputs) with each parameter's place in them, and the
    Muon tiles' scratch."""
    device: torch.device
    scale: torch.Tensor
    clip_partials: torch.Tensor
    layout: MuonStacks
    places: list[torch.Tensor]
    inputs: torch.Tensor
    input_views: list[torch.Tensor]
    muon_partials: torch.Tensor
    shape_scales: list[float]


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
    chain on those labels and `optax.set_to_zero()` on the rest.

    The step runs the multi-tensor kernels when every parameter is a plain
    CUDA float32 tensor, else the plain loop (the module docstring)."""

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
        self._buffers: _KernelBuffers | None = None

    def labels(self) -> dict[str, str]:
        """Parameter name -> 'muon' or 'adam'."""
        return {n: g['kind'] for g in self.param_groups for n in g['names']}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError('MuonAdamAtan2 takes no closure')
        device = self._kernel_device()
        if device is None:
            self._step_plain()
        else:
            self._step_kernels(device)

    def _kernel_device(self) -> torch.device | None:
        """The CUDA device the kernels run on, or None for the plain loop."""
        params = [p for g in self.param_groups for p in g['params']]
        if any(isinstance(p, DTensor) for p in params):
            return None
        devices = {p.device for p in params}
        if devices == {torch.device('cpu')}:
            return None
        if len(devices) != 1 or next(iter(devices)).type != 'cuda':
            raise ValueError(f'MuonAdamAtan2 runs on CPU tensors or on one CUDA device; '
                             f'its parameters are on {sorted(map(str, devices))}')
        dtypes = {p.dtype for p in params}
        if dtypes != {torch.float32}:
            raise ValueError(f'MuonAdamAtan2 on CUDA takes float32 parameters; got {dtypes}')
        return devices.pop()

    # ------------------------------------------------------------- kernels

    def _kernel_buffers(self, device: torch.device) -> _KernelBuffers:
        if self._buffers is not None and self._buffers.device == device:
            return self._buffers
        params = [p for g in self.param_groups for p in g['params']]
        # Muon's group; an empty one where the optimizer has none
        muon = next((g for g in self.param_groups if g['kind'] == 'muon'),
                    dict(params=[], transposed=[]))
        shapes = [tuple(p.shape) for p in muon['params']]
        layout = muon_stacks(shapes, muon['transposed'])
        flat = torch.empty(layout.size, dtype=torch.float32, device=device)
        inputs = torch.empty(layout.size, dtype=NS_DTYPE, device=device)
        places, input_views = [], []
        for i, shape in enumerate(shapes):
            view_shape = shape[::-1] if layout.flips[i] else shape
            off, n = layout.offset(i), shape[0] * shape[1]
            places.append(flat[off:off + n].view(view_shape))
            input_views.append(inputs[off:off + n].view(view_shape))
        self._buffers = _KernelBuffers(
            device, torch.empty(1, device=device),
            torch.empty(multi_tensor.clip_partials_len([p.numel() for p in params]), device=device),
            layout, places, inputs, input_views,
            torch.empty(multi_tensor.muon_partials_len(shapes), device=device),
            [muon_shape_scale(s, t) for s, t in zip(shapes, muon['transposed'])])
        return self._buffers

    def _state(self, p: torch.Tensor, *names: str) -> list[torch.Tensor]:
        """The state tensors `names` of p (this rank's shard of a DTensor),
        made as zeros at p's first step."""
        state = self.state[p]
        for name in names:
            if name not in state:
                state[name] = torch.zeros_like(local(p))
        return [state[name] for name in names]

    def _step_kernels(self, device: torch.device):
        bufs = self._kernel_buffers(device)
        grads = {p: p.grad for g in self.param_groups for p in g['params']}
        scale, max_norm = None, self.defaults['clip_grad_norm']
        if max_norm is not None:
            multi_tensor.clip_scale(list(grads), list(grads.values()), max_norm,
                                    bufs.clip_partials, bufs.scale)
            scale = bufs.scale
        wd = self.defaults['weight_decay']
        for group in self.param_groups:
            params = group['params']
            if group['kind'] == 'muon':
                moms = [self._state(p, 'momentum')[0] for p in params]
                multi_tensor.muon_prepare(
                    params, [grads[p] for p in params], moms, bufs.places, bufs.input_views,
                    bufs.layout.flips, scale, bufs.muon_partials, weight_decay=wd,
                    momentum=group['momentum'], eps=NS_EPS)
                outs = [_ns_iterate(bufs.inputs[off:off + k * n * m].view(k, n, m),
                                    group['ns_steps'])
                        for off, k, n, m in bufs.layout.stacks]
                multi_tensor.muon_apply(params, [outs[s][pos] for s, pos in bufs.layout.slots],
                                        bufs.layout.flips,
                                        [-group['lr'] * s for s in bufs.shape_scales])
            else:
                group['count'] += 1
                mus, nus = zip(*(self._state(p, 'mu', 'nu') for p in params))
                multi_tensor.adam_atan2(
                    params, [grads[p] for p in params], mus, nus, scale, weight_decay=wd,
                    b1=group['b1'], b2=group['b2'], c1=bias_correction(group['b1'], group['count']),
                    c2=bias_correction(group['b2'], group['count']), b=group['b'],
                    lr_a=group['lr'] * group['a'])

    # ---------------------------------------------------------- plain loop

    def _step_plain(self):
        grads = {p: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for g in self.param_groups for p in g['params']}
        max_norm = self.defaults['clip_grad_norm']
        scale = None
        if max_norm is not None:
            norm = torch.stack([_square_sum(g) for g in grads.values()]).sum().sqrt()
            scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-16), max=1.0)
        wd = self.defaults['weight_decay']
        for p, g in grads.items():
            g = local(g)
            if scale is not None:
                g = (g * scale).to(g.dtype)
            grads[p] = g + wd * local(p) if wd > 0.0 else g
        for group in self.param_groups:
            if group['kind'] == 'muon':
                self._muon(group, grads)
            else:
                self._adam_atan2(group, grads)

    def _muon(self, group, grads):
        mom = group['momentum']
        use = []
        for p in group['params']:
            g = grads[p]
            m = self._state(p, 'momentum')[0].mul_(mom).add_(g)
            u = m * mom + g                              # Nesterov
            if isinstance(p, DTensor):                   # the whole update
                u = whole_of_shard(u, p)
            use.append(u)
        # the update in flax's orientation, then back to the torch layout
        flax = [u.T if t else u for u, t in zip(use, group['transposed'])]
        orthed = batched_orthogonalize(flax, group['ns_steps'], NS_EPS)
        for p, o, t in zip(group['params'], orthed, group['transposed']):
            update = -group['lr'] * muon_shape_scale(tuple(p.shape), t) * o
            update = update.T if t else update
            if isinstance(p, DTensor):                   # this rank's shard of it
                update = shard_of(update, p)
            local(p).add_(update)

    def _adam_atan2(self, group, grads):
        group['count'] += 1
        b1, b2 = group['b1'], group['b2']
        c1 = bias_correction(b1, group['count'])
        c2 = bias_correction(b2, group['count'])
        for p in group['params']:
            g = grads[p]
            mu, nu = self._state(p, 'mu', 'nu')
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * g.square())
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
