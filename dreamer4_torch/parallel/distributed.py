"""Multi-process scaffolding (counterpart of
`dreamer4_tpu/parallel/distributed.py`).

Each process is one rank of a `torch.distributed` process group on one
device: `cuda:<local rank>` over NCCL, or the CPU over gloo when the caller
asks for it. Nothing falls back: asking for a card where there is none, or
for NCCL where it cannot start, raises.

    from dreamer4_torch.parallel import distributed as dist
    device = dist.initialize()               # torchrun's environment
    mesh = dist.create_global_mesh(data=-1)  # data axis over every rank
    batch = dist.host_local_batch_to_global(mesh, ('data',), local_batch)

The counterpart's gradient averaging is GSPMD's; here a trainer given a mesh
runs its step inside `batch_parallel`, and afterwards averages the gradients
over `data` (`average_gradients`). Inside, loss code reduces over the batch
only through the `batch_*` helpers, which reduce over the ranks of `data`
(and are the plain reductions outside): `batch_mean` and `batch_sum` for
means and sums, `batch_gather` where a loss needs the rows themselves; and
each draw is made at the global batch and cut to the rank's rows
(`local_rows`). Every rank then computes the loss of the global batch, and
the step equals one process's on it. A plain `.mean()` over the batch in
loss code would be the rank's, and is a fault.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..device import resolve_device
from ..ops.utils import masked_mean

DATA_AXIS = 'data'
MODEL_AXIS = 'model'


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device: str | torch.device | None = None,
               store: dist.Store | None = None, timeout: float | None = None) -> torch.device:
    """Joins this process to the group and returns its device.

    `coordinator_address` ('host:port', a TCP rendezvous), or a `store`
    (e.g. a `FileStore`), with `num_processes` and `process_id`; with
    neither, torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK, LOCAL_RANK). The rank runs on `cuda:<LOCAL_RANK>` (without
    LOCAL_RANK, the rank modulo the cards) over NCCL, unless `device='cpu'`:
    then on the CPU over gloo. `timeout` (seconds)
    bounds every collective."""
    kwargs: dict = {}
    if timeout is not None:
        kwargs['timeout'] = datetime.timedelta(seconds=timeout)
    if store is not None or coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError('a store or a coordinator address needs num_processes and '
                             'process_id')
        kwargs.update(world_size=num_processes, rank=process_id)
        if store is not None:
            kwargs['store'] = store
        else:
            kwargs['init_method'] = f'tcp://{coordinator_address}'
    else:
        kwargs['init_method'] = 'env://'
    rank = process_id if process_id is not None else int(os.environ.get('RANK', 0))

    if device is not None and torch.device(device).type == 'cpu':
        device, backend = torch.device('cpu'), 'gloo'
    else:
        if 'LOCAL_RANK' in os.environ:
            index = int(os.environ['LOCAL_RANK'])
        else:
            resolve_device()   # raises without a card
            index = rank % torch.cuda.device_count()
        device = resolve_device(torch.device('cuda', index))
        torch.cuda.set_device(device)
        backend = 'nccl'
    dist.init_process_group(backend, **kwargs)
    return device


def create_global_mesh(data: int = -1, model: int = 1) -> DeviceMesh:
    """A (data, model) mesh over every rank of the group; `data=-1` takes
    the ranks `model` leaves. On the devices of the group's backend."""
    n = dist.get_world_size()
    if data == -1:
        if n % model:
            raise ValueError(f'{n} ranks do not split into model axes of {model}')
        data = n // model
    if data * model != n:
        raise ValueError(f'{data}x{model} != {n} ranks')
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    return init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def placements_of(mesh: DeviceMesh, pspec) -> list:
    """The DTensor placements of a partition spec: `pspec[i]` names the mesh
    axis (or tuple of axes) tensor dim i is split over, None for none."""
    placements = [Replicate()] * mesh.ndim
    for dim, axes in enumerate(pspec):
        for axis in (axes if isinstance(axes, tuple) else (axes,)):
            if axis is not None:
                placements[mesh.mesh_dim_names.index(axis)] = Shard(dim)
    return placements


def map_tensors(fn, tree: Any) -> Any:
    """`fn` on every tensor or numpy leaf of dicts, lists, tuples (named
    too) and dataclasses (an `Experience`); other leaves pass through."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: map_tensors(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(mesh.device_type)


def host_local_batch_to_global(mesh: DeviceMesh, pspec, local_batch: Any) -> Any:
    """Each process's shard of the leading dim (numpy or torch) as one
    global DTensor per leaf, on the rank's device; `pspec` as in
    `placements_of` (e.g. ('data',)). A trainer takes such a batch (or the
    rank's rows as plain tensors). Any tree of `map_tensors`."""
    placements = placements_of(mesh, tuple(pspec))
    device = _mesh_device(mesh)

    def convert(x):
        x = torch.as_tensor(x).to(device)
        return DTensor.from_local(x, mesh, placements, run_check=False)

    return map_tensors(convert, local_batch)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


# ------------------------------------------------------ data parallelism

class BatchGroup(NamedTuple):
    """The ranks that split the batch: their group, this rank's index in it
    and their count."""
    group: dist.ProcessGroup
    rank: int
    size: int


_BATCH_GROUP: contextvars.ContextVar[BatchGroup | None] = contextvars.ContextVar(
    'batch_group', default=None)


def _data_submesh(mesh: DeviceMesh) -> DeviceMesh:
    return mesh[DATA_AXIS] if mesh.ndim > 1 else mesh


@contextlib.contextmanager
def batch_parallel(mesh: DeviceMesh):
    """Inside, the `batch_*` reductions run over the ranks of `data`, and
    `local_rows` draws at the global batch (see the module docstring)."""
    sub = _data_submesh(mesh)
    token = _BATCH_GROUP.set(BatchGroup(sub.get_group(), sub.get_local_rank(), sub.size()))
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


def batch_group() -> BatchGroup | None:
    """The active `batch_parallel` group, or None outside one."""
    return _BATCH_GROUP.get()


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group whose gradient is the sum of the ranks'
    gradients: each rank's loss reads the global sum, so the gradient of
    the ranks' summed losses reaches each rank's term in full."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks of the active `batch_parallel` group,
    differentiably; t itself outside one. Averaging the gradients over the
    group then gives the gradient of the loss of the global batch."""
    bg = batch_group()
    return t if bg is None else _AllReduceSum.apply(t, bg.group)


def batch_mean(t: torch.Tensor, mask: torch.Tensor | None = None, dim=None) -> torch.Tensor:
    """`ops.utils.masked_mean(t, mask, dim)` where `dim` (all dims by
    default) holds the batch: inside `batch_parallel`, of the global batch,
    its sums taken over the ranks by `batch_sum` (without a mask every rank
    holds as many rows)."""
    bg = batch_group()
    if bg is None:
        return masked_mean(t, mask, dim)
    total = (lambda x: x.sum()) if dim is None else (lambda x: x.sum(dim=dim))
    if mask is None:
        s = total(t)
        return batch_sum(s) / (t.numel() // max(s.numel(), 1) * bg.size)
    maskf = mask.broadcast_to(t.shape).to(t.dtype)
    return batch_sum(total(t * maskf)) / batch_sum(total(maskf)).clamp_min(1.0)


class _AllGather(torch.autograd.Function):
    """The ranks' t concatenated along `dim` in rank order. Every rank
    computes the same loss of the whole, so the gradient of this rank's
    part is the sum of the ranks' gradients of it (as `batch_sum`'s)."""

    @staticmethod
    def forward(ctx, t, dim, bg):
        ctx.dim, ctx.bg, ctx.n = dim, bg, t.shape[dim]
        parts = [torch.empty_like(t) for _ in range(bg.size)]
        dist.all_gather(parts, t.contiguous(), group=bg.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.bg.group)
        return grad.narrow(ctx.dim, ctx.bg.rank * ctx.n, ctx.n), None, None


def batch_gather(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The global batch of t, whose `dim` holds this rank's rows: the
    ranks' t concatenated along it in rank order, differentiably; t itself
    outside `batch_parallel`. For a loss that is not a sum over the rows
    (a quantile, a sample of rows)."""
    bg = batch_group()
    return t if bg is None else _AllGather.apply(t, dim, bg)


def batch_span(b: int) -> tuple[int, int]:
    """(the global index of this rank's first row, the global batch's
    rows) for a rank that holds b rows; (0, b) outside `batch_parallel`."""
    bg = batch_group()
    return (0, b) if bg is None else (bg.rank * b, bg.size * b)


def local_rows(make, shape) -> torch.Tensor:
    """`make(shape)`, a draw whose dim 0 is the batch: inside
    `batch_parallel` it is made at the global batch and this rank's rows
    are taken, so that the ranks together draw what one process draws."""
    shape = tuple(shape)
    if not shape:
        return make(shape)
    start, total = batch_span(shape[0])
    return make((total, *shape[1:]))[start:start + shape[0]]


def average_gradients(params, mesh: DeviceMesh) -> None:
    """Each parameter's gradient averaged over the ranks of `data`, in one
    flat all-reduce; a missing gradient counts as zeros (the counterpart
    has one for every parameter)."""
    params = list(params)
    if not params:
        return
    sub = _data_submesh(mesh)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])    # in the widest of their dtypes
    dist.all_reduce(flat, group=sub.get_group())
    flat /= sub.size()
    offset = 0
    for p, g in zip(params, grads):
        p.grad = flat[offset:offset + g.numel()].view_as(g).to(g.dtype)
        offset += g.numel()


def mean_over_data(t: torch.Tensor, mesh: DeviceMesh | None) -> torch.Tensor:
    """A rank's value (a loss, detached) averaged over the ranks of `data`."""
    if mesh is None:
        return t
    sub = _data_submesh(mesh)
    t = t.detach().clone()
    dist.all_reduce(t, group=sub.get_group())
    return t / sub.size()
