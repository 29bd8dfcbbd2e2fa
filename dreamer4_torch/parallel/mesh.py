"""Device mesh and sharding rules (counterpart of
`dreamer4_tpu/parallel/mesh.py`).

A (data, model) `DeviceMesh`: batches split over `data`, large weights over
`model`. The placements are DTensors (`distribute_tensor`): `shard_params`
turns a module's parameters into DTensors laid out by
`param_sharding_rule`, so between steps each rank keeps its shards only.
The hand-written kernels take plain tensors, so a sharded module computes
inside `unsharded`, which gathers each weight whole for the duration and
hands the gradients back as shards. The optimizer (`MuonAdamAtan2`) updates
the shards; it gathers a weight whole only to orthogonalize it.

DTensor over FSDP2's `fully_shard`: FSDP2 shards every parameter of the
modules it wraps (a small weight cannot stay replicated, as the rule wants),
and it gathers and reduces from hooks on a module's forward, which the RL
losses' direct calls of the heads and the attention pools' direct reads of
their raw kernels never run.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from .distributed import (DATA_AXIS, MODEL_AXIS, average_gradients, batch_parallel,
                          create_global_mesh, map_tensors, placements_of)


def create_mesh(num_data: int | None = None, num_model: int = 1) -> DeviceMesh:
    """A (data, model) mesh over every rank of the initialized group;
    `num_data=None` takes the ranks `num_model` leaves."""
    return create_global_mesh(data=-1 if num_data is None else num_data, model=num_model)


def flax_layouts(module: nn.Module) -> dict[str, tuple[int, ...]]:
    """The parameters whose torch layout permutes flax's (see convert.py):
    name -> for each torch dim, the flax dim it holds. `nn.Linear` weights
    are (out, in) for flax's (in, out); `nn.Conv2d` weights OIHW for HWIO."""
    layouts = {}
    for name, mod in module.named_modules():
        prefix = f'{name}.' if name else ''
        if isinstance(mod, nn.Linear):
            layouts[prefix + 'weight'] = (1, 0)
        elif isinstance(mod, nn.Conv2d):
            layouts[prefix + 'weight'] = (3, 2, 0, 1)
    return layouts


def param_sharding_rule(name: str, param: torch.Tensor, mesh: DeviceMesh,
                        layout: tuple[int, ...] | None = None) -> tuple:
    """The counterpart's FSDP-style rule on `param` seen in flax's layout
    (`layout`, from `flax_layouts`): a weight of 2 or more dims and at least
    2^16 elements is split over `model` along the last flax dim that the
    axis divides; every other weight is replicated. Returns the DTensor
    placements, one per mesh dim."""
    placements = [Replicate()] * mesh.ndim
    names = mesh.mesh_dim_names or ()
    if MODEL_AXIS not in names:
        return tuple(placements)
    model_size = mesh.size(names.index(MODEL_AXIS))
    layout = layout or tuple(range(param.ndim))
    flax_shape = [0] * param.ndim
    for torch_dim, flax_dim in enumerate(layout):
        flax_shape[flax_dim] = param.shape[torch_dim]
    if model_size > 1 and param.ndim >= 2 and param.numel() >= 2 ** 16:
        for axis in reversed(range(param.ndim)):
            if flax_shape[axis] % model_size == 0:
                placements[names.index(MODEL_AXIS)] = Shard(layout.index(axis))
                break
    return tuple(placements)


def shard_params(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Turns every parameter of `module` into a DTensor laid out by
    `param_sharding_rule`, in place: each rank keeps its shard (taken from
    its own whole copy, which every rank must hold alike). Returns module."""
    layouts = flax_layouts(module)
    with torch.no_grad():
        for name, param in list(module.named_parameters()):
            owner, _, leaf = name.rpartition('.')
            sub = module.get_submodule(owner)
            placements = param_sharding_rule(name, param, mesh, layouts.get(name))
            sharded = distribute_tensor(param.detach(), mesh, placements, src_data_rank=None)
            sub._parameters[leaf] = nn.Parameter(sharded, requires_grad=param.requires_grad)
    return module


def shard_batch(batch: Any, mesh: DeviceMesh) -> Any:
    """A global batch that every rank holds alike, as DTensors split over
    `data` along dim 0 (each rank keeps its rows); None leaves stay None."""
    placements = placements_of(mesh, (DATA_AXIS,))
    return map_tensors(lambda x: distribute_tensor(torch.as_tensor(x), mesh, placements,
                                                   src_data_rank=None), batch)


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """Every tensor of `tree` replicated over the mesh, as the first rank
    holds it (broadcast from there)."""
    placements = [Replicate()] * mesh.ndim
    return map_tensors(lambda x: distribute_tensor(torch.as_tensor(x), mesh, placements), tree)


def local(x):
    """The rank's part of a DTensor (a batch's rows, a weight's shard; in
    place updates of it reach the DTensor); anything else as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def whole(x):
    """A DTensor gathered whole from its shards; anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def whole_of_shard(shard: torch.Tensor, like: DTensor) -> torch.Tensor:
    """`shard`, laid out as this rank's shard of `like` (a parameter's
    optimizer state), gathered whole."""
    return DTensor.from_local(shard, like.device_mesh, like.placements, shape=like.shape,
                              stride=like.stride()).full_tensor()


def shard_of(t: torch.Tensor, like: DTensor) -> torch.Tensor:
    """This rank's shard of the whole tensor `t`, laid out as `like`."""
    return distribute_tensor(t, like.device_mesh, like.placements,
                             src_data_rank=None).to_local()


def local_batch(batch: Any) -> Any:
    """A batch with each DTensor leaf replaced by the rank's rows."""
    return map_tensors(local, batch)


@contextlib.contextmanager
def unsharded(modules: nn.Module | dict[str, nn.Module]):
    """Inside, each DTensor parameter of `modules` is a plain leaf holding
    the whole weight (gathered over the mesh); on leaving, each DTensor
    parameter's gradient becomes the shard of the whole one's, and the
    DTensors return. Yields the parameters the modules hold inside."""
    mods = modules.values() if isinstance(modules, dict) else [modules]
    swapped = []   # (owner module, leaf name, DTensor parameter, whole parameter)
    for module in mods:
        for sub in module.modules():
            for leaf, p in list(sub._parameters.items()):
                if isinstance(p, DTensor):
                    whole = nn.Parameter(p.detach().full_tensor(), requires_grad=p.requires_grad)
                    sub._parameters[leaf] = whole
                    swapped.append((sub, leaf, p, whole))
    try:
        yield [p for m in mods for p in m.parameters()]
    finally:
        for sub, leaf, p, whole in swapped:
            sub._parameters[leaf] = p
            if whole.grad is not None:
                p.grad = distribute_tensor(whole.grad, p.device_mesh, p.placements,
                                           src_data_rank=None)


@contextlib.contextmanager
def data_parallel(modules: nn.Module | dict[str, nn.Module], mesh: DeviceMesh | None,
                  trained=None):
    """A trainer's forward and backward of the rank's rows: inside
    `batch_parallel` and `unsharded`; leaving without an error averages the
    gradients over `data`, of the parameters `trained` (default: all the
    modules hold). A no-op without a mesh."""
    if mesh is None:
        yield
        return
    with batch_parallel(mesh), unsharded(modules) as params:
        yield
        average_gradients(params if trained is None else trained, mesh)


def model_axis_size(mesh: DeviceMesh | None) -> int:
    names = (mesh.mesh_dim_names or ()) if mesh is not None else ()
    return mesh.size(names.index(MODEL_AXIS)) if MODEL_AXIS in names else 1


_MESH: contextvars.ContextVar[DeviceMesh | None] = contextvars.ContextVar('mesh', default=None)


@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh):
    """The ambient mesh (the counterpart's `jax.set_mesh`): a trunk built
    with `time_ring_axis` finds the ring's process group in it by name."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> DeviceMesh | None:
    return _MESH.get()


def axis_group(axis: str) -> dist.ProcessGroup:
    """The process group of the ambient mesh's axis `axis`."""
    mesh = current_mesh()
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        raise RuntimeError(f'mesh axis {axis!r} needs an ambient mesh that has it '
                           '(parallel.mesh.set_mesh)')
    return mesh.get_group(axis)
