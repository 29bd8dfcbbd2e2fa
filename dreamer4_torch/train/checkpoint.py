"""Checkpoint / resume (counterpart of `dreamer4_tpu/train/checkpoint.py`).

A model checkpoint is a directory:
  config.json  — the model's class, its constructor arguments (tagged so
                 that tuples, dicts and torch dtypes round-trip exactly) and
                 free-form `extra` metadata
  weights.pt   — the state_dict, saved with `torch.save`
A train-state checkpoint adds `train_meta.json` and `train_state.pt` (model
state_dict, optimizer state_dict, EMA weights, step, and the state_dicts
of the modules trained beside the model, by their prefix).

Under a process group every rank calls these functions. A module sharded
over a mesh (`parallel.mesh.shard_params`) saves whole tensors, gathered
from the shards (its optimizer state too), which the first rank writes, in
the same format as one process. A checkpoint loads at any rank count: the
whole tensors are read, and a sharded module (a `mesh` given to
`load_model`, or the train state's own placements) keeps its shards of them
(the counterpart restores across device layouts the same way).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Type

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..parallel.mesh import local, shard_of, shard_params, whole, whole_of_shard

# dtypes that may appear in model configs, keyed by canonical name
_DTYPES = {name: getattr(torch, name)
           for name in ('bfloat16', 'float16', 'float32', 'float64', 'int8', 'int16', 'int32',
                        'int64', 'uint8', 'bool')}


def _encode(value):
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, tuple):
        return {'__kind__': 'tuple', 'items': [_encode(v) for v in value]}
    if isinstance(value, list):
        return {'__kind__': 'list', 'items': [_encode(v) for v in value]}
    if isinstance(value, dict):
        return {'__kind__': 'dict', 'items': {str(k): _encode(v) for k, v in value.items()}}
    if isinstance(value, torch.dtype):
        return {'__kind__': 'dtype', 'name': str(value).removeprefix('torch.')}
    raise TypeError(f'cannot serialize config value {value!r} of type {type(value)}; '
                    'add a tagged encoding for it in train/checkpoint.py')


def _decode(value):
    if isinstance(value, dict) and '__kind__' in value:
        kind = value['__kind__']
        if kind == 'tuple':
            return tuple(_decode(v) for v in value['items'])
        if kind == 'list':
            return [_decode(v) for v in value['items']]
        if kind == 'dict':
            return {k: _decode(v) for k, v in value['items'].items()}
        if kind == 'dtype':
            return _DTYPES[value['name']]
        raise ValueError(f'unknown config tag {kind!r}')
    return value


def encode_config(config: dict) -> dict:
    return {k: _encode(v) for k, v in config.items()}


def decode_config(meta: dict) -> dict:
    """Decode the tagged `config` section of a checkpoint's config.json."""
    return {k: _decode(v) for k, v in meta['config'].items()}


def load_config(path: str | Path) -> dict:
    return json.loads((Path(path) / 'config.json').read_text())


def _writes() -> bool:
    """Whether this process writes: the first rank, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _written():
    """Every rank waits until the first has written."""
    if dist.is_initialized():
        dist.barrier()


def load_whole_state_dict(module: torch.nn.Module, state_dict: dict):
    """`module.load_state_dict` from whole tensors: a DTensor parameter
    keeps its shard of the whole one."""
    sharded = {n: p for n, p in module.named_parameters() if isinstance(p, DTensor)}
    if not sharded:
        module.load_state_dict(state_dict)
        return
    with torch.no_grad():
        for name, p in sharded.items():
            p.to_local().copy_(shard_of(state_dict[name].to(p.dtype), p))
    missing, unexpected = module.load_state_dict(
        {k: v for k, v in state_dict.items() if k not in sharded}, strict=False)
    if set(missing) - set(sharded) or unexpected:
        raise KeyError(f'state dict mismatch: missing {sorted(set(missing) - set(sharded))}, '
                       f'unexpected {sorted(unexpected)}')


def save_model(path: str | Path, module, state_dict: dict | None = None,
               extra: dict | None = None):
    """`module.config` and `state_dict` (default: the module's own) into
    the directory `path`."""
    path = Path(path).absolute()
    weights = module.state_dict() if state_dict is None else state_dict
    weights = {k: whole(v).detach().cpu() for k, v in weights.items()}
    if _writes():
        path.mkdir(parents=True, exist_ok=True)
        meta = dict(module_class=type(module).__name__, config=encode_config(module.config),
                    extra=extra or {})
        (path / 'config.json').write_text(json.dumps(meta, indent=2))
        torch.save(weights, path / 'weights.pt')
    _written()


def load_model(path: str | Path, module_class: Type, device=None, mesh=None):
    """Rebuild the module from a checkpoint directory and load its weights,
    on `device` (CUDA unless 'cpu' is asked for, as every entry point);
    with a `mesh`, sharded over it (`parallel.mesh.shard_params`)."""
    path = Path(path).absolute()
    module = module_class(**decode_config(load_config(path)), device=device)
    module.load_state_dict(torch.load(path / 'weights.pt', map_location=module.device))
    if mesh is not None:
        shard_params(module, mesh)
    return module


# ------------------------------------------------------- train-state resume

def save_train_state(path: str | Path, ts, extra: dict | None = None):
    """A trainer's whole TrainState (weights, optimizer state, EMA weights,
    step) for exact resumption."""
    path = Path(path).absolute()
    gathered = lambda sd: {k: whole(v).detach().cpu() for k, v in sd.items()}
    others = {prefix: gathered(m.state_dict()) for prefix, m in ts.modules().items() if prefix}
    tree = dict(params=gathered(ts.model.state_dict()),
                opt_state=_whole_optimizer_state(ts.optimizer),
                ema_params=None if ts.ema_params is None else gathered(ts.ema_params),
                step=ts.step, modules=others)
    if _writes():
        path.mkdir(parents=True, exist_ok=True)
        (path / 'train_meta.json').write_text(json.dumps(
            dict(step=ts.step, has_ema=ts.ema_params is not None, extra=extra or {}), indent=2))
        torch.save(tree, path / 'train_state.pt')
    _written()


def _sharded_params(optimizer) -> list:
    """(parameter, its index in the state dict) of each DTensor parameter
    of the optimizer (or of the one a `MultiSteps` wraps)."""
    inner = getattr(optimizer, 'optimizer', optimizer)
    params = [p for g in inner.param_groups for p in g['params']]
    return [(p, i) for i, p in enumerate(params) if isinstance(p, DTensor)]


def _whole_optimizer_state(optimizer) -> dict:
    """The optimizer's state dict with each DTensor parameter's shard of
    state gathered whole."""
    state = optimizer.state_dict()
    sharded = _sharded_params(optimizer)
    if not sharded:
        return state
    inner = state.get('inner', state)
    for p, i in sharded:
        # state_dict() hands out the live per-parameter dicts: copy first
        inner['state'][i] = dict(inner['state'].get(i, {}))
        for name, t in inner['state'][i].items():
            if isinstance(t, torch.Tensor) and t.shape == p.to_local().shape and t.ndim:
                inner['state'][i][name] = whole_of_shard(t, p)
    return state


def _shard_optimizer_state(optimizer):
    """After loading whole state: each DTensor parameter keeps its shard."""
    inner = getattr(optimizer, 'optimizer', optimizer)
    for p, _ in _sharded_params(optimizer):
        for name, t in inner.state.get(p, {}).items():
            if isinstance(t, torch.Tensor) and t.shape == p.shape and t.ndim:
                inner.state[p][name] = shard_of(t.to(p.to_local().device), p)


def load_train_state(path: str | Path, ts):
    """Restore into `ts` (a TrainState of the same model and optimizer) in
    place. Returns (TrainState, the checkpoint's extra metadata)."""
    path = Path(path).absolute()
    meta = json.loads((path / 'train_meta.json').read_text())
    tree = torch.load(path / 'train_state.pt', map_location=ts.model.device)
    load_whole_state_dict(ts.model, tree['params'])
    others = {prefix: m for prefix, m in ts.modules().items() if prefix}
    if set(others) != set(tree.get('modules', {})):
        raise ValueError(f'the checkpoint trains modules {sorted(tree.get("modules", {}))} '
                         f'beside the model, the train state {sorted(others)}')
    for prefix, module in others.items():
        load_whole_state_dict(module, tree['modules'][prefix])
    ts.optimizer.load_state_dict(tree['opt_state'])
    _shard_optimizer_state(ts.optimizer)
    ema = ts.ema_params
    if meta['has_ema']:
        if ema is None:
            raise ValueError('the checkpoint has EMA weights and the train state has none')
        with torch.no_grad():
            for name, e in ema.items():
                saved = tree['ema_params'][name]
                local(e).copy_(shard_of(saved, e) if isinstance(e, DTensor) else saved)
    return ts._replace(step=int(tree['step'])), meta.get('extra', {})
