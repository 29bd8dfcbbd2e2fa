"""Checkpoint / resume (counterpart of `dreamer4_tpu/train/checkpoint.py`).

A model checkpoint is a directory:
  config.json  — the model's class, its constructor arguments (tagged so
                 that tuples, dicts and torch dtypes round-trip exactly) and
                 free-form `extra` metadata
  weights.pt   — the state_dict, saved with `torch.save`
A train-state checkpoint adds `train_meta.json` and `train_state.pt` (model
state_dict, optimizer state_dict, EMA weights, step).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Type

import torch

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


def save_model(path: str | Path, module, state_dict: dict | None = None,
               extra: dict | None = None):
    """`module.config` and `state_dict` (default: the module's own) into
    the directory `path`."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    meta = dict(module_class=type(module).__name__, config=encode_config(module.config),
                extra=extra or {})
    (path / 'config.json').write_text(json.dumps(meta, indent=2))
    weights = module.state_dict() if state_dict is None else state_dict
    torch.save({k: v.detach().cpu() for k, v in weights.items()}, path / 'weights.pt')


def load_model(path: str | Path, module_class: Type, device=None):
    """Rebuild the module from a checkpoint directory and load its weights,
    on `device` (CUDA unless 'cpu' is asked for, as every entry point)."""
    path = Path(path).absolute()
    module = module_class(**decode_config(load_config(path)), device=device)
    module.load_state_dict(torch.load(path / 'weights.pt', map_location=module.device))
    return module


# ------------------------------------------------------- train-state resume

def save_train_state(path: str | Path, ts, extra: dict | None = None):
    """A trainer's whole TrainState (weights, optimizer state, EMA weights,
    step) for exact resumption."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    (path / 'train_meta.json').write_text(json.dumps(
        dict(step=ts.step, has_ema=ts.ema_params is not None, extra=extra or {}), indent=2))
    torch.save(dict(params=ts.model.state_dict(), opt_state=ts.optimizer.state_dict(),
                    ema_params=ts.ema_params, step=ts.step), path / 'train_state.pt')


def load_train_state(path: str | Path, ts):
    """Restore into `ts` (a TrainState of the same model and optimizer) in
    place. Returns (TrainState, the checkpoint's extra metadata)."""
    path = Path(path).absolute()
    meta = json.loads((path / 'train_meta.json').read_text())
    tree = torch.load(path / 'train_state.pt', map_location=ts.model.device)
    ts.model.load_state_dict(tree['params'])
    ts.optimizer.load_state_dict(tree['opt_state'])
    ema = ts.ema_params
    if meta['has_ema']:
        if ema is None:
            raise ValueError('the checkpoint has EMA weights and the train state has none')
        with torch.no_grad():
            for name, e in ema.items():
                e.copy_(tree['ema_params'][name])
    return ts._replace(step=int(tree['step'])), meta.get('extra', {})
