"""Multi-tensor kernels of the optimizer step (`csrc/multi_tensor_optim.cu`):
each phase of `MuonAdamAtan2.step` over all of its parameters in one launch,
the counterpart of PyTorch's own `multi_tensor_apply`, written for this repo.

`clip_scale`, `adam_atan2`, `muon_prepare` and `muon_apply` take lists of
CUDA tensors, check them, and hand the kernels a table of their pointers
and sizes in host memory. The tables travel in the launches' own arguments
(a launch holds up to 60-200 tensors, so a longer list takes a few), so no
table is copied to the device and nothing synchronizes: the gradients are
new tensors each step, and the state may be replaced by `load_state_dict`,
so the pointers are read anew at each call. The plain version of the whole
step is the optimizer's own loop (`MuonAdamAtan2` on CPU tensors); nothing
here runs on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

# kernel launches since the last reset, all phases
KERNEL_LAUNCHES = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    'multi_tensor_optim_config': [_P, _P],
    'multi_tensor_clip_scale': [_P, _I, _P, _P, _F, _P],
    'multi_tensor_adam_atan2': [_P, _I, _P] + [_F] * 9 + [_P],
    'multi_tensor_muon_prepare': [_P, _I, _P, _P, _F, _F, _F, _P],
    'multi_tensor_muon_apply': [_P, _P, _I, _P],
}
_INT_MAX = 2 ** 31 - 1


@functools.cache
def _lib():
    from .cuda_build import load
    lib = load('multi_tensor_optim')
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


@functools.cache
def config() -> tuple[int, int]:
    """(elements a block of the 1-D kernels takes, rows and columns of a
    Muon tile), as the kernels are built."""
    chunk, tile = ctypes.c_int(), ctypes.c_int()
    _lib().multi_tensor_optim_config(ctypes.byref(chunk), ctypes.byref(tile))
    return chunk.value, tile.value


def clip_partials_len(numels: list[int]) -> int:
    """The floats `clip_scale` needs for tensors of these sizes."""
    chunk, _ = config()
    return sum(-(-n // chunk) for n in numels)


def muon_partials_len(shapes: list[tuple[int, int]]) -> int:
    """The floats `muon_prepare` needs for matrices of these shapes."""
    _, tile = config()
    return sum(-(-r // tile) * -(-c // tile) for r, c in shapes)


def _ptr(t: torch.Tensor, device: torch.device, dtype=torch.float32, like=None) -> int:
    """t's address, after the checks the kernels rely on: the device, the
    dtype, contiguity and, given `like`, its shape (the kernels size every
    tensor of a row by its parameter; a loaded state is not checked
    elsewhere)."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f'the optimizer kernels take contiguous {dtype} tensors on {device}; '
                         f'got {t.dtype} on {t.device}, contiguous {t.is_contiguous()}')
    if like is not None and t.shape != like.shape:
        raise ValueError(f'a tensor of shape {tuple(t.shape)} beside a parameter of shape '
                         f'{tuple(like.shape)}')
    return t.data_ptr()


def _grad_ptr(g: torch.Tensor | None, device) -> int:
    """0 (a null pointer) for a missing gradient, which counts as zero.
    (torch gives a parameter's gradient the parameter's shape.)"""
    return 0 if g is None else _ptr(g, device)


def _numel(p: torch.Tensor) -> int:
    n = p.numel()
    if n > _INT_MAX:
        raise ValueError(f'a tensor of {n} elements is over the kernels\' int range')
    return n


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _count(launches: int, name: str) -> None:
    global KERNEL_LAUNCHES
    if launches < 0:
        raise RuntimeError(f'{name} launch failed with CUDA error {-launches}')
    KERNEL_LAUNCHES += launches


def _table(rows: list[tuple]) -> np.ndarray:
    return np.array(rows, dtype=np.int64).reshape(len(rows), -1)


def clip_scale(params: list[torch.Tensor], grads: list[torch.Tensor | None], max_norm: float,
               partials: torch.Tensor, scale: torch.Tensor) -> None:
    """scale <- min(1, max_norm / max(||grads||, 1e-16)), the float32 norm
    over every gradient (a missing one counts as zero), in one fixed order.
    `partials`: `clip_partials_len` floats of scratch."""
    device = scale.device
    table = _table([(_grad_ptr(g, device), _numel(p)) for p, g in zip(params, grads)])
    if partials.numel() < clip_partials_len([int(r[1]) for r in table]):
        raise ValueError('clip_scale: partials too short')
    _count(_lib().multi_tensor_clip_scale(
        table.ctypes.data, len(table), _ptr(partials, device), _ptr(scale, device),
        float(max_norm), _stream(device)), 'multi_tensor_clip_scale')


def adam_atan2(params, grads, mus, nus, scale: torch.Tensor | None, *, weight_decay: float,
               b1: float, b2: float, c1: float, c2: float, b: float, lr_a: float) -> None:
    """In place, per element: g <- g * scale (if a scale is given), g <- g +
    weight_decay * p (if it is above 0), mu <- b1 mu + (1 - b1) g, nu <- b2 nu
    + (1 - b2) g^2, p <- p - lr_a * atan2(mu / c1, b * sqrt(nu / c2)); every
    scalar rounded to float32 as torch rounds a Python number."""
    device = params[0].device
    table = _table([(_ptr(p, device), _grad_ptr(g, device), _ptr(m, device, like=p),
                     _ptr(v, device, like=p), _numel(p))
                    for p, g, m, v in zip(params, grads, mus, nus)])
    _count(_lib().multi_tensor_adam_atan2(
        table.ctypes.data, len(table), None if scale is None else _ptr(scale, device),
        weight_decay, b1, 1.0 - b1, b2, 1.0 - b2, c1, c2, b, -lr_a, _stream(device)),
        'multi_tensor_adam_atan2')


def muon_prepare(params, grads, moms, places: list[torch.Tensor], inputs: list[torch.Tensor],
                 flips: list[bool], scale: torch.Tensor | None, partials: torch.Tensor, *,
                 weight_decay: float, momentum: float, eps: float) -> None:
    """Muon's momentum and Newton-Schulz input, in place: g as in
    `adam_atan2`, m <- momentum m + g, u = momentum m + g written to `places`
    (float32, each the parameter's shape or, where `flips` says so, its
    transpose), then `inputs` (bf16, the same shapes) <- u / (||u|| + eps).
    `partials`: `muon_partials_len` floats of scratch."""
    device = params[0].device
    rows = []
    for p, g, m, u, x, flip in zip(params, grads, moms, places, inputs, flips):
        if p.ndim != 2 or u.shape != (p.shape[::-1] if flip else p.shape) or x.shape != u.shape:
            raise ValueError(f'muon_prepare: a {tuple(p.shape)} parameter, flip {flip}, takes '
                             f'places of its shape; got {tuple(u.shape)}, {tuple(x.shape)}')
        _numel(p)
        rows.append((_ptr(p, device), _grad_ptr(g, device), _ptr(m, device, like=p),
                     _ptr(u, device), _ptr(x, device, torch.bfloat16), p.shape[0], p.shape[1],
                     int(flip)))
    if partials.numel() < muon_partials_len([tuple(p.shape) for p in params]):
        raise ValueError('muon_prepare: partials too short')
    table = _table(rows)
    _count(_lib().multi_tensor_muon_prepare(
        table.ctypes.data, len(table), None if scale is None else _ptr(scale, device),
        _ptr(partials, device), weight_decay, momentum, eps, _stream(device)),
        'multi_tensor_muon_prepare')


def muon_apply(params, outputs: list[torch.Tensor], flips: list[bool], coefs: list[float]) -> None:
    """p <- p + coef * o, in place: o from `outputs` (bf16, each the
    parameter's shape or, where `flips` says so, its transpose)."""
    device = params[0].device
    rows = []
    for p, o, flip in zip(params, outputs, flips):
        if p.ndim != 2 or o.shape != (p.shape[::-1] if flip else p.shape):
            raise ValueError(f'muon_apply: a {tuple(p.shape)} parameter, flip {flip}, takes an '
                             f'output of its shape; got {tuple(o.shape)}')
        _numel(p)
        rows.append((_ptr(p, device), _ptr(o, device, torch.bfloat16), p.shape[0], p.shape[1],
                     int(flip)))
    table = _table(rows)
    coef_table = np.asarray(coefs, dtype=np.float32)
    _count(_lib().multi_tensor_muon_apply(table.ctypes.data, coef_table.ctypes.data, len(table),
                                          _stream(device)), 'multi_tensor_muon_apply')
