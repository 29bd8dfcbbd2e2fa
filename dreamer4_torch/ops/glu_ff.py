"""The GLU feedforward's elementwise parts as CUDA kernels
(`csrc/glu_ff.cu`), around its projections as aligned cuBLAS products.

`glu_feedforward(x, w_in, b_in, w_out, b_out, activation, dtype)` computes
`nn.attention.FeedForward`'s GLU after its norm,

    x_h, g = (x W_in^T + b_in).chunk(2)          (M, f) each
    y      = (x_h act(g)) W_out^T + b_out          (M, d)

in the compute dtype `dtype`, with the hidden kept in rows padded to P =
round_up(f, 8) elements (`padded_width`): every row of every operand of the
six matrix products is then a multiple of 16 bytes, which cuBLAS's Hopper
kernels need. A call packs the parameters (float32 or bf16) into zero-padded
compute-dtype copies in one launch, W_in_p (2P, d) with the value half in
rows [0, f) and the gate half in [P, P + f), b_in_p (2P), W_out_p (d, P) and
b_out; then h = addmm(b_in_p, x, W_in_p^T) (M, 2P), a = glu_fwd(h) (M, P),
y = addmm(b_out, a, W_out_p^T). The backward: dA = dy W_out_p, dh =
glu_bwd(dA, h) (M, 2P), dx = dh W_in_p, the padded weight gradients dh^T x
and dy^T a and the bias sums (float32), and one launch that unpacks them into
the parameters' shapes and dtype. Every pad holds exact zeros, so the padded
products compute the unpadded ones; the activation (silu or tanh gelu) is
computed in float32 and each kernel output rounded once.

The op takes CUDA tensors in float32 or bf16 and raises on anything else;
`FeedForward` sends every CUDA call of a GLU to it and keeps its plain code
for the CPU. `pack_reference`, `glu_fwd_reference`, `glu_bwd_reference` and
`unpack_reference` write the four kernels in plain torch (the same
signatures as the launchers `_pack`, `_glu_fwd`, `_glu_bwd`, `_unpack`); the
CPU tests run the op's autograd function on them against autograd of the
plain code.
"""
from __future__ import annotations

import ctypes
import functools

import torch

# kernel launches since the last reset, one a call each
PACK_LAUNCHES = 0     # the parameters' padded copies
FWD_LAUNCHES = 0      # the GLU forward
BWD_LAUNCHES = 0      # the GLU backward
UNPACK_LAUNCHES = 0   # the parameters' gradients

ACTIVATIONS = {'silu': 0, 'gelu': 1}    # gelu: tanh-approximate, as nn.activations has it
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VEC = 8                                  # elements a kernel thread moves: 16 bytes in bf16


def padded_width(f: int) -> int:
    """P: the GLU width f rounded up to a multiple of 8."""
    return -(-f // VEC) * VEC


# ------------------------------------------------------- plain references

def _act(g, act: str):
    if act == 'silu':
        return g * torch.sigmoid(g)
    return 0.5 * g * (1.0 + torch.tanh(0.7978845608028654 * (g + 0.044715 * g ** 3)))


def _act_grad(g, act: str):
    if act == 'silu':
        s = torch.sigmoid(g)
        return s * (1.0 + g * (1.0 - s))
    k0, k1 = 0.7978845608028654, 0.044715
    t = torch.tanh(k0 * (g + k1 * g ** 3))
    return 0.5 * (1.0 + t) + 0.5 * g * (1.0 - t * t) * k0 * (1.0 + 3.0 * k1 * g * g)


def pack_reference(w_in, b_in, w_out, b_out, dtype, f: int, P: int):
    """`glu_ff_pack`: (W_in_p (2P, d), b_in_p (2P), W_out_p (d, P), b_out)
    in `dtype`, every pad zero."""
    d = w_in.shape[1]
    w_in_p = w_in.new_zeros((2 * P, d), dtype=dtype)
    b_in_p = b_in.new_zeros(2 * P, dtype=dtype)
    for half in (0, 1):
        w_in_p[half * P:half * P + f] = w_in[half * f:(half + 1) * f]
        b_in_p[half * P:half * P + f] = b_in[half * f:(half + 1) * f]
    w_out_p = w_out.new_zeros((w_out.shape[0], P), dtype=dtype)
    w_out_p[:, :f] = w_out
    return w_in_p, b_in_p, w_out_p, b_out.to(dtype)


def glu_fwd_reference(h, f: int, act: str):
    """`glu_ff_fwd`: a (M, P) from h (M, 2P), the activation in float32,
    exact zeros in columns f and beyond."""
    P = h.shape[1] // 2
    hf = h.float()
    a = hf[:, :P] * _act(hf[:, P:], act)
    a[:, f:] = 0
    return a.to(h.dtype)


def glu_bwd_reference(da, h, f: int, act: str):
    """`glu_ff_bwd`: dh (M, 2P) from dA (M, P) and h, exact zeros in every
    pad column."""
    P = h.shape[1] // 2
    hf, df = h.float(), da.float()
    x, g = hf[:, :P], hf[:, P:]
    dh = torch.cat([df * _act(g, act), df * x * _act_grad(g, act)], dim=1)
    dh[:, f:P] = 0
    dh[:, P + f:] = 0
    return dh.to(h.dtype)


def unpack_reference(dw_in_p, db_in_p, dw_out_p, db_out, f: int, dtype):
    """`glu_ff_unpack`: (dW_in (2f, d), db_in (2f), dW_out (d, f), db_out)
    in `dtype` from the padded gradients."""
    P = dw_out_p.shape[1]
    take = lambda t: torch.cat([t[:f], t[P:P + f]])
    return (take(dw_in_p).to(dtype), take(db_in_p).to(dtype), dw_out_p[:, :f].to(dtype),
            db_out.to(dtype))


# ------------------------------------------------------------------ the op

def glu_feedforward(x, w_in, b_in, w_out, b_out, activation: str, dtype):
    """The GLU feedforward (module docstring) of x (..., d) in `dtype`: the
    same shape, in `dtype`. Differentiable in x and the four parameters."""
    if activation not in ACTIVATIONS:
        raise ValueError(f'the GLU kernels take the activations {list(ACTIVATIONS)}, '
                         f'not {activation!r}')
    if dtype not in _DTYPE_CODES:
        raise ValueError(f'the GLU kernels compute in float32 or bfloat16, not {dtype}')
    params = (w_in, b_in, w_out, b_out)
    if not x.is_cuda or not all(p.is_cuda for p in params):
        raise ValueError('glu_feedforward takes CUDA tensors; the CPU runs '
                         '`nn.attention.FeedForward`\'s plain code')
    if len({p.dtype for p in params}) != 1 or w_in.dtype not in _DTYPE_CODES:
        raise ValueError(f'the GLU kernels take float32 or bfloat16 parameters of one dtype; '
                         f'got {[p.dtype for p in params]}')
    d = x.shape[-1]
    f = w_out.shape[1]
    if w_in.shape != (2 * f, d) or b_in.shape != (2 * f,) or w_out.shape[0] != d \
            or b_out.shape != (d,):
        raise ValueError(f'parameters {[tuple(p.shape) for p in params]} do not make a GLU '
                         f'feedforward of width {d}')
    x2 = x.to(dtype).reshape(-1, d)
    if torch.is_grad_enabled() and (x2.requires_grad or any(p.requires_grad for p in params)):
        y = _GluFeedForward.apply(x2, w_in, b_in, w_out, b_out, activation, dtype)
    else:
        y = _forward(x2.contiguous(), params, activation, dtype)[0]
    return y.reshape(*x.shape[:-1], w_out.shape[0])


def _forward(x2, params, act: str, dtype):
    f = params[2].shape[1]
    P = padded_width(f)
    w_in_p, b_in_p, w_out_p, b_out = _pack(*params, dtype, f, P)
    h = torch.addmm(b_in_p, x2, w_in_p.t())
    a = _glu_fwd(h, f, act)
    y = torch.addmm(b_out, a, w_out_p.t())
    return y, h, a, w_in_p, w_out_p


class _GluFeedForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w_in, b_in, w_out, b_out, act, dtype):
        x2 = x2.contiguous()
        y, h, a, w_in_p, w_out_p = _forward(x2, (w_in, b_in, w_out, b_out), act, dtype)
        ctx.save_for_backward(x2, h, a, w_in_p, w_out_p)
        ctx.act, ctx.f, ctx.param_dtype = act, w_out.shape[1], w_in.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, h, a, w_in_p, w_out_p = ctx.saved_tensors
        dy = dy.to(x2.dtype).contiguous()
        dh = _glu_bwd(dy @ w_out_p, h, ctx.f, ctx.act)
        dx = dh @ w_in_p if ctx.needs_input_grad[0] else None
        grads = (None,) * 4
        if any(ctx.needs_input_grad[1:5]):
            grads = _unpack(dh.t() @ x2, dh.sum(0, dtype=torch.float32), dy.t() @ a,
                            dy.sum(0, dtype=torch.float32), ctx.f, ctx.param_dtype)
            grads = tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad[1:5]))
        return dx, *grads, None, None


# ------------------------------------------------------------------ CUDA

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    'glu_ff_forward': [_P, _P, _L, _I, _I, _I, _I, _P],
    'glu_ff_backward': [_P, _P, _P, _L, _I, _I, _I, _I, _P],
    'glu_ff_pack_weights': [_P] * 8 + [_I] * 5 + [_P],
    'glu_ff_unpack_grads': [_P] * 8 + [_I] * 5 + [_P],
}


@functools.cache
def _lib():
    from .cuda_build import load
    lib = load('glu_ff')
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def _check_cuda(named: dict, dtype, device, vectors: bool = True):
    """Contiguous `dtype` tensors on `device`, and 16-byte aligned where the
    kernel moves them as vectors (the GLU's; the pack and unpack move single
    elements)."""
    for name, t in named.items():
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f'{name}: the GLU kernels take contiguous {dtype} tensors on '
                             f'{device}; got {t.dtype} on {t.device}, contiguous '
                             f'{t.is_contiguous()}')
        if vectors and t.data_ptr() % 16 != 0:
            raise ValueError(f'{name} must be 16-byte aligned')
    if dtype not in _DTYPE_CODES:
        raise ValueError(f'the GLU kernels take float32 or bfloat16, not {dtype}')


def _empty(shape: tuple, dtype, device):
    """The launchers' outputs, uninitialized (every element is written)."""
    return torch.empty(shape, dtype=dtype, device=device)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f'{name} failed with {"an unsupported argument" if err < 0 else f"CUDA error {err}"}')


def _pack(w_in, b_in, w_out, b_out, dtype, f: int, P: int):
    """`glu_ff_pack` (`pack_reference`'s result), one launch."""
    global PACK_LAUNCHES
    src = w_in.dtype
    named = dict(w_in=w_in, b_in=b_in, w_out=w_out, b_out=b_out)
    named = {k: v.contiguous() for k, v in named.items()}     # parameters are: no copy
    _check_cuda(named, src, w_in.device, vectors=False)
    d = w_in.shape[1]
    kw = dict(dtype=dtype, device=w_in.device)
    out = (_empty((2 * P, d), **kw), _empty((2 * P,), **kw), _empty((d, P), **kw),
           _empty((d,), **kw))
    _raise_on(_lib().glu_ff_pack_weights(
        *(t.data_ptr() for t in named.values()), *(t.data_ptr() for t in out), d, f, P,
        _DTYPE_CODES[src], _DTYPE_CODES[dtype], _stream(w_in.device)), 'glu_ff_pack_weights')
    PACK_LAUNCHES += 1
    return out


def _glu_fwd(h, f: int, act: str):
    """`glu_ff_fwd` (`glu_fwd_reference`), one launch."""
    global FWD_LAUNCHES
    _check_cuda(dict(h=h), h.dtype, h.device)
    M, P = h.shape[0], h.shape[1] // 2
    a = _empty((M, P), h.dtype, h.device)
    _raise_on(_lib().glu_ff_forward(h.data_ptr(), a.data_ptr(), M, P, f, _DTYPE_CODES[h.dtype],
                                    ACTIVATIONS[act], _stream(h.device)), 'glu_ff_forward')
    FWD_LAUNCHES += 1
    return a


def _glu_bwd(da, h, f: int, act: str):
    """`glu_ff_bwd` (`glu_bwd_reference`), one launch."""
    global BWD_LAUNCHES
    _check_cuda(dict(da=da, h=h), h.dtype, h.device)
    M, P = h.shape[0], h.shape[1] // 2
    if da.shape != (M, P):
        raise ValueError(f'dA {tuple(da.shape)} for h {tuple(h.shape)}')
    dh = _empty(h.shape, h.dtype, h.device)
    _raise_on(_lib().glu_ff_backward(da.data_ptr(), h.data_ptr(), dh.data_ptr(), M, P, f,
                                     _DTYPE_CODES[h.dtype], ACTIVATIONS[act], _stream(h.device)),
              'glu_ff_backward')
    BWD_LAUNCHES += 1
    return dh


def _unpack(dw_in_p, db_in_p, dw_out_p, db_out, f: int, dtype):
    """`glu_ff_unpack` (`unpack_reference`), one launch."""
    global UNPACK_LAUNCHES
    dev = dw_in_p.device
    _check_cuda(dict(dw_in_p=dw_in_p, dw_out_p=dw_out_p), dw_in_p.dtype, dev, vectors=False)
    _check_cuda(dict(db_in_p=db_in_p, db_out=db_out), torch.float32, dev, vectors=False)
    d, P = dw_out_p.shape
    kw = dict(dtype=dtype, device=dev)
    out = (_empty((2 * f, d), **kw), _empty((2 * f,), **kw), _empty((d, f), **kw),
           _empty((d,), **kw))
    _raise_on(_lib().glu_ff_unpack_grads(
        dw_in_p.data_ptr(), db_in_p.data_ptr(), dw_out_p.data_ptr(), db_out.data_ptr(),
        *(t.data_ptr() for t in out), d, f, P, _DTYPE_CODES[dw_in_p.dtype], _DTYPE_CODES[dtype],
        _stream(dev)), 'glu_ff_unpack_grads')
    UNPACK_LAUNCHES += 1
    return out
