"""The trunk's attention pools and the normalization of the hiddens they
read, as CUDA kernels (`csrc/attn_pool.cu`).

`pool_attend(q, k, v, scale, gate_logits)` is the core of
`nn.attention._StreamingPoolAttention`: each token's single query attends
over the stack of its L layer hiddens, projected to keys and values,

    k^_l = k_l * rsqrt(sum k_l^2 + 1e-12) * scale       (the head norm)
    s_l  = c * tanh(q . k^_l / (sqrt(dh) c))             (the softclamp c)
    out  = sigmoid(gate_logits) * sum_l softmax_l(s) v_l

with q (N, h*dh), k and v (L, N, h*dh) as the projections write them, the
head-norm scale (h, dh) and the gate logits (N, h). Its forward launches
one kernel (which, before a backward, also keeps the log-sum-exp and the
un-gated output in float32), its backward two (dq, dk, dv and the gate
logits' gradient in one pass over the layers, the scale's gradient summed
over the first one's blocks in a second).
`rms_normalize(x)` is x * rsqrt(mean(x^2) + eps) over the last axis, one
launch forward and one backward; under no-grad it can write into a slot of
the trunk's stack of normalized hiddens (`out`).

Both are differentiable and take CUDA tensors in float32 or bf16, the pool
at 4 heads of 64 and the normalization at a width that is a multiple of 8;
they raise on anything else. The callers in `nn.attention` send them every
CUDA tensor and keep their plain code (`pool_attend_plain`,
`rms_normalize_plain`) for the CPU. `pool_attend_bwd_reference` and
`rms_normalize_bwd_reference` write the backward kernels' formulas in plain
torch; the CPU tests hold them against autograd of the plain code.
"""
from __future__ import annotations

import ctypes
import functools

import torch

# kernel launches since the last reset
FWD_LAUNCHES = 0    # the pool's forward
BWD_LAUNCHES = 0    # the pool's backward: two a call
NORM_LAUNCHES = 0   # rms_normalize, forward and backward

HEADS, DIM_HEAD = 4, 64                 # the pool's heads, as the kernels are built
ROW = HEADS * DIM_HEAD                  # a warp of the kernels covers a token
MAX_BWD_BLOCKS = 2048                   # the backward's grid, and its partial sums
WARPS = 8                               # tokens (rows) a block takes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KEY_EPS = 1e-12


def _acc(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


# ------------------------------------------------------------ the backward

def pool_attend_bwd_reference(q, k, v, scale, gate_logits, dout,
                              softclamp_value: float | None = 50.0):
    """The backward kernel's formulas in plain torch, in float32 (float64
    for float64 inputs). The kernel reads the log-sum-exp lse of the scores
    and the un-gated output o from its forward; here they are computed from
    the inputs. g = sigmoid(gate_logits); the logits' gradient (dout . o) g
    (1 - g); delta = sum_l p_l dp_l = g (dout . o); per layer p_l = exp(s_l
    - lse), do = g dout, dp_l = do . v_l, dv_l = p_l do, dz_l = p_l (dp_l -
    delta) (1 - t_l^2) / sqrt(dh) (t_l the softclamp's tanh); with w = q
    scale and u_l = r_l k_l: dq = sum_l dz_l u_l scale, the scale's gradient
    sum over l and n of dz_l q u_l, dk_l = dz_l r_l (w - u_l (u_l . w)).
    Returns (dq, dk, dv, dscale, dgate_logits), each in its input's dtype."""
    L, N, _ = k.shape
    h, dh = scale.shape
    f = _acc(q)
    qf, dof = q.to(f).reshape(N, h, dh), dout.to(f).reshape(N, h, dh)
    kf, vf = k.to(f).reshape(L, N, h, dh), v.to(f).reshape(L, N, h, dh)
    sc = scale.to(f)
    sm_scale = dh ** -0.5
    r = torch.rsqrt(kf.square().sum(-1, keepdim=True) + KEY_EPS)
    u = kf * r
    w = qf * sc
    z = torch.einsum('nhd,lnhd->nhl', qf, u * sc) * sm_scale
    if softclamp_value is not None:
        t = torch.tanh(z / softclamp_value)
        s, dsdz = softclamp_value * t, 1.0 - t * t
    else:
        s, dsdz = z, 1.0
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum('nhl,lnhd->nhd', p, vf)
    g = torch.sigmoid(gate_logits.to(f))
    dg = (dof * o).sum(-1)
    dgate = dg * g * (1.0 - g)
    delta = (g * dg)[..., None]
    do = dof * g[..., None]
    dv = torch.einsum('nhl,nhd->lnhd', p, do)
    dp = torch.einsum('nhd,lnhd->nhl', do, vf)
    dz = p * (dp - delta) * dsdz * sm_scale
    dq = torch.einsum('nhl,lnhd->nhd', dz, u * sc)
    dscale = torch.einsum('nhl,nhd,lnhd->hd', dz, qf, u)
    uw = (u * w).sum(-1, keepdim=True)                               # (L, N, h, 1)
    dk = torch.einsum('nhl,lnhd->lnhd', dz, r * (w - u * uw))
    return (dq.reshape(q.shape).to(q.dtype), dk.reshape(k.shape).to(k.dtype),
            dv.reshape(v.shape).to(v.dtype), dscale.to(scale.dtype),
            dgate.to(gate_logits.dtype))


def rms_normalize_bwd_reference(x, dy, eps: float = 1e-6):
    """The backward kernel's formula: dx = r dy - r^3 x (x . dy) / d, r =
    rsqrt(mean(x^2) + eps)."""
    f = _acc(x)
    xf, dyf = x.to(f), dy.to(f)
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    coef = r ** 3 * (xf * dyf).sum(-1, keepdim=True) / x.shape[-1]
    return (r * dyf - coef * xf).to(x.dtype)


# -------------------------------------------------------------- wrappers

def _check_pool(q, k, v, scale, gate_logits):
    if k.ndim != 3 or v.shape != k.shape or q.shape != k.shape[1:]:
        raise ValueError(f'pool_attend takes q (N, h*dh) and k, v (L, N, h*dh); got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}')
    h, dh = scale.shape
    if h * dh != q.shape[-1] or gate_logits.shape != (q.shape[0], h):
        raise ValueError(f'scale {tuple(scale.shape)} and gate logits '
                         f'{tuple(gate_logits.shape)} do not fit q {tuple(q.shape)}')
    if not (q.dtype == k.dtype == v.dtype == gate_logits.dtype):
        raise ValueError(f'dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}, {gate_logits.dtype}')
    if not all(t.is_cuda for t in (q, k, v, scale, gate_logits)):
        raise ValueError('pool_attend takes CUDA tensors; the CPU runs '
                         '`nn.attention.pool_attend_plain`')


def pool_attend(q, k, v, scale, gate_logits, softclamp_value: float | None = 50.0):
    """The pool's attention (module docstring): (N, h*dh) in q's dtype.
    Differentiable in q, k, v, scale and gate_logits."""
    _check_pool(q, k, v, scale, gate_logits)
    if softclamp_value is not None and softclamp_value <= 0:
        raise ValueError('softclamp_value must be positive or None')
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, scale, gate_logits)):
        return _PoolAttend.apply(q, k, v, scale, gate_logits, softclamp_value)
    return _pool_fwd_cuda(q, k, v, scale, gate_logits, softclamp_value, for_backward=False)[0]


class _PoolAttend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, gate_logits, softclamp_value):
        out, lse, o = _pool_fwd_cuda(q, k, v, scale, gate_logits, softclamp_value,
                                     for_backward=True)
        ctx.save_for_backward(q, k, v, scale, gate_logits, lse, o)
        ctx.softclamp_value = softclamp_value
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, scale, gate_logits, lse, o = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        return (*_pool_bwd_cuda(q, k, v, scale, gate_logits, lse, o, dout,
                                ctx.softclamp_value), None)


def rms_normalize(x, eps: float = 1e-6, out: torch.Tensor | None = None):
    """x * rsqrt(mean(x^2) + eps) over the last axis in x's dtype (module
    docstring). Differentiable in x; `out` (x's shape and dtype, contiguous,
    no grad) receives the result in place and is returned."""
    if out is not None:
        if out.shape != x.shape or out.dtype != x.dtype or not out.is_contiguous():
            raise ValueError(f'out {tuple(out.shape)} {out.dtype} for x {tuple(x.shape)} '
                             f'{x.dtype}: same shape and dtype, contiguous')
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError('rms_normalize writes into out only without grad')
    if not x.is_cuda:
        raise ValueError('rms_normalize takes a CUDA tensor; the CPU runs '
                         '`nn.attention.rms_normalize_plain`')
    if torch.is_grad_enabled() and x.requires_grad:
        return _RmsNormalize.apply(x, eps)
    return _rms_fwd_cuda(x, eps, out)


class _RmsNormalize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps):
        x = x.contiguous()
        ctx.save_for_backward(x)
        ctx.eps = eps
        return _rms_fwd_cuda(x, eps)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return _rms_bwd_cuda(x, dy.to(x.dtype), ctx.eps), None


# ------------------------------------------------------------------ CUDA

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    'attn_pool_forward': [_P] * 8 + [_I] * 3 + [_F, _F, _P],
    'attn_pool_backward': [_P] * 14 + [_I] * 3 + [_F, _F, _I, _P],
    'attn_pool_rms_forward': [_P, _P, _I, _I, _I, _F, _P],
    'attn_pool_rms_backward': [_P, _P, _P, _I, _I, _I, _F, _P],
}


@functools.cache
def _lib():
    from .cuda_build import load
    lib = load('attn_pool')
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def _check_cuda(named: dict, dtype, device):
    for name, t in named.items():
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f'{name}: the pool kernels take contiguous {dtype} tensors on '
                             f'{device}; got {t.dtype} on {t.device}, contiguous '
                             f'{t.is_contiguous()}')
        if t.data_ptr() % 16 != 0:
            raise ValueError(f'{name} must be 16-byte aligned')
    if dtype not in _DTYPE_CODES:
        raise ValueError(f'the pool kernels take float32 or bfloat16, not {dtype}')


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f'{name} failed with {"an unsupported shape" if err < 0 else f"CUDA error {err}"}')


def _pool_cfg(k, scale, softclamp_value):
    L = k.shape[0]
    h, dh = scale.shape
    if (h, dh) != (HEADS, DIM_HEAD) or L < 1:
        raise ValueError(f'the pool kernels take {HEADS} heads of {DIM_HEAD} and a layer or '
                         f'more; got {h} x {dh}, {L} layers')
    return L, float(dh ** -0.5), float(softclamp_value or 0.0)


def _pool_fwd_cuda(q, k, v, scale, gate_logits, softclamp_value, for_backward: bool):
    global FWD_LAUNCHES
    scale = scale.float().contiguous()
    _check_cuda(dict(q=q, k=k, v=v, gate_logits=gate_logits), q.dtype, q.device)
    _check_cuda(dict(scale=scale), torch.float32, q.device)
    L, sm_scale, softclamp = _pool_cfg(k, scale, softclamp_value)
    N = q.shape[0]
    out = torch.empty_like(q)
    lse = o = None
    if for_backward:
        lse = torch.empty((N, scale.shape[0]), dtype=torch.float32, device=q.device)
        o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    _raise_on(_lib().attn_pool_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), scale.data_ptr(), gate_logits.data_ptr(),
        out.data_ptr(), ptr(lse), ptr(o), N, L, _DTYPE_CODES[q.dtype], sm_scale, softclamp,
        _stream(q.device)), 'attn_pool_forward')
    FWD_LAUNCHES += 1
    return out, lse, o


def bwd_blocks(n: int) -> int:
    """The backward's grid at N tokens: a block a WARPS tokens, at most
    MAX_BWD_BLOCKS (each warp then walks several tokens)."""
    return max(1, min(-(-n // WARPS), MAX_BWD_BLOCKS))


def _pool_bwd_cuda(q, k, v, scale, gate_logits, lse, o, dout, softclamp_value):
    global BWD_LAUNCHES
    scale32 = scale.float().contiguous()
    _check_cuda(dict(q=q, k=k, v=v, gate_logits=gate_logits, dout=dout), q.dtype, q.device)
    _check_cuda(dict(scale=scale32, lse=lse, o=o), torch.float32, q.device)
    L, sm_scale, softclamp = _pool_cfg(k, scale32, softclamp_value)
    N = q.shape[0]
    blocks = bwd_blocks(N)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dgate = torch.empty_like(gate_logits)
    partials = torch.empty(blocks * ROW, dtype=torch.float32, device=q.device)
    dscale = torch.empty_like(scale32)
    _raise_on(_lib().attn_pool_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), scale32.data_ptr(), gate_logits.data_ptr(),
        lse.data_ptr(), o.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dgate.data_ptr(), partials.data_ptr(), dscale.data_ptr(), N, L,
        _DTYPE_CODES[q.dtype], sm_scale, softclamp, blocks, _stream(q.device)),
        'attn_pool_backward')
    BWD_LAUNCHES += 2
    return dq, dk, dv, dscale.to(scale.dtype), dgate


def _rms_rows(x):
    if x.shape[-1] % 8 != 0:
        raise ValueError(f'rms_normalize\'s kernels take a last axis that is a multiple of 8, '
                         f'not {x.shape[-1]}')
    return x.numel() // x.shape[-1], x.shape[-1]


def _rms_fwd_cuda(x, eps, out=None):
    global NORM_LAUNCHES
    x = x.contiguous()
    y = torch.empty_like(x) if out is None else out
    _check_cuda(dict(x=x, out=y), x.dtype, x.device)
    rows, dim = _rms_rows(x)
    _raise_on(_lib().attn_pool_rms_forward(x.data_ptr(), y.data_ptr(), rows, dim,
                                           _DTYPE_CODES[x.dtype], float(eps),
                                           _stream(x.device)), 'attn_pool_rms_forward')
    NORM_LAUNCHES += 1
    return y


def _rms_bwd_cuda(x, dy, eps):
    global NORM_LAUNCHES
    dy = dy.contiguous()
    _check_cuda(dict(x=x, dy=dy), x.dtype, x.device)
    rows, dim = _rms_rows(x)
    dx = torch.empty_like(x)
    _raise_on(_lib().attn_pool_rms_backward(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), rows,
                                            dim, _DTYPE_CODES[x.dtype], float(eps),
                                            _stream(x.device)), 'attn_pool_rms_backward')
    NORM_LAUNCHES += 1
    return dx
