"""Building blocks of the reference: matrix products at a chosen precision,
norms, rotary angles and plain masked attention.

Every matrix product goes through `Precision.mm`. In float32 it is a plain
`matmul` (the caller turns TF32 off, `float32_matmuls`). In fp8 each operand,
and in the backward the incoming gradient, is rounded to float8 e4m3 with one
scale per tensor (its largest magnitude at 448) before a float32 product:
what a model trained in fp8 computes, the step below the bf16 the
configurations state.
"""
from __future__ import annotations

import contextlib
import math

import torch

FP8_MAX = 448.0
NEG_INF = -1e30


def _q8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def _unbroadcast(g: torch.Tensor, shape) -> torch.Tensor:
    while g.ndim > len(shape):
        g = g.sum(dim=0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(dim=i, keepdim=True)
    return g


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a), _q8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q8(g)
        return (_unbroadcast(qg @ qb.transpose(-1, -2), qa.shape),
                _unbroadcast(qa.transpose(-1, -2) @ qg, qb.shape))


class Precision:
    """'float32' (the reference) or 'fp8' (the control)."""

    def __init__(self, kind: str = 'float32'):
        if kind not in ('float32', 'fp8'):
            raise ValueError(f'unknown precision {kind}')
        self.kind = kind

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == 'fp8':
            return _Fp8MatMul.apply(a, b)
        return a @ b


@contextlib.contextmanager
def float32_matmuls():
    """TF32 off for the block, as the reference's products are float32."""
    cuda, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def linear(prec: Precision, x, weight, bias=None):
    """x @ weight.T (+ bias), weight stored (out, in)."""
    y = prec.mm(x, weight.t())
    return y if bias is None else y + bias


def rmsnorm(x, scale, eps: float = 1e-6):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def rms_normalize(x, eps: float = 1e-6):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


def layernorm(x, scale, eps: float = 1e-6):
    """LayerNorm with a scale and no bias."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
    return (x - mean) * torch.rsqrt(var + eps) * scale


def l2norm(x, eps: float = 1e-12):
    return x * torch.rsqrt(x.square().sum(dim=-1, keepdim=True) + eps)


def softclamp(x, value: float):
    return torch.tanh(x / value) * value


def rotary_angles(dim_head: int, n: int, device, theta: float = 10000.0):
    """(n, dim_head) angles of positions 0..n-1, the half-frequencies twice."""
    inv = 1.0 / theta ** (torch.arange(0, dim_head, 2, dtype=torch.float32,
                                       device=device) / dim_head)
    f = torch.outer(torch.arange(n, dtype=torch.float32, device=device), inv)
    return torch.cat([f, f], dim=-1)


def rotate(t, angles):
    half = t.shape[-1] // 2
    rotated = torch.cat([-t[..., half:], t[..., :half]], dim=-1)
    return t * torch.cos(angles) + rotated * torch.sin(angles)


def attend(prec: Precision, q, k, v, mask=None, softclamp_value: float | None = 50.0):
    """Softmax attention of (B, h, n, d) q over (B, h, m, d) k, v; mask (n, m),
    True where a query may see a key."""
    sim = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if softclamp_value is not None:
        sim = softclamp(sim, softclamp_value)
    if mask is not None:
        sim = sim.masked_fill(~mask, NEG_INF)
    return prec.mm(torch.softmax(sim, dim=-1), v)


def space_mask(s: int, num_special: int, only_itself: bool, device):
    """The special tokens sit last in each frame. By default the other
    tokens do not see them; with `only_itself` they see only each other."""
    sp = torch.arange(s, device=device) >= s - num_special
    if only_itself:
        return ~(sp[:, None] & ~sp[None, :])
    return ~(~sp[:, None] & sp[None, :])


def causal_mask(n: int, device):
    i = torch.arange(n, device=device)
    return i[:, None] >= i[None, :]


def silu_mlp(prec: Precision, P: dict, prefix: str, x, layers: int, rmsnorm_in: bool):
    """Dense layers `Dense_0..layers-1` with SiLU between, after an optional
    RMSNorm `RMSNorm_0`."""
    if rmsnorm_in:
        x = rmsnorm(x, P[f'{prefix}RMSNorm_0.scale'])
    for i in range(layers):
        x = linear(prec, x, P[f'{prefix}Dense_{i}.weight'], P.get(f'{prefix}Dense_{i}.bias'))
        if i < layers - 1:
            x = torch.nn.functional.silu(x)
    return x
