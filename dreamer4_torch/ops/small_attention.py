"""Fused attention for small score matrices: K4 and K5 of the port
(counterpart of `dreamer4_tpu/ops/small_attention.py`).

The trunk's axial attention below the flash gate (space attention over
tens of tokens, time attention over T = 16-32 frames) takes this path when
`use_fused_small` is on. q, k, v stay in the projections' flat layout
(B, n*h, dh): row i holds position i // h of head i % h, so the reshapes
around the kernels are free. `small_attend_flat` is differentiable: its
forward launches `csrc/small_attn_fwd.cu` (K4), its backward
`csrc/small_attn_bwd.cu` (K5), which recomputes the probabilities from q
and k (no saved LSE) and writes dq, dk and dv in one launch.

The plain versions (`small_attend_flat_reference`,
`small_attend_flat_bwd_reference`) are the counterpart's formula line for
line: one (n*h, n*h) product over all heads with an additive interleaved
bias that is -1e30 across heads and where the (n, n) mask forbids a pair.
A wrapper computes them only for tensors on the CPU: on a CUDA tensor it
launches the kernel or raises. The kernels compute each (row, head) on its
own from the (n, n) mask, without the h-fold redundant scores.

Both kernels are persistent: a block walks items of one batch row and G
heads, fed through a ring of shared-memory stages by bulk-async copies
(`csrc/small_attn_common.cuh`). `small_plan` picks G and the number of
stages per call from the shape alone, a pure function cached per shape, so
the wrapper adds no host work per call.
"""
from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = -1e30

# kernel launches since the last reset; one per launch of each CUDA kernel
FWD_LAUNCHES = 0    # K4
BWD_LAUNCHES = 0    # K5

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels are built for n padded to 16, 32 or 64 tokens (csrc/small_attn_*.cu)
MAX_TOKENS = 64
# the counterpart's efficiency cap on the flat rows n * heads
MAX_NH = 512


# csrc/small_attn_common.cuh: consumer warps per block, the ring's barrier
# bytes, and a block's shared-memory limit on sm_90
MAX_CONSUMER_WARPS = 8
_BARRIER_BYTES = 128
SMEM_LIMIT = 232448
# staged inputs per item, and output tiles (K5 in bf16 only: K4 and the
# float32 kernels store from registers) of K4 ('fwd') and K5 ('bwd')
_TENSORS = {'fwd': (3, 0), 'bwd': (4, 3)}
# The plan's choices, measured on an NVIDIA H100 80GB HBM3 at 700 W by
# `scripts/time_torch_small.py sweep` (PERF.md §6): with 2 stages, 2
# heads per item in bf16 and 1 in float32 were the fastest plan at the
# tokenizer's and the world model's shapes or within 3% of it (3 stages in
# float32 at the world-model shapes), and within 0.0008 ms of it at the
# ragged n = 13 shapes.
HEADS_PER_ITEM = {torch.bfloat16: 2, torch.float32: 1}
STAGES = 2


def _npad(n: int) -> int:
    return 16 if n <= 16 else 32 if n <= 32 else 64


def consumer_warps(n: int, heads_per_item: int, dtype: torch.dtype) -> int:
    """Consumer warps of a block: per head, one per 16 query rows (bf16) or
    one per 8 rows at four threads a row (float32)."""
    return heads_per_item * _npad(n) // (16 if dtype == torch.bfloat16 else 8)


def small_smem_bytes(n: int, dim_head: int, dtype: torch.dtype, which: str,
                     heads_per_item: int, stages: int) -> int:
    """Dynamic shared memory of a launch, as the kernels size it
    (`smem_bytes` in csrc/small_attn_fwd.cu and small_attn_bwd.cu): the
    ring's stages of NPAD-row tiles (rows of G * dh elements and 16 bytes
    of pad), K5's bf16 output tiles (which a launch whose grid holds every
    item at once leaves out), and K5's (K4's in float32) p / ds tiles."""
    elem = 2 if dtype == torch.bfloat16 else 4
    npad, G = _npad(n), heads_per_item
    tile = npad * (G * dim_head + 16 // elem) * elem
    ins, outs = _TENSORS[which]
    if elem == 4:
        outs = 0
    total = _BARRIER_BYTES + (stages * ins + outs) * tile
    if which == 'bwd':
        total += 2 * G * npad * (npad + 16 // elem) * elem
    elif elem == 4:
        total += G * npad * (npad + 4) * 4
    return total


@functools.lru_cache(maxsize=256)
def small_plan(n: int, heads: int, dim_head: int, dtype: torch.dtype,
               which: str) -> tuple[int, int]:
    """(heads per item G, ring stages) of K4 (`which='fwd'`) or K5
    ('bwd') at this shape: the largest G up to `HEADS_PER_ITEM[dtype]`
    that divides `heads`, gives at most `MAX_CONSUMER_WARPS` consumer warps
    and fits in `SMEM_LIMIT` with one stage (G = 1 at least); the stages
    are `STAGES` where they fit, else as many as fit."""
    G = 1
    for g in range(min(heads, HEADS_PER_ITEM[dtype]), 0, -1):
        if (heads % g == 0 and consumer_warps(n, g, dtype) <= MAX_CONSUMER_WARPS
                and small_smem_bytes(n, dim_head, dtype, which, g, 1) <= SMEM_LIMIT):
            G = g
            break
    for stages in range(STAGES, 0, -1):
        if small_smem_bytes(n, dim_head, dtype, which, G, stages) <= SMEM_LIMIT:
            return G, stages
    raise ValueError(f'no plan fits n {n}, dh {dim_head}, {dtype} in shared memory')


def kernels_take(n: int, dim_head: int, dtype: torch.dtype) -> bool:
    """What K4 and K5 are built for: n <= 64 tokens (the register tiles are
    sized for n padded to 16, 32 or 64), a supported head dim and type."""
    return 1 <= n <= MAX_TOKENS and dim_head in SUPPORTED_HEAD_DIMS and dtype in _DTYPE_CODES


def small_attention_viable(n: int, heads: int, dim_head: int, dtype: torch.dtype) -> bool:
    """The port's gate for the fused small path: the counterpart's
    efficiency cap `n * heads <= MAX_NH`, and in place of its TPU VMEM
    estimate what the kernels take (`kernels_take`). A shape refused here
    takes the generic attention, which computes the same function."""
    return n * heads <= MAX_NH and kernels_take(n, dim_head, dtype)


# ------------------------------------------------------------------ plain

@functools.lru_cache(maxsize=64)
def _bias_from_key(n: int, heads: int, mask_key: bytes | None) -> torch.Tensor:
    nh = n * heads
    i = torch.arange(nh)
    allowed = (i[:, None] % heads) == (i[None, :] % heads)
    if mask_key is not None:
        mask = torch.frombuffer(bytearray(mask_key), dtype=torch.bool).reshape(n, n)
        qi = i // heads
        allowed = allowed & mask[qi[:, None], qi[None, :]]
    return torch.where(allowed, 0.0, NEG_INF)


def build_interleaved_bias(n: int, heads: int, mask: torch.Tensor | None,
                           device=None) -> torch.Tensor:
    """(n*h, n*h) float32 additive bias of the flat layout: 0 where row and
    column share a head and the (n, n) `mask` allows the pair, -1e30
    elsewhere. Built once per (n, heads, mask) and cached."""
    key = None
    if mask is not None:
        if tuple(mask.shape) != (n, n):
            raise ValueError(f'mask of shape {tuple(mask.shape)}, expected {(n, n)}')
        key = mask.detach().to('cpu', torch.bool).contiguous().numpy().tobytes()
    return _bias_from_key(n, heads, key).to(device)


def _softclamp_fwd(s, c):
    if c is None:
        return s, None
    t = torch.tanh(s / c)
    return t * c, t


def small_attend_flat_reference(q, k, v, bias, softclamp_value: float | None = 50.0,
                                scale: float | None = None):
    """Plain PyTorch version of K4, the counterpart's `_fwd_kernel`: all
    heads in one (n*h, n*h) float32 product, scale, softclamp, the
    interleaved bias, float32 softmax, p cast to v's type, PV summed in
    float32 and returned in v's type."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum('bid,bjd->bij', q.float(), k.float()) * scale
    s, _ = _softclamp_fwd(s, softclamp_value)
    s = s + bias
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum('bij,bjd->bid', p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def small_attend_flat_bwd_reference(q, k, v, do, bias, softclamp_value: float | None = 50.0,
                                    scale: float | None = None):
    """Plain PyTorch version of K5, the counterpart's `_bwd_kernel`: p
    recomputed as in the forward; dp = dO . v^T; ds = p * (dp - rowsum(dp *
    p)) * (1 - t^2) * scale, cast to q's type; dq = ds . k, dk = ds^T . q,
    dv = p^T . dO with p cast to v's type, each summed in float32. `do`
    comes in v's type. Returns (dq, dk, dv)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum('bid,bjd->bij', qf, kf) * scale
    s, t = _softclamp_fwd(s, softclamp_value)
    s = s + bias
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = e / e.sum(dim=-1, keepdim=True)
    dp = torch.einsum('bid,bjd->bij', dof, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    if softclamp_value is not None:
        ds = ds * (1.0 - t * t)
    ds = (ds * scale).to(q.dtype).float()
    p_c = p.to(v.dtype).float()
    dq = torch.einsum('bij,bjd->bid', ds, kf).to(q.dtype)
    dk = torch.einsum('bij,bid->bjd', ds, qf).to(k.dtype)
    dv = torch.einsum('bij,bid->bjd', p_c, dof).to(v.dtype)
    return dq, dk, dv


# -------------------------------------------------------------- wrappers

def _check_inputs(q, k, v, heads, mask, softclamp_value):
    if q.ndim != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f'small_attend_flat takes q, k, v of one shape (B, n*h, dh), got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}')
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f'dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}')
    if heads < 1 or q.shape[1] % heads != 0 or q.shape[1] == 0:
        raise ValueError(f'{q.shape[1]} flat rows are not a positive multiple of {heads} heads')
    n = q.shape[1] // heads
    if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != (n, n)):
        raise ValueError(f'mask must be a bool ({n}, {n}) tensor')
    if softclamp_value is not None and softclamp_value <= 0:
        raise ValueError('softclamp_value must be positive or None')


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == 'cpu' for t in tensors)


def small_attend_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor | None, heads: int,
                      softclamp_value: float | None = 50.0, scale: float | None = None):
    """Fused small attention over the flat layout. q, k, v: (B, n*h, dh);
    mask: None or an (n, n) bool tensor (True = may attend). Returns
    (B, n*h, dh) in v's type. Differentiable in q, k and v: K4 forward, K5
    backward; the mask has no gradient (the counterpart returns a zero one
    for its bias)."""
    _check_inputs(q, k, v, heads, mask, softclamp_value)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    cfg = (heads, softclamp_value, float(scale))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _SmallAttend.apply(q, k, v, mask, cfg)
    return _forward(q, k, v, mask, cfg)


def _forward(q, k, v, mask, cfg):
    heads, softclamp_value, scale = cfg
    if _on_cpu(q, k, v):
        bias = build_interleaved_bias(q.shape[1] // heads, heads, mask, device=q.device)
        return small_attend_flat_reference(q, k, v, bias, softclamp_value, scale)
    return _fwd_cuda(q, k, v, mask, cfg)


def small_attend_flat_bwd(q, k, v, do, mask, heads: int, softclamp_value=50.0,
                          scale: float | None = None):
    """K5's wrapper: (dq, dk, dv) of `small_attend_flat` from its inputs
    and the output gradient `do` (cast to v's type, as the counterpart's
    VJP does). The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    do = do.to(v.dtype).contiguous()
    if _on_cpu(q, k, v, do):
        bias = build_interleaved_bias(q.shape[1] // heads, heads, mask, device=q.device)
        return small_attend_flat_bwd_reference(q, k, v, do, bias, softclamp_value, scale)
    return _bwd_cuda(q, k, v, do, mask, (heads, softclamp_value, float(scale)))


class _SmallAttend(torch.autograd.Function):
    """The counterpart's `_small_attend_flat` custom VJP: K4 forward, K5
    backward, no gradient for the mask."""

    @staticmethod
    def forward(ctx, q, k, v, mask, cfg):
        ctx.save_for_backward(q, k, v)
        ctx.mask, ctx.cfg = mask, cfg
        return _forward(q, k, v, mask, cfg)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        heads, softclamp_value, scale = ctx.cfg
        dq, dk, dv = small_attend_flat_bwd(q, k, v, do, ctx.mask, heads, softclamp_value, scale)
        return dq, dk, dv, None, None


# ------------------------------------------------------------------ CUDA


@functools.cache
def _kernel_entry(name: str):
    """The entry point `name` of the built `csrc/<name>.cu`, its C signature
    declared once: n_ptr pointers (the mask pointer may be null), then B, n,
    h, dh, dtype, heads per item, stages, scale, softclamp and the
    stream."""
    from .cuda_build import load
    return declare_entry(getattr(load(name), name), name)


def declare_entry(fn, name: str):
    """`fn`, a ctypes function of the C entry point `name`, with its
    signature declared."""
    n_ptr = {'small_attn_fwd': 5, 'small_attn_bwd': 8}[name]
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    return fn


def resident_blocks(which: str, n: int, heads: int, dim_head: int, dtype: torch.dtype,
                    plan: tuple[int, int] | None = None) -> int:
    """The persistent grid of K4 (`which='fwd'`) or K5 ('bwd') at `plan`
    (default: `small_plan`'s): the blocks the card holds at once, as the
    kernel's launch queries them (once per configuration). -1 where the
    plan does not launch. For the record; the wrapper never calls it."""
    from .cuda_build import load
    name = f'small_attn_{which}'
    fn = getattr(load(name), f'{name}_resident')
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 6
    plan = plan or small_plan(n, heads, dim_head, dtype, which)
    return fn(n, heads, dim_head, _DTYPE_CODES[dtype], *plan)


def _check_cuda(heads, named: dict):
    q = named['q']
    for name, t in named.items():
        if t.device.type != 'cuda' or t.device != q.device:
            raise ValueError(f'{name} on {t.device}; the kernel takes all inputs on one '
                             'CUDA device')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if t.data_ptr() % 16 != 0:
            raise ValueError(f'{name} must be 16-byte aligned')
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f'{name} must match q in shape and dtype')
    n, dh = q.shape[1] // heads, q.shape[2]
    if not kernels_take(n, dh, q.dtype):
        raise ValueError(f'the kernels take n <= {MAX_TOKENS}, head dim in '
                         f'{SUPPORTED_HEAD_DIMS}, float32 or bfloat16; got n {n}, dh {dh}, '
                         f'{q.dtype}')


def _mask_table(mask, device):
    """The (n, n) mask as the kernel's byte table on `device`, or None. A
    bool tensor stores one byte of 0 or 1 per entry, as the kernel reads
    it, so a contiguous mask on the card is passed as it is."""
    if mask is None:
        return None
    return mask.to(device=device).contiguous()


def _launch(which, pointers, q, heads, softclamp_value, scale):
    """One launch of K4 (`which='fwd'`) or K5 ('bwd') at its plan."""
    name = f'small_attn_{which}'
    B, NH, D = q.shape
    n = NH // heads
    err = _kernel_entry(name)(
        *pointers, B, n, heads, D, _DTYPE_CODES[q.dtype],
        *small_plan(n, heads, D, q.dtype, which), float(scale),
        float(softclamp_value) if softclamp_value is not None else 0.0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{name} launch failed with CUDA error {err}')


def _fwd_cuda(q, k, v, mask, cfg):
    global FWD_LAUNCHES
    heads, softclamp_value, scale = cfg
    _check_cuda(heads, dict(q=q, k=k, v=v))
    table = _mask_table(mask, q.device)
    out = torch.empty_like(v)
    _launch('fwd', (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    table.data_ptr() if table is not None else None, out.data_ptr()),
            q, heads, softclamp_value, scale)
    FWD_LAUNCHES += 1
    return out


def _bwd_cuda(q, k, v, do, mask, cfg):
    global BWD_LAUNCHES
    heads, softclamp_value, scale = cfg
    _check_cuda(heads, dict(q=q, k=k, v=v, do=do))
    table = _mask_table(mask, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch('bwd', (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    table.data_ptr() if table is not None else None,
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, heads, softclamp_value, scale)
    BWD_LAUNCHES += 1
    return dq, dk, dv
