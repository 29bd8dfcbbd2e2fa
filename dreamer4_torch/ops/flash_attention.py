"""Fused attention, forward and backward: K1, K2 and K3 of the port
(counterpart of `dreamer4_tpu/ops/flash_attention.py`).

`flash_attend` is differentiable. Its forward launches the hand-written
CUDA kernel `csrc/flash_attn_fwd.cu` (K1), with the log-sum-exp when a
gradient is needed; its backward (`flash_attend_bwd`) launches
`csrc/flash_attn_bwd_dq.cu` (K2), which also computes delta = rowsum(dO * O),
and `csrc/flash_attn_bwd_dkv.cu` (K3). Each kernel has its plain PyTorch version
here (`flash_attend_reference`, `bwd_dq_reference`, `bwd_dkv_reference`),
which a wrapper computes only for tensors on the CPU: on a CUDA tensor it
launches the kernel or raises. The mask family is that of the TPU kernels:
kv-length validity, causal order under an offset (which may be negative),
and special tokens at the right of every `special_seq_len` block in either
direction, the query's period counted from its offset position.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .attention import naive_attend

# kernel launches since the last reset; one per launch of each CUDA kernel
LAUNCHES = 0            # K1, the forward
BWD_DQ_LAUNCHES = 0     # K2
BWD_DKV_LAUNCHES = 0    # K3

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)


def attend_mask(N: int, M: int, offset: int, kv_len: int, *, causal=False, num_special=0,
                special_seq_len=0, special_attend_only_itself=False, device=None):
    """(N, M) dense mask of the kernel's predicates (the counterpart's
    `_mask_block`): True = may attend. Query i sits at position offset + i,
    also for the special-token period."""
    q_pos = torch.arange(N, device=device)[:, None] + offset
    k_pos = torch.arange(M, device=device)[None, :]
    mask = (k_pos < kv_len).expand(N, M)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if num_special > 0:
        L = special_seq_len if special_seq_len > 0 else M
        q_sp = q_pos % L >= L - num_special
        k_sp = k_pos % L >= L - num_special
        if special_attend_only_itself:
            mask = mask & ~(q_sp & ~k_sp)
        else:
            mask = mask & ~(~q_sp & k_sp)
    return mask


def flash_attend_reference(q, k, v, offset: int, kv_len: int, *, softclamp_value=50.0,
                           causal=False, num_special=0, special_seq_len=0,
                           special_attend_only_itself=False, return_lse=False, scale=None):
    """Plain PyTorch version of the kernel: the dense mask of the same
    predicates and `naive_attend`. Unlike the counterpart's
    `_reference_attend`, the special-token period counts from the offset,
    as both kernels do."""
    N, M = q.shape[-2], k.shape[-2]
    mask = attend_mask(N, M, offset, kv_len, causal=causal, num_special=num_special,
                       special_seq_len=special_seq_len,
                       special_attend_only_itself=special_attend_only_itself, device=q.device)
    out = naive_attend(q, k, v, mask=mask, softclamp_value=softclamp_value, scale=scale)
    if not return_lse:
        return out
    if scale is None:
        scale = q.shape[-1] ** -0.5
    groups = q.shape[-3] // k.shape[-3]
    kf = k.float().repeat_interleave(groups, dim=-3)
    sim = torch.einsum('...id,...jd->...ij', q.float(), kf) * scale
    if softclamp_value is not None:
        sim = torch.tanh(sim / softclamp_value) * softclamp_value
    sim = sim.masked_fill(~mask, -1e30)
    return out, torch.logsumexp(sim, dim=-1)


def _p_ds_reference(q, k, v, do, lse, delta, offset, kv_len, *, softclamp_value, causal,
                    num_special, special_seq_len, special_attend_only_itself, scale):
    """The TPU kernels' `_recompute_p_ds` over whole matrices, in float32:
    p from the saved LSE, zeroed by the mask predicate; ds = p * (dp - delta)
    * (1 - tanh^2), the gradient of the scaled score before the softclamp.
    k and v come expanded to the query heads. Returns (p, ds)."""
    N, M = q.shape[-2], k.shape[-2]
    mask = attend_mask(N, M, offset, kv_len, causal=causal, num_special=num_special,
                       special_seq_len=special_seq_len,
                       special_attend_only_itself=special_attend_only_itself, device=q.device)
    s = torch.einsum('...id,...jd->...ij', q.float(), k.float()) * scale
    if softclamp_value is not None:
        t = torch.tanh(s / softclamp_value)
        s = t * softclamp_value
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum('...id,...jd->...ij', do.float(), v.float())
    ds = p * (dp - delta[..., None])
    if softclamp_value is not None:
        ds = ds * (1.0 - t * t)
    return p, ds


def _scale_and_groups(q, k, scale):
    return (q.shape[-1] ** -0.5 if scale is None else scale), q.shape[-3] // k.shape[-3]


def bwd_dq_reference(q, k, v, o, lse, do, offset: int, kv_len: int, *, softclamp_value=50.0,
                     causal=False, num_special=0, special_seq_len=0,
                     special_attend_only_itself=False, scale=None):
    """Plain PyTorch version of K2: delta = `attention_delta(o, do)`, then
    dq = scale * ds . k, ds rounded to k's dtype and the product summed in
    float32, as the TPU kernel does. Returns (dq, delta)."""
    delta = attention_delta(o, do)
    scale, groups = _scale_and_groups(q, k, scale)
    kx, vx = (t.repeat_interleave(groups, dim=-3) for t in (k, v))
    _, ds = _p_ds_reference(q, kx, vx, do, lse, delta, offset, kv_len,
                            softclamp_value=softclamp_value, causal=causal,
                            num_special=num_special, special_seq_len=special_seq_len,
                            special_attend_only_itself=special_attend_only_itself, scale=scale)
    dq = torch.einsum('...ij,...jd->...id', ds.to(k.dtype).float(), kx.float())
    return (dq * scale).to(q.dtype), delta


def bwd_dkv_reference(q, k, v, do, lse, delta, offset: int, kv_len: int, *, softclamp_value=50.0,
                      causal=False, num_special=0, special_seq_len=0,
                      special_attend_only_itself=False, scale=None):
    """Plain PyTorch version of K3: dv = p^T . dO (p rounded to dO's dtype),
    dk = scale * ds^T . q (ds rounded to q's dtype), each summed over the
    GQA group of query heads in float32."""
    scale, groups = _scale_and_groups(q, k, scale)
    kx, vx = (t.repeat_interleave(groups, dim=-3) for t in (k, v))
    p, ds = _p_ds_reference(q, kx, vx, do, lse, delta, offset, kv_len,
                            softclamp_value=softclamp_value, causal=causal,
                            num_special=num_special, special_seq_len=special_seq_len,
                            special_attend_only_itself=special_attend_only_itself, scale=scale)
    dv = torch.einsum('...ij,...id->...jd', p.to(do.dtype).float(), do.float())
    dk = torch.einsum('...ij,...id->...jd', ds.to(q.dtype).float(), q.float()) * scale
    group_sum = lambda t: t.reshape(*k.shape[:-3], k.shape[-3], groups, *t.shape[-2:]).sum(-3)
    return group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)


def attention_delta(o, do):
    """delta = rowsum(dO * O) in float32, (B, Hq, N)."""
    return (do.float() * o.float()).sum(dim=-1)


def _check_inputs(q, k, v, offset, kv_len, softclamp_value):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError('flash_attend takes q (B, Hq, N, D) and k, v (B, H, M, D)')
    B, Hq, N, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[-1] != D:
        raise ValueError(f'shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, '
                         f'v {tuple(v.shape)}')
    H, M = k.shape[1], k.shape[2]
    if Hq % H != 0:
        raise ValueError(f'query heads {Hq} must be a multiple of kv heads {H}')
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f'dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}')
    if not isinstance(offset, int) or not isinstance(kv_len, int):
        raise TypeError('offset and kv_len are host ints')
    if not 1 <= kv_len <= M:
        raise ValueError(f'kv_len {kv_len} outside [1, {M}]')
    if min(N, M) == 0:
        raise ValueError('empty attention')
    if softclamp_value is not None and softclamp_value <= 0:
        raise ValueError('softclamp_value must be positive or None')


def flash_attend(q: torch.Tensor,   # (B, Hq, N, D)
                 k: torch.Tensor,   # (B, H, M, D)
                 v: torch.Tensor,   # (B, H, M, D)
                 offset: int,
                 kv_len: int,
                 *,
                 softclamp_value: float | None = 50.0,
                 causal: bool = False,
                 num_special: int = 0,
                 special_seq_len: int = 0,
                 special_attend_only_itself: bool = False,
                 return_lse: bool = False,
                 scale: float | None = None):
    """Fused attention. Returns o (B, Hq, N, D) in the input dtype, and the
    float32 log-sum-exp (B, Hq, N) with `return_lse`. Differentiable in q,
    k and v (the counterpart's custom VJP): under grad the forward keeps its
    LSE for the backward; the LSE itself carries no gradient."""
    _check_inputs(q, k, v, offset, kv_len, softclamp_value)
    cfg = dict(softclamp_value=softclamp_value, causal=causal, num_special=num_special,
               special_seq_len=special_seq_len,
               special_attend_only_itself=special_attend_only_itself, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out, lse = _FlashAttend.apply(q, k, v, offset, kv_len, cfg)
        return (out, lse) if return_lse else out
    return _forward(q, k, v, offset, kv_len, return_lse=return_lse, **cfg)


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == 'cpu' for t in tensors)


def _forward(q, k, v, offset, kv_len, *, return_lse, **cfg):
    if _on_cpu(q, k, v):
        return flash_attend_reference(q, k, v, offset, kv_len, return_lse=return_lse, **cfg)
    return _flash_attend_cuda(q, k, v, offset, kv_len, return_lse=return_lse, **cfg)


def flash_attend_bwd(q, k, v, o, lse, do, offset: int, kv_len: int, **cfg):
    """The backward of `flash_attend` from its saved output and LSE: K2
    (dq, and delta = rowsum(dO * O)), then K3 (dk, dv) from that delta. The
    LSE is an input, so a caller may pass one it reduced itself (a ring's
    global LSE). Returns (dq, dk, dv) in the input dtypes."""
    do = do.contiguous()   # autograd may hand over a strided view
    dq, delta = bwd_dq(q, k, v, o, lse, do, offset, kv_len, **cfg)
    return (dq, *bwd_dkv(q, k, v, do, lse, delta, offset, kv_len, **cfg))


class _FlashAttend(torch.autograd.Function):
    """`flash_attend` under autograd: K1 with its LSE forward, K2 and K3
    backward (the counterpart's `flash_attend.defvjp(_fwd, _bwd)`; the port
    takes the fused backward at every shape)."""

    @staticmethod
    def forward(ctx, q, k, v, offset, kv_len, cfg):
        out, lse = _forward(q, k, v, offset, kv_len, return_lse=True, **cfg)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (offset, kv_len, cfg)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        offset, kv_len, cfg = ctx.args
        dq, dk, dv = flash_attend_bwd(q, k, v, out, lse, do, offset, kv_len, **cfg)
        return dq, dk, dv, None, None, None


# ------------------------------------------------------------------ CUDA

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel_entry(name: str):
    """The entry point `name` of the built `csrc/<name>.cu`, its C signature
    declared once: n_ptr pointers, then B, Hq, H, N, M, D, dtype, offset,
    kv_len, scale, softclamp, causal, num_special, special_seq_len,
    special_only_itself and the stream."""
    from .cuda_build import load
    n_ptr = {'flash_attn_fwd': 5, 'flash_attn_bwd_dq': 8, 'flash_attn_bwd_dkv': 8}[name]
    fn = getattr(load(name), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


def _check_cuda(q, named: dict):
    for name, t in named.items():
        if t.device.type != 'cuda' or t.device != q.device:
            raise ValueError(f'{name} on {t.device}; the kernel takes all inputs on one '
                             'CUDA device')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if t.data_ptr() % 16 != 0:
            raise ValueError(f'{name} must be 16-byte aligned')
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f'the kernel takes float32 or bfloat16, not {q.dtype}')
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f'head dim {q.shape[-1]} not in {SUPPORTED_HEAD_DIMS}')


def _check_bwd(q, k, v, do, lse, *, o=None, delta=None):
    """The backward kernels' inputs: do (and K2's o) like q; lse (and K3's
    delta) float32 of shape q.shape[:-1]."""
    like_q = {'do': do} if o is None else {'do': do, 'o': o}
    stats = {'lse': lse} if delta is None else {'lse': lse, 'delta': delta}
    _check_cuda(q, dict(q=q, k=k, v=v, **like_q, **stats))
    for name, t in like_q.items():
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f'{name} must match q in shape and dtype')
    for name, t in stats.items():
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(q.shape[:-1]):
            raise ValueError(f'{name} must be float32 of shape {tuple(q.shape[:-1])}')


def _launch(name, pointers, q, k, offset, kv_len, *, softclamp_value=50.0, causal=False,
            num_special=0, special_seq_len=0, special_attend_only_itself=False, scale=None):
    B, Hq, N, D = q.shape
    H, M = k.shape[1], k.shape[2]
    L = special_seq_len if special_seq_len > 0 else M
    err = _kernel_entry(name)(
        *pointers, B, Hq, H, N, M, D, _DTYPE_CODES[q.dtype], offset, kv_len,
        float(D ** -0.5 if scale is None else scale),
        float(softclamp_value) if softclamp_value is not None else 0.0,
        int(causal), int(num_special), int(L), int(special_attend_only_itself),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{name} launch failed with CUDA error {err}')


def _flash_attend_cuda(q, k, v, offset, kv_len, *, return_lse, **cfg):
    global LAUNCHES
    _check_cuda(q, dict(q=q, k=k, v=v))
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device) if return_lse else None
    _launch('flash_attn_fwd', (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               lse.data_ptr() if lse is not None else None),
            q, k, offset, kv_len, **cfg)
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def _bwd_dq_cuda(q, k, v, o, lse, do, offset, kv_len, **cfg):
    global BWD_DQ_LAUNCHES
    _check_bwd(q, k, v, do, lse, o=o)
    dq = torch.empty_like(q)
    delta = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    _launch('flash_attn_bwd_dq', (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                  o.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr()),
            q, k, offset, kv_len, **cfg)
    BWD_DQ_LAUNCHES += 1
    return dq, delta


def _bwd_dkv_cuda(q, k, v, do, lse, delta, offset, kv_len, **cfg):
    global BWD_DKV_LAUNCHES
    _check_bwd(q, k, v, do, lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch('flash_attn_bwd_dkv', (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                   lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                                   dv.data_ptr()),
            q, k, offset, kv_len, **cfg)
    BWD_DKV_LAUNCHES += 1
    return dk, dv


def bwd_dq(q, k, v, o, lse, do, offset: int, kv_len: int, **cfg):
    """K2's wrapper: the kernel on CUDA tensors, `bwd_dq_reference` on CPU
    tensors. Returns (dq, delta), delta = rowsum(dO * O) in float32 for
    `bwd_dkv`."""
    if _on_cpu(q, k, v, o, lse, do):
        return bwd_dq_reference(q, k, v, o, lse, do, offset, kv_len, **cfg)
    return _bwd_dq_cuda(q, k, v, o, lse, do, offset, kv_len, **cfg)


def bwd_dkv(q, k, v, do, lse, delta, offset: int, kv_len: int, **cfg):
    """K3's wrapper: the kernel on CUDA tensors, `bwd_dkv_reference` on CPU
    tensors."""
    if _on_cpu(q, k, v, do, lse, delta):
        return bwd_dkv_reference(q, k, v, do, lse, delta, offset, kv_len, **cfg)
    return _bwd_dkv_cuda(q, k, v, do, lse, delta, offset, kv_len, **cfg)
