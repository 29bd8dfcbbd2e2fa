"""Fused attention forward, K1 of the port (counterpart of
`dreamer4_tpu/ops/flash_attention.py`).

`flash_attend` launches the hand-written CUDA kernel `csrc/flash_attn_fwd.cu`
for tensors on a CUDA device and computes `flash_attend_reference`, the plain
PyTorch version in this module, for tensors on the CPU. A CUDA tensor never
reaches the plain version: the wrapper launches the kernel or raises. The
mask family is that of the TPU kernel: kv-length validity, causal order
under an offset, and special tokens at the right of every
`special_seq_len` block in either direction.

The backward kernels (K2, K3) belong to the training slice; on CUDA the
wrapper refuses inputs that require grad.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .attention import naive_attend

# kernel launches since the last reset; one per launch of the CUDA kernel
LAUNCHES = 0

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    """Fused attention forward. Returns o (B, Hq, N, D) in the input dtype,
    and the float32 log-sum-exp (B, Hq, N) with `return_lse`."""
    _check_inputs(q, k, v, offset, kv_len, softclamp_value)
    cfg = dict(softclamp_value=softclamp_value, causal=causal, num_special=num_special,
               special_seq_len=special_seq_len,
               special_attend_only_itself=special_attend_only_itself, scale=scale)
    if q.device.type == 'cpu' and k.device.type == 'cpu' and v.device.type == 'cpu':
        return flash_attend_reference(q, k, v, offset, kv_len, return_lse=return_lse, **cfg)
    return _flash_attend_cuda(q, k, v, offset, kv_len, return_lse=return_lse, **cfg)


@functools.cache
def _kernel_entry():
    """`flash_attn_fwd` of the built library, its C signature declared once."""
    from .cuda_build import load
    fn = load('flash_attn_fwd').flash_attn_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return fn


def _flash_attend_cuda(q, k, v, offset, kv_len, *, softclamp_value, causal, num_special,
                       special_seq_len, special_attend_only_itself, return_lse, scale):
    global LAUNCHES
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.device.type != 'cuda' or t.device != q.device:
            raise ValueError(f'{name} on {t.device}; the kernel takes all inputs on one '
                             'CUDA device')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if t.data_ptr() % 16 != 0:
            raise ValueError(f'{name} must be 16-byte aligned')
        if t.requires_grad:
            raise NotImplementedError('the flash-attention backward (K2/K3) is not ported; '
                                      'call under torch.no_grad()')
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f'the kernel takes float32 or bfloat16, not {q.dtype}')
    B, Hq, N, D = q.shape
    H, M = k.shape[1], k.shape[2]
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f'head dim {D} not in {SUPPORTED_HEAD_DIMS}')
    if scale is None:
        scale = D ** -0.5
    L = special_seq_len if special_seq_len > 0 else M

    fn = _kernel_entry()
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, N), dtype=torch.float32, device=q.device) if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr() if lse is not None else None,
             B, Hq, H, N, M, D, _DTYPE_CODES[q.dtype], offset, kv_len,
             float(scale), float(softclamp_value) if softclamp_value is not None else 0.0,
             int(causal), int(num_special), int(L), int(special_attend_only_itself), stream)
    if err != 0:
        raise RuntimeError(f'flash_attn_fwd launch failed with CUDA error {err}')
    LAUNCHES += 1
    return (out, lse) if return_lse else out
