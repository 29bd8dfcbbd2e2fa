"""Ring attention: sequence parallelism over the time axis (counterpart of
`dreamer4_tpu/parallel/ring_attention.py`).

The time axis is split over the ranks of a process group. Each rank attends
its local queries against key/value blocks that travel around the ring
(`batch_isend_irecv` to rank (i + 1) % P), merging the blocks by an online
softmax, so no rank holds the scores of the whole sequence.

`ring_attend` runs the float32 block math of the counterpart; with
`use_flash` each (local query, travelling key/value) block runs the fused
kernels: K1 with its log-sum-exp forward, merged by `logaddexp`; K2/K3
backward from the merged output and the global LSE, the dk/dv accumulators
travelling with their blocks until they are home. One ring step is one call
of `flash_ring_fwd_step` / `flash_ring_bwd_step`; `flash_ring_blocks` runs
the same steps for P virtual ranks in one process.

Under the causal mask the block that came from rank src sits at offset
(my_idx - src) * n_local: 0 on the diagonal (step 0, so the running LSE is
finite from the first merge), negative down to -(P - 1) * n_local for the
blocks after the queries, which no query sees. Such a block merges with
weight 0 (its LSE is near -1e30) and its backward is zero.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.flash_attention import flash_attend, flash_attend_bwd
from ..ops.utils import softclamp as softclamp_fn

NEG_INF = -1e30


def process_group(group):
    """A process group, or the ambient mesh's group of an axis name."""
    if isinstance(group, str):
        from .mesh import axis_group
        return axis_group(group)
    return group


def _send_next(tensors, group, step: int = 1):
    """Each tensor sent to the rank `step` after this one in `group`, and
    the one `step` before received in its place."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if size == 1:
        return list(tensors)
    dst = dist.get_global_rank(group, (rank + step) % size)
    src = dist.get_global_rank(group, (rank - step) % size)
    outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), dst, group) for t in tensors]
           + [dist.P2POp(dist.irecv, o, src, group) for o in outs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _Rotate(torch.autograd.Function):
    """A block passed to the next rank; its gradient goes back the other way."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _send_next([t], group)[0]

    @staticmethod
    def backward(ctx, grad):
        return _send_next([grad], ctx.group, step=-1)[0], None


def _block_attend(q, k, v, scale, softclamp_value, mask):
    """One (local q, held kv) block in float32: (max, sumexp, acc)."""
    s = torch.einsum('...hid,...hjd->...hij', q, k) * scale
    if softclamp_value is not None:
        s = softclamp_fn(s, softclamp_value)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return m, p.sum(dim=-1, keepdim=True), torch.einsum('...hij,...hjd->...hid', p, v)


def ring_attend(q: torch.Tensor,   # (b, hq, n_local, d)
                k: torch.Tensor,   # (b, h, n_local, d)
                v: torch.Tensor,   # (b, h, n_local, d)
                group, causal: bool = True, softclamp_value: float | None = 50.0,
                scale: float | None = None, use_flash: bool = False) -> torch.Tensor:
    """Attention of this rank's time shard of q over the whole sequence,
    its k/v shards travelling around `group` (a process group, or an axis
    name of the ambient mesh). Every rank of the group calls it with
    shards of equal length. GQA: q heads a multiple of the kv heads.
    Differentiable; `use_flash` runs the kernels per block
    (`flash_ring_attend`)."""
    group = process_group(group)
    if use_flash:
        return flash_ring_attend(q, k, v, group, causal=causal,
                                 softclamp_value=softclamp_value, scale=scale)
    size, my_idx = dist.get_world_size(group), dist.get_rank(group)
    groups = q.shape[-3] // k.shape[-3]
    n_local = q.shape[-2]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q_pos = my_idx * n_local + torch.arange(n_local, device=q.device)

    m_i = torch.full((*q.shape[:-1], 1), NEG_INF, device=q.device)
    l_i = torch.zeros((*q.shape[:-1], 1), device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    k_blk, v_blk = k, v
    for step in range(size):
        src = (my_idx - step) % size
        mask = None
        if causal:
            k_pos = src * n_local + torch.arange(n_local, device=q.device)
            mask = k_pos[None, :] <= q_pos[:, None]
        kx, vx = (t.repeat_interleave(groups, dim=-3) if groups > 1 else t
                  for t in (k_blk, v_blk))
        m_b, l_b, acc_b = _block_attend(q.float(), kx.float(), vx.float(), scale,
                                        softclamp_value, mask)
        m_new = torch.maximum(m_i, m_b)
        alpha_i, alpha_b = torch.exp(m_i - m_new), torch.exp(m_b - m_new)
        l_i = l_i * alpha_i + l_b * alpha_b
        acc = acc * alpha_i + acc_b * alpha_b
        m_i = m_new
        if step < size - 1:
            k_blk, v_blk = _Rotate.apply(k_blk, group), _Rotate.apply(v_blk, group)
    return (acc / l_i.clamp_min(1e-30)).to(q.dtype)


# ----------------------------------------------------- the flash ring

def ring_offset(my_idx: int, step: int, size: int, n_local: int) -> int:
    """The causal offset of rank my_idx's queries against the block it
    holds at `step`, which came from rank (my_idx - step) % size."""
    return (my_idx - (my_idx - step) % size) * n_local


def flash_ring_fwd_step(q, k_blk, v_blk, offset: int, o, lse, **cfg):
    """One forward ring step: K1 with its LSE on the held block at
    `offset`, merged into the running float32 output `o` and LSE `lse`
    (B, Hq, n_local). Returns the new (o, lse)."""
    o_b, lse_b = flash_attend(q, k_blk, v_blk, offset, k_blk.shape[-2], return_lse=True, **cfg)
    lse_new = torch.logaddexp(lse, lse_b)
    o = (o * torch.exp(lse - lse_new)[..., None]
         + o_b.float() * torch.exp(lse_b - lse_new)[..., None])
    return o, lse_new


def flash_ring_bwd_step(q, k_blk, v_blk, out, lse, do, offset: int, dq, dk_acc, dv_acc,
                        **cfg):
    """One backward ring step: K2/K3 on the held block at `offset` from the
    merged output `out` and the global LSE, added to the float32 dq and to
    the block's travelling dk/dv accumulators. Returns (dq, dk_acc, dv_acc)."""
    dq_b, dk_b, dv_b = flash_attend_bwd(q, k_blk, v_blk, out, lse, do, offset,
                                        k_blk.shape[-2], **cfg)
    return dq + dq_b.float(), dk_acc + dk_b.float(), dv_acc + dv_b.float()


def _fwd_init(q):
    B, Hq, n, _ = q.shape
    return (torch.zeros(q.shape, device=q.device),
            torch.full((B, Hq, n), NEG_INF, device=q.device))


def _flash_ring_forward(q, k, v, group, cfg):
    size, my_idx = dist.get_world_size(group), dist.get_rank(group)
    o, lse = _fwd_init(q)
    k_blk, v_blk = k, v
    for step in range(size):
        o, lse = flash_ring_fwd_step(q, k_blk, v_blk,
                                     ring_offset(my_idx, step, size, q.shape[-2]), o, lse, **cfg)
        if step < size - 1:
            k_blk, v_blk = _send_next([k_blk, v_blk], group)
    return o.to(q.dtype), lse


def _flash_ring_backward(q, k, v, out, lse, do, group, cfg):
    size, my_idx = dist.get_world_size(group), dist.get_rank(group)
    dq = torch.zeros(q.shape, device=q.device)
    dk_acc = torch.zeros(k.shape, device=k.device)
    dv_acc = torch.zeros(v.shape, device=v.device)
    k_blk, v_blk = k, v
    for step in range(size):
        dq, dk_acc, dv_acc = flash_ring_bwd_step(
            q, k_blk, v_blk, out, lse, do, ring_offset(my_idx, step, size, q.shape[-2]),
            dq, dk_acc, dv_acc, **cfg)
        # the blocks and their accumulators travel on together; after P
        # moves each accumulator is home (the blocks need only P - 1)
        if step < size - 1:
            k_blk, v_blk, dk_acc, dv_acc = _send_next([k_blk, v_blk, dk_acc, dv_acc], group)
        else:
            dk_acc, dv_acc = _send_next([dk_acc, dv_acc], group)
    return dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


class _FlashRing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, cfg):
        out, lse = _flash_ring_forward(q, k, v, group, cfg)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.cfg = group, cfg
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        grads = _flash_ring_backward(q, k, v, out, lse, do.contiguous(), ctx.group, ctx.cfg)
        return (*grads, None, None)


def flash_ring_attend(q, k, v, group, *, causal: bool = True,
                      softclamp_value: float | None = 50.0, scale: float | None = None):
    """Ring attention whose every block runs the fused kernels, forward
    and backward (the counterpart's `custom_vjp`). q, k, v contiguous
    shards of equal length on every rank of `group`."""
    cfg = dict(softclamp_value=softclamp_value, causal=causal, scale=scale)
    q, k, v = (t.contiguous() for t in (q, k, v))
    return _FlashRing.apply(q, k, v, process_group(group), cfg)


@torch.no_grad()
def flash_ring_blocks(q, k, v, num_blocks: int, do=None, *, causal: bool = True,
                      softclamp_value: float | None = 50.0, scale: float | None = None):
    """The flash ring of `num_blocks` virtual ranks in one process, through
    the same step functions: q, k, v hold the whole sequence, virtual rank
    r its r-th slice of n / num_blocks rows. The steps run in the ring's
    order (step outer, rank inner), so every sum adds in the order the
    distributed ring's does. Returns (out, lse), and with `do` also
    (dq, dk, dv)."""
    cfg = dict(softclamp_value=softclamp_value, causal=causal, scale=scale)
    P = num_blocks
    n = q.shape[-2] // P
    rows = lambda t, r: t[..., r * n:(r + 1) * n, :].contiguous()
    qs = [rows(q, r) for r in range(P)]
    ks, vs = [rows(k, r) for r in range(P)], [rows(v, r) for r in range(P)]
    state = [_fwd_init(qr) for qr in qs]
    for step in range(P):
        for r in range(P):
            src = (r - step) % P
            state[r] = flash_ring_fwd_step(qs[r], ks[src], vs[src], ring_offset(r, step, P, n),
                                           *state[r], **cfg)
    outs = [o.to(q.dtype) for o, _ in state]
    out, lse = torch.cat(outs, dim=-2), torch.cat([l for _, l in state], dim=-1)
    if do is None:
        return out, lse
    dos = [rows(do, r) for r in range(P)]
    dq = [torch.zeros(qr.shape, device=q.device) for qr in qs]
    dk = [torch.zeros(kr.shape, device=k.device) for kr in ks]
    dv = [torch.zeros(vr.shape, device=v.device) for vr in vs]
    for step in range(P):
        for r in range(P):
            src = (r - step) % P
            dq[r], dk[src], dv[src] = flash_ring_bwd_step(
                qs[r], ks[src], vs[src], outs[r], state[r][1], dos[r],
                ring_offset(r, step, P, n), dq[r], dk[src], dv[src], **cfg)
    cat = lambda ts, dtype: torch.cat(ts, dim=-2).to(dtype)
    return out, lse, (cat(dq, q.dtype), cat(dk, k.dtype), cat(dv, v.dtype))


# ------------------------------------------------ global tokens in and out

class _SplitRows(torch.autograd.Function):
    """This rank's slice of the rows (dim -2) of a tensor every rank holds
    whole; the gradient gathers the ranks' row gradients (the pair of
    `_GatherRows`)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        n = t.shape[-2] // size
        return t[..., rank * n:(rank + 1) * n, :].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_rows(grad, ctx.group), None


class _GatherRows(torch.autograd.Function):
    """The ranks' row slices concatenated in rank order; the gradient keeps
    this rank's rows."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_gather_rows(t, group)

    @staticmethod
    def backward(ctx, grad):
        size, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        n = grad.shape[-2] // size
        return grad[..., rank * n:(rank + 1) * n, :].contiguous(), None


def _all_gather_rows(t, group):
    t = t.contiguous()
    parts = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=-2)


def split_rows(t, group):
    return _SplitRows.apply(t, group)


def gather_rows(t, group):
    return _GatherRows.apply(t, group)


def ring_attention_global(q, k, v, group, *, causal: bool = True,
                          softclamp_value: float | None = 50.0, use_flash: bool = False):
    """Global tokens in and out: every rank of `group` holds the whole
    (b, h, N, d) q, k, v; each runs the ring on its N / P rows and the
    output is gathered whole on every rank. Gradients flow back exactly
    once to each row (`_SplitRows` / `_GatherRows`)."""
    group = process_group(group)
    size = dist.get_world_size(group)
    if q.shape[-2] % size:
        raise ValueError(f'sequence length {q.shape[-2]} does not split over {size} ranks')
    q_l, k_l, v_l = (split_rows(t, group) for t in (q, k, v))
    out = ring_attend(q_l, k_l, v_l, group, causal=causal, softclamp_value=softclamp_value,
                      use_flash=use_flash)
    return gather_rows(out, group)


def make_ring_attention(mesh, axis_name: str, causal: bool = True,
                        softclamp_value: float | None = 50.0):
    """Whole (b, h, N, d) q, k, v in, the sequence split over the mesh axis
    `axis_name`, ring-attended (the plain ring, as the counterpart's), and
    the output gathered whole."""
    group = mesh.get_group(axis_name)
    return lambda q, k, v: ring_attention_global(q, k, v, group, causal=causal,
                                                 softclamp_value=softclamp_value)
