"""The attention pools' and `rms_normalize`'s kernel ops (`ops/attn_pool.py`)
on the CPU, where they do not run: the ops take CUDA tensors only.

The backward the CUDA kernels implement is written in plain torch
(`pool_attend_bwd_reference`, `rms_normalize_bwd_reference`); in float64 it
matches autograd of the plain code (`_StreamingPoolAttention` as it runs on
the CPU) for q, k, v, the gate logits and the head-norm scale, at L = 1, 3
and 17 layers and at a token count that is a multiple of no block. On CPU
parameters the pool, `rms_normalize` and a whole trunk take the plain code:
the outputs are bitwise those of the plain formulas, and the kernel ops are
never called. The kernels themselves are held against the plain code on a
card (`tests/test_torch_cuda.py`).
"""
from contextlib import nullcontext

import pytest
import torch

from dreamer4_torch.models.transformer import AxialSpaceTimeTransformer
from dreamer4_torch.nn import attention
from dreamer4_torch.nn.attention import AttentionPool, _StreamingPoolAttention, rms_normalize
from dreamer4_torch.ops import attn_pool
from dreamer4_torch.ops.utils import softclamp

torch.set_num_threads(2)
H, DH = 4, 64


def pool_inputs(L, N, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float64)
    q = rand(N, H * DH)
    k, v = rand(L, N, H * DH), rand(L, N, H * DH)
    scale = (1.0 + 0.3 * rand(H, DH)) * DH ** 0.5
    gates = rand(N, H)
    return [t.to(dtype).requires_grad_() for t in (q, k, v, scale, gates)]


def plain_pool(q, k, v, scale, gate_logits, softclamp_value=50.0):
    """The pool's plain code (`_StreamingPoolAttention.forward` after the
    projections), in the inputs' dtype."""
    L, N, _ = k.shape
    q = q.reshape(N, H, DH)
    k, v = k.reshape(L, N, H, DH), v.reshape(L, N, H, DH)
    inv = torch.rsqrt(k.float().square().sum(dim=-1, keepdim=True) + 1e-12)
    k = k * inv.to(k.dtype) * scale.to(k.dtype)
    sim = torch.einsum('bhd,lbhd->bhl', q.double(), k.double()) * DH ** -0.5
    if softclamp_value is not None:
        sim = softclamp(sim, softclamp_value)
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    out = torch.einsum('bhl,lbhd->bhd', attn, v)
    return (out * torch.sigmoid(gate_logits)[..., None]).reshape(N, H * DH)


def grads(fn, inputs, dout):
    inputs = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*inputs)
    return out, torch.autograd.grad(out, inputs, dout)


@pytest.mark.parametrize('softclamp_value', [50.0, None])
@pytest.mark.parametrize('L, N', [(3, 37), (17, 37), (17, 9)])
def test_reference_backward_matches_autograd_of_the_plain_pool(L, N, softclamp_value):
    """Float64 autograd of the plain pool (float32 key statistic kept, so the
    tolerance is the statistic's float32 rounding, about 1e-7 relative)
    against the kernel's formulas."""
    inputs = pool_inputs(L, N)
    dout = torch.randn(N, H * DH, generator=torch.Generator().manual_seed(1),
                       dtype=torch.float64)
    _, want = grads(lambda *a: plain_pool(*a, softclamp_value=softclamp_value), inputs, dout)
    got = attn_pool.pool_attend_bwd_reference(*[t.detach() for t in inputs], dout,
                                              softclamp_value=softclamp_value)
    for name, a, b in zip(('dq', 'dk', 'dv', 'dscale', 'dgate'), got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * b.abs().max().item(),
                                   msg=lambda m: f'{name}: {m}')


@pytest.mark.parametrize('softclamp_value', [50.0, None])
def test_reference_backward_at_one_layer(softclamp_value):
    """At L = 1 the softmax is 1: the formulas give q, k and the scale no
    gradient beyond rounding, and v and the gate logits autograd's."""
    inputs = pool_inputs(1, 37)
    dout = torch.randn(37, H * DH, generator=torch.Generator().manual_seed(1),
                       dtype=torch.float64)
    _, want = grads(lambda *a: plain_pool(*a, softclamp_value=softclamp_value), inputs, dout)
    got = attn_pool.pool_attend_bwd_reference(*[t.detach() for t in inputs], dout,
                                              softclamp_value=softclamp_value)
    for a in got[:2] + got[3:4]:
        assert a.abs().max().item() < 1e-12
    for a, b in zip(got[2:5:2], want[2:5:2]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * b.abs().max().item())


@pytest.mark.parametrize('shape', [(7, 64), (2, 3, 5, 40)])
def test_rms_reference_backward_matches_autograd(shape):
    """Against autograd of the plain `rms_normalize` in float64 (its
    statistic in float32, hence 1e-6)."""
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    dy = torch.randn(*shape, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    xr = x.clone().requires_grad_()
    want = torch.autograd.grad(rms_normalize(xr), xr, dy)[0]
    torch.testing.assert_close(attn_pool.rms_normalize_bwd_reference(x, dy), want,
                               rtol=1e-6, atol=1e-6)


def float64_pool(seed=0):
    torch.manual_seed(seed)
    pool = AttentionPool(48, device='cpu').double()
    with torch.no_grad():
        for p in pool.parameters():
            p.add_(0.2 * torch.randn_like(p))
    return pool


TRUNK = dict(dim=32, depth=4, attn_heads=2, attn_dim_head=16, time_block_every=2,
             num_special_tokens=1)


def refuse(*a, **k):
    raise AssertionError('a kernel op was called on the CPU path')


@pytest.mark.parametrize('dtype', [None, torch.bfloat16])
def test_cpu_pool_takes_the_plain_code(monkeypatch, dtype):
    """CPU parameters, float32 or bf16 compute: the pool's output is bitwise
    the plain formula's on the module's own weights, and no kernel op runs."""
    monkeypatch.setattr(attn_pool, 'pool_attend', refuse)
    monkeypatch.setattr(attn_pool, 'rms_normalize', refuse)
    torch.manual_seed(1)
    mod = _StreamingPoolAttention(48, H, DH, dtype=dtype, device='cpu')
    g = torch.Generator().manual_seed(6)
    x = torch.randn(13, 48, generator=g)
    stack = torch.stack([rms_normalize(torch.randn(13, 48, generator=g)) for _ in range(5)])
    cdt = dtype or torch.float32
    if dtype is not None:
        x, stack = x.to(dtype), stack.to(dtype)
    got = mod(x, stack)

    tn = mod.norm(x)
    q = mod.to_q(tn)
    cscale = mod.norm_context.scale.to(cdt)[:, None]
    k = stack @ (cscale * mod.to_k.kernel.to(cdt))
    v = stack @ (cscale * mod.to_v.kernel.to(cdt))
    gamma_scale = ((mod.k_norm.gamma + 1.0) * DH ** 0.5).to(cdt)
    k = k.reshape(5, 13, H, DH)
    inv = torch.rsqrt(k.float().square().sum(dim=-1, keepdim=True) + 1e-12)
    k = k * inv.to(k.dtype) * gamma_scale
    sim = torch.einsum('bhd,lbhd->bhl', q.reshape(13, H, DH).float(), k.float()) * DH ** -0.5
    attn = torch.softmax(softclamp(sim, 50.0), dim=-1).to(cdt)
    out = torch.einsum('bhl,lbhd->bhd', attn, v.reshape(5, 13, H, DH))
    want = mod.to_out((out * torch.sigmoid(mod.to_gates(tn))[..., None]).reshape(13, H * DH))
    assert torch.equal(got, want)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_cpu_rms_normalize_takes_the_plain_code(monkeypatch, dtype):
    """`rms_normalize` on the CPU is the plain formula bit for bit, and with
    `out` (the trunk's no-grad slot, here of another dtype) it writes that
    result cast to the slot's dtype."""
    monkeypatch.setattr(attn_pool, 'rms_normalize', refuse)
    x = torch.randn(6, 40, generator=torch.Generator().manual_seed(7)).to(dtype)
    want = x * torch.rsqrt(x.float().square().mean(dim=-1, keepdim=True) + 1e-6).to(dtype)
    assert torch.equal(rms_normalize(x), want)
    slot = torch.empty(6, 40, dtype=torch.bfloat16)
    assert rms_normalize(x, out=slot) is slot
    assert torch.equal(slot, want.to(torch.bfloat16))


def test_cpu_trunk_takes_the_plain_code(monkeypatch):
    """A depth-4 trunk on the CPU, with grad (stacked hiddens) and without
    (the preallocated stack): no kernel op runs, and each pass calls the
    plain pool once a layer (L = 3, 5, 7, then the final pool's 9) and the
    plain normalization once a hidden (1 + 2 x depth), the counts the
    kernels launch at on the card."""
    monkeypatch.setattr(attn_pool, 'pool_attend', refuse)
    monkeypatch.setattr(attn_pool, 'rms_normalize', refuse)
    layers, norms = [], []
    pool_plain, norm_plain = attention.pool_attend_plain, attention.rms_normalize_plain

    def counted_pool(q, k, *a, **kw):
        layers.append(k.shape[0])
        return pool_plain(q, k, *a, **kw)

    def counted_norm(*a, **kw):
        norms.append(1)
        return norm_plain(*a, **kw)

    monkeypatch.setattr(attention, 'pool_attend_plain', counted_pool)
    monkeypatch.setattr(attention, 'rms_normalize_plain', counted_norm)
    torch.manual_seed(0)
    trunk = AxialSpaceTimeTransformer(**TRUNK, device='cpu')
    x = torch.randn(2, 3, 5, 32, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        trunk(x)
    trunk(x)[0].sum().backward()
    depth = TRUNK['depth']
    assert layers == 2 * [3, 5, 7, 9]
    assert len(norms) == 2 * (1 + 2 * depth)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_ops_take_cuda_tensors_only(dtype):
    """The ops refuse CPU tensors; the callers keep them on the plain code."""
    q, k, v, scale, gates = [t.detach().to(dtype) for t in pool_inputs(3, 5)]
    with pytest.raises(ValueError, match='CUDA'):
        attn_pool.pool_attend(q, k, v, scale, gates)
    with pytest.raises(ValueError, match='CUDA'):
        attn_pool.rms_normalize(q)


def test_routing_gate():
    """The kernels are built for the pool's 4 heads of 64 and a layer or
    more, and the norm for a width that is a multiple of 8: the ops raise on
    anything else (checked before a launch). The backward's grid is a block
    for 8 tokens, at most MAX_BWD_BLOCKS."""
    scale = torch.ones(H, DH)
    assert attn_pool._pool_cfg(torch.zeros(17, 3, H * DH), scale, 50.0)[0] == 17
    assert attn_pool._pool_cfg(torch.zeros(1, 3, H * DH), scale, None)[2] == 0.0
    for layers, heads, dim_head in ((17, 8, 64), (0, 4, 64), (3, 2, 128)):
        with pytest.raises(ValueError):
            attn_pool._pool_cfg(torch.zeros(layers, 3, heads * dim_head),
                                torch.ones(heads, dim_head), 50.0)
    assert attn_pool._rms_rows(torch.zeros(2, 3, 512)) == (6, 512)
    with pytest.raises(ValueError):
        attn_pool._rms_rows(torch.zeros(2, 36))
    assert attn_pool.bwd_blocks(41_472) == attn_pool.MAX_BWD_BLOCKS
    assert attn_pool.bwd_blocks(9) == 2 and attn_pool.bwd_blocks(1) == 1


def test_ops_refuse_what_they_do_not_take():
    q, k, v, scale, gates = [t.detach() for t in pool_inputs(3, 5)]
    with pytest.raises(ValueError):
        attn_pool.pool_attend(q, k[:, :4], v, scale, gates)
    with pytest.raises(ValueError):
        attn_pool.pool_attend(q, k, v, scale, gates[:, :2])
    with pytest.raises(ValueError):
        attn_pool.pool_attend(q, k, v.float(), scale, gates)
    with pytest.raises(ValueError):
        attn_pool.pool_attend(q, k, v, scale, gates, softclamp_value=0.0)
    x = torch.randn(3, 8, requires_grad=True)
    with pytest.raises(ValueError):
        attn_pool.rms_normalize(x, out=torch.empty(3, 8))
    with pytest.raises(ValueError):
        attn_pool.rms_normalize(x.detach(), out=torch.empty(3, 8, dtype=torch.float64))


def test_pool_call_is_a_span(monkeypatch):
    """Each `AttentionPool` call opens `dreamer4.attention_pool`."""
    opened = []
    monkeypatch.setattr(attention, 'span', lambda name: opened.append(name) or nullcontext())
    pool = float64_pool()
    pool(torch.randn(3, 48, dtype=torch.float64), [torch.randn(3, 48, dtype=torch.float64)])
    assert opened == ['dreamer4.attention_pool']
