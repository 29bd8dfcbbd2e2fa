"""The GLU feedforward's kernel op (`ops/glu_ff.py`) on the CPU, where its
kernels do not run: the op takes CUDA tensors only.

The four kernels are written in plain torch (`pack_reference`,
`glu_fwd_reference`, `glu_bwd_reference`, `unpack_reference`). With them in
the launchers' place, the op's autograd function (the padded layout, the six
matrix products, the bias sums and the unpacking) is held in float32 against
autograd of `FeedForward`'s plain code: the output and the gradients of the
input and of the four parameters, at the inner width 1365 (dim 512, padded
to 1368) and at an aligned one (dim 384, 1024: no pads), an odd row count,
silu and tanh gelu. Tolerance: 2e-6 of each tensor's largest entry, float32
summation order (the padded products add exact zeros, but may block their
sums otherwise). The pads of every padded operand are exact zeros, also
where the hidden's pads hold NaN. CPU tensors take the plain code, bitwise.
The kernels themselves are held against the plain code on a card
(`tests/test_torch_cuda.py`).
"""
import pytest
import torch

from dreamer4_torch.nn.attention import FeedForward
from dreamer4_torch.ops import glu_ff

torch.set_num_threads(2)
REFERENCES = dict(_pack=glu_ff.pack_reference, _glu_fwd=glu_ff.glu_fwd_reference,
                  _glu_bwd=glu_ff.glu_bwd_reference, _unpack=glu_ff.unpack_reference)


@pytest.fixture
def references(monkeypatch):
    """The op's launchers replaced by the kernels' plain references."""
    for name, fn in REFERENCES.items():
        monkeypatch.setattr(glu_ff, name, fn)


def feedforward(dim, activation, seed=0):
    torch.manual_seed(seed)
    ff = FeedForward(dim, activation=activation, device='cpu')
    with torch.no_grad():
        ff.proj_in.bias.normal_(0.0, 0.5)
        ff.proj_out.bias.normal_(0.0, 0.5)
    return ff


def params(ff):
    return [ff.proj_in.weight, ff.proj_in.bias, ff.proj_out.weight, ff.proj_out.bias]


def close(got, want, name):
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6 * want.abs().max().item(),
                               msg=lambda m: f'{name}: {m}')


@pytest.mark.parametrize('activation', ['silu', 'gelu'])
@pytest.mark.parametrize('dim, f, P', [(512, 1365, 1368), (384, 1024, 1024)])
def test_padded_op_matches_autograd_of_the_plain_feedforward(references, dim, f, P, activation):
    ff = feedforward(dim, activation)
    assert ff.proj_out.weight.shape == (dim, f) and glu_ff.padded_width(f) == P
    g = torch.Generator().manual_seed(1)
    x = torch.randn(37, dim, generator=g)
    dy = torch.randn(37, dim, generator=g)

    xr = x.clone().requires_grad_()
    want_y = ff._plain(xr)
    want = torch.autograd.grad(want_y, [xr, *params(ff)], dy)

    xg = x.clone().requires_grad_()
    got_y = glu_ff._GluFeedForward.apply(xg, *params(ff), activation, torch.float32)
    got = torch.autograd.grad(got_y, [xg, *params(ff)], dy)
    close(got_y, want_y, 'y')
    for name, a, b in zip(('dx', 'dW_in', 'db_in', 'dW_out', 'db_out'), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        close(a, b, name)
    with torch.no_grad():
        close(glu_ff._forward(x, params(ff), activation, torch.float32)[0], want_y, 'no-grad y')


def test_frozen_parameters_get_no_gradient(references, monkeypatch):
    """Only the input asks for a gradient: the parameters' products and the
    unpacking are skipped and the input's gradient is autograd's."""
    ff = feedforward(48, 'silu')
    for p in ff.parameters():
        p.requires_grad_(False)
    x = torch.randn(5, 48, generator=torch.Generator().manual_seed(2), requires_grad=True)
    called = []
    monkeypatch.setattr(glu_ff, '_unpack', lambda *a: called.append(a))
    y = glu_ff._GluFeedForward.apply(x, *params(ff), 'silu', torch.float32)
    dx = torch.autograd.grad(y.square().sum(), x)[0]
    xr = x.detach().clone().requires_grad_()
    want = torch.autograd.grad(ff._plain(xr).square().sum(), xr)[0]
    close(dx, want, 'dx')
    assert called == []


@pytest.mark.parametrize('activation', ['silu', 'gelu'])
def test_every_pad_is_an_exact_zero(activation):
    """The packed weights' pad rows and columns, a's pad columns and dh's
    pad columns in both halves are exact zeros, whatever the hidden's pads
    hold (NaN here)."""
    ff = feedforward(512, activation)
    f, P = 1365, 1368
    w_in_p, b_in_p, w_out_p, b_out = glu_ff.pack_reference(*params(ff), torch.bfloat16, f, P)
    for t in (w_in_p[f:P], w_in_p[P + f:], b_in_p[f:P], b_in_p[P + f:], w_out_p[:, f:]):
        assert t.numel() and bool((t == 0).all())
    assert torch.equal(w_in_p[:f], ff.proj_in.weight[:f].to(torch.bfloat16))
    assert torch.equal(w_in_p[P:P + f], ff.proj_in.weight[f:].to(torch.bfloat16))
    assert torch.equal(w_out_p[:, :f], ff.proj_out.weight.to(torch.bfloat16))
    assert torch.equal(b_out, ff.proj_out.bias.to(torch.bfloat16))

    g = torch.Generator().manual_seed(3)
    h = torch.randn(11, 2 * P, generator=g).to(torch.bfloat16)
    h[:, f:P] = float('nan')
    h[:, P + f:] = float('nan')
    a = glu_ff.glu_fwd_reference(h, f, activation)
    dh = glu_ff.glu_bwd_reference(torch.randn(11, P, generator=g).to(torch.bfloat16), h, f,
                                  activation)
    assert a.shape == (11, P) and dh.shape == (11, 2 * P)
    assert bool((a[:, f:] == 0).all()) and bool(torch.isfinite(a).all())
    assert bool((dh[:, f:P] == 0).all()) and bool((dh[:, P + f:] == 0).all())
    assert bool(torch.isfinite(dh).all())


def test_the_op_refuses_what_its_kernels_do_not_take():
    ff = feedforward(48, 'silu')
    x = torch.randn(3, 48)
    with pytest.raises(ValueError, match='activations'):
        glu_ff.glu_feedforward(x, *params(ff), 'relu', torch.float32)
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        glu_ff.glu_feedforward(x, *params(ff), 'silu', torch.float16)
    with pytest.raises(ValueError, match='CUDA'):
        glu_ff.glu_feedforward(x, *params(ff), 'silu', torch.float32)


@pytest.mark.parametrize('dtype', [None, torch.bfloat16])
def test_cpu_feedforward_takes_the_plain_code(monkeypatch, dtype):
    """CPU parameters: the output is bitwise the plain formula's and the op
    is never called."""
    def refuse(*a, **k):
        raise AssertionError('the kernel op was called on the CPU path')

    monkeypatch.setattr(glu_ff, 'glu_feedforward', refuse)
    torch.manual_seed(4)
    ff = FeedForward(64, dtype=dtype, device='cpu')
    x = torch.randn(2, 7, 64)
    dt = dtype or torch.float32
    xn = ff.norm(x)
    h = torch.nn.functional.linear(xn.to(dt), ff.proj_in.weight.to(dt), ff.proj_in.bias.to(dt))
    v, gates = h.chunk(2, dim=-1)
    want = torch.nn.functional.linear(v * torch.nn.functional.silu(gates),
                                      ff.proj_out.weight.to(dt), ff.proj_out.bias.to(dt))
    assert torch.equal(ff(x), want)
