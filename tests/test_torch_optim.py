"""The optimizer kernels' planning on the CPU: where `MuonAdamAtan2`'s
multi-tensor kernels put each Muon update (`muon_stacks`) against the
stacks `batched_orthogonalize` forms, the three-product Newton-Schulz
iteration against the five-product form it replaced, the float32 bias
corrections and the choice of path. The kernels themselves run on a card
(`tests/test_torch_cuda.py`); the plain loop is held against optax in
`tests/test_torch_train.py`.

Tolerances: the two Newton-Schulz forms differ by float32 rounding only
(`baddbmm` sums b A + c A A in one pass): 1e-5 relative to the largest entry
after five iterations of entries of size about 1. Everything else is exact.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dreamer4_torch.models.tokenizer import VideoTokenizer
from dreamer4_torch.models.world_model import DynamicsWorldModel
from dreamer4_torch.train import optim

CONFIGS = Path(__file__).resolve().parent.parent / 'benchmark' / 'configs'
MODELS = {'world_model': (DynamicsWorldModel, 'dreamer4-wm-512.json'),
          'tokenizer': (VideoTokenizer, 'dreamer4-tok-512.json')}
TINY = {'world_model': lambda: DynamicsWorldModel(
            dim=64, dim_latent=8, depth=2, num_spatial_tokens=2, num_latent_tokens=2,
            attn_heads=2, attn_dim_head=16, num_discrete_actions=[4], device='cpu'),
        'tokenizer': lambda: VideoTokenizer(
            dim=64, dim_latent=8, patch_size=8, image_height=16, image_width=16,
            num_latent_tokens=2, encoder_depth=1, decoder_depth=1, device='cpu')}


def muon_group(model):
    opt = optim.MuonAdamAtan2(model)
    return next(g for g in opt.param_groups if g['kind'] == 'muon')


def old_ns_iterate(X, steps):
    """The five-product form on the wide (k, m, n) stack."""
    a, b, c = optim.NS_COEFFS
    for _ in range(steps):
        A = X @ X.transpose(-1, -2)
        B = b * A + c * (A @ A)
        X = a * X + B @ X
    return X


@pytest.mark.parametrize('shape', [(3, 16, 48), (2, 32, 32)])
def test_ns_iterate_equals_the_five_product_form(shape):
    """`_ns_iterate` on the tall stack Y is the transpose of the old form on
    the wide X = Y^T."""
    g = torch.Generator().manual_seed(0)
    X = torch.randn(shape, generator=g)
    X = X / X.square().sum(dim=(-2, -1), keepdim=True).sqrt()
    new, old = optim._ns_iterate(X.mT.contiguous(), 5).mT, old_ns_iterate(X, 5)
    assert (new - old).abs().max().item() <= 1e-5 * old.abs().max().item()


@pytest.mark.parametrize('model', list(MODELS))
def test_muon_stacks_of_the_benchmark_models(model):
    """The benchmark configurations' Muon parameters (on the meta device):
    the stacks are `ns_stacks` of the updates in flax's orientation, each
    parameter's place has its stack's matrix shape and lies inside it, and
    the places tile the buffer."""
    cls, config = MODELS[model]
    kwargs = json.loads((CONFIGS / config).read_text())['kwargs']
    group = muon_group(cls(**kwargs, device='meta'))
    shapes = [tuple(p.shape) for p in group['params']]
    layout = optim.muon_stacks(shapes, group['transposed'])
    flax = [(c, r) if t else (r, c) for (r, c), t in zip(shapes, group['transposed'])]
    stacks = optim.ns_stacks(flax)
    assert [(k, n, m) for _, k, n, m in layout.stacks] == [(len(i), *s) for s, i in stacks]
    # the four shapes of Muon's stacks in both models
    assert sorted((k, n, m) for _, k, n, m in layout.stacks) == [
        (9, 1365, 512), (9, 2730, 512), (16, 512, 256), (18, 512, 512)]
    covered = []
    for i, (shape, t) in enumerate(zip(shapes, group['transposed'])):
        s, pos = layout.slots[i]
        off, k, n, m = layout.stacks[s]
        assert i in stacks[s][1] and stacks[s][1].index(i) == pos
        assert (shape[::-1] if layout.flips[i] else shape) == (n, m)
        assert layout.flips[i] == (t == (flax[i][0] > flax[i][1]))
        assert off <= layout.offset(i) and layout.offset(i) + n * m <= off + k * n * m
        covered.append((layout.offset(i), n * m))
    covered.sort()
    assert covered[0][0] == 0 and sum(n for _, n in covered) == layout.size
    assert all(a + n == b for (a, n), (b, _) in zip(covered, covered[1:]))


@pytest.mark.parametrize('model', list(TINY))
def test_muon_stacks_hold_what_batched_orthogonalize_stacks(model, monkeypatch):
    """Updates written into the flat buffer as the kernels write them (each
    in its torch layout, or transposed where `flips` says so) are, stack by
    stack, the normalized matrices `batched_orthogonalize` hands to
    Newton-Schulz (float32), and reading each place back in the torch layout
    gives `batched_orthogonalize`'s result for that parameter."""
    group = muon_group(TINY[model]())
    shapes = [tuple(p.shape) for p in group['params']]
    transposed = group['transposed']
    assert len(set(shapes)) > 2 and any(transposed) and not all(transposed)
    layout = optim.muon_stacks(shapes, transposed)
    assert any(layout.flips) and not all(layout.flips)
    g = torch.Generator().manual_seed(0)
    updates = [torch.randn(s, generator=g) for s in shapes]

    recorded = []
    monkeypatch.setattr(optim, '_ns_iterate', lambda X, steps: recorded.append(X) or X)
    flax = [u.T if t else u for u, t in zip(updates, transposed)]
    orthed = optim.batched_orthogonalize(flax, ns_dtype=torch.float32)

    flat = torch.zeros(layout.size)
    for i, u in enumerate(updates):
        n = u.numel()
        flat[layout.offset(i):layout.offset(i) + n] = (u.T if layout.flips[i] else u).flatten()
    assert len(recorded) == len(layout.stacks)
    for X, (off, k, n, m) in zip(recorded, layout.stacks):
        stack = flat[off:off + k * n * m].view(k, n, m)
        norm = stack.square().sum(dim=(-2, -1), keepdim=True).sqrt()
        assert torch.equal(X, stack / (norm + optim.NS_EPS))
    for i, (o, t) in enumerate(zip(orthed, transposed)):
        s, pos = layout.slots[i]
        read = recorded[s][pos]
        read = read.T if layout.flips[i] else read
        assert torch.equal(read, o.T if t else o)


def test_bias_correction_is_the_float32_power():
    for beta in (0.9, 0.99, 0.999):
        for count in (1, 2, 3, 10, 100, 1000, 12345):
            want = float(1 - torch.tensor(beta) ** torch.tensor(float(count)))
            assert optim.bias_correction(beta, count) == want
            assert np.float32(want) == want


def test_the_path_follows_the_parameters():
    model = TINY['world_model']()
    assert optim.MuonAdamAtan2(model)._kernel_device() is None       # CPU: the plain loop
    meta = DynamicsWorldModel(dim=64, dim_latent=8, depth=2, num_spatial_tokens=2,
                              num_latent_tokens=2, attn_heads=2, attn_dim_head=16,
                              num_discrete_actions=[4], device='meta')
    with pytest.raises(ValueError, match='one CUDA device'):
        optim.MuonAdamAtan2(meta)._kernel_device()
