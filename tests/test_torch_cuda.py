"""The port's CUDA kernel K1 (`csrc/flash_attn_fwd.cu`) on a card, against
its plain PyTorch version `flash_attend_reference`. Every test here needs a
CUDA device and skips without one: a hand-written kernel has no CPU or
interpret mode. This file imports torch and the port only, so it runs on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: float32 1e-4 (the two differ in summation order only); bf16
2e-2 (one rounding of the output, 1.6e-2 at |o| < 4, and of p before PV).
"""
import pytest
import torch

from dreamer4_torch.models.transformer import AxialSpaceTimeTransformer
from dreamer4_torch.ops import flash_attention as fa

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU or interpret mode')
    return torch.Generator(device='cuda').manual_seed(0)


def qkv(gen, b, hq, h, n, m, d, dtype):
    return tuple(torch.randn(shape, generator=gen, device='cuda').to(dtype)
                 for shape in ((b, hq, n, d), (b, h, m, d), (b, h, m, d)))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('d', fa.SUPPORTED_HEAD_DIMS)
def test_kernel_matches_plain_version(gen, dtype, d):
    """Ragged N and M, GQA, causal with an offset, a kv_len inside the
    buffer and periodic special tokens, with the LSE."""
    q, k, v = qkv(gen, 3, 4, 2, 70, 90, d, dtype)
    cfg = dict(softclamp_value=50.0, causal=True, num_special=1, special_seq_len=9)
    before = fa.LAUNCHES
    out, lse = fa.flash_attend(q, k, v, 5, 80, return_lse=True, **cfg)
    assert fa.LAUNCHES == before + 1
    ref, ref_lse = fa.flash_attend_reference(q, k, v, 5, 80, return_lse=True, **cfg)
    assert out.dtype == dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['prefill', 'decode', 'space_only_itself', 'no_softclamp'])
def test_kernel_rollout_masks(gen, case):
    """The rollout's shapes, cut in batch: the prompt pass over a longer
    cache buffer, a cached decode step, and space attention with a special
    token."""
    shape, cfg, offset, kv_len = {
        'prefill': ((8, 8, 8, 96, 192, 64), dict(causal=True), 0, 96),
        'decode': ((8, 8, 8, 1, 192, 64), dict(causal=True), 4, 5),
        'space_only_itself': ((8, 8, 8, 144, 144, 64),
                              dict(num_special=1, special_seq_len=144,
                                   special_attend_only_itself=True), 0, 144),
        'no_softclamp': ((8, 8, 4, 128, 128, 64), dict(causal=True, softclamp_value=None),
                         0, 128),
    }[case]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(gen, *shape, dtype)
        out = fa.flash_attend(q, k, v, offset, kv_len, **cfg)
        ref = fa.flash_attend_reference(q, k, v, offset, kv_len, **cfg)
        assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n, kv_len, causal', [(96, 96, True), (7, 80, False)])
def test_rows_beyond_kv_len_do_not_reach_the_output(gen, dtype, n, kv_len, causal):
    """Cache rows at and beyond kv_len may hold anything, even non-finite
    values; the output is that of the same cache with those rows zeroed."""
    q, k, v = qkv(gen, 2, 4, 4, n, 192, 64, dtype)
    k_zero, v_zero = k.clone(), v.clone()
    k_zero[:, :, kv_len:] = 0
    v_zero[:, :, kv_len:] = 0
    k[:, :, kv_len:] = float('nan')
    v[:, :, kv_len:] = float('inf')
    out = fa.flash_attend(q, k, v, 0, kv_len, causal=causal)
    ref = fa.flash_attend_reference(q, k_zero, v_zero, 0, kv_len, causal=causal)
    assert bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(gen):
    q, k, v = qkv(gen, 1, 2, 2, 8, 8, 16, torch.float32)
    with pytest.raises(NotImplementedError):
        fa.flash_attend(q.requires_grad_(), k, v, 0, 8)
    with pytest.raises(ValueError):
        fa.flash_attend(q.detach().half(), k.half(), v.half(), 0, 8)
    with pytest.raises(ValueError):
        fa.flash_attend(q.detach().transpose(1, 2).contiguous().transpose(1, 2), k, v, 0, 8)
    with pytest.raises(ValueError):
        fa.flash_attend(*qkv(gen, 1, 2, 2, 8, 8, 48, torch.float32), 0, 8)
    with pytest.raises(ValueError):
        fa.flash_attend(q.detach(), k.cpu(), v, 0, 8)


@pytest.mark.cuda
def test_trunk_flash_branch_matches_plain_branch(gen):
    """A small trunk on the card with the flash gate at 1: every attention
    of a prefill runs K1 and agrees with the same trunk on the plain path."""
    torch.manual_seed(0)
    trunk = AxialSpaceTimeTransformer(dim=64, depth=4, attn_heads=2, attn_dim_head=32,
                                      time_block_every=2, use_flash_attention=True,
                                      flash_min_scores=1, device='cuda')
    x = torch.randn(2, 6, 7, 64, generator=gen, device='cuda')
    with torch.no_grad():
        before = fa.LAUNCHES
        out, cache = trunk(x, max_time=10)
        assert fa.LAUNCHES == before + 4
        step, _ = trunk(x[:, :1], cache=cache)
        trunk.use_flash_attention = False
        ref, ref_cache = trunk(x, max_time=10)
        ref_step, _ = trunk(x[:, :1], cache=ref_cache)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(step, ref_step, atol=1e-4, rtol=1e-4)
