"""The port's CUDA kernels on a card, each against its plain PyTorch
version: K1 (`csrc/flash_attn_fwd.cu`) against `flash_attend_reference`, K2
(`csrc/flash_attn_bwd_dq.cu`) against `bwd_dq_reference`, K3
(`csrc/flash_attn_bwd_dkv.cu`) against `bwd_dkv_reference`, K4
(`csrc/small_attn_fwd.cu`) against `small_attend_flat_reference` and K5
(`csrc/small_attn_bwd.cu`) against `small_attend_flat_bwd_reference`. Every test here
needs a CUDA device and skips without one: a hand-written kernel has no CPU
or interpret mode. This file imports torch and the port only, so it runs on
a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances. K1: float32 1e-4 (the two differ in summation order only);
bf16 2e-2 (one rounding of the output, 1.6e-2 at |o| < 4, and of p before
PV). K2/K3, as a fraction of the largest gradient entry: float32 2e-4 (the
kernels' one-exponential softclamp moves a score by up to about c * 1e-6,
hence p by that relative amount, plus summation order); bf16 1e-2 (one
rounding of each output, 2^-9 of it, plus ds and p rounded to bf16 at the
TPU kernel's points, where the kernel and the plain version may round a
value that differs in its last float32 bits to neighbouring bf16 values).
K4 takes K1's tolerances and K5 those of K2/K3, for the same reasons.
"""
import pytest
import torch

from dreamer4_torch.models.tokenizer import VideoTokenizer
from dreamer4_torch.models.transformer import AxialSpaceTimeTransformer
from dreamer4_torch.ops import flash_attention as fa
from dreamer4_torch.ops import small_attention as sa
from dreamer4_torch.ops.masks import build_attend_mask

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GRAD_TOL = {torch.float32: 2e-4, torch.bfloat16: 1e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU or interpret mode')
    return torch.Generator(device='cuda').manual_seed(0)


def k1_launches():
    return sum(fa.K1_LAUNCHES.values())


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
    before = k1_launches()
    out, lse = fa.flash_attend(q, k, v, 5, 80, return_lse=True, **cfg)
    assert k1_launches() == before + 1
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


# K1's wgmma kernel (`k1_variant` 'sm90'): (B, Hq, H, N, M, D, offset,
# kv_len, mask config) of the shapes its 64-row tiles and warpgroups must
# meet: the train step's time attention and a longer walk, ragged N = M,
# head dim 128 with GQA, kv_len inside a tile, both signs of the offset,
# special tokens in both directions, the rollout's prefill, a cached decode
# step and a handful of query rows in one tile
K1_SM90_CASES = {
    't1024': ((2, 8, 8, 1024, 1024, 64, 0, 1024), dict(causal=True)),
    't2048': ((1, 8, 8, 2048, 2048, 64, 0, 2048), dict(causal=True)),
    'n1000': ((2, 8, 8, 1000, 1000, 64, 0, 1000), dict(causal=True)),
    'head_dim_128_gqa': ((2, 8, 4, 512, 512, 128, 0, 512), dict(causal=True)),
    'head_dim_128_ragged': ((3, 4, 2, 77, 130, 128, 3, 101),
                            dict(causal=True, softclamp_value=30.0)),
    'kv_len_in_tile_offset': ((2, 4, 4, 100, 256, 64, 37, 137), dict(causal=True)),
    'negative_offset': ((2, 4, 4, 100, 96, 64, -7, 96), dict(causal=True)),
    'space_special': ((4, 8, 8, 144, 144, 64, 0, 144), dict(num_special=1, special_seq_len=144)),
    'space_special_only_itself': ((4, 8, 8, 144, 144, 64, 0, 144),
                                  dict(num_special=1, special_seq_len=144,
                                       special_attend_only_itself=True)),
    'special_period_offset': ((3, 4, 2, 130, 192, 64, 20, 150),
                              dict(causal=True, num_special=2, special_seq_len=9)),
    'prefill': ((8, 8, 8, 96, 192, 64, 0, 96), dict(causal=True)),
    'decode': ((8, 8, 8, 1, 192, 64, 4, 5), dict(causal=True)),
    # SimTrainer's dynamics step at the bench width: b16 rollouts padded to
    # 151 frames, 16 x 27 rows
    'sim': ((432, 8, 8, 151, 151, 64, 0, 151), dict(causal=True)),
    'few_queries_gqa': ((3, 8, 4, 13, 200, 128, 150, 163), dict(causal=True)),
    'no_softclamp': ((4, 8, 4, 128, 128, 64, 0, 128), dict(causal=True, softclamp_value=None)),
}


def seen_rows(shape, cfg):
    """The query rows that see some key: a row that sees none has no
    softmax, and the kernels and the plain version fill it differently."""
    B, Hq, H, N, M, D, offset, kv_len = shape
    return fa.attend_mask(N, M, offset, kv_len, device='cuda', **{
        x: cfg[x] for x in ('causal', 'num_special', 'special_seq_len',
                            'special_attend_only_itself') if x in cfg}).any(-1)


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(K1_SM90_CASES))
def test_sm90_forward_matches_plain_version(gen, monkeypatch, case):
    """bf16 through the wgmma kernel (forced where `k1_variant` would route
    the shape elsewhere), o and its LSE."""
    shape, cfg = K1_SM90_CASES[case]
    B, Hq, H, N, M, D, offset, kv_len = shape
    monkeypatch.setattr(fa, 'k1_variant', lambda *_: 'sm90')
    q, k, v = qkv(gen, B, Hq, H, N, M, D, torch.bfloat16)
    before = fa.K1_LAUNCHES['sm90']
    out, lse = fa.flash_attend(q, k, v, offset, kv_len, return_lse=True, **cfg)
    torch.cuda.synchronize()
    assert fa.K1_LAUNCHES['sm90'] == before + 1
    ref, ref_lse = fa.flash_attend_reference(q, k, v, offset, kv_len, return_lse=True, **cfg)
    rows = seen_rows(shape, cfg)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out).all())
    assert (out.float() - ref.float())[:, :, rows].abs().max().item() <= TOL[torch.bfloat16]
    assert (lse - ref_lse)[:, :, rows].abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize('variant', ['mma', 'sm90'])
@pytest.mark.parametrize('case', ['t1024', 'special_period_offset', 'head_dim_128_ragged',
                                  'prefill', 'decode'])
def test_bf16_variants_agree(gen, monkeypatch, case, variant):
    """Either bf16 kernel, forced, at the same shape: each within the bf16
    tolerance of the plain version."""
    shape, cfg = K1_SM90_CASES[case]
    B, Hq, H, N, M, D, offset, kv_len = shape
    monkeypatch.setattr(fa, 'k1_variant', lambda *_: variant)
    q, k, v = qkv(gen, B, Hq, H, N, M, D, torch.bfloat16)
    before = fa.K1_LAUNCHES[variant]
    out = fa.flash_attend(q, k, v, offset, kv_len, **cfg)
    assert fa.K1_LAUNCHES[variant] == before + 1
    ref = fa.flash_attend_reference(q, k, v, offset, kv_len, **cfg)
    assert (out.float() - ref.float())[:, :, seen_rows(shape, cfg)].abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize('d, kv_len', [(64, 100), (64, 128), (128, 77)])
def test_sm90_rows_beyond_kv_len_do_not_reach_the_output(gen, monkeypatch, d, kv_len):
    """The wgmma kernel's k/v tensor maps end at kv_len: NaN and Inf in the
    cache rows after it (also inside a 64-row tile) reach no output."""
    monkeypatch.setattr(fa, 'k1_variant', lambda *_: 'sm90')
    q, k, v = qkv(gen, 2, 4, 4, 256, 320, d, torch.bfloat16)
    k_zero, v_zero = k.clone(), v.clone()
    k_zero[:, :, kv_len:] = 0
    v_zero[:, :, kv_len:] = 0
    k[:, :, kv_len:] = float('nan')
    v[:, :, kv_len:] = float('inf')
    before = fa.K1_LAUNCHES['sm90']
    out, lse = fa.flash_attend(q, k, v, 0, kv_len, return_lse=True)
    assert fa.K1_LAUNCHES['sm90'] == before + 1
    ref, ref_lse = fa.flash_attend_reference(q, k_zero, v_zero, 0, kv_len, return_lse=True)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
    assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16]
    assert (lse - ref_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['t1024', 'special_period_offset', 'head_dim_128_gqa'])
def test_sm90_forward_is_bitwise_reproducible(gen, monkeypatch, case):
    """Nothing is summed across blocks: two runs of the wgmma kernel give
    the same bits of o and the LSE."""
    monkeypatch.setattr(fa, 'k1_variant', lambda *_: 'sm90')
    shape, cfg = K1_SM90_CASES[case]
    B, Hq, H, N, M, D, offset, kv_len = shape
    q, k, v = qkv(gen, B, Hq, H, N, M, D, torch.bfloat16)
    first = fa.flash_attend(q, k, v, offset, kv_len, return_lse=True, **cfg)
    second = fa.flash_attend(q, k, v, offset, kv_len, return_lse=True, **cfg)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(gen):
    q, k, v = qkv(gen, 1, 2, 2, 8, 8, 16, torch.float32)
    with pytest.raises(ValueError):   # the LSE of the backward is float32
        fa.bwd_dq(q, k, v, q, torch.zeros(1, 2, 8, device='cuda').double(), q, 0, 8)
    with pytest.raises(ValueError):   # K2's o is like q
        fa.bwd_dq(q, k, v, q.half(), torch.zeros(1, 2, 8, device='cuda'), q, 0, 8)
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
        before = k1_launches()
        out, cache = trunk(x, max_time=10)
        assert k1_launches() == before + 4
        step, _ = trunk(x[:, :1], cache=cache)
        trunk.use_flash_attention = False
        ref, ref_cache = trunk(x, max_time=10)
        ref_step, _ = trunk(x[:, :1], cache=ref_cache)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(step, ref_step, atol=1e-4, rtol=1e-4)


# K2 / K3: (B, Hq, H, N, M, D, offset, kv_len, mask config) of the kernel
# phase of chip_smoke.py, cut in batch, and shapes the 64-row tiles of the
# Hopper path must meet: a longer causal walk, N = M not a multiple of a
# tile, head dim 128 with GQA, kv_len inside a tile at an offset
BWD_CASES = {
    't1024': ((2, 8, 8, 1024, 1024, 64, 0, 1024), dict(causal=True)),
    't2048': ((1, 8, 8, 2048, 2048, 64, 0, 2048), dict(causal=True)),
    'n1000': ((2, 8, 8, 1000, 1000, 64, 0, 1000), dict(causal=True)),
    'gqa': ((4, 8, 4, 128, 128, 64, 0, 128), dict(causal=True)),
    'space_special': ((8, 8, 8, 144, 144, 64, 0, 144),
                      dict(num_special=1, special_seq_len=144)),
    'space_special_only_itself': ((8, 8, 8, 144, 144, 64, 0, 144),
                                  dict(num_special=1, special_seq_len=144,
                                       special_attend_only_itself=True)),
    'ragged_offset': ((3, 4, 2, 130, 192, 64, 20, 150),
                      dict(causal=True, num_special=2, special_seq_len=9)),
    'negative_offset': ((2, 4, 4, 100, 96, 64, -7, 96), dict(causal=True)),
    'kv_len_in_tile_offset': ((2, 4, 4, 100, 256, 64, 37, 137), dict(causal=True)),
    'no_softclamp': ((4, 8, 4, 128, 128, 64, 0, 128), dict(causal=True, softclamp_value=None)),
    'head_dim_16': ((3, 4, 2, 77, 130, 16, 3, 101), dict(causal=True, softclamp_value=30.0)),
    'head_dim_32': ((3, 4, 2, 77, 130, 32, 3, 101), dict(causal=True, softclamp_value=30.0)),
    'head_dim_128': ((3, 4, 2, 77, 130, 128, 3, 101), dict(causal=True, softclamp_value=30.0)),
    'head_dim_128_gqa_t512': ((2, 8, 2, 512, 512, 128, 0, 512), dict(causal=True)),
    'head_dim_128_special': ((4, 8, 8, 144, 144, 128, 0, 144),
                             dict(num_special=1, special_seq_len=144)),
    'sim': ((432, 8, 8, 151, 151, 64, 0, 151), dict(causal=True)),
}


def bwd_inputs(gen, shape, dtype, cfg):
    """q, k, v, dO and the forward's o, lse (from the plain version, so that
    kernel and plain version see the same inputs)."""
    B, Hq, H, N, M, D, offset, kv_len = shape
    q, k, v = qkv(gen, B, Hq, H, N, M, D, dtype)
    do = torch.randn((B, Hq, N, D), generator=gen, device='cuda').to(dtype)
    o, lse = fa.flash_attend_reference(q, k, v, offset, kv_len, return_lse=True, **cfg)
    return q, k, v, do, o, lse


def run_backward(q, k, v, do, o, lse, offset, kv_len, cfg):
    """K2 then K3 from K2's delta, as `flash_attend_bwd` runs them: (dq, dk,
    dv, delta)."""
    dq, delta = fa.bwd_dq(q, k, v, o, lse, do, offset, kv_len, **cfg)
    dk, dv = fa.bwd_dkv(q, k, v, do, lse, delta, offset, kv_len, **cfg)
    return dq, dk, dv, delta


def plain_backward(q, k, v, do, o, lse, offset, kv_len, cfg):
    ref_dq, delta = fa.bwd_dq_reference(q, k, v, o, lse, do, offset, kv_len, **cfg)
    return (ref_dq, *fa.bwd_dkv_reference(q, k, v, do, lse, delta, offset, kv_len, **cfg))


def rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', list(BWD_CASES))
def test_backward_kernels_match_plain_versions(gen, case, dtype):
    shape, cfg = BWD_CASES[case]
    offset, kv_len = shape[6], shape[7]
    inputs = bwd_inputs(gen, shape, dtype, cfg)
    before = (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    dq, dk, dv, _ = run_backward(*inputs, offset, kv_len, cfg)
    torch.cuda.synchronize()
    assert (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == (before[0] + 1, before[1] + 1)
    for out, ref in zip((dq, dk, dv), plain_backward(*inputs, offset, kv_len, cfg)):
        assert out.dtype == dtype and out.shape == ref.shape
        assert bool(torch.isfinite(out).all())
        assert rel_err(out, ref) <= GRAD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', ['t1024', 'n1000', 'head_dim_16', 'head_dim_128_gqa_t512'])
def test_k2_delta_matches_attention_delta(gen, case, dtype):
    """The delta K2 writes is rowsum(dO * O) in float32; it differs from
    `attention_delta` by the order of the float32 sums only."""
    shape, cfg = BWD_CASES[case]
    q, k, v, do, o, lse = bwd_inputs(gen, shape, dtype, cfg)
    _, delta = fa.bwd_dq(q, k, v, o, lse, do, shape[6], shape[7], **cfg)
    ref = fa.attention_delta(o, do)
    assert delta.dtype == torch.float32 and delta.shape == ref.shape
    assert rel_err(delta, ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', ['t1024', 'ragged_offset', 'head_dim_128_gqa_t512'])
def test_backward_is_bitwise_reproducible(gen, case, dtype):
    """No atomics: two runs of K2 and K3 on the same inputs give the same
    bits of dq, dk, dv and delta."""
    shape, cfg = BWD_CASES[case]
    inputs = bwd_inputs(gen, shape, dtype, cfg)
    first = run_backward(*inputs, shape[6], shape[7], cfg)
    second = run_backward(*inputs, shape[6], shape[7], cfg)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('d, kv_len', [(64, 96), (64, 100), (128, 77)])
def test_rows_beyond_kv_len_do_not_reach_the_gradients(gen, dtype, d, kv_len):
    """Non-finite values in cache rows at and beyond kv_len (also inside a
    64-row tile) reach none of dq, dk, dv; those rows get zero gradients."""
    shape, cfg = (2, 4, 4, 96, 192, d, 0, kv_len), dict(causal=True)
    q, k, v, do, o, lse = bwd_inputs(gen, shape, dtype, cfg)
    refs = plain_backward(q, k, v, do, o, lse, 0, kv_len, cfg)
    k[:, :, kv_len:] = float('nan')
    v[:, :, kv_len:] = float('inf')
    dq, dk, dv, _ = run_backward(q, k, v, do, o, lse, 0, kv_len, cfg)
    for out, ref in zip((dq, dk, dv), refs):
        assert bool(torch.isfinite(out).all())
        assert rel_err(out, ref) <= GRAD_TOL[dtype]
    assert not bool(dk[:, :, kv_len:].any()) and not bool(dv[:, :, kv_len:].any())


@pytest.mark.cuda
def test_autograd_runs_the_kernels(gen):
    """Under grad `flash_attend` launches K1 once with its LSE, and the
    backward K2 and K3 once each; its gradients are those of the plain
    attention under autograd (float32)."""
    q, k, v = (t.requires_grad_() for t in qkv(gen, 2, 4, 2, 200, 200, 64, torch.float32))
    do = torch.randn((2, 4, 200, 64), generator=gen, device='cuda')
    cfg = dict(causal=True, num_special=1, special_seq_len=25)
    counts = lambda: (k1_launches(), fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    before = counts()
    grads = torch.autograd.grad(fa.flash_attend(q, k, v, 0, 200, **cfg), (q, k, v), do)
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    ref = torch.autograd.grad(fa.flash_attend_reference(q, k, v, 0, 200, **cfg), (q, k, v), do)
    for out, r in zip(grads, ref):
        assert rel_err(out, r) <= GRAD_TOL[torch.float32]
    with torch.no_grad():
        fa.flash_attend(q, k, v, 0, 200, **cfg)
    assert counts() == (before[0] + 2, before[1] + 1, before[2] + 1)


# K4 / K5: (B, n, h, dh, mask) at the shapes of chip_smoke.py, cut in batch:
# the tokenizer's time layer, the world model's space and time layers, and
# ragged n with other head dims
SMALL_CASES = {
    'tok_time': (64, 16, 8, 64, 'causal'),
    'wm_space': (32, 27, 8, 64, 'special'),
    'wm_time': (27, 32, 8, 64, 'causal'),
    'ragged_16': (5, 13, 4, 16, 'special_only_itself'),
    'ragged_32': (5, 13, 4, 32, 'none'),
    'ragged_128': (5, 13, 4, 128, 'causal'),
    'n64': (3, 64, 8, 64, 'causal'),
}


def small_mask(kind, n):
    if kind == 'none':
        return None
    if kind == 'causal':
        return build_attend_mask(n, n, causal=True, device='cuda')
    return build_attend_mask(n, n, num_special=1, block_size_per_special=n,
                             special_attend_only_itself=kind == 'special_only_itself',
                             device='cuda')


def small_inputs(gen, B, n, h, dh, dtype):
    return tuple(torch.randn((B, n * h, dh), generator=gen, device='cuda').to(dtype)
                 for _ in range(4))


@pytest.mark.cuda
@pytest.mark.parametrize('softclamp', [50.0, None])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', list(SMALL_CASES))
def test_small_kernels_match_plain_versions(gen, case, dtype, softclamp):
    B, n, h, dh, kind = SMALL_CASES[case]
    q, k, v, do = small_inputs(gen, B, n, h, dh, dtype)
    mask = small_mask(kind, n)
    bias = sa.build_interleaved_bias(n, h, mask, device='cuda')
    before = (sa.FWD_LAUNCHES, sa.BWD_LAUNCHES)
    out = sa.small_attend_flat(q, k, v, mask, h, softclamp_value=softclamp)
    grads = sa.small_attend_flat_bwd(q, k, v, do, mask, h, softclamp_value=softclamp)
    torch.cuda.synchronize()
    assert (sa.FWD_LAUNCHES, sa.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref = sa.small_attend_flat_reference(q, k, v, bias, softclamp)
    refs = sa.small_attend_flat_bwd_reference(q, k, v, do, bias, softclamp)
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    for g, r in zip(grads, refs):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        assert rel_err(g, r) <= GRAD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_small_kernels_never_read_past_the_head(gen, dtype):
    """n = 13 pads to 16 rows inside the kernel. The rows after the last
    batch row hold NaN; no padded row is read from device memory, so no
    output or gradient sees them."""
    B, n, h, dh = 3, 13, 4, 64
    full = [torch.full((B + 1, n * h, dh), float('nan'), device='cuda', dtype=dtype)
            for _ in range(4)]
    for t, src in zip(full, small_inputs(gen, B, n, h, dh, dtype)):
        t[:B] = src
    q, k, v, do = (t[:B] for t in full)
    mask = small_mask('causal', n)
    bias = sa.build_interleaved_bias(n, h, mask, device='cuda')
    out = sa.small_attend_flat(q, k, v, mask, h)
    grads = sa.small_attend_flat_bwd(q, k, v, do, mask, h)
    assert bool(torch.isfinite(out).all())
    assert (out.float() - sa.small_attend_flat_reference(q, k, v, bias).float()
            ).abs().max().item() <= TOL[dtype]
    for g, r in zip(grads, sa.small_attend_flat_bwd_reference(q, k, v, do, bias)):
        assert bool(torch.isfinite(g).all()) and rel_err(g, r) <= GRAD_TOL[dtype]


@pytest.mark.cuda
def test_small_autograd_runs_the_kernels(gen):
    """Under grad `small_attend_flat` launches K4 once and its backward K5
    once; without grad K4 only."""
    q, k, v, do = small_inputs(gen, 8, 27, 8, 64, torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    mask = small_mask('special', 27)
    before = (sa.FWD_LAUNCHES, sa.BWD_LAUNCHES)
    grads = torch.autograd.grad(sa.small_attend_flat(q, k, v, mask, 8), (q, k, v), do)
    assert (sa.FWD_LAUNCHES, sa.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    refs = sa.small_attend_flat_bwd_reference(q, k, v, do, sa.build_interleaved_bias(
        27, 8, mask, device='cuda'))
    for g, r in zip(grads, refs):
        assert rel_err(g, r) <= GRAD_TOL[torch.bfloat16]
    with torch.no_grad():
        sa.small_attend_flat(q, k, v, mask, 8)
    assert (sa.FWD_LAUNCHES, sa.BWD_LAUNCHES) == (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
def test_small_wrapper_refuses_what_the_kernels_do_not_take(gen):
    q, k, v, _ = small_inputs(gen, 2, 8, 2, 16, torch.float32)
    with pytest.raises(ValueError):   # n = 80 > 64
        sa.small_attend_flat(*small_inputs(gen, 1, 80, 1, 16, torch.float32)[:3], None, 1)
    with pytest.raises(ValueError):
        sa.small_attend_flat(q.half(), k.half(), v.half(), None, 2)
    with pytest.raises(ValueError):
        sa.small_attend_flat(q, k.cpu(), v, None, 2)


@pytest.mark.cuda
def test_streaming_encode_matches_parallel_on_the_card(gen):
    """The tokenizer's frame-by-frame encode over its KV cache (the plain
    attention) against the whole video at once (K4 in the time layer), in
    float32: K4's tolerance, 1e-4, as the two differ by K4 against the
    plain attention and the order of their sums."""
    torch.manual_seed(0)
    tok = VideoTokenizer(dim=64, dim_latent=16, patch_size=8, image_height=32, image_width=32,
                         num_latent_tokens=4, encoder_depth=2, decoder_depth=1,
                         time_block_every=2, attn_dim_head=32, attn_heads=2,
                         use_fused_small=True)
    video = torch.rand((2, 3, 6, 32, 32), generator=gen, device='cuda')
    with torch.no_grad():
        before = sa.FWD_LAUNCHES
        parallel = tok.encode(video)
        launched = sa.FWD_LAUNCHES
        assert launched > before
        cache, frames = None, []
        for i in range(6):
            kw = dict(max_time=6) if cache is None else dict(cache=cache)
            latents, cache = tok.encode(video[:, :, i:i + 1], return_cache=True, **kw)
            frames.append(latents)
        assert sa.FWD_LAUNCHES == launched      # the cached path is the plain one
    assert (torch.cat(frames, dim=1) - parallel).abs().max().item() <= TOL[torch.float32]


# K4 / K5 as persistent kernels: items of one batch row and G heads through
# a ring of bulk-async stages (`sa.small_plan`), at today's tolerances


def check_small(gen, B, n, h, dh, dtype, kind, softclamp=50.0, inputs=None):
    """Both kernels against their plain versions; returns (out, grads)."""
    q, k, v, do = inputs if inputs is not None else small_inputs(gen, B, n, h, dh, dtype)
    mask = small_mask(kind, n)
    bias = sa.build_interleaved_bias(n, h, mask, device='cuda')
    out = sa.small_attend_flat(q, k, v, mask, h, softclamp_value=softclamp)
    grads = sa.small_attend_flat_bwd(q, k, v, do, mask, h, softclamp_value=softclamp)
    torch.cuda.synchronize()
    ref = sa.small_attend_flat_reference(q, k, v, bias, softclamp)
    refs = sa.small_attend_flat_bwd_reference(q, k, v, do, bias, softclamp)
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    for g, r in zip(grads, refs):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        assert rel_err(g, r) <= GRAD_TOL[dtype]
    return out, grads


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('B', [5000, 1])
def test_small_kernels_more_and_fewer_items_than_blocks(gen, dtype, B):
    """B = 5000 at n = 16, h = 8 gives each persistent block many items
    (the ring wraps many times); B = 1 leaves most of the grid unused."""
    check_small(gen, B, 16, 8, 64, dtype, 'causal')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n, h', [(1, 8), (17, 8), (64, 8), (33, 2)])
def test_small_kernels_edge_token_counts(gen, dtype, n, h):
    """n = 1 (one valid row of 16), n = 17 (padding inside a 32-row tile),
    n = 64 with h = 8 (n*h = 512, the gate's edge), n = 33 (a 64-row tile
    mostly padding)."""
    check_small(gen, 6, n, h, 64, dtype, 'causal')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('dh', sa.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize('n', [16, 27, 64])
def test_small_kernels_every_head_dim(gen, dtype, dh, n):
    check_small(gen, 7, n, 8 if n < 64 else 4, dh, dtype, 'special')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kind', ['none', 'causal', 'special', 'special_only_itself'])
def test_small_kernels_every_mask_kind(gen, dtype, kind):
    check_small(gen, 9, 27, 8, 64, dtype, kind)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n, h, dh', [(16, 8, 64), (13, 4, 128), (27, 8, 32), (64, 8, 16)])
def test_small_kernels_never_read_the_next_batch_row(gen, dtype, n, h, dh):
    """The tensors sit inside buffers whose rows before and after them (the
    neighbouring batch rows) hold NaN: no copy of an item reads past its
    rows, so no output or gradient sees them."""
    B = 5
    bufs = [torch.full((B + 2, n * h, dh), float('nan'), device='cuda', dtype=dtype)
            for _ in range(4)]
    for t, src in zip(bufs, small_inputs(gen, B, n, h, dh, dtype)):
        t[1:B + 1] = src
    check_small(gen, B, n, h, dh, dtype, 'causal', inputs=tuple(t[1:B + 1] for t in bufs))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('case', ['tok_time', 'wm_space', 'n64'])
def test_small_kernels_are_bitwise_reproducible(gen, dtype, case):
    """Each head's gradients are written by its own warps (no atomics), so
    K5's dq, dk, dv and K4's output are the same bits from run to run."""
    B, n, h, dh, kind = SMALL_CASES[case]
    q, k, v, do = small_inputs(gen, B * 4, n, h, dh, dtype)
    mask = small_mask(kind, n)
    runs = [(sa.small_attend_flat(q, k, v, mask, h),
             *sa.small_attend_flat_bwd(q, k, v, do, mask, h)) for _ in range(3)]
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            assert torch.equal(a, b)


def small_plans(n, h, dh, dtype, which):
    """Every plan the kernels take at this shape: G dividing h within the
    consumer-warp limit, 1-3 stages where they fit in shared memory."""
    return [(g, s) for g in range(1, h + 1) if h % g == 0
            and sa.consumer_warps(n, g, dtype) <= sa.MAX_CONSUMER_WARPS
            for s in (1, 2, 3)
            if sa.small_smem_bytes(n, dh, dtype, which, g, s) <= sa.SMEM_LIMIT]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('n, h, dh', [(16, 8, 64), (27, 4, 32)])
def test_small_kernels_agree_at_every_plan(gen, monkeypatch, dtype, n, h, dh):
    """Forced through every plan (heads per item, stages) at a shape, both
    kernels match their plain versions: the ring is right whatever
    `small_plan` picks."""
    q, k, v, do = small_inputs(gen, 300, n, h, dh, dtype)
    routed = sa.small_plan
    for which in ('fwd', 'bwd'):
        for plan in small_plans(n, h, dh, dtype, which):
            monkeypatch.setattr(sa, 'small_plan', lambda *a, plan=plan, which=which: (
                plan if a[-1] == which else routed(*a)))
            check_small(gen, 300, n, h, dh, dtype, 'causal', inputs=(q, k, v, do))
            monkeypatch.undo()


@pytest.mark.cuda
def test_small_kernels_refuse_a_plan_they_do_not_take(gen):
    """A plan whose G does not divide h, or that needs more threads or
    shared memory than the kernels are built for, fails the launch: the
    wrapper raises, nothing falls back."""
    q, k, v, _ = small_inputs(gen, 2, 16, 8, 64, torch.bfloat16)
    for plan in [(3, 2), (16, 2), (8, 9)]:
        with pytest.MonkeyPatch.context() as m:
            m.setattr(sa, 'small_plan', lambda *a, plan=plan: plan)
            with pytest.raises(RuntimeError):
                sa.small_attend_flat(q, k, v, None, 8)
