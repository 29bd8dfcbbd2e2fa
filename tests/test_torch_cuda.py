"""The port's CUDA kernels on a card, each against its plain PyTorch
version: K1 (`csrc/flash_attn_fwd.cu`) against `flash_attend_reference`, K2
(`csrc/flash_attn_bwd_dq.cu`) against `bwd_dq_reference`, K3
(`csrc/flash_attn_bwd_dkv.cu`) against `bwd_dkv_reference`, K4
(`csrc/small_attn_fwd.cu`) against `small_attend_flat_reference` and K5
(`csrc/small_attn_bwd.cu`) against `small_attend_flat_bwd_reference`. Every test here
needs a CUDA device and skips without one: a hand-written kernel has no CPU
or interpret mode. This file imports torch, the port and `chip_smoke.py`
(whose helpers the pool tests share) only, so it runs on a machine without
JAX:

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

The optimizer's multi-tensor kernels (`csrc/multi_tensor_optim.cu`) against
the float32 arithmetic they replace: the clip scale bitwise against the same
sums in the kernels' order; Muon's momentum, its stacked update and
p + coef * o bitwise; its bf16 Newton-Schulz input within one bf16 step;
Adam-atan2 at 1e-6 relative; the whole `MuonAdamAtan2` step against its
plain loop as `test_optimizer_kernels_match_the_plain_loop` states.

The attention pools' kernels (`csrc/attn_pool.cu`) against the pool's plain
code, output and every gradient as relative L2 distances: float32 within
1e-4 (orders of summation; the scale's gradient sums L N terms), bf16 no
further from the float32 plain result than the bf16 plain code, up to 1.25x
(the kernels round each output once from float32); `rms_normalize`'s alike
(float32 1e-5). A whole `dreamer4-wm-512` step with the kernels against one
without, within the benchmark's own `loss_gap` / `grad_gap`, and a cached
dream with and without them, each against float32.

The GLU feedforward's kernels (`csrc/glu_ff.cu`) through `FeedForward` on
the card against its plain code: output and the five gradients as relative
L2 distances, float32 within 1e-5 (orders of summation), bf16 no further
from the float32 plain result than the bf16 plain code, up to 1.25x; every
kernel output allocated full of NaN, so an unwritten pad shows; a GLU over
another activation or another compute dtype raises.
"""
import copy
from pathlib import Path

import pytest
import torch

import chip_smoke
from dreamer4_torch.models.tokenizer import VideoTokenizer
from dreamer4_torch.models.transformer import AxialSpaceTimeTransformer
from dreamer4_torch.ops import flash_attention as fa
from dreamer4_torch.ops import multi_tensor as mt
from dreamer4_torch.ops import small_attention as sa
from dreamer4_torch.ops.masks import build_attend_mask
from dreamer4_torch.train import optim

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
    # continuous actions with proprio and the state head, 29 tokens per
    # frame: the b1 x T1024 train step and the full-model update over b8
    # rows of the b16 x T192 dream
    'continuous_train': ((29, 8, 8, 1024, 1024, 64, 0, 1024), dict(causal=True)),
    'continuous_rl_full': ((232, 8, 8, 192, 192, 64, 0, 192), dict(causal=True)),
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
    'continuous_train': ((29, 8, 8, 1024, 1024, 64, 0, 1024), dict(causal=True)),
    'continuous_rl_full': ((232, 8, 8, 192, 192, 64, 0, 192), dict(causal=True)),
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


# the data plane and serving on the card: no kernel of their own, the models
# they drive run on the card as on the CPU


@pytest.mark.cuda
def test_experience_from_batch_on_the_card(gen, tmp_path):
    """A replay-buffer batch read into an Experience on the card equals
    the same batch read on the CPU."""
    import numpy as np

    from dreamer4_torch.data.experience import (Experience, add_experience_to_buffer,
                                                create_experience_replay_buffer,
                                                experience_from_batch)
    from dreamer4_torch.nn.action_embedder import Actions

    rng = np.random.default_rng(0)
    exp = Experience(latents=torch.from_numpy(rng.standard_normal((3, 5, 4, 6)).astype('f4')),
                     rewards=torch.from_numpy(rng.standard_normal((3, 5)).astype('f4')),
                     actions=Actions(torch.from_numpy(rng.integers(0, 4, (3, 5, 1))), None),
                     lens=torch.tensor([5, 2, 4]), terminals=torch.tensor([False, True, True]),
                     step_size=16)
    buf = create_experience_replay_buffer(exp, tmp_path / 'buf', 4, 6)
    add_experience_to_buffer(exp, buf)
    batch = buf.sample_batch(np.random.default_rng(1), 4, 6)
    on_card, on_cpu = (experience_from_batch(batch, device=d) for d in ('cuda', 'cpu'))
    for name in ('latents', 'rewards', 'lens', 'terminals'):
        got, want = getattr(on_card, name), getattr(on_cpu, name)
        assert got.device.type == 'cuda' and torch.equal(got.cpu(), want), name
    assert torch.equal(on_card.actions.discrete.cpu(), on_cpu.actions.discrete)
    assert on_card.step_size == 16


@pytest.mark.cuda
def test_world_model_wrapper_on_the_card_matches_the_cpu(gen, monkeypatch):
    """`DynamicsWorldModelWrapper` over a world model and tokenizer on the
    card against the same wrapper on the CPU, with the same draws (made on
    the host from a seed per kind and frame): float32, 1e-4 absolute on
    pixels and rewards (five world-model passes and a decoder pass, summed
    in other orders), equal flags."""
    import numpy as np

    from dreamer4_torch.envs import world_model_env
    from dreamer4_torch.envs.world_model_env import DynamicsWorldModelWrapper
    from dreamer4_torch.models.world_model import DynamicsWorldModel

    def host_draw(kind, frame, shape, *, generator, device):
        rng = np.random.default_rng([('noise', 'terminal', 'decode').index(kind), frame])
        x = rng.uniform(size=shape) if kind == 'terminal' else rng.standard_normal(shape)
        return torch.from_numpy(x.astype('f4')).to(device)

    monkeypatch.setattr(world_model_env, 'draw', host_draw)
    torch.manual_seed(0)
    cfg = dict(dim=64, dim_latent=16, num_latent_tokens=4, max_steps=8, depth=2,
               time_block_every=2, num_spatial_tokens=4, num_discrete_actions=(4,),
               attn_dim_head=32, attn_heads=2, num_register_tokens=2)
    tok_cfg = dict(dim=64, dim_latent=16, patch_size=8, image_height=32, image_width=32,
                   num_latent_tokens=4, encoder_depth=1, decoder_depth=1, time_block_every=1,
                   attn_dim_head=32, attn_heads=2)
    torch.manual_seed(0)
    models = {'cuda': (DynamicsWorldModel(**cfg, device='cuda'),
                       VideoTokenizer(**tok_cfg, device='cuda')),
              'cpu': (DynamicsWorldModel(**cfg, device='cpu'),
                      VideoTokenizer(**tok_cfg, device='cpu'))}
    for cpu_module, card_module in zip(models['cpu'], models['cuda']):
        cpu_module.load_state_dict({k: v.cpu() for k, v in card_module.state_dict().items()})
    out = {}
    for device, (model, tok) in models.items():
        env = DynamicsWorldModelWrapper(model, tokenizer=tok, num_steps=2, max_timesteps=6,
                                        device=device)
        out[device] = [env.reset()[0]] + [env.step(a) for a in (1, 3, 0, 2)]
    assert out['cuda'][0].shape == (1, 3, 32, 32)
    np.testing.assert_allclose(out['cuda'][0], out['cpu'][0], atol=1e-4, rtol=0)
    for card, cpu in zip(out['cuda'][1:], out['cpu'][1:]):
        np.testing.assert_allclose(card[0], cpu[0], atol=1e-4, rtol=0)
        assert abs(card[1] - cpu[1]) <= 1e-4
        assert card[2:4] == cpu[2:4]


# ------------------------------------------------- continuous actions

@pytest.mark.cuda
def test_beta_sampler_moments_on_the_card(gen):
    """The port's Beta draws (gamma ratio, `torch._standard_gamma` from a
    card generator) against the mean a / (a + b) and the variance
    ab / ((a + b)^2 (a + b + 1)): 10^6 draws, a standard error of the mean
    below 5e-4."""
    from dreamer4_torch.ops import dists

    alpha = torch.tensor([1.0, 2.5, 7.0, 1.2, 30.0], device='cuda')
    beta = torch.tensor([1.0, 4.0, 1.5, 9.0, 30.0], device='cuda')
    x = dists.beta_sample(alpha.expand(1_000_000, 5), beta.expand(1_000_000, 5), generator=gen)
    assert x.device.type == 'cuda' and bool(((x > 0) & (x < 1)).all())
    s = alpha + beta
    torch.testing.assert_close(x.mean(0), alpha / s, atol=2.5e-3, rtol=0)
    torch.testing.assert_close(x.var(0), alpha * beta / (s.square() * (s + 1)), atol=1e-3,
                               rtol=0)


# the bench world model (bench.py:174-193) with the reacher recipe's
# continuous actions and proprio and the state head: 29 tokens per frame
CONTINUOUS_MODEL = dict(dim=512, dim_latent=32, num_latent_tokens=16, num_spatial_tokens=16,
                        max_steps=64, depth=8, time_block_every=4, attn_heads=8,
                        attn_dim_head=64, multi_token_pred_len=8, num_register_tokens=8,
                        predict_terminals=False, num_continuous_actions=6,
                        continuous_dist_type='beta', continuous_target_action_range=(-1.0, 1.0),
                        dim_proprio=4, add_action_embed_to_spatial=True,
                        add_state_pred_head=True)


def continuous_loss_terms(model, batch):
    """Per element, the state-prediction Beta NLL of the next frame's
    latents and the continuous actions' MTP NLL under the policy head, off
    one forward at the clean signal level (what the training losses
    average)."""
    from dreamer4_torch.ops import dists
    from dreamer4_torch.ops.mtp import create_multi_token_prediction_targets

    K = model.max_steps
    pred, (embeds, _) = model(**batch, signal_levels=K - 1, step_sizes=K // 4,
                              latent_is_noised=True, return_intermediates=True)
    target = ((batch['latents'][:, 1:] + 1) / 2).clamp(1e-6, 1 - 1e-6)
    state_nll = -dists.continuous_log_prob(pred.state[:, :-1], target, 'beta')
    acts = torch.nn.functional.pad(batch['continuous_actions'], (0, 0, 1, 0))
    targets, _ = create_multi_token_prediction_targets(acts, model.multi_token_pred_len)
    policy = model.policy_head(embeds.actor[:, :-1, 0])
    lp = model.action_embedder.log_probs(policy, continuous_targets=targets[:, 1:].movedim(2, 0),
                                         soft_validate_range=True)
    return {'state_pred': state_nll, 'continuous_actions': -lp.continuous}


@pytest.mark.cuda
def test_bf16_continuous_losses_through_the_kernels(gen):
    """b1 x T1024 (B = 29, N = M = 1024 in each time layer): the bf16 state
    and action loss terms through K1 are finite (float32 distribution
    terms: at bf16 a target of 1 - 1e-6 would round to 1), and within 2x
    the plain bf16 attention's distance from float32."""
    from dreamer4_torch import DynamicsWorldModel

    torch.manual_seed(0)
    model = DynamicsWorldModel(**CONTINUOUS_MODEL, use_flash_attention=True,
                               dtype=torch.bfloat16, device='cuda')
    ref = DynamicsWorldModel(**CONTINUOUS_MODEL, device='cuda')
    ref.load_state_dict(model.state_dict())
    t = 1024
    batch = dict(latents=torch.rand((1, t, 16, 32), generator=gen, device='cuda') * 2 - 1,
                 continuous_actions=torch.rand((1, t - 1, 6), generator=gen, device='cuda') * 2 - 1,
                 proprio=torch.randn((1, t, 4), generator=gen, device='cuda'))
    with torch.no_grad():
        before = k1_launches()
        kernel = continuous_loss_terms(model, batch)
        assert k1_launches() == before + 2   # the two time layers
        model.transformer.use_flash_attention = False
        plain = continuous_loss_terms(model, batch)
        want = continuous_loss_terms(ref, batch)
    for name, w in want.items():
        assert kernel[name].dtype == torch.float32 and bool(torch.isfinite(kernel[name]).all())
        e_kernel = (kernel[name] - w).abs().max().item()
        e_plain = (plain[name] - w).abs().max().item()
        assert e_kernel <= 2.0 * e_plain, (name, e_kernel, e_plain)


@pytest.mark.cuda
def test_options_tokenizer_bf16_step_runs_the_small_kernels(gen):
    """A tokenizer with every option of the pixel recipe's slice (causal
    conv3d, shifted patch tokenization, LPIPS on seeded random VGG16
    features, both decorrelations, ortho, sigreg, latent consistency, loss
    normalization) with bf16 trunks on the small path: its training loss is
    no further from the float32 loss than twice the plain bf16 attention's
    distance (or 1e-3 of it), and one `TokenizerTrainer` step launches K4
    and K5 in each trunk's space and time layer, and again in the
    encoder's for the consistency re-encode (under grad: the reconstruction
    it reads takes a gradient), with every loss term finite and nonzero."""
    from dreamer4_torch import TokenizerTrainer
    cfg = dict(dim=64, dim_latent=16, patch_size=8, image_height=32, image_width=32,
               num_latent_tokens=4, encoder_depth=2, decoder_depth=2, time_block_every=2,
               attn_dim_head=32, attn_heads=2, decoder_flow_steps=2, use_causal_conv3d=True,
               use_shifted_patch_tokenization=True, encoder_add_decorr_aux_loss=True,
               latent_ortho_loss_weight=0.1, latent_sigreg_loss_weight=0.1,
               latent_consistency_loss_weight=0.1)
    torch.manual_seed(0)
    tok = VideoTokenizer(**cfg, use_fused_small=True, dtype=torch.bfloat16)
    plain = VideoTokenizer(**cfg, dtype=torch.bfloat16)
    ref = VideoTokenizer(**cfg)
    for m in (plain, ref):
        m.load_state_dict(tok.state_dict())
    video = torch.rand((2, 3, 6, 32, 32), generator=gen, device='cuda')
    with torch.no_grad():
        losses = [m(video, update_loss_ema=False,
                    generator=torch.Generator(device='cuda').manual_seed(1)).item()
                  for m in (tok, plain, ref)]
    e_kernel, e_plain = abs(losses[0] - losses[2]), abs(losses[1] - losses[2])
    assert e_kernel <= max(2 * e_plain, 1e-3 * abs(losses[2])), losses

    trainer = TokenizerTrainer(tok, use_lpips=True, seed=0)
    fwd, bwd = sa.FWD_LAUNCHES, sa.BWD_LAUNCHES
    loss, parts = trainer.train_on_batch(video)
    torch.cuda.synchronize()
    assert (sa.FWD_LAUNCHES - fwd, sa.BWD_LAUNCHES - bwd) == (6, 6)
    assert torch.isfinite(loss) and trainer.ts.step == 1
    for name in ('recon', 'lpips', 'time_decorr', 'space_decorr', 'latent_ortho',
                 'latent_sigreg'):
        value = getattr(parts, name)
        assert torch.isfinite(value) and value.item() != 0.0, name


# ------------------------------------------------------ optimizer kernels

# csrc/multi_tensor_optim.cu: threads of a block and warps of it
OPT_THREADS, OPT_WARPS = 256, 8


def block_sum_in_kernel_order(acc):
    """The kernels' `block_sum` over the last dim (one block's 256 threads):
    shuffles 16, 8, 4, 2, 1 lanes down within each warp, then the same over
    the eight warps' sums (the other lanes hold zeros, which add exactly)."""
    a = acc.view(*acc.shape[:-1], OPT_WARPS, 32)
    for off in (16, 8, 4, 2, 1):
        a = a[..., :off] + a[..., off:2 * off]
    w = a[..., 0]
    for off in (4, 2, 1):
        w = w[..., :off] + w[..., off:2 * off]
    return w[..., 0]


def strided_sums(x, rows):
    """Thread t's running sum of x's rows, in order: (..., rows, 256) -> (..., 256)."""
    acc = torch.zeros(x.shape[:-2] + (OPT_THREADS,), device=x.device)
    for r in range(rows):
        acc = acc + x[..., r, :]
    return acc


def clip_scale_in_kernel_order(grads, numels, max_norm):
    """The clip scale as the kernels compute it, in float32 and in their
    order: per chunk, thread t sums the squares of elements t, t + 256, ...;
    one block per chunk; then one block over the chunks' sums."""
    chunk, _ = mt.config()
    parts = []
    for g, n in zip(grads, numels):
        k = -(-n // chunk)
        x = torch.zeros(k * chunk, device='cuda')
        if g is not None:
            x[:n] = g.flatten()
        sq = (x * x).view(k, chunk // OPT_THREADS, OPT_THREADS)
        parts.append(block_sum_in_kernel_order(strided_sums(sq, chunk // OPT_THREADS)))
    partials = torch.cat(parts)
    rows = -(-partials.numel() // OPT_THREADS)
    x = torch.zeros(rows * OPT_THREADS, device='cuda')
    x[:partials.numel()] = partials
    total = block_sum_in_kernel_order(strided_sums(x.view(rows, OPT_THREADS), rows))
    norm = torch.clamp(total.sqrt(), min=1e-16)
    return torch.clamp(norm.reciprocal() * max_norm, max=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['ragged', 'long_table'])
@pytest.mark.parametrize('max_norm', [0.5, 1e9])
def test_clip_scale_is_the_float32_sum_in_kernel_order(gen, case, max_norm):
    """Bitwise against the same float32 sums in the same order, and from run
    to run; a missing gradient counts as zero. The ragged sizes sit on both
    sides of a chunk's edge; the long table takes three partial launches."""
    chunk, _ = mt.config()
    if case == 'ragged':
        numels = [1, 255, chunk - 1, chunk, chunk + 1, 3 * chunk + 7, 70000, 513]
    else:
        numels = torch.randint(1, 3000, (450,), generator=torch.Generator().manual_seed(0)).tolist()
    grads = [torch.randn(n, generator=gen, device='cuda') * 0.1 for n in numels]
    grads[2] = None
    params = [torch.empty(n, device='cuda') for n in numels]
    partials = torch.empty(mt.clip_partials_len(numels), device='cuda')
    runs = []
    for _ in range(2):
        scale = torch.empty(1, device='cuda')
        before = mt.KERNEL_LAUNCHES
        mt.clip_scale(params, grads, max_norm, partials, scale)
        assert mt.KERNEL_LAUNCHES - before == (2 if case == 'ragged' else 4)
        runs.append(scale)
    want = clip_scale_in_kernel_order(grads, numels, max_norm)
    assert torch.equal(runs[0], want.view(1)) and torch.equal(runs[0], runs[1])
    if max_norm > 1e8:
        assert runs[0].item() == 1.0


def muon_reference(p, g, m, scale, wd, mom):
    """Muon's momentum and Nesterov update, the plain loop's arithmetic."""
    g = torch.zeros_like(p) if g is None else g
    g = g * scale + wd * p if wd > 0 else g * scale
    m = m * mom + g
    return m, m * mom + g


@pytest.mark.cuda
def test_muon_prepare_and_apply_match_their_formulas(gen):
    """Momentum and the stacks' float32 updates bitwise (the same float32
    operations); the bf16 Newton-Schulz input within one bf16 step of the
    float32 normalized update cast (the kernel sums a matrix's norm in tiles,
    which may round it to a neighbouring float32 value); p + coef * o
    bitwise, through the tile transpose and without it."""
    shapes = [(70, 33), (33, 70), (64, 64), (130, 64), (1, 5), (200, 129)]
    flips = [True, False, True, True, False, True]
    p = [torch.randn(s, generator=gen, device='cuda') for s in shapes]
    g = [torch.randn(s, generator=gen, device='cuda') for s in shapes]
    g[4] = None
    m = [torch.randn(s, generator=gen, device='cuda') for s in shapes]
    places = [torch.empty(s[::-1] if f else s, device='cuda') for s, f in zip(shapes, flips)]
    inputs = [torch.empty_like(u, dtype=torch.bfloat16) for u in places]
    scale = torch.full((1,), 0.37, device='cuda')
    wd, mom, eps = 0.01, 0.95, 1e-7
    want = [muon_reference(*a, scale, wd, mom) for a in zip(p, g, m)]
    partials = torch.empty(mt.muon_partials_len(shapes), device='cuda')
    before = mt.KERNEL_LAUNCHES
    mt.muon_prepare(p, g, m, places, inputs, flips, scale, partials, weight_decay=wd,
                    momentum=mom, eps=eps)
    assert mt.KERNEL_LAUNCHES - before == 2
    for (m_ref, u_ref), m_k, u_k, x_k, f in zip(want, m, places, inputs, flips):
        u_ref = u_ref.T if f else u_ref
        assert torch.equal(m_k, m_ref) and torch.equal(u_k, u_ref)
        x_ref = u_ref / (u_ref.square().sum().sqrt() + eps)
        assert ((x_k.float() - x_ref).abs() <= 2 ** -7 * x_ref.abs()).all()
        assert (x_k == x_ref.bfloat16()).float().mean().item() >= 0.99

    coefs = [-0.003 * (1 + i) for i in range(len(shapes))]
    outs = [torch.randn(u.shape, generator=gen, device='cuda').bfloat16() for u in places]
    want = [pp + c * (o.float().T if f else o.float()) for pp, c, o, f in zip(p, coefs, outs, flips)]
    mt.muon_apply(p, outs, flips, coefs)
    assert mt.KERNEL_LAUNCHES - before == 3
    for pp, w in zip(p, want):
        assert torch.equal(pp, w)


@pytest.mark.cuda
@pytest.mark.parametrize('scaled', [True, False])
def test_adam_atan2_kernel_matches_its_formula(gen, scaled):
    """Three steps over ragged sizes and a missing gradient, decay on: 1e-6
    relative (the kernel and torch's atan2 come from two builds of the
    math library; everything else is the same float32 arithmetic)."""
    chunk, _ = mt.config()
    numels = [1, 7, chunk - 3, chunk + 5, 3 * chunk + 1, 4099]
    p = [torch.randn(n, generator=gen, device='cuda') for n in numels]
    mu = [torch.zeros(n, device='cuda') for n in numels]
    nu = [torch.zeros(n, device='cuda') for n in numels]
    ref = [[t.clone() for t in ts] for ts in (p, mu, nu)]
    scale = torch.full((1,), 0.41, device='cuda') if scaled else None
    b1, b2, wd, lr, a, b = 0.9, 0.99, 0.02, 3e-4, 1.27, 1.0
    for count in (1, 2, 3):
        g = [torch.randn(n, generator=gen, device='cuda') * 0.01 for n in numels]
        g[1] = None
        c1, c2 = optim.bias_correction(b1, count), optim.bias_correction(b2, count)
        mt.adam_atan2(p, g, mu, nu, scale, weight_decay=wd, b1=b1, b2=b2, c1=c1, c2=c2, b=b,
                      lr_a=lr * a)
        c1t, c2t = (torch.tensor(c, device='cuda') for c in (c1, c2))
        for i, gi in enumerate(g):
            pr, mr, vr = ref[0][i], ref[1][i], ref[2][i]
            gi = torch.zeros_like(pr) if gi is None else gi
            gi = gi * scale if scaled else gi
            gi = gi + wd * pr
            mr.mul_(b1).add_((1 - b1) * gi)
            vr.mul_(b2).add_((1 - b2) * gi.square())
            pr.add_(-lr * a * torch.atan2(mr / c1t, b * (vr / c2t).sqrt()))
    for got, want in zip(p + mu + nu, ref[0] + ref[1] + ref[2]):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-12)


class OptimToy(torch.nn.Module):
    """Parameters of every kind the optimizer meets: Muon's transposed
    `nn.Linear` weights (wide, tall, ragged), a raw flax-layout kernel,
    Adam's biases, a 2-D Adam weight, a 3-D one and sizes off the chunk,
    tile and vector edges."""

    def __init__(self, layers: int):
        super().__init__()
        self.layers = torch.nn.ModuleList()
        for _ in range(layers):
            block = torch.nn.Module()
            block.to_v = torch.nn.Linear(64, 96)
            block.to_out = torch.nn.Linear(96, 64)
            block.proj_in = torch.nn.Linear(64, 130)
            block.proj_out = torch.nn.Linear(130, 64)
            self.layers.append(block)
        self.pool = torch.nn.Module()
        self.pool.to_v = torch.nn.Module()
        self.pool.to_v.kernel = torch.nn.Parameter(torch.randn(70, 33) * 0.1)
        self.embed = torch.nn.Parameter(torch.randn(100, 171) * 0.1)
        self.cube = torch.nn.Parameter(torch.randn(3, 50, 111) * 0.1)
        self.long = torch.nn.Parameter(torch.randn(3 * 16384 + 7) * 0.1)
        self.one = torch.nn.Parameter(torch.randn(1))


def clone_toy(model):
    twin = OptimToy(len(model.layers)).cuda()
    twin.load_state_dict(model.state_dict())
    return twin


OPTIM_CASES = {
    'plain': dict(layers=2),
    'decay_and_missing_grads': dict(layers=2, weight_decay=0.05, drop=True),
    'only': dict(layers=2, only=True),
    'long_tables': dict(layers=24),
    'no_clip': dict(layers=2, clip=None),
    'state_dict_round_trip': dict(layers=2, round_trip=True, weight_decay=0.01),
    'multi_steps': dict(layers=2, every_k=2, round_trip=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(OPTIM_CASES))
def test_optimizer_kernels_match_the_plain_loop(gen, monkeypatch, case):
    """`MuonAdamAtan2` on the card against its plain loop on the same CUDA
    tensors over three steps with fresh gradients. Adam's parameters: 1e-6
    relative (the clip's sums and the bias corrections' divisions round
    differently, each by under a float32 step). Both moments and Muon's
    momentum: 1e-6 of the tensor's largest entry (an entry where the decayed
    momentum and the new gradient nearly cancel keeps the absolute error of
    its terms), plus, under weight decay, the decay times the parameter's
    difference for each step. Muon's parameters: their change within 2e-2 of the plain
    change's largest entry (a bf16 Newton-Schulz input may sit a bf16 step
    from the plain one where the two norms round apart; five iterations
    carry that to the output). Each step makes the expected launches and no
    synchronize; after a `state_dict` round trip the kernels read the loaded
    state."""
    cfg = OPTIM_CASES[case]
    torch.manual_seed(0)
    model = OptimToy(cfg['layers']).cuda()
    twin = clone_toy(model)
    names = [n for n, _ in model.named_parameters()]
    only = set(names[::2]) if cfg.get('only') else None
    kw = dict(learning_rate=3e-4, clip_grad_norm=cfg.get('clip', 1.0),
              weight_decay=cfg.get('weight_decay', 0.0), only=only)

    def make(m):
        opt = optim.MuonAdamAtan2(m, **kw)
        return optim.MultiSteps(opt, cfg['every_k']) if 'every_k' in cfg else opt

    kernels, plain = make(model), make(twin)
    inner = lambda o: o.optimizer if isinstance(o, optim.MultiSteps) else o
    inner(plain)._kernel_device = lambda: None
    labels = inner(kernels).labels()
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    drift = dict.fromkeys(start, 0.0)       # the largest |p - q| after any step
    micro = cfg.get('every_k', 1)
    for step in range(3 * micro):
        for (name, p), q in zip(model.named_parameters(), twin.parameters()):
            g = None if cfg.get('drop') and step % 2 == 0 and name.endswith('bias') else \
                torch.randn(p.shape, generator=gen, device='cuda') * 0.02
            p.grad, q.grad = g, None if g is None else g.clone()
        before = mt.KERNEL_LAUNCHES
        torch.cuda.set_sync_debug_mode('error')
        try:
            kernels.step()
        finally:
            torch.cuda.set_sync_debug_mode('default')
        plain.step()
        for (name, p), q in zip(model.named_parameters(), twin.parameters()):
            drift[name] = max(drift[name], (p - q).abs().max().item())
        applied = (step + 1) % micro == 0
        n_muon = sum(v == 'muon' for v in labels.values())
        n_adam = len(labels) - n_muon
        want = 0 if not applied else (
            (-(-len(labels) // 200) + 1 if kw['clip_grad_norm'] else 0)
            + -(-n_adam // 90) + -(-n_muon // 60) + -(-n_muon // 100) + -(-n_muon // 80))
        assert mt.KERNEL_LAUNCHES - before == want, (mt.KERNEL_LAUNCHES - before, want)
        if cfg.get('round_trip') and step == micro - 1:
            # fresh tensors, as from a checkpoint: the kernels must read them
            kernels.load_state_dict(copy.deepcopy(kernels.state_dict()))
    torch.cuda.synchronize()
    state_k, state_p = inner(kernels).state, inner(plain).state
    for (name, p), q in zip(model.named_parameters(), twin.parameters()):
        kind = labels.get(name)
        if kind is None:
            assert torch.equal(p, start[name]) and torch.equal(q, start[name])
            continue
        # the decay carries the parameters' difference into the state: at
        # most the decay times it in each of the three steps
        carried = kw['weight_decay'] * 3 * drift[name]
        for key in state_p[q]:
            want = state_p[q][key]
            torch.testing.assert_close(state_k[p][key], want, rtol=0,
                                       atol=1e-6 * want.abs().max().item() + carried,
                                       msg=lambda m: f'{name} {key} (carried {carried}): {m}')
        if kind == 'adam':
            torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-9, msg=lambda m: f'{name}: {m}')
        else:
            change_k, change_p = p - start[name], q - start[name]
            err = (change_k - change_p).abs().max().item()
            assert err <= 2e-2 * change_p.abs().max().item(), (name, err)


@pytest.mark.cuda
def test_optimizer_refuses_what_the_kernels_do_not_take(gen):
    """A state tensor of another shape than its parameter (as a mismatched
    checkpoint would load), a gradient that is not contiguous, a CUDA
    parameter that is not float32 and parameters on two devices raise;
    nothing falls back to the loop."""
    model = OptimToy(1).cuda()
    opt = optim.MuonAdamAtan2(model)
    opt.step()
    opt.state[model.cube]['mu'] = torch.zeros(5, device='cuda')
    with pytest.raises(ValueError, match='beside a parameter'):
        opt.step()
    opt.state[model.cube]['mu'] = torch.zeros_like(model.cube)
    model.embed.grad = torch.randn(171, 100, generator=gen, device='cuda').T
    with pytest.raises(ValueError, match='contiguous'):
        opt.step()
    model.embed.grad = None
    model.one.data = model.one.data.double()
    with pytest.raises(ValueError, match='float32'):
        opt.step()
    model.one.data = model.one.data.float().cpu()
    with pytest.raises(ValueError, match='one CUDA device'):
        opt.step()


# ------------------------------------------------------- attention pools

WM_512 = Path(__file__).resolve().parent.parent / 'benchmark'
POOL_CASES = [(3, 41_472), (17, 41_472), (3, 1_001), (17, 1_001)]


def pool_case(gen, L, N, dtype):
    """Inputs at the pool's widths (4 x 64), rounded to `dtype` and handed
    back in float32 too: the float32 plain result of the same values is the
    reference."""
    rand = lambda *shape: torch.randn(*shape, generator=gen, device='cuda')
    q, k, v = rand(N, 256), rand(L, N, 256), rand(L, N, 256)
    gates, dout = rand(N, 4), rand(N, 256)
    scale = (1.0 + 0.3 * rand(4, 64)) * 8.0
    xs = [t.to(dtype) for t in (q, k, v, gates, dout)]
    return xs, [t.float() for t in xs], scale


POOL_NAMES = ('out', 'dq', 'dk', 'dv', 'dscale', 'dgate')


def rel_l2(a, b):
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('L, N', POOL_CASES)
def test_pool_kernels_match_the_plain_path(gen, dtype, L, N):
    """The pool's forward and backward kernels against the plain code
    (`nn.attention.pool_attend_plain`), at
    L = 3 and 17 and N = 41,472 (`wm_train_long`'s tokens) and 1,001 (no
    multiple of a block): float32 within 1e-4 relative L2 for the output
    and every gradient (orders of summation; the scale's gradient sums
    L N terms); bf16 no further from the float32 plain result than the bf16
    plain code is, up to 1.25x."""
    from dreamer4_torch.nn.attention import pool_attend_plain as plain_pool
    from dreamer4_torch.ops import attn_pool as ap

    pool_outputs = chip_smoke.pool_outputs
    xs, xs32, scale = pool_case(gen, L, N, dtype)
    before = (ap.FWD_LAUNCHES, ap.BWD_LAUNCHES)
    kernel = pool_outputs(ap.pool_attend, xs, scale)
    assert (ap.FWD_LAUNCHES, ap.BWD_LAUNCHES) == (before[0] + 1, before[1] + 2)
    ref = pool_outputs(plain_pool, xs32, scale)
    if dtype == torch.float32:
        for name, a, b in zip(POOL_NAMES, kernel, ref):
            assert rel_l2(a, b) <= 1e-4, name
    else:
        plain = pool_outputs(plain_pool, xs, scale)
        for name, a, p, b in zip(POOL_NAMES, kernel, plain, ref):
            assert rel_l2(a, b) <= 1.25 * rel_l2(p, b), (name, rel_l2(a, b), rel_l2(p, b))


@pytest.mark.cuda
def test_pool_kernels_are_bitwise_reproducible(gen):
    """The scale's gradient is summed in a fixed order (block partials,
    then one pass), so two backward passes agree bit for bit."""
    from dreamer4_torch.ops import attn_pool as ap

    xs, _, scale = pool_case(gen, 17, 41_472, torch.bfloat16)
    first = chip_smoke.pool_outputs(ap.pool_attend, xs, scale)
    second = chip_smoke.pool_outputs(ap.pool_attend, xs, scale)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('rows', [41_472, 1_001])
def test_rms_kernel_matches_the_plain_path(gen, dtype, rows):
    """`rms_normalize`'s kernels at the trunk's width 512 against its plain
    code: float32 within 1e-5 relative L2, forward and backward; bf16 no
    further from the float32 plain result than the bf16 plain code, up to
    1.25x. With `out`, the kernel writes the same bits into the slot; the
    caller routes both dtypes to the kernel."""
    from dreamer4_torch.nn import attention
    from dreamer4_torch.ops import attn_pool as ap

    x = (torch.randn(rows, 512, generator=gen, device='cuda') * 3).to(dtype)
    dy = torch.randn(rows, 512, generator=gen, device='cuda').to(dtype)

    def through(fn, x, dy):
        x = x.clone().requires_grad_()
        y = fn(x)
        return [y.detach().float(), torch.autograd.grad(y, x, dy)[0].float()]

    before = ap.NORM_LAUNCHES
    kernel = through(ap.rms_normalize, x, dy)
    assert ap.NORM_LAUNCHES == before + 2
    slot = torch.empty_like(x)
    with torch.no_grad():
        assert ap.rms_normalize(x, out=slot) is slot
        assert torch.equal(slot.float(), kernel[0])
        assert torch.equal(attention.rms_normalize(x).float(), kernel[0])
    ref = through(attention.rms_normalize_plain, x.float(), dy.float())
    if dtype == torch.float32:
        for a, b in zip(kernel, ref):
            assert rel_l2(a, b) <= 1e-5
    else:
        plain = through(attention.rms_normalize_plain, x, dy)
        for name, a, p, b in zip(('y', 'dx'), kernel, plain, ref):
            assert rel_l2(a, b) <= 1.25 * rel_l2(p, b), (name, rel_l2(a, b), rel_l2(p, b))


def wm_512():
    """The benchmark's world-model configuration (`dreamer4-wm-512`) and
    the limits `wm_train_long` holds a train step to."""
    import json
    config = json.loads((WM_512 / 'configs' / 'dreamer4-wm-512.json').read_text())
    limits = json.loads((WM_512 / 'workloads' / 'wm_train_long.json').read_text())['limits']
    return config['kwargs'], limits


@pytest.mark.cuda
@pytest.mark.parametrize('shortcut', [False, True])
def test_world_model_step_with_the_pool_kernels_matches_one_without(gen, shortcut):
    """A whole `dreamer4-wm-512` training forward and backward (b2 x T192,
    bf16 over float32 weights) with the pool and normalization kernels
    against the same step on the plain code, same weights, batch and draws:
    the loss within the benchmark's `loss_gap` and every parameter's
    gradient norm within its `grad_gap` (|difference| over the larger of
    the plain norm and the median plain norm)."""
    from dreamer4_torch.models.world_model import DynamicsWorldModel
    from dreamer4_torch.ops import attn_pool as ap

    kw, limits = wm_512()
    torch.manual_seed(0)
    model = DynamicsWorldModel(**kw, dtype=torch.bfloat16, device='cuda')
    b, t = 2, 192
    batch = dict(latents=torch.tanh(torch.randn(b, t, kw['num_latent_tokens'], kw['dim_latent'],
                                                generator=gen, device='cuda')),
                 discrete_actions=torch.randint(0, 4, (b, t, 1), generator=gen, device='cuda'),
                 rewards=torch.randn(b, t, generator=gen, device='cuda'))

    def step():
        model.zero_grad(set_to_none=True)
        torch.manual_seed(1)
        draws = torch.Generator(device='cuda').manual_seed(2)
        loss = model(**batch, shortcut_train=shortcut, generator=draws, update_loss_ema=False)
        loss.backward()
        return loss.item(), {n: p.grad.float().norm().item()
                             for n, p in model.named_parameters() if p.grad is not None}

    counts = (ap.FWD_LAUNCHES, ap.BWD_LAUNCHES, ap.NORM_LAUNCHES)
    kernel_loss, kernel_norms = step()
    moved = [a - b for a, b in zip((ap.FWD_LAUNCHES, ap.BWD_LAUNCHES, ap.NORM_LAUNCHES), counts)]
    assert moved[0] >= kw['depth'] and moved[1] == 2 * kw['depth'] and moved[2] > 0, moved
    with chip_smoke.plain_pools():
        plain_loss, plain_norms = step()
    assert abs(kernel_loss - plain_loss) <= limits['loss_gap'] * abs(plain_loss)
    assert kernel_norms.keys() == plain_norms.keys()
    median = torch.tensor(list(plain_norms.values())).median().item()
    gaps = {n: abs(kernel_norms[n] - p) / max(p, median) for n, p in plain_norms.items()}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= limits['grad_gap'], (worst, gaps[worst])


@pytest.mark.cuda
def test_cached_dream_with_the_pool_kernels_matches_one_without(gen):
    """A prompted cached dream (b2, 4 prompt frames, 4 dreamed, 4 denoising
    steps) of the `dreamer4-wm-512` model in bf16 weights, with the pool and
    normalization kernels and without, same draws: each dream's latents
    against the float32 model's, the kernels' no further than 2x the plain
    code's distance (the bf16 prompt pass's factor in `chip_smoke.py`)."""
    from dreamer4_torch import DynamicsWorldModel, generate
    from dreamer4_torch.ops import attn_pool as ap
    from dreamer4_torch.ops.utils import cast_params_for_inference

    kw, _ = wm_512()
    torch.manual_seed(0)
    model = DynamicsWorldModel(**kw, dtype=torch.bfloat16, device='cuda').eval()
    ref = DynamicsWorldModel(**kw, device='cuda').eval()
    ref.load_state_dict(model.state_dict())
    cast_params_for_inference(model, torch.bfloat16)
    prompt = dict(prompt_latents=torch.rand((2, 4, kw['num_latent_tokens'], kw['dim_latent']),
                                            generator=gen, device='cuda') * 2 - 1,
                  prompt_discrete_actions=torch.randint(0, 4, (2, 4, 1), generator=gen,
                                                        device='cuda'))

    def dream(m):
        draws = torch.Generator(device='cuda').manual_seed(3)
        with torch.no_grad():
            return generate(m, draws, batch_size=2, time_steps=8, num_steps=4,
                            **prompt).latents[:, 4:].float()

    counts = (ap.FWD_LAUNCHES, ap.NORM_LAUNCHES)
    kernel = dream(model)
    assert ap.FWD_LAUNCHES > counts[0] and ap.NORM_LAUNCHES > counts[1]
    with chip_smoke.plain_pools():
        plain, want = dream(model), dream(ref)
    assert rel_l2(kernel, want) <= 2.0 * rel_l2(plain, want), (rel_l2(kernel, want),
                                                             rel_l2(plain, want))


# ------------------------------------------------------ GLU feedforward

GLU_CASES = [(41_472, 512, 'silu'), (41_472, 512, 'gelu'), (1_001, 384, 'silu'),
             (1_001, 512, 'gelu')]


def glu_feedforwards(gen, dim, activation, dtype):
    """A `FeedForward` computing in `dtype` over float32 parameters (random
    biases) and a float32 copy of it: the reference."""
    from dreamer4_torch.nn.attention import FeedForward

    torch.manual_seed(0)
    ff = FeedForward(dim, activation=activation, dtype=dtype, device='cuda')
    with torch.no_grad():
        for p in (ff.proj_in.bias, ff.proj_out.bias):
            p.copy_(0.5 * torch.randn(p.shape, generator=gen, device='cuda'))
    ref = FeedForward(dim, activation=activation, device='cuda')
    ref.load_state_dict(ff.state_dict())
    return ff, ref


def plain_call(ff, x):
    """The feedforward's plain code, also on the card."""
    with chip_smoke.plain_feedforward():
        return ff(x)


def glu_outputs(ff, run, x, dy):
    """run(ff, x)'s output and the gradients of x and of the feedforward's
    four projection parameters for the output gradient dy, as float32."""
    ps = [ff.proj_in.weight, ff.proj_in.bias, ff.proj_out.weight, ff.proj_out.bias]
    x = x.clone().requires_grad_()
    y = run(ff, x)
    grads = torch.autograd.grad(y, [x, *ps], dy.to(y.dtype))
    return [y.detach().float()] + [g.float() for g in grads]


GLU_NAMES = ('y', 'dx', 'dW_in', 'db_in', 'dW_out', 'db_out')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('M, dim, activation', GLU_CASES)
def test_glu_ff_kernels_match_the_plain_code(gen, dtype, M, dim, activation):
    """`FeedForward` on the card (the kernels, `ops/glu_ff.py`) against its
    plain code (`chip_smoke.plain_feedforward`) at M = 41,472, d = 512
    (`wm_train_long`'s trunk call), and at an odd M with an aligned width
    (384: f = 1024, no pads): output and the five gradients as relative L2
    distances. float32 within 1e-5 (orders of summation, the padded products
    block their sums otherwise); bf16 no further from the float32 plain
    result than the bf16 plain code, up to 1.25x (the same bf16 products;
    the GLU is rounded once, from float32). Each counter moves once a call."""
    from dreamer4_torch.ops import glu_ff

    ff, ref = glu_feedforwards(gen, dim, activation, dtype)
    x = torch.randn(M, dim, generator=gen, device='cuda').to(dtype)
    dy = torch.randn(M, dim, generator=gen, device='cuda')
    counters = lambda: (glu_ff.PACK_LAUNCHES, glu_ff.FWD_LAUNCHES, glu_ff.BWD_LAUNCHES,
                        glu_ff.UNPACK_LAUNCHES)
    before = counters()
    kernel = glu_outputs(ff, lambda m, t: m(t), x, dy)
    assert counters() == tuple(b + 1 for b in before)
    want = glu_outputs(ref, plain_call, x.float(), dy)
    if dtype == torch.float32:
        for name, a, b in zip(GLU_NAMES, kernel, want):
            assert rel_l2(a, b) <= 1e-5, (name, rel_l2(a, b))
    else:
        plain = glu_outputs(ff, plain_call, x, dy)
        for name, a, p, b in zip(GLU_NAMES, kernel, plain, want):
            assert rel_l2(a, b) <= 1.25 * rel_l2(p, b), (name, rel_l2(a, b), rel_l2(p, b))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('activation', ['silu', 'gelu'])
def test_glu_ff_kernels_write_every_pad_as_zero(gen, monkeypatch, dtype, activation):
    """Every output of the four kernels is allocated full of NaN: the pack's
    copies are bitwise `pack_reference`'s (every pad zero), the GLU's
    forward and backward write exact zeros in every pad column and match
    their references (float32 activation: 1e-6 relative in float32, one bf16
    rounding apart in bf16), the unpacked gradients are bitwise
    `unpack_reference`'s. M = 41,472, d = 512, f = 1365, P = 1368."""
    from dreamer4_torch.ops import glu_ff

    def nan_empty(shape, dtype, device):
        return torch.full(shape, float('nan'), dtype=dtype, device=device)

    monkeypatch.setattr(glu_ff, '_empty', nan_empty)
    ff, _ = glu_feedforwards(gen, 512, activation, dtype)
    ps = [ff.proj_in.weight, ff.proj_in.bias, ff.proj_out.weight, ff.proj_out.bias]
    M, f, P = 41_472, 1365, 1368
    packed = glu_ff._pack(*ps, dtype, f, P)
    for a, b in zip(packed, glu_ff.pack_reference(*ps, dtype, f, P)):
        assert torch.equal(a, b)

    x = torch.randn(M, 512, generator=gen, device='cuda').to(dtype)
    h = torch.addmm(packed[1], x, packed[0].t())
    assert bool((h[:, f:P] == 0).all()) and bool((h[:, P + f:] == 0).all())
    a = glu_ff._glu_fwd(h, f, activation)
    da = torch.randn(M, P, generator=gen, device='cuda').to(dtype)
    dh = glu_ff._glu_bwd(da, h, f, activation)
    assert bool((a[:, f:] == 0).all())
    assert bool((dh[:, f:P] == 0).all()) and bool((dh[:, P + f:] == 0).all())
    for got, want in ((a, glu_ff.glu_fwd_reference(h, f, activation)),
                      (dh, glu_ff.glu_bwd_reference(da, h, f, activation))):
        assert bool(torch.isfinite(got).all())
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * want.abs().max().item())
        else:
            # one bf16 step of the larger of the two, where they round apart
            step = torch.maximum(got.float().abs(), want.float().abs()) * 2.0 ** -7
            assert bool(((got.float() - want.float()).abs() <= step).all())

    grads = (torch.randn(2 * P, 512, generator=gen, device='cuda').to(dtype),
             torch.randn(2 * P, generator=gen, device='cuda'),
             torch.randn(512, P, generator=gen, device='cuda').to(dtype),
             torch.randn(512, generator=gen, device='cuda'))
    for got, want in zip(glu_ff._unpack(*grads, f, torch.float32),
                         glu_ff.unpack_reference(*grads, f, torch.float32)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_glu_ff_raises_on_what_its_kernels_do_not_take(gen):
    """A GLU over another activation, or a compute dtype other than float32
    and bf16, raises on the card: no configuration of the port builds one."""
    from dreamer4_torch.nn.attention import FeedForward

    x = torch.randn(4, 64, generator=gen, device='cuda')
    with pytest.raises(ValueError, match='activations'):
        FeedForward(64, activation='relu', use_glu=True, device='cuda')(x)
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        FeedForward(64, dtype=torch.float16, device='cuda')(x)
    # a feedforward without a GLU keeps its plain code on the card
    FeedForward(64, activation='relu_squared', device='cuda')(x)
