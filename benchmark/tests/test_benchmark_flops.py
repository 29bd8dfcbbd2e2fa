"""The FLOP counts of `benchmark/flops.py` against torch's own count of the
plain reference's matrix products at a tiny size, and the kernels' bounds
against hand counts.

torch's `FlopCounterMode` counts every product the reference computes, the
attention scores of every (query, key) pair included; `flops.py` counts only
the pairs the masks allow. The tests add the masked pairs back."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, harness
from benchmark.reference.ops import Precision
from benchmark.reference.tokenizer import Tokenizer
from benchmark.reference.trunk import Trunk
from benchmark.reference.world_model import WorldModel

from .tiny import tiny_tokenizer, tiny_world_model, weights_of


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            fn()
    return fc.get_total_flops()


def masked_pairs_flops(*, rows, frames, s, heads, dim_head, depth, time_every, num_special,
                       only_itself=False):
    """4 D per (query, key) pair that the masks hide: what a dense count adds."""
    space_hidden = s * s - flops.space_pairs(s, num_special, only_itself)
    time_hidden = frames * frames - flops.causal_pairs(frames)
    total = 0
    for i in range(depth):
        if (i + 1) % time_every == 0:
            total += rows * s * heads * time_hidden
        else:
            total += rows * frames * heads * space_hidden
    return 4 * dim_head * total


def test_trunk_hand_count():
    """rows 2, frames 3, s 4, dim 8, depth 2 (a space then a time layer),
    2 heads of 4, one special token; counted by hand."""
    n, hd, f = 24, 8, 21
    per_layer = 2 * n * 8 * hd * 4 + 2 * n * 8 * 2 * 2 + 2 * n * 8 * 2 * f + 2 * n * f * 8
    space = 4 * 4 * (2 * 3 * 2 * (3 * 3 + 1 * 4))
    time = 4 * 4 * (2 * 4 * 2 * 6)
    pool = lambda L: n * (2 * 8 * 256 + 4 * L * 8 * 256 + 4 * L * 256 + 2 * 8 * 4 + 2 * 256 * 8)
    cross = 6 * (2 * 8 * 8 + 4 * 3 * 8 * 8 + 4 * 4 * 2 * 3 + 2 * 8 * 2 + 2 * 8 * 8
                 + 2 * 8 * 2 * f + 2 * f * 8)
    expected = 2 * n * 8 * hd + 2 * per_layer + space + time + pool(3) + pool(5) + cross
    assert flops.trunk_flops(rows=2, frames=3, s=4, dim=8, depth=2, heads=2, dim_head=4,
                             time_every=2, num_special=1) == expected


def test_trunk_matches_the_counted_reference():
    cfg, P = tiny_world_model()
    kw = cfg['kwargs']
    s = flops.wm_tokens_per_frame(kw)
    x = torch.randn(2, 5, s, kw['dim'])
    trunk = Trunk(P, 'transformer.', depth=kw['depth'], heads=kw['attn_heads'],
                  time_every=kw['time_block_every'], num_special=1, final_norm=False,
                  prec=Precision())
    shape = dict(rows=2, frames=5, s=s, heads=kw['attn_heads'], dim_head=kw['attn_dim_head'],
                 depth=kw['depth'], time_every=kw['time_block_every'], num_special=1)
    ours = flops.trunk_flops(dim=kw['dim'], **shape)
    assert ours + masked_pairs_flops(**shape) == counted(lambda: trunk(x))


def test_world_model_step_matches_the_counted_reference():
    cfg, P = tiny_world_model()
    kw = cfg['kwargs']
    b, t = 2, 6
    model = WorldModel(P, cfg, Precision())
    lat = torch.rand(b, t, kw['num_latent_tokens'], kw['dim_latent'])
    draws = {'signal_levels': torch.randint(0, kw['max_steps'], (b, t)),
             'noise': torch.randn(lat.shape)}
    acts = torch.randint(0, kw['num_discrete_actions'][0], (b, t))
    rew = torch.randn(b, t)
    fwd = counted(lambda: model.loss(lat, acts, rew, draws, shortcut=False))
    s = flops.wm_tokens_per_frame(kw)
    dense = masked_pairs_flops(rows=b, frames=t, s=s, heads=kw['attn_heads'],
                               dim_head=kw['attn_dim_head'], depth=kw['depth'],
                               time_every=kw['time_block_every'], num_special=1)
    assert flops.wm_train_step_flops(kw, b, t, shortcut=False) == 3 * (fwd - dense)
    predict = flops.wm_predict_flops(kw, b, t)
    assert (flops.wm_train_step_flops(kw, b, t, shortcut=True)
            == flops.wm_train_step_flops(kw, b, t, shortcut=False) + 2 * predict)


def test_tokenizer_step_matches_the_counted_reference():
    cfg, P = tiny_tokenizer()
    kw = cfg['kwargs']
    b, t = 2, 3
    model = Tokenizer(P, cfg, Precision())
    h, w, p = kw['image_height'], kw['image_width'], kw['patch_size']
    video = torch.rand(b, 3, t, h, w)
    draws = {'patch_mask': torch.rand(b, t, h // p, w // p) < 0.5,
             'time_indices': torch.zeros(b, dtype=torch.long),
             'noise': torch.randn(b, t, h, w, 3)}
    fwd = counted(lambda: model.loss(video, draws, torch.ones(())))
    s = (h // p) * (w // p) + kw['num_latent_tokens']
    common = dict(rows=b, frames=t, s=s, heads=kw['attn_heads'], dim_head=kw['attn_dim_head'],
                  time_every=kw['time_block_every'], num_special=kw['num_latent_tokens'])
    dense = (masked_pairs_flops(depth=kw['encoder_depth'], **common)
             + masked_pairs_flops(depth=kw['decoder_depth'], only_itself=True, **common))
    assert flops.tok_train_step_flops(kw, b, t) == 3 * (fwd - dense)


def test_flash_bounds_hand_count():
    """B 1, 1 head, n 2, D 2, bf16: 3 causal pairs."""
    e, D, pairs = 2, 2, 3
    rows = 1 * 1 * 2 * D * e
    lse = 2 * 4
    hbm, sfu = flops.HBM_BYTES_PER_S, flops.SFU_OPS_PER_S
    peak = flops.PEAK_FLOPS['bfloat16']
    want = {'k1': max(4 * rows / hbm, 4 * D * pairs / peak, 2 * pairs / sfu),
            'k1_lse': max((4 * rows + lse) / hbm, 4 * D * pairs / peak, 2 * pairs / sfu),
            'k2': max((6 * rows + 2 * lse) / hbm, 6 * D * pairs / peak, 2 * pairs / sfu),
            'k3': max((6 * rows + 2 * lse) / hbm, 8 * D * pairs / peak, 2 * pairs / sfu)}
    assert flops.flash_bounds_s(B=1, heads=1, n=2, dim_head=2, dtype='bfloat16') == want


def test_small_bounds_hand_count():
    """B 3 rows of n 2 positions, 2 heads of 4, float32, 3 allowed pairs."""
    flat = 3 * 2 * 2 * 4 * 4
    hbm, peak = flops.HBM_BYTES_PER_S, flops.PEAK_FLOPS['float32']
    got = flops.small_bounds_s(B=3, n=2, heads=2, dim_head=4, dtype='float32', allowed_pairs=3)
    assert got == {'k4': max((4 * flat + 4) / hbm, 4 * 4 * 3 * 3 * 2 / peak),
                   'k5': max((7 * flat + 4) / hbm, 10 * 4 * 3 * 3 * 2 / peak)}


def test_rollout_is_its_passes():
    cfg, _ = tiny_world_model()
    kw = cfg['kwargs']
    b, p, t, k = 3, 2, 5, 4
    heads = b * 2 * kw['dim'] * 255 + flops.wm_policy_flops(kw, b, 1) + flops.wm_value_flops(kw, b)
    want = flops.wm_predict_flops(kw, b, p) + sum(
        (k + 1) * flops.wm_predict_flops(kw, b, 1, time_pairs=i + 1) + heads
        for i in range(p, t))
    assert flops.wm_rollout_flops(kw, b, p, t, k) == want
    # one frame against i earlier ones: i + 1 pairs per row's time attention
    one = flops.trunk_flops(rows=b, frames=1, s=flops.wm_tokens_per_frame(kw), dim=kw['dim'],
                            depth=kw['depth'], heads=kw['attn_heads'],
                            dim_head=kw['attn_dim_head'], time_every=kw['time_block_every'],
                            num_special=1, time_pairs=1)
    more = flops.trunk_flops(rows=b, frames=1, s=flops.wm_tokens_per_frame(kw), dim=kw['dim'],
                             depth=kw['depth'], heads=kw['attn_heads'],
                             dim_head=kw['attn_dim_head'], time_every=kw['time_block_every'],
                             num_special=1, time_pairs=4)
    n_time = kw['depth'] // kw['time_block_every']
    assert more - one == n_time * 4 * kw['attn_dim_head'] * b * flops.wm_tokens_per_frame(kw) \
        * kw['attn_heads'] * 3


def test_weights_are_made_from_the_seed():
    cfg, _ = tiny_world_model()
    a = weights_of('wm', 5)
    b = weights_of('wm', 5)
    c = weights_of('wm', 6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
    assert harness.sub_seed(2 ** 31 + 7, 'weights') != harness.sub_seed(2 ** 31 + 8, 'weights')
