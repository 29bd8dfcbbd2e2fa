"""The port's AxialSpaceTimeTransformer: parity with the JAX trunk at f32 on
the CPU (converted weights), and the port's own "parallel == frame-by-frame
cached" invariant, copied from tests/test_transformer.py.

Tolerance: 2e-5 absolute, 1e-4 relative (as the JAX trunk's own
parallel-vs-cached test) — float32 through four layers.
"""
import jax
import numpy as np
import pytest
import torch

from dreamer4_tpu.models.transformer import AxialSpaceTimeTransformer as JTrunk
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.models.transformer import AxialSpaceTimeTransformer

torch.set_num_threads(1)
SMALL = dict(dim=64, depth=4, attn_heads=2, attn_dim_head=32, time_block_every=2,
             num_special_tokens=1)


def close(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4)


def tokens_np(b=2, t=5, s=7, d=64, seed=0):
    return np.random.default_rng(seed).standard_normal((b, t, s, d)).astype(np.float32)


def jax_and_port(**kw):
    cfg = {**SMALL, **kw}
    jm = JTrunk(**cfg)
    x = tokens_np()
    params = jm.init(jax.random.PRNGKey(1), x)['params']
    rng = np.random.default_rng(2)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32), params)
    tm = AxialSpaceTimeTransformer(**cfg, device='cpu')
    tm.load_state_dict(flax_params_to_torch(params, tm))
    return jm, params, tm


@pytest.mark.parametrize('use_flash', [False, True])
def test_trunk_matches_jax(use_flash):
    """Parallel pass, then a prefill that builds the cache and one cached
    frame. With the flash gate lowered to 1, every attention of the prefill
    and the space attention of the cached step take the flash branch."""
    flash = dict(use_flash_attention=use_flash, flash_min_scores=1)
    jm, params, tm = jax_and_port(**flash)
    japply = jax.jit(jm.apply, static_argnames=['max_time'])
    x = tokens_np()
    with torch.no_grad():
        jout, _ = japply({'params': params}, x)
        tout, _ = tm(torch.from_numpy(x))
        close(jout, tout)

        _, jcache = japply({'params': params}, x[:, :4], max_time=6)
        _, tcache = tm(torch.from_numpy(x[:, :4]), max_time=6)
        assert tcache.token_count == int(jcache.token_count) == 4
        jstep, jcache = japply({'params': params}, x[:, 4:5], cache=jcache)
        tstep, tcache = tm(torch.from_numpy(x[:, 4:5]), cache=tcache)
        close(jstep, tstep)
        for jkv, tkv in zip(jcache.kv, tcache.kv):
            close(jkv.k, tkv.k)
            close(jkv.v, tkv.v)


def test_trunk_matches_jax_without_value_residual_and_pools():
    jm, params, tm = jax_and_port(value_residual=False, use_attn_pool=False, query_heads=4)
    x = tokens_np()
    with torch.no_grad():
        close(jax.jit(jm.apply)({'params': params}, x)[0], tm(torch.from_numpy(x))[0])


def build(model, b=2, t=5, s=7, d=32, seed=0):
    torch.manual_seed(seed)
    return torch.randn(b, t, s, d)


@pytest.mark.parametrize('time_block_every', [1, 2])
@pytest.mark.parametrize('query_heads', [None, 8])
@pytest.mark.parametrize('use_attn_pool', [False, True])
def test_cached_frames_match_parallel_pass(time_block_every, query_heads, use_attn_pool):
    torch.manual_seed(1)
    model = AxialSpaceTimeTransformer(
        dim=32, depth=2, attn_heads=4, attn_dim_head=8, query_heads=query_heads,
        time_block_every=time_block_every, num_special_tokens=2,
        use_attn_pool=use_attn_pool, device='cpu')
    tokens = build(model)
    b, t, s, d = tokens.shape
    with torch.no_grad():
        parallel_out, _ = model(tokens)
        cache = model.init_cache(b, s, max_time=t)
        outs = []
        for i in range(t):
            out_i, cache = model(tokens[:, i:i + 1], cache=cache)
            outs.append(out_i)
    close(parallel_out, torch.cat(outs, dim=1))


def test_prefill_cache_continues_like_parallel_pass():
    torch.manual_seed(1)
    model = AxialSpaceTimeTransformer(dim=32, depth=2, attn_heads=4, attn_dim_head=8,
                                      time_block_every=2, num_special_tokens=1, device='cpu')
    tokens = build(model, t=6)
    with torch.no_grad():
        parallel_out, _ = model(tokens)
        _, cache = model(tokens[:, :3], max_time=6)
        outs = []
        for i in range(3, 6):
            out_i, cache = model(tokens[:, i:i + 1], cache=cache)
            outs.append(out_i)
    close(parallel_out[:, 3:], torch.cat(outs, dim=1))


def test_cached_forward_with_history_processes_last_frame():
    torch.manual_seed(1)
    model = AxialSpaceTimeTransformer(dim=32, depth=2, attn_heads=4, attn_dim_head=8,
                                      time_block_every=1, num_special_tokens=1, device='cpu')
    tokens = build(model, t=3)
    with torch.no_grad():
        _, cache = model(tokens[:, :2], max_time=3)
        full, new_cache = model(tokens, cache=cache)
        parallel, _ = model(tokens)
    assert new_cache.token_count == 3
    close(full[:, :2], tokens[:, :2])
    close(full[:, 2:], parallel[:, 2:])


@pytest.mark.parametrize('option', ['rnn_time', 'mot_temporal', 'h_net_layer',
                                    'time_ring_axis'])
def test_unported_options_raise(option):
    """The GRU time layer, MoT, the H-Net and ring attention (refused here
    before) build and run a forward (tests/test_torch_subsystems.py and
    tests/test_torch_parallel.py hold them against JAX). The ring looks up
    its mesh only in an uncached forward: a cached one runs without a mesh,
    an uncached one raises without it."""
    if option == 'time_ring_axis':
        model = AxialSpaceTimeTransformer(dim=32, depth=2, time_block_every=2, device='cpu',
                                          time_ring_axis='sp')
        tokens = torch.randn(2, 5, 3, 32)
        with torch.no_grad():
            out, _ = model(tokens, max_time=5)
            with pytest.raises(RuntimeError, match="'sp'"):
                model(tokens)
        assert out.shape == tokens.shape and bool(torch.isfinite(out).all())
        return
    model = AxialSpaceTimeTransformer(dim=32, depth=2, time_block_every=2, device='cpu',
                                      **{option: 1})
    tokens = torch.randn(2, 5, 3, 32)
    with torch.no_grad():
        out, _ = model(tokens)
    assert out.shape == tokens.shape and bool(torch.isfinite(out).all())


def test_default_device_is_cuda():
    """The trunk is an entry point: with no device it runs on the card, and
    without a card it raises rather than fall back to the CPU."""
    kw = dict(dim=32, depth=2, attn_heads=4, attn_dim_head=8, time_block_every=2)
    if torch.cuda.is_available():
        model = AxialSpaceTimeTransformer(**kw)
        assert model.device.type == 'cuda'
        assert model.init_cache(1, 3, max_time=4).kv[0].k.device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError):
            AxialSpaceTimeTransformer(**kw)
    assert AxialSpaceTimeTransformer(**kw, device='cpu').init_cache(
        1, 3, max_time=4).kv[0].k.device.type == 'cpu'
