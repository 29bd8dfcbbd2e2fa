"""The port's attention modules against the JAX package at f32 on the CPU,
with flax weights converted by `dreamer4_torch.convert`: `Attention` on the
masked path, the flash_spec path and the cached path, cross attention,
`FeedForward`, `AttentionPool` and `LearnedQueriesAttentionPool`.

Tolerance: 2e-5 absolute, 1e-4 relative — float32 through a few matmuls
whose sums run in another order in each framework.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamer4_tpu.nn import attention as jattn
from dreamer4_tpu.ops.masks import build_attend_mask as j_build_attend_mask
from dreamer4_tpu.ops.rotary import rotary_frequencies as j_rotary_frequencies
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.nn import attention as tattn
from dreamer4_torch.ops.rotary import rotary_frequencies

torch.set_num_threads(1)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(j, t):
    np.testing.assert_allclose(np.asarray(j), t.detach().numpy(), atol=2e-5, rtol=1e-4)


def perturbed(params, seed):
    """Flax init leaves norms at 1 / 0; perturb every leaf so the test sees
    the weights actually being used."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.1 * rand(rng, *x.shape), params)


def convert(params, module):
    module.load_state_dict(flax_params_to_torch(params, module))
    return module


T = lambda x: torch.from_numpy(np.array(x))


@pytest.mark.parametrize('query_heads', [None, 4])
@pytest.mark.parametrize('use_flash', [False, True])
def test_attention_self(query_heads, use_flash):
    rng = np.random.default_rng(0)
    B, n, d, h, dh = 3, 6, 32, 2, 16
    x, rv = rand(rng, B, n, d), rand(rng, B, n, h, dh)
    mask = j_build_attend_mask(n, n, causal=True)
    kw = dict(dim=d, dim_head=dh, heads=h, query_heads=query_heads)
    jm = jattn.Attention(**kw)
    jrot = j_rotary_frequencies(dh, n)
    spec = jattn.FlashSpec(causal=True) if use_flash else None
    jargs = dict(rotary=jrot, mask=None if use_flash else mask, residual_values=rv,
                 flash_spec=spec)
    params = perturbed(jm.init(jax.random.PRNGKey(0), x, **jargs)['params'], 1)
    jout = jm.apply({'params': params}, x, **jargs)

    tm = convert(params, tattn.Attention(**kw))
    tspec = tattn.FlashSpec(causal=True) if use_flash else None
    with torch.no_grad():
        tout = tm(T(x), rotary=rotary_frequencies(dh, n),
                  mask=None if use_flash else T(mask), residual_values=T(rv), flash_spec=tspec)
    close(jout.out, tout.out)
    close(jout.normed_inputs, tout.normed_inputs)


@pytest.mark.parametrize('use_flash', [False, True])
def test_attention_cached(use_flash):
    """A prefix written into the cache, then one cached step at offset."""
    rng = np.random.default_rng(2)
    B, d, h, dh, max_len, P = 2, 32, 2, 16, 8, 5
    x = rand(rng, B, P + 1, d)
    rv = rand(rng, B, P + 1, h, dh)
    kw = dict(dim=d, dim_head=dh, heads=h)
    jm = jattn.Attention(**kw)
    params = perturbed(jm.init(jax.random.PRNGKey(0), x[:, :1], residual_values=rv[:, :1])
                       ['params'], 3)
    tm = convert(params, tattn.Attention(**kw))

    jrot = j_rotary_frequencies(dh, P)
    jcache = jattn.KVCache.create(B, h, max_len, dh)
    jspec = jattn.FlashSpec(causal=True) if use_flash else None
    jmask = None if use_flash else (jnp.arange(max_len)[None] <= jnp.arange(P)[:, None])
    jpre = jm.apply({'params': params}, x[:, :P], kv_cache=jcache, rotary=jrot, mask=jmask,
                    residual_values=rv[:, :P], flash_spec=jspec)
    jstep = jm.apply({'params': params}, x[:, P:], kv_cache=jpre.cache,
                     rotary=j_rotary_frequencies(dh, 1, offset=P),
                     mask=jnp.arange(max_len)[None] <= P, residual_values=rv[:, P:])

    tcache = tattn.KVCache.create(B, h, max_len, dh)
    tspec = tattn.FlashSpec(causal=True) if use_flash else None
    tmask = None if use_flash else (torch.arange(max_len)[None] <= torch.arange(P)[:, None])
    with torch.no_grad():
        tpre = tm(T(x[:, :P]), kv_cache=tcache, rotary=rotary_frequencies(dh, P), mask=tmask,
                  residual_values=T(rv[:, :P]), flash_spec=tspec)
        tstep = tm(T(x[:, P:]), kv_cache=tpre.cache,
                   rotary=rotary_frequencies(dh, 1, offset=P),
                   mask=torch.arange(max_len)[None] <= P, residual_values=T(rv[:, P:]))
    close(jpre.out, tpre.out)
    close(jstep.out, tstep.out)
    assert tstep.cache.length == int(jstep.cache.length) == P + 1
    close(jstep.cache.k, tstep.cache.k)
    close(jstep.cache.v, tstep.cache.v)


def test_kv_cache_append_writes_in_place():
    cache = tattn.KVCache.create(1, 1, 4, 2)
    k = torch.ones(1, 1, 2, 2)
    new = cache.append(k, 2 * k)
    assert new.k is cache.k and new.length == 2 and cache.length == 0
    assert cache.k[0, 0, :2].eq(1).all() and cache.v[0, 0, 2:].eq(0).all()
    with pytest.raises(ValueError):
        new.append(torch.ones(1, 1, 3, 2), torch.ones(1, 1, 3, 2))


def test_cross_attention_with_context_norm():
    rng = np.random.default_rng(4)
    x, ctx = rand(rng, 4, 2, 32), rand(rng, 4, 7, 32)
    kw = dict(dim=32, dim_head=16, heads=2, value_residual=False, pre_context_rmsnorm=True)
    jm = jattn.Attention(**kw)
    params = perturbed(jm.init(jax.random.PRNGKey(0), x, context=ctx)['params'], 5)
    tm = convert(params, tattn.Attention(**kw))
    with torch.no_grad():
        close(jm.apply({'params': params}, x, context=ctx).out, tm(T(x), context=T(ctx)).out)


@pytest.mark.parametrize('activation', ['silu', 'relu_squared'])
def test_feedforward(activation):
    rng = np.random.default_rng(6)
    x = rand(rng, 3, 5, 32)
    jm = jattn.FeedForward(dim=32, activation=activation)
    params = perturbed(jm.init(jax.random.PRNGKey(0), x)['params'], 7)
    tm = convert(params, tattn.FeedForward(32, activation=activation))
    with torch.no_grad():
        close(jm.apply({'params': params}, x), tm(T(x)))


@pytest.mark.parametrize('stacked', [False, True])
def test_attention_pool(stacked):
    rng = np.random.default_rng(8)
    x = rand(rng, 2, 3, 32)
    hiddens = [rand(rng, 2, 3, 32) for _ in range(5)]
    jm = jattn.AttentionPool(dim=32)
    params = perturbed(jm.init(jax.random.PRNGKey(0), x, hiddens)['params'], 9)
    tm = convert(params, tattn.AttentionPool(32))
    th = [T(h) for h in hiddens]
    with torch.no_grad():
        if stacked:
            normed = torch.stack([tattn.rms_normalize(h).reshape(-1, 32) for h in th])
            tout = tm(T(x), th, normed_hiddens=normed)
        else:
            tout = tm(T(x), th)
    close(jm.apply({'params': params}, x, hiddens), tout)


def test_learned_queries_pool():
    rng = np.random.default_rng(10)
    x = rand(rng, 2, 3, 6, 8)
    kw = dict(num_queries=4, dim=32, dim_kv_input=8, heads=2, dim_head=16)
    jm = jattn.LearnedQueriesAttentionPool(**kw)
    params = perturbed(jm.init(jax.random.PRNGKey(0), x)['params'], 11)
    tm = convert(params, tattn.LearnedQueriesAttentionPool(**kw))
    with torch.no_grad():
        close(jm.apply({'params': params}, x), tm(T(x)))


def test_converter_rejects_leftover_and_missing_keys():
    jm = jattn.FeedForward(dim=16)
    params = jm.init(jax.random.PRNGKey(0), np.zeros((1, 16), np.float32))['params']
    params = jax.tree.map(np.asarray, params)
    tm = tattn.FeedForward(16)
    with pytest.raises(KeyError):
        flax_params_to_torch({**params, 'extra': {'kernel': np.zeros((16, 16))}}, tm)
    with pytest.raises(KeyError):
        flax_params_to_torch({k: v for k, v in params.items() if k != 'norm'}, tm)
    with pytest.raises(ValueError):
        flax_params_to_torch({**params, 'norm': {'scale': np.zeros(15)}}, tm)
