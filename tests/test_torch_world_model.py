"""The port's DynamicsWorldModel inference forward against the JAX model at
f32 on the CPU, with converted weights: a forward with `latent_is_noised`
and fixed signal levels, a prefill that builds the cache (`max_time`), then
one cached step.

Tolerance: 5e-5 absolute, 1e-4 relative — float32 through the trunk and
the heads (measured differences are ~3e-6).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamer4_tpu.models.world_model import DynamicsWorldModel as JWorldModel
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.models.world_model import DynamicsWorldModel

torch.set_num_threads(1)
SMALL = dict(dim=64, dim_latent=8, num_latent_tokens=4, num_spatial_tokens=4, max_steps=16,
             depth=4, time_block_every=2, attn_heads=2, attn_dim_head=32,
             num_discrete_actions=(4,), multi_token_pred_len=2, num_register_tokens=2,
             predict_terminals=True)


def close(a, b):
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
    np.testing.assert_allclose(np.asarray(a), b, atol=5e-5, rtol=1e-4)


def build_pair(**kw):
    cfg = {**SMALL, **kw}
    jm = JWorldModel(**cfg)
    rngs = {'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)}
    params = jm.init(rngs, latents=jnp.zeros((2, 3, 4, 8)), shortcut_train=False,
                     rewards=jnp.zeros((2, 3)), terminals=jnp.zeros((2,), bool),
                     discrete_actions=jnp.zeros((2, 2, 1), jnp.int32))['params']
    params = jax.tree.map(np.asarray, params)
    tm = DynamicsWorldModel(**cfg, device='cpu')
    tm.load_state_dict(flax_params_to_torch(params, tm))
    return jm, params, tm


@pytest.mark.parametrize('variant', ['bench_like', 'resampled_with_rewards'])
def test_inference_forward_prefill_and_cached_step(variant):
    kw = {} if variant == 'bench_like' else dict(
        num_spatial_tokens=3, add_reward_embed_to_agent_token=True,
        reward_encoder_type='symexp_two_hot', predict_terminals=False)
    jm, params, tm = build_pair(**kw)
    rng = np.random.default_rng(0)
    b, t = 2, 5
    lat = rng.standard_normal((b, t, 4, 8)).astype(np.float32)
    sig = rng.integers(0, 16, (b, t)).astype(np.int32)
    acts = rng.integers(0, 4, (b, t, 1)).astype(np.int32)
    rew = rng.standard_normal((b, t)).astype(np.float32)
    extra = dict(rewards=rew) if kw else {}

    @partial(jax.jit, static_argnames=['max_time'])
    def jfwd(lat, sig, acts, extra, cache=None, max_time=None):
        return jm.apply({'params': params}, latents=lat, signal_levels=sig, step_sizes=4,
                        discrete_actions=acts, cache=cache, max_time=max_time,
                        latent_is_noised=True, is_training=False, return_intermediates=True,
                        **extra)

    T = torch.from_numpy
    text = {k: T(v) for k, v in extra.items()}
    common = dict(step_sizes=4, latent_is_noised=True, return_intermediates=True)
    with torch.no_grad():
        jp, (je, _) = jfwd(lat, sig, acts, extra)
        tp, (te, _) = tm(latents=T(lat), signal_levels=T(sig), discrete_actions=T(acts),
                         **common, **text)
        close(jp.flow, tp.flow)
        close(je.agent, te.agent)

        # prefill over a longer cache buffer, then one cached frame
        jp, (je, jc) = jfwd(lat, sig, acts, extra, max_time=8)
        tp, (te, tc) = tm(latents=T(lat), signal_levels=T(sig), discrete_actions=T(acts),
                          max_time=8, **common, **text)
        close(jp.flow, tp.flow)
        assert tc.main.token_count == int(jc.main.token_count) == t
        close(jc.main.kv[0].k, tc.main.kv[0].k)

        lat1, a1 = lat[:, :1], acts[:, :1]
        one = {k: v[:, :1] for k, v in extra.items()}
        jp1, (je1, jc1) = jfwd(lat1, np.full((b, 1), 3, np.int32), a1, one, cache=jc)
        tp1, (te1, tc1) = tm(latents=T(lat1), signal_levels=torch.full((b, 1), 3),
                             discrete_actions=T(a1), cache=tc, **common,
                             **{k: T(v) for k, v in one.items()})
        close(jp1.flow, tp1.flow)
        close(je1.agent, te1.agent)
        assert tc1.main.token_count == t + 1


def test_heads_match():
    jm, params, tm = build_pair()
    e = np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32)
    pooled = e[:, :8]
    T = torch.from_numpy
    ap = lambda f, x: jm.apply({'params': params}, x, method=f)
    with torch.no_grad():
        close(ap(lambda m, x: m.to_reward_pred(x), e), tm.to_reward_pred(T(e)))
        close(ap(lambda m, x: m.value_head(x), e), tm.value_head(T(e)))
        pe = ap(lambda m, x: m.policy_head(x), e)
        close(pe, tm.policy_head(T(e)))
        close(ap(lambda m, x: m.to_state_terminal_pred(x), pooled),
              tm.to_state_terminal_pred(T(pooled)))
        jl = ap(lambda m, x: m.action_embedder.unembed(x, pred_head_index=1), pe)[0][0]
        close(jl, tm.action_embedder.unembed(T(np.array(pe)), pred_head_index=1)[0][0])


def test_training_forward_and_unported_options_raise():
    """The training forward needs the trainer's shortcut choice, as in the
    counterpart; MoT, refused here before, builds; an unknown name raises."""
    tm = DynamicsWorldModel(**SMALL, device='cpu')
    with pytest.raises(ValueError):
        tm(latents=torch.zeros(1, 2, 4, 8))
    assert DynamicsWorldModel(**SMALL, device='cpu', mot_temporal=True).transformer.use_mot
    with pytest.raises(TypeError):
        DynamicsWorldModel(**SMALL, device='cpu', no_such_option=1)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert DynamicsWorldModel(**SMALL).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError):
            DynamicsWorldModel(**SMALL)
