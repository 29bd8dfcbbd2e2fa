"""Continuous actions, proprioception and the state-prediction head in the
port against the JAX package, at float32 on the CPU, with converted weights
and the JAX draws replayed.

The model is the reacher recipe's (examples/train_reacher_proprio_dynamics.py:
dim 64, depth 2, 6 Beta actions in [-1, 1], 4-dim proprio, the action
embedding added to the spatial tokens), with the state-prediction head.
`jax.random.beta` is a rejection sampler, whose stream the port does not
share: a Beta draw is replayed by asking `jax.random.beta` for it with the
JAX key of that draw and the port's own (alpha, beta), which agree with
JAX's to rounding. Gaussian draws are the JAX normals of the same keys.

Tolerances, all float32:
  - dists and `ActionEmbedder`: 1e-5 (lgamma / digamma of two libraries);
  - training losses 2e-5 absolute and 1e-4 relative; gradients 2e-5
    absolute and 1e-3 relative, as tests/test_torch_train.py;
  - rollouts (`generate`, the interactor): latents and proprio 2e-4,
    rewards and values 2e-3, log probs 2e-4, actions 2e-5;
  - RL losses and stats 1e-5 absolute and 1e-4 relative, gradients 2e-5
    absolute and 1e-3 relative, as tests/test_torch_rl.py;
  - trainer steps: parameters as tests/test_torch_env.py (1e-6, Muon's
    1e-5, within rounding-of-zero gradients 2.01 lr per update).
"""
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import dreamer4_tpu.train.optim as joptim
from test_torch_env import GradSpy, assert_params_close
from dreamer4_tpu.data import experience as jexperience
from dreamer4_tpu.envs.interact import EnvInteractor as JEnvInteractor
from dreamer4_tpu.envs.mocks import MockStateEnv as JMockStateEnv
from dreamer4_tpu.envs.world_model_env import DynamicsWorldModelWrapper as JWrapper
from dreamer4_tpu.models.tokenizer import VideoTokenizer as JTokenizer
from dreamer4_tpu.models.generate import generate as jgenerate
from dreamer4_tpu.models.rl import rl_losses as j_rl_losses
from dreamer4_tpu.models.world_model import DynamicsWorldModel as JWorldModel
from dreamer4_tpu.nn.action_embedder import ActionEmbedder as JActionEmbedder
from dreamer4_tpu.ops import dists as jdists
from dreamer4_tpu.train.trainers import BehaviorCloneTrainer as JBehaviorCloneTrainer
from dreamer4_tpu.train.trainers import SimTrainer as JSimTrainer
import dreamer4_torch.train.optim as toptim
from dreamer4_torch import (BehaviorCloneTrainer, DreamTrainer, EnvInteractor, SimTrainer,
                            VideoTokenizer)
from dreamer4_torch.data import experience as texperience
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.data.experience import Experience
from dreamer4_torch.envs import interact as interact_module
from dreamer4_torch.envs.mocks import MockStateEnv
from dreamer4_torch.envs import world_model_env
from dreamer4_torch.envs.world_model_env import DynamicsWorldModelWrapper
from dreamer4_torch.models import generate as generate_module
from dreamer4_torch.models import world_model as world_model_module
from dreamer4_torch.models.generate import generate
from dreamer4_torch.models.rl import rl_losses
from dreamer4_torch.models.world_model import DynamicsWorldModel, WorldModelLosses
from dreamer4_torch.nn.action_embedder import ActionEmbedder, Actions
from dreamer4_torch.ops import dists as tdists

torch.set_num_threads(1)
T = torch.from_numpy
# examples/train_reacher_proprio_dynamics.py:130-136, with the state head
REACHER = dict(dim=64, dim_latent=16, num_latent_tokens=8, num_spatial_tokens=8, max_steps=16,
               depth=2, time_block_every=2, attn_heads=4, attn_dim_head=16,
               num_continuous_actions=6, continuous_dist_type='beta',
               continuous_target_action_range=(-1.0, 1.0), dim_proprio=4,
               multi_token_pred_len=4, num_register_tokens=4, predict_terminals=False,
               add_action_embed_to_spatial=True)
CFG = dict(REACHER, add_state_pred_head=True)
DIST_TYPES = ('gaussian', 'squashed_gaussian', 'beta')


def close(a, b, atol, rtol=0.0, err_msg=''):
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
    np.testing.assert_allclose(np.asarray(a), b, atol=atol, rtol=rtol, err_msg=err_msg)


def as_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ models

@functools.cache
def _jax_params(items):
    cfg = dict(items)
    jm = JWorldModel(**cfg)
    b, t = 2, 4
    kw = dict(latents=jnp.zeros((b, t, cfg['num_latent_tokens'], cfg['dim_latent'])),
              shortcut_train=False, rewards=jnp.zeros((b, t)))
    if cfg.get('num_continuous_actions'):
        kw['continuous_actions'] = jnp.full((b, t - 1, cfg['num_continuous_actions']), 0.1)
    if cfg.get('num_discrete_actions'):
        kw['discrete_actions'] = jnp.zeros((b, t - 1, 1), jnp.int32)
    if cfg.get('dim_proprio'):
        kw['proprio'] = jnp.zeros((b, t, cfg['dim_proprio']))
    init = jax.jit(lambda rngs: jm.init(rngs, **kw)['params'])
    params = init({'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)})
    return jax.tree.map(np.asarray, params)


def build_pair(**kw):
    """The JAX world model and the port's, with the JAX weights."""
    cfg = {**CFG, **kw}
    params = _jax_params(tuple(sorted(cfg.items())))
    tm = DynamicsWorldModel(**cfg, device='cpu')
    tm.load_state_dict(flax_params_to_torch(params, tm))
    return JWorldModel(**cfg), params, tm


def beta_replay(key):
    """A Beta sampler for the port that returns `jax.random.beta(key, ...)`
    at the port's concentrations."""
    def sample(alpha, beta):
        x = jax.random.beta(key, jnp.asarray(as_np(alpha)), jnp.asarray(as_np(beta)))
        return T(np.array(x))
    return sample


# ------------------------------------------------------------------- dists

def dist_params(seed, shape=(3, 5, 6)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((*shape, 2)) * 1.5).astype(np.float32)


def dist_targets(dist_type, seed, shape=(3, 5, 6)):
    rng = np.random.default_rng(seed)
    if dist_type == 'gaussian':
        return (rng.standard_normal(shape) * 2).astype(np.float32)
    lo = -1.0 if dist_type == 'squashed_gaussian' else 0.0
    # some targets on and past the edges of the support
    t = rng.uniform(lo - 0.05, 1.05, shape).astype(np.float32)
    t.flat[:3] = (lo, 1.0, 0.5)
    return t


@pytest.mark.parametrize('fn', ['sample', 'log_prob', 'entropy', 'kl', 'rescale'])
@pytest.mark.parametrize('dist_type', DIST_TYPES)
def test_continuous_dists_match_jax(dist_type, fn):
    params = dist_params(0)
    jparams, tparams = jnp.asarray(params), T(params)
    if fn == 'sample':
        key = jax.random.PRNGKey(3)
        for temp in (1.0, 0.5):
            want = jdists.continuous_sample(key, jparams, dist_type, temperature=temp)
            noise = (beta_replay(key) if dist_type == 'beta'
                     else T(np.array(jax.random.normal(key, params.shape[:-1]))))
            got = tdists.continuous_sample(tparams, dist_type, noise, temperature=temp)
            close(want, got, 1e-5, err_msg=str(temp))
    elif fn == 'log_prob':
        targets = dist_targets(dist_type, 1)
        for eps in (1e-5, 1e-3):
            close(jdists.continuous_log_prob(jparams, jnp.asarray(targets), dist_type, eps=eps),
                  tdists.continuous_log_prob(tparams, T(targets), dist_type, eps=eps), 1e-5,
                  1e-5)
    elif fn == 'entropy':
        close(jdists.continuous_entropy(jparams, dist_type),
              tdists.continuous_entropy(tparams, dist_type), 1e-5, 1e-5)
    elif fn == 'kl':
        other = dist_params(2)
        want = jdists.continuous_kl(jparams, jnp.asarray(other), dist_type)
        got = tdists.continuous_kl(tparams, T(other), dist_type)
        close(want, got, 1e-5, 1e-5)
        assert float(tdists.continuous_kl(tparams, tparams, dist_type).abs().max()) < 1e-5
    else:
        assert jdists.native_range(dist_type) == tdists.native_range(dist_type)
        x = dist_targets(dist_type, 4)
        close(jdists.rescale(jnp.asarray(x), (0.0, 1.0), (-2.0, 3.0)),
              tdists.rescale(T(x), (0.0, 1.0), (-2.0, 3.0)), 1e-6)
        if dist_type == 'gaussian':
            with pytest.raises(ValueError, match='unbounded'):
                tdists.rescale_from_native(T(x), dist_type, (-1.0, 1.0))
        else:
            close(jdists.rescale_from_native(jnp.asarray(x), dist_type, (-0.5, 2.0)),
                  tdists.rescale_from_native(T(x), dist_type, (-0.5, 2.0)), 1e-6)


def test_continuous_dists_stay_finite_in_bf16():
    """Params in bf16: the terms are float32, so a target of 1 - 1e-6 (which
    rounds to 1 in bf16) keeps a finite log prob."""
    params = T(dist_params(0)).bfloat16()
    t = torch.full((3, 5, 6), 1.0 - 1e-6)
    for dist_type in DIST_TYPES:
        lp = tdists.continuous_log_prob(params, t, dist_type)
        assert lp.dtype == torch.float32 and torch.isfinite(lp).all()
        assert tdists.continuous_entropy(params, dist_type).dtype == torch.float32


def test_beta_sample_moments():
    """The port's own Beta draws (gamma ratio, from a generator) against the
    mean a / (a + b) and variance ab / ((a + b)^2 (a + b + 1)): 200k draws,
    a standard error of about 2e-3 of the mean."""
    alpha = torch.tensor([1.0, 2.5, 7.0, 1.2])
    beta = torch.tensor([1.0, 4.0, 1.5, 9.0])
    g = torch.Generator().manual_seed(0)
    x = tdists.beta_sample(alpha.expand(200_000, 4), beta.expand(200_000, 4), generator=g)
    assert ((x > 0) & (x < 1)).all()
    s = alpha + beta
    close(alpha / s, x.mean(0), 5e-3)
    close(alpha * beta / (s.square() * (s + 1)), x.var(0), 2e-3)


# ------------------------------------------------------------ ActionEmbedder

@pytest.mark.parametrize('norm_stats', [False, True])
@pytest.mark.parametrize('dist_type', DIST_TYPES)
def test_action_embedder_continuous_matches_jax(dist_type, norm_stats):
    """Embed (with and without norm stats), unembed at both head forms,
    sample, the rescale toward the environment, log probs and entropies
    (with `soft_validate_range`), and `kl_div`, on mixed discrete and
    continuous actions."""
    kw = dict(dim=8, num_discrete_actions=(4,), num_continuous_actions=3,
              continuous_dist_type=dist_type, continuous_target_action_range=(-2.0, 2.0),
              can_unembed=True, unembed_dim=12, num_unembed_preds=2,
              continuous_norm_stats=((0.5, 2.0), (-1.0, 0.5), (0.0, 1e-9)) if norm_stats else None)
    jae = JActionEmbedder(**kw)
    rng = np.random.default_rng(1)
    disc = rng.integers(0, 4, (2, 5, 1)).astype(np.int32)
    cont = rng.uniform(-1, 1, (2, 5, 3)).astype(np.float32)
    params = jae.init(jax.random.PRNGKey(0), discrete_actions=jnp.asarray(disc),
                      continuous_actions=jnp.asarray(cont))['params']
    params = jax.tree.map(np.asarray, params)
    params['continuous_action_unembed'] = (rng.standard_normal(
        params['continuous_action_unembed'].shape) * 0.3).astype(np.float32)
    tae = ActionEmbedder(**kw, device='cpu')
    tae.load_state_dict(flax_params_to_torch(params, tae))
    assert tae.continuous_action_unembed.shape == (3, 2, 12, 2)
    apply = partial(jae.apply, {'params': params})
    embeds = rng.standard_normal((2, 5, 12)).astype(np.float32)
    other = rng.standard_normal((2, 5, 12)).astype(np.float32)
    native = (rng.uniform(0.0, 1.0, (2, 5, 3)) if dist_type == 'beta'
              else rng.uniform(-1.0, 1.0, (2, 5, 3))).astype(np.float32)

    with torch.no_grad():
        close(apply(jnp.asarray(disc), jnp.asarray(cont)), tae(T(disc), T(cont)), 1e-5)
        for head in (None, 1):
            (_, jp), (_, tp) = (apply(jnp.asarray(embeds), pred_head_index=head,
                                      method=jae.unembed),
                                tae.unembed(T(embeds), pred_head_index=head))
            assert tp.shape == ((2, 2, 5, 3, 2) if head is None else (2, 5, 3, 2))
            close(jp, tp, 1e-5)
            for soft in (False, True):
                (jlp, jent), (tlp, tent) = (
                    apply(jnp.asarray(embeds), discrete_targets=jnp.asarray(disc),
                          continuous_targets=jnp.asarray(native), pred_head_index=head,
                          return_entropies=True, soft_validate_range=soft,
                          method=jae.log_probs),
                    tae.log_probs(T(embeds), discrete_targets=T(disc),
                                  continuous_targets=T(native), pred_head_index=head,
                                  return_entropies=True, soft_validate_range=soft))
                for j, t in ((jlp, tlp), (jent, tent)):
                    close(j.discrete, t.discrete, 1e-5)
                    close(j.continuous, t.continuous, 1e-5, 1e-5)

        key = jax.random.PRNGKey(5)
        jd, jc = apply(key, jnp.asarray(embeds), pred_head_index=1, continuous_temperature=0.7,
                       method=jae.sample)
        k_discrete, k_cont = jax.random.split(key)
        gumbels = [T(np.array(jax.random.gumbel(jax.random.split(k_discrete, 1)[0], (2, 5, 4))))]
        noise = (beta_replay(k_cont) if dist_type == 'beta'
                 else T(np.array(jax.random.normal(k_cont, (2, 5, 3)))))
        td, tc = tae.sample(T(embeds), gumbels, noise, pred_head_index=1,
                            continuous_temperature=0.7)
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
        close(jc, tc, 1e-5)
        if dist_type == 'gaussian':
            assert tae.target_action_range is None
        else:
            assert tae.target_action_range == (-2.0, 2.0)
            close(apply(jnp.asarray(native), method=jae.rescale_for_env),
                  tae.rescale_for_env(T(native)), 1e-6)

        src = tae.unembed(T(embeds), pred_head_index=0)
        tgt = tae.unembed(T(other), pred_head_index=0)
        jsrc = apply(jnp.asarray(embeds), pred_head_index=0, method=jae.unembed)
        jtgt = apply(jnp.asarray(other), pred_head_index=0, method=jae.unembed)
        for reduce in (True, False):
            jkl = jae.kl_div(jsrc, jtgt, reduce_across_num_actions=reduce)
            tkl = tae.kl_div(src, tgt, reduce_across_num_actions=reduce)
            close(jkl[0], tkl[0], 1e-5)
            close(jkl[1], tkl[1], 1e-5, 1e-5)


def test_beta_targets_in_the_env_range_are_clipped_not_rescaled():
    """A fault of the JAX package, pinned and followed: `log_probs` clips
    Beta targets into (0, 1) and never maps them from
    `continuous_target_action_range` (`nn/action_embedder.py:203-213`),
    while datasets carry actions in the environment's range (the reacher's
    [-1, 1]). So behaviour cloning scores every negative action as 1e-5:
    -0.9 and -0.1 get one log prob, that of 0. Both packages agree on it."""
    kw = dict(dim=8, num_continuous_actions=2, continuous_dist_type='beta',
              continuous_target_action_range=(-1.0, 1.0), can_unembed=True, unembed_dim=12)
    jae = JActionEmbedder(**kw)
    params = jax.tree.map(np.asarray, jae.init(
        jax.random.PRNGKey(0), continuous_actions=jnp.zeros((1, 2)))['params'])
    params['continuous_action_unembed'] = np.random.default_rng(0).standard_normal(
        params['continuous_action_unembed'].shape).astype(np.float32)
    tae = ActionEmbedder(**kw, device='cpu')
    tae.load_state_dict(flax_params_to_torch(params, tae))
    # one policy, four targets
    embeds = np.random.default_rng(1).standard_normal((1, 12)).astype(np.float32).repeat(4, 0)
    targets = np.array([[-0.9, -0.9], [-0.1, -0.1], [0.0, 0.0], [0.5, 0.5]], np.float32)
    jlp = np.asarray(jae.apply({'params': params}, jnp.asarray(embeds),
                               continuous_targets=jnp.asarray(targets), pred_head_index=0,
                               soft_validate_range=True, method=jae.log_probs).continuous)
    with torch.no_grad():
        tlp = tae.log_probs(T(embeds), continuous_targets=T(targets), pred_head_index=0,
                            soft_validate_range=True).continuous.numpy()
    close(jlp, tlp, 1e-5)
    rows = lambda lp: [lp[i] for i in range(4)]
    for lp in (jlp, tlp):
        a, b_, zero, half = rows(lp)
        # the three nonpositive actions are one target; only the positive one differs
        close(a, b_, 0.0)
        close(a, zero, 1e-6)
        assert np.abs(half - zero).max() > 1.0


# ------------------------------------------------------- training forward

def reacher_batch(seed, b=2, t=5, lens=None, *, proprio=True):
    """Latents in [-1, 1] (the state head's Beta targets cover (0, 1)),
    continuous actions in [-1, 1] as the reacher's, proprio as its
    sin/cos of two angles, rewards."""
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-np.pi, np.pi, (b, t, 2))
    batch = dict(latents=np.tanh(rng.standard_normal((b, t, 8, 16))).astype(np.float32),
                 continuous_actions=rng.uniform(-1, 1, (b, t - 1, 6)).astype(np.float32),
                 rewards=rng.standard_normal((b, t)).astype(np.float32))
    if proprio:
        batch['proprio'] = np.concatenate([np.sin(angles), np.cos(angles)],
                                          axis=-1).astype(np.float32)
    if lens is not None:
        batch['lens'] = np.asarray(lens, np.int32)
    return batch


def to_torch(batch):
    return {k: T(np.asarray(v)) for k, v in batch.items()}


_JAX_DRAWS = ('randint', 'normal', 'bernoulli')
_PORT_DRAW_OF = {'step_sizes_log2': 'randint', 'signal_levels': 'randint', 'noise': 'normal',
                 'proprio_noise': 'normal', 'reward_keep': 'bernoulli'}


def record_jax_draws(cfg, params, batch, key, shortcut):
    """The JAX training forward's draws for `key`, in call order: the
    wrappers note each draw while a jitted `apply` is traced and return its
    values (as tests/test_torch_train.py). The draws depend on the key and
    the shapes only, so they are recorded with flash attention off."""
    jm = JWorldModel(**{**cfg, 'use_flash_attention': False})
    names, real = [], {name: getattr(jax.random, name) for name in _JAX_DRAWS}

    def run(params, batch, key):
        values = []

        def recording(name):
            def fn(*args, **kwargs):
                out = real[name](*args, **kwargs)
                names.append(name)
                values.append(out)
                return out
            return fn

        with pytest.MonkeyPatch.context() as mp:
            for name in _JAX_DRAWS:
                mp.setattr(jax.random, name, recording(name))
            jm.apply({'params': params}, **batch, shortcut_train=shortcut,
                     rngs={'sample': key})
        return values

    values = jax.jit(run)(params, batch, key)
    return [(name, np.asarray(v)) for name, v in zip(names, values)]


def replay(records):
    queue = list(records)

    def draw(kind, shape, *, generator, device, low=0, high=0, prob=0.0):
        name, x = queue.pop(0)
        assert name == _PORT_DRAW_OF[kind] and x.shape == tuple(shape), (kind, name, x.shape)
        out = torch.from_numpy(np.array(x))
        return (out.long() if name == 'randint' else out).to(device)

    draw.remaining = queue
    return draw


LOSS_CASES = {
    'plain': (dict(), dict(b=2, t=5), False),
    'shortcut_lens': (dict(), dict(b=2, t=5, lens=[5, 3]), True),
    'gaussian_v_space_shortcut': (dict(continuous_dist_type='gaussian', pred_orig_latent=False,
                                       continuous_norm_stats=((0.1, 0.5),) * 6),
                                  dict(b=2, t=4), True),
}


@pytest.mark.parametrize('case', list(LOSS_CASES))
def test_continuous_world_model_losses_and_grads_match_jax(case, monkeypatch):
    """tests/test_world_model.py::test_proprio_and_state_env with continuous
    actions: every loss and every gradient, plain and shortcut."""
    cfg_kw, batch_kw, shortcut = LOSS_CASES[case]
    jm, params, tm = build_pair(**cfg_kw)
    batch = reacher_batch(0, **batch_kw)
    key = jax.random.PRNGKey(7)

    def j_loss(p):
        loss, losses, _ = jm.apply({'params': p}, **batch, shortcut_train=shortcut,
                                   return_intermediates=True, rngs={'sample': key})
        return loss, losses

    (j_total, j_losses), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    draw = replay(record_jax_draws({**CFG, **cfg_kw}, params, batch, key, shortcut))
    assert [n for n, _ in draw.remaining].count('normal') == 2   # latents, then proprio
    monkeypatch.setattr(world_model_module, 'draw', draw)
    t_total, t_losses, embeds = tm(**to_torch(batch), shortcut_train=shortcut,
                                   return_intermediates=True)
    t_total.backward()
    assert draw.remaining == []
    assert tm.tokens_per_frame == 1 + 8 + 1 + 1 + 4 + 1 + 1 == 17
    assert embeds.state_pred.shape == (2, batch_kw['t'], 1, 64)
    for name in ('flow', 'state_pred'):
        assert float(getattr(t_losses, name).detach()) > 0
    assert float(t_losses.continuous_actions.detach().abs().sum()) > 0
    close(j_total, t_total, 2e-5, 1e-4)
    for field in WorldModelLosses._fields:
        close(getattr(j_losses, field), getattr(t_losses, field), 2e-5, 1e-4, field)
    want = flax_params_to_torch(j_grads, tm)
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        close(want[name], got, 2e-5, 1e-3, name)
    for name in ('to_proprio_token.weight', 'to_proprio_pred.weight', 'state_pred_token',
                 'to_state_pred.weight', 'action_embedder.continuous_action_embed.weight',
                 'action_embedder.continuous_action_unembed'):
        assert tm.get_parameter(name).grad.abs().sum() > 0, name


def test_continuous_prediction_heads_match_jax():
    """The inference forward: flow, proprio and state predictions and the
    embeddings, with the new tokens' offsets."""
    jm, params, tm = build_pair()
    batch = reacher_batch(3, b=2, t=3)
    kw = dict(latents=batch['latents'], proprio=batch['proprio'],
              continuous_actions=batch['continuous_actions'], signal_levels=5, step_sizes=4)
    jpred, (jemb, _) = jm.apply({'params': params}, **kw, latent_is_noised=True,
                                return_intermediates=True)
    with torch.no_grad():
        tpred, (temb, _) = tm(**{k: T(np.asarray(v)) if isinstance(v, np.ndarray) else v
                                 for k, v in kw.items()}, latent_is_noised=True,
                              return_intermediates=True)
    assert tpred.state.shape == (2, 3, 8, 16, 2) and tpred.proprio.shape == (2, 3, 4)
    for a, b_, name in ((jpred.flow, tpred.flow, 'flow'), (jpred.proprio, tpred.proprio, 'p'),
                        (jpred.state, tpred.state, 'state'), (jemb.agent, temb.agent, 'agent'),
                        (jemb.state_pred, temb.state_pred, 'state_pred')):
        close(a, b_, 2e-5, 1e-4, name)


# ---------------------------------------------------------------- generate

def jax_generate_draws(key):
    """The draws of the JAX `generate` for `key`, in the port's
    `models.generate.draw` signature: split once for the prompt context (its
    proprio noise folds in 1), then per frame fold_in(key, i) split five
    ways (noise, proprio noise, terminal, action, forward); the action key
    splits into the discrete and the continuous one."""
    key, k_init = jax.random.split(key)
    k_ctx, _ = jax.random.split(k_init)

    def draw(kind, frame, shape, *, generator, device, part=0, concentration=None):
        if kind == 'context_noise':
            x = jax.random.normal(k_ctx, shape)
        elif kind == 'context_proprio_noise':
            x = jax.random.normal(jax.random.fold_in(k_ctx, 1), shape)
        else:
            k_noise, k_pnoise, k_term, k_act, _ = jax.random.split(
                jax.random.fold_in(key, frame), 5)
            k_cont = jax.random.split(k_act)[1]
            if kind == 'continuous_action' and concentration is not None:
                return beta_replay(k_cont)(*concentration)
            x = {'noise': lambda: jax.random.normal(k_noise, shape),
                 'proprio_noise': lambda: jax.random.normal(k_pnoise, shape),
                 'terminal': lambda: jax.random.uniform(k_term, shape),
                 'continuous_action': lambda: jax.random.normal(k_cont, shape)}[kind]()
        return T(np.array(x)).to(device)

    return draw


def reacher_prompt(seed, b, p):
    batch = reacher_batch(seed, b=b, t=p + 1)
    return dict(prompt_latents=batch['latents'][:, :p],
                prompt_continuous_actions=batch['continuous_actions'][:, :p],
                prompt_proprio=batch['proprio'][:, :p])


def generate_pair(monkeypatch, key, model_kw=None, **kw):
    """One rollout in each package; numpy arguments go to both."""
    jm, params, tm = build_pair(**(model_kw or {}))
    arrays = {k: v for k, v in kw.items() if isinstance(v, np.ndarray)}
    static = {k: v for k, v in kw.items() if k not in arrays}
    jexp = jax.jit(lambda p, a: jgenerate(jm, {'params': p}, key, **a, **static))(params, arrays)
    monkeypatch.setattr(generate_module, 'draw', jax_generate_draws(key))
    texp = generate(tm, torch.Generator(), **{k: T(v.copy()) for k, v in arrays.items()},
                    **static)
    return jexp, texp, tm


def assert_continuous_rollouts_close(jexp, texp):
    np.testing.assert_array_equal(np.asarray(jexp.lens), texp.lens.numpy())
    close(jexp.actions.continuous, texp.actions.continuous, 2e-5, err_msg='actions')
    for name, tol in (('latents', 2e-4), ('proprio', 2e-4), ('agent_embed', 2e-4),
                      ('rewards', 2e-3), ('values', 2e-3)):
        close(getattr(jexp, name), getattr(texp, name), tol, err_msg=name)
    close(jexp.log_probs.continuous, texp.log_probs.continuous, 2e-4, 1e-5, 'log_probs')
    close(jexp.old_action_unembeds[1], texp.old_action_unembeds[1], 2e-4, err_msg='unembeds')
    assert texp.actions.discrete is None and texp.log_probs.discrete is None


GENERATE_CASES = {
    # the policy's own Beta samples, at a temperature
    'sampled_beta': (dict(), dict(continuous_temperature=0.8)),
    # the recipe's probe: constant forced actions, log probs of the executed ones
    'forced': (dict(), dict(forced_continuous_actions=np.full((2, 8, 6), -0.9, np.float32))),
    'sampled_squashed_gaussian': (dict(continuous_dist_type='squashed_gaussian'), dict()),
}


@pytest.mark.parametrize('case', list(GENERATE_CASES))
def test_generate_continuous_with_proprio_prompt_matches_jax(case, monkeypatch):
    model_kw, kw = GENERATE_CASES[case]
    jexp, texp, _ = generate_pair(monkeypatch, jax.random.PRNGKey(3), model_kw,
                                  time_steps=8, num_steps=2, batch_size=2,
                                  **reacher_prompt(1, 2, 3), **kw)
    assert_continuous_rollouts_close(jexp, texp)
    assert texp.proprio.shape == (2, 8, 4) and texp.prompt_len == 3
    dreamed = texp.actions.continuous[:, 3:]
    if case == 'forced':
        assert (dreamed == -0.9).all()
    elif case == 'sampled_beta':
        assert ((dreamed > 0) & (dreamed < 1)).all()
    else:
        assert ((dreamed > -1) & (dreamed < 1)).all()


def test_generate_continuous_without_prompt_draws_from_generator():
    """Without a replaced `draw`: Beta actions in (0, 1) from the gamma
    ratio, proprio finite, one seed one rollout."""
    torch.manual_seed(0)
    model = DynamicsWorldModel(**CFG, device='cpu')
    run = lambda seed: generate(model, torch.Generator().manual_seed(seed), time_steps=3,
                                num_steps=2, batch_size=2)
    a, b = run(0), run(0)
    torch.testing.assert_close(a.actions.continuous, b.actions.continuous, rtol=0, atol=0)
    assert ((a.actions.continuous > 0) & (a.actions.continuous < 1)).all()
    assert torch.isfinite(a.proprio).all() and torch.isfinite(a.log_probs.continuous).all()


# ------------------------------------------------------------------- RL

def _t(x):
    return None if x is None else T(np.array(x))


def to_torch_experience(jexp) -> Experience:
    """The JAX experience as the port's, array for array."""
    unembeds = jexp.old_action_unembeds
    return Experience(
        latents=_t(jexp.latents), proprio=_t(jexp.proprio), agent_embed=_t(jexp.agent_embed),
        rewards=_t(jexp.rewards), terminals=_t(jexp.terminals),
        terminal_probs=_t(jexp.terminal_probs),
        actions=Actions(None, _t(jexp.actions.continuous)),
        log_probs=Actions(None, _t(jexp.log_probs.continuous)),
        old_action_unembeds=None if unembeds is None else (None, _t(unembeds[1])),
        values=_t(jexp.values), step_size=jexp.step_size, lens=_t(jexp.lens).long(),
        is_truncated=_t(jexp.is_truncated), agent_index=jexp.agent_index,
        prompt_len=jexp.prompt_len, episode_return=_t(jexp.episode_return))


@functools.cache
def jax_dream():
    """A b2 x T8 dream of the JAX model from a 3-frame prompt."""
    jm, params, _ = build_pair()
    prompt = reacher_prompt(2, 2, 3)
    run = jax.jit(lambda p, pr: jgenerate(jm, {'params': p}, jax.random.PRNGKey(0),
                                          time_steps=8, num_steps=2, batch_size=2, **pr))
    return run(params, prompt)


@functools.cache
def jax_rl(heads_only):
    """{objective: (outputs, gradients)} of the JAX losses on the dream."""
    jm, params, _ = build_pair()
    jexp = jax_dream()

    def loss_fn(objective, p):
        out = j_rl_losses(jm, {'params': p}, jexp, objective=objective,
                          only_learn_policy_value_heads=heads_only)
        return out.policy_loss + out.value_loss, out

    def run(p):
        return {o: jax.value_and_grad(partial(loss_fn, o), has_aux=True)(p)
                for o in ('ppo', 'pmpo', 'spo')}

    return {o: (out, grads) for o, ((_, out), grads) in jax.jit(run)(params).items()}


@pytest.mark.parametrize('heads_only', [True, False])
@pytest.mark.parametrize('objective', ['ppo', 'pmpo', 'spo'])
def test_rl_losses_continuous_match_jax(objective, heads_only):
    """tests/test_rl.py::test_rl_continuous at the reacher's widths, with
    proprio: losses, stats and every gradient; the full-model replay feeds
    the dream's proprio and continuous actions back to the trunk."""
    _, _, tm = build_pair()
    jout, jgrads = jax_rl(heads_only)[objective]
    exp = to_torch_experience(jax_dream())
    assert exp.proprio is not None and exp.old_action_unembeds[1].shape == (2, 8, 6, 2)
    out = rl_losses(tm, exp, objective=objective, only_learn_policy_value_heads=heads_only)
    (out.policy_loss + out.value_loss).backward()
    close(jout.policy_loss, out.policy_loss, 1e-5, 1e-4)
    close(jout.value_loss, out.value_loss, 1e-5, 1e-4)
    assert set(jout.stats) == set(out.stats)
    for name, value in jout.stats.items():
        close(value, out.stats[name], 1e-5, 1e-4, err_msg=name)
    want = flax_params_to_torch(jgrads, tm)
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        close(want[name], got, 2e-5, 1e-3, err_msg=name)
    assert tm.action_embedder.continuous_action_unembed.grad.abs().sum() > 0
    moved = tm.to_proprio_token.weight.grad
    assert (moved is not None and moved.abs().sum() > 0) == (not heads_only)


# ------------------------------------------------- interactor, SimTrainer

# a state-vector environment: no proprio (the interactor refuses it), the
# state head's entropy as an exploration bonus
SIM = dict(dim_proprio=None, dim_state=4, dim_critic_state=4, state_entropy_bonus_weight=0.5)


def jax_interactor_draws(key):
    """The continuous action draws of the JAX `EnvInteractor` for rollout
    key `key`: frame i's action key split(fold_in(fold_in(key, i), 1))[0],
    split again in `ActionEmbedder.sample` (the discrete key, then the
    continuous one)."""
    def draw(kind, step, shape, *, generator, device, part=0, concentration=None):
        k_act, _ = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, step), 1))
        k_discrete, k_cont = jax.random.split(k_act)
        if kind == 'action':
            x = jax.random.gumbel(jax.random.split(k_discrete, 1)[part], shape)
        elif concentration is not None:
            return beta_replay(k_cont)(*concentration)
        else:
            x = jax.random.normal(k_cont, shape)
        return T(np.array(x)).to(device)
    return draw


def assert_env_experiences_close(jexp, exp, with_bonus):
    """The port's rollout against the JAX one. The mock environments ignore
    the actions, so the recorded actions are compared themselves."""
    for name in ('lens', 'terminals', 'is_truncated', 'critic_state'):
        np.testing.assert_array_equal(np.asarray(getattr(jexp, name)),
                                      as_np(getattr(exp, name)), name)
    # the rewards carry the bonus, a float32 entropy mean of each package
    close(jexp.rewards, exp.rewards, 2e-5 if with_bonus else 0.0, err_msg='rewards')
    close(jexp.actions.continuous, exp.actions.continuous, 2e-5, err_msg='actions')
    close(jexp.log_probs.continuous, exp.log_probs.continuous, 2e-4, 1e-5, 'log_probs')
    if jexp.actions.discrete is not None:
        np.testing.assert_array_equal(np.asarray(jexp.actions.discrete),
                                      exp.actions.discrete.numpy())
    for name in ('latents', 'values', 'agent_embed'):
        close(getattr(jexp, name), getattr(exp, name), 1e-5, 1e-4, name)
    close(jexp.old_action_unembeds[1], exp.old_action_unembeds[1], 1e-5, 1e-4, 'unembeds')
    assert exp.proprio is None


class JaxModelForInteractor:
    """The JAX world model as its `EnvInteractor` reads it, with the one
    attribute the JAX package gets wrong supplied: its policy step reads
    `model.action_embedder.target_action_range` off the unbound module
    (`dreamer4_tpu/envs/interact.py:140`), where flax has no submodules, so
    every continuous model raises AttributeError there (pinned by
    `test_jax_interactor_cannot_read_the_action_range`). The range is the
    JAX `ActionEmbedder.target_action_range` of the model's own fields;
    everything else is the model's."""

    def __init__(self, jm):
        self._jm = jm
        bounded = jm.continuous_dist_type in ('beta', 'squashed_gaussian')
        rng = (jm.continuous_target_action_range or (-1.0, 1.0)) if bounded else None
        self.action_embedder = type('Range', (), {'target_action_range': rng})()

    def __getattr__(self, name):
        return getattr(self._jm, name)


class ActionLog:
    """A MockStateEnv that notes the actions it is handed."""

    def __init__(self, cls, **kw):
        self.env, self.actions = cls(**kw), []

    def reset(self, **kw):
        return self.env.reset(**kw)

    def step(self, action):
        self.actions.append(action)
        return self.env.step(action)


INTERACT_CASES = {
    # vectorized, Beta actions in [-1, 1] toward the env, the state bonus
    'beta_bonus': (dict(), dict(batch=3)),
    # one unbatched env, a (discrete, continuous) pair per step, squashed
    # Gaussian actions rescaled into (-2, 2), no bonus
    'mixed_unbatched': (dict(num_discrete_actions=(3,), num_continuous_actions=2,
                             continuous_dist_type='squashed_gaussian',
                             continuous_target_action_range=(-2.0, 2.0),
                             state_entropy_bonus_weight=0.0), dict(batch=None)),
}


@pytest.mark.parametrize('case', list(INTERACT_CASES))
def test_env_interactor_continuous_matches_jax(case, monkeypatch):
    model_kw, env_kw = INTERACT_CASES[case]
    jm, params, tm = build_pair(**{**SIM, **model_kw})
    env_kw = dict(dim_state=4, num_actions=3, max_steps=5, seed=3, **env_kw)
    key = jax.random.PRNGKey(7)
    jenv, tenv = ActionLog(JMockStateEnv, **env_kw), ActionLog(MockStateEnv, **env_kw)
    jexp = JEnvInteractor(JaxModelForInteractor(jm))({'params': params}, jenv, key,
                                                     max_timesteps=5, num_steps=2)
    monkeypatch.setattr(interact_module, 'draw', jax_interactor_draws(key))
    exp = EnvInteractor(tm, device='cpu')(tenv, torch.Generator(), max_timesteps=5, num_steps=2)
    bonus = model_kw.get('state_entropy_bonus_weight', 0.5) > 0
    assert tm.add_state_entropy_bonus == bonus
    assert_env_experiences_close(jexp, exp, bonus)
    # what the environments were handed: the native samples rescaled
    assert len(jenv.actions) == len(tenv.actions) == 5
    for ja, ta in zip(jenv.actions, tenv.actions):
        if isinstance(ja, tuple):
            np.testing.assert_array_equal(np.asarray(ja[0]), np.asarray(ta[0]))
            ja, ta = ja[1], ta[1]
        close(ja, ta, 4e-5)
    lo, hi = tm.action_embedder.target_action_range
    sent = np.stack([a[1] if isinstance(a, tuple) else a for a in tenv.actions])
    assert (sent >= lo).all() and (sent <= hi).all()
    if bonus:   # the same rollout without the bonus: only the rewards change
        plain = DynamicsWorldModel(**{**CFG, **SIM, 'state_entropy_bonus_weight': 0.0},
                                   device='cpu')
        plain.load_state_dict(tm.state_dict())
        exp_plain = EnvInteractor(plain, device='cpu')(ActionLog(MockStateEnv, **env_kw),
                                                       torch.Generator(), max_timesteps=5,
                                                       num_steps=2)
        delta = exp.rewards - exp_plain.rewards
        valid = torch.arange(delta.shape[1])[None] < (exp.lens - exp.is_truncated.long())[:, None]
        # a Beta's differential entropy is at most 0 (that of the uniform)
        assert (delta[valid] < -1e-6).all() and not delta[~valid].any()


def ns_float32(monkeypatch):
    """Newton-Schulz in float32 in both packages (tests/test_torch_train.py)."""
    monkeypatch.setattr(joptim, '_batched_orthogonalize',
                        partial(joptim._batched_orthogonalize, ns_dtype=jnp.float32))
    monkeypatch.setattr(toptim, 'batched_orthogonalize',
                        partial(toptim.batched_orthogonalize, ns_dtype=torch.float32))


def test_sim_trainer_state_entropy_bonus_two_steps_match_jax(monkeypatch):
    """tests/test_data_and_envs.py's state-entropy bonus run through two
    SimTrainer steps: the rollouts with the bonus in their rewards, the
    dynamics step on the continuous actions (its draws recorded from the
    key the JAX step received), and the RL updates."""
    ns_float32(monkeypatch)
    cfg = {**CFG, **SIM}
    jm, params, tm = build_pair(**SIM)
    env_kw = dict(dim_state=4, num_actions=3, max_steps=5, batch=2, seed=3)
    kw = dict(num_steps=2, seed=1, max_timesteps=5, update_epochs=1)
    jtrainer = JSimTrainer(jm, {'params': params}, JMockStateEnv(**env_kw), **kw)
    jtrainer.interactor = JEnvInteractor(JaxModelForInteractor(jm))
    trainer = SimTrainer(tm, MockStateEnv(**env_kw), device='cpu', **kw)
    wm_calls, j_wm_step = [], jtrainer._wm_step

    def spy(ts, batch, key, shortcut_train):
        wm_calls.append((batch, key, shortcut_train))
        return j_wm_step(ts, batch, key, shortcut_train=shortcut_train)

    jtrainer._wm_step = spy
    small = {n: np.zeros(p.shape, bool) for n, p in tm.named_parameters()}
    lr_sum = dict.fromkeys(small, 0.0)
    coarse = {n for n, kind in trainer.wm_optimizer.labels().items() if kind == 'muon'}
    trainer._wm_step = GradSpy(tm, trainer.wm_optimizer, trainer._wm_step, small, lr_sum)
    trainer._update = GradSpy(tm, trainer.optimizer, trainer._update, small, lr_sum)

    key = jax.random.PRNGKey(4)
    for i in range(2):
        jparams = jtrainer.rl_state.params
        jexp, jouts = jtrainer.step(jax.random.fold_in(key, i))
        batch, wm_key, shortcut = wm_calls[i]
        assert batch['continuous_actions'].shape == (2, 6, 6)
        monkeypatch.setattr(world_model_module, 'draw',
                            replay(record_jax_draws(cfg, jparams, batch, wm_key, shortcut)))
        monkeypatch.setattr(interact_module, 'draw', jax_interactor_draws(
            jax.random.fold_in(jax.random.fold_in(key, i), 0)))
        exp, outs = trainer.step()
        assert world_model_module.draw.remaining == []
        assert_env_experiences_close(jexp, exp, with_bonus=True)
        for jout, tout in zip(jouts, outs, strict=True):
            close(jout.policy_loss, tout.policy_loss, 1e-5, 1e-4)
            close(jout.value_loss, tout.value_loss, 1e-5, 1e-4)
        assert_params_close(jtrainer.rl_state.params, tm, small, lr_sum, coarse)
    assert trainer.rl_state.step == int(jtrainer.rl_state.step) == 2


def test_jax_interactor_cannot_read_the_action_range():
    """A fault of the JAX package, pinned: its `EnvInteractor` raises on
    every model with continuous actions, reading the action range off the
    unbound flax module; the port's interactor runs the same model and
    sends the environment actions in the target range."""
    jm, params, tm = build_pair(**SIM)
    env_kw = dict(dim_state=4, num_actions=3, max_steps=3, batch=2, seed=0)
    with pytest.raises(AttributeError, match='action_embedder'):
        JEnvInteractor(jm)({'params': params}, JMockStateEnv(**env_kw), jax.random.PRNGKey(0),
                           max_timesteps=3, num_steps=2)
    env = ActionLog(MockStateEnv, **env_kw)
    exp = EnvInteractor(tm, device='cpu')(env, torch.Generator().manual_seed(0),
                                          max_timesteps=3, num_steps=2)
    native = exp.actions.continuous[:, :3]
    close(np.stack(env.actions, axis=1), native * 2.0 - 1.0, 1e-6)


# -------------------------------------------------------------- experience

def assert_continuous_experiences_equal(jexp, exp, err=''):
    for name in ('latents', 'proprio', 'rewards', 'values', 'lens', 'agent_embed'):
        np.testing.assert_array_equal(np.asarray(getattr(jexp, name)),
                                      as_np(getattr(exp, name)), err + name)
    for name in ('actions', 'log_probs'):
        np.testing.assert_array_equal(np.asarray(getattr(jexp, name).continuous),
                                      as_np(getattr(exp, name).continuous), err + name)
    if jexp.old_action_unembeds is not None:
        np.testing.assert_array_equal(np.asarray(jexp.old_action_unembeds[1]),
                                      as_np(exp.old_action_unembeds[1]), err + 'unembeds')


def test_experience_ops_keep_continuous_fields_match_jax(tmp_path):
    """`index_experience`, `pad_experience_time`, `combine_experiences` and
    the replay-buffer bridge carry proprio, the continuous actions, their
    log probs and the continuous unembeddings as the JAX package does."""
    jexp = jax_dream()
    exp = to_torch_experience(jexp)
    pairs = [
        ('index', jexperience.index_experience(jexp, jnp.asarray([1])),
         texperience.index_experience(exp, torch.tensor([1]))),
        ('pad', jexperience.pad_experience_time(jexp, 11),
         texperience.pad_experience_time(exp, 11)),
        ('combine', jexperience.combine_experiences(
            [jexp, jexperience.index_experience(jexp, jnp.asarray([0]))]),
         texperience.combine_experiences([exp, texperience.index_experience(
             exp, torch.tensor([0]))])),
    ]
    for name, j, t in pairs:
        assert_continuous_experiences_equal(j, t, name + ': ')
    assert pairs[1][2].proprio.shape == (2, 11, 4) and not pairs[1][2].proprio[:, 8:].any()

    # the buffer: the same fields, the same files, the same experience back
    jexp, exp = jexp.replace(old_action_unembeds=None), Experience(
        **{**vars(exp), 'old_action_unembeds': None})
    fields = texperience.experience_buffer_fields(exp)
    assert fields == jexperience.experience_buffer_fields(jexp)
    assert {'proprio', 'actions_continuous', 'log_probs_continuous'} <= set(fields[0])
    jbuf = jexperience.create_experience_replay_buffer(jexp, tmp_path / 'jax', 4, 8)
    tbuf = texperience.create_experience_replay_buffer(exp, tmp_path / 'torch', 4, 8)
    jexperience.add_experience_to_buffer(jexp, jbuf)
    texperience.add_experience_to_buffer(exp, tbuf)
    for f in sorted((tmp_path / 'jax').glob('*.npy')):
        np.testing.assert_array_equal(np.load(f), np.load(tmp_path / 'torch' / f.name),
                                      f.name)
    batch = tbuf.sample_batch(np.random.default_rng(0), 2, 8)
    jout = jexperience.experience_from_batch(batch)
    tout = texperience.experience_from_batch(batch, device='cpu')
    for name in ('proprio', 'latents'):
        np.testing.assert_array_equal(np.asarray(getattr(jout, name)),
                                      getattr(tout, name).numpy(), name)
    for name in ('actions', 'log_probs'):
        np.testing.assert_array_equal(np.asarray(getattr(jout, name).continuous),
                                      getattr(tout, name).continuous.numpy(), name)


# ----------------------------------------------------------------- wrapper

WRAPPED = dict(dim_proprio=None, predict_terminals=True)


def test_world_model_wrapper_continuous_matches_jax(monkeypatch):
    """`DynamicsWorldModelWrapper` with continuous actions: reset, then
    steps with an action array (a batch of 2) in both packages, the JAX
    wrapper's draws (split(key), then split(sub, 3) for noise / forward /
    terminal) replayed."""
    jm, params, tm = build_pair(**WRAPPED)
    b, steps = 2, 4
    draws = {'noise': [], 'terminal': []}
    key = jax.random.PRNGKey(0)
    for _ in range(steps + 1):
        key, sub = jax.random.split(key)
        k_noise, _, k_term = jax.random.split(sub, 3)
        draws['noise'].append(np.asarray(jax.random.normal(k_noise, (b, 1, 8, 16))))
        draws['terminal'].append(np.asarray(jax.random.uniform(k_term, (b,))))
    monkeypatch.setattr(world_model_env, 'draw',
                        lambda kind, frame, shape, *, generator, device:
                        T(draws[kind][frame].copy()))
    jw = JWrapper(jm, {'params': params}, batch_size=b, max_timesteps=steps, seed=0)
    tw = DynamicsWorldModelWrapper(tm, batch_size=b, max_timesteps=steps, device='cpu')
    close(jw.reset()[0], tw.reset()[0], 1e-4)
    actions = np.random.default_rng(1).uniform(-1, 1, (steps, b, 6)).astype(np.float32)
    for i in range(steps):
        jout, tout = jw.step(actions[i]), tw.step(actions[i])
        close(jout[0], tout[0], 1e-4, err_msg=f'obs {i}')
        close(jout[1], tout[1], 1e-4, err_msg=f'reward {i}')
        for k in (2, 3):
            np.testing.assert_array_equal(np.asarray(jout[k]), tout[k])
    # the action moves the dream: another action, another frame
    tw.reset()
    other = tw.step(-actions[0])[0]
    tw.reset()
    assert np.abs(tw.step(actions[0])[0] - other).max() > 1e-4


# ------------------------------------------------------------------ reacher

def render_arm(theta1: float, theta2: float) -> np.ndarray:
    """examples/train_reacher_proprio_dynamics.py:31-54, copied."""
    image = 32
    img = np.zeros((image, image, 3), np.float32)
    cx, cy = image / 2, image / 2
    l1, l2 = image * 0.28, image * 0.22
    x1, y1 = cx + l1 * np.cos(theta1), cy + l1 * np.sin(theta1)
    x2, y2 = x1 + l2 * np.cos(theta1 + theta2), y1 + l2 * np.sin(theta1 + theta2)

    def stamp_line(x0, y0, x1, y1, channel, width=1.1):
        yy, xx = np.mgrid[0:image, 0:image]
        for px, py in zip(np.linspace(x0, x1, 24), np.linspace(y0, y1, 24)):
            img[..., channel] += np.exp(-((xx - px) ** 2 + (yy - py) ** 2) / (2 * width ** 2))

    stamp_line(cx, cy, x1, y1, 0)
    stamp_line(x1, y1, x2, y2, 1)
    img[..., 2] += np.exp(-(((np.mgrid[0:image, 0:image][1] - x2) ** 2
                             + (np.mgrid[0:image, 0:image][0] - y2) ** 2) / (2 * 1.5 ** 2)))
    return np.clip(img, 0.0, 1.0)


def test_reacher_trajectories_follow_the_recipe():
    """chip_smoke's batched arm renderer and trajectories against the
    recipe's renderer and dynamics."""
    data = chip_smoke.reacher_trajectories(2, 5, torch.Generator().manual_seed(0))
    assert data['video'].shape == (2, 3, 5, 32, 32)
    assert data['continuous_actions'].shape == (2, 4, 6) and data['proprio'].shape == (2, 5, 4)
    prop = data['proprio'].numpy()
    theta = np.arctan2(prop[..., :2], prop[..., 2:])
    for i in range(2):
        for t in range(5):
            close(render_arm(*theta[i, t]).transpose(2, 0, 1), data['video'][i, :, t], 2e-5)
        step = np.angle(np.exp(1j * (theta[i, 1:] - theta[i, :-1])))
        close(step, 0.35 * data['continuous_actions'][i, :, :2], 2e-5)


# examples/train_reacher_proprio_dynamics.py:104-106
REACHER_TOKENIZER = dict(dim=64, dim_latent=16, patch_size=8, image_height=32, image_width=32,
                         num_latent_tokens=8, encoder_depth=2, decoder_depth=2,
                         time_block_every=2)


def test_reacher_recipe_matches_jax(monkeypatch):
    """The reacher recipe in both packages at its widths: behaviour cloning
    on the arm's video through the tokenizer with continuous actions,
    proprio and rewards (two steps, a shortcut and a plain one), then the
    +-0.9 forced-action dreams from a 3-frame prompt, which must diverge by
    the recipe's bound (`lat_div > 0.01 * lat_scale`) in both."""
    ns_float32(monkeypatch)
    jm, params, tm = build_pair(add_state_pred_head=False)
    jt = JTokenizer(**REACHER_TOKENIZER)
    tok_vars = jax.jit(lambda r: jt.init(r, jnp.zeros((1, 3, 2, 32, 32))))(
        {'params': jax.random.PRNGKey(2), 'sample': jax.random.PRNGKey(3)})
    tok_vars = jax.tree.map(np.asarray, tok_vars)
    tt = VideoTokenizer(**REACHER_TOKENIZER, device='cpu')
    tt.load_state_dict(flax_params_to_torch(tok_vars['params'], tt, state=tok_vars['state']))

    g = torch.Generator().manual_seed(0)
    batches = []
    for _ in range(2):
        data = chip_smoke.reacher_trajectories(2, 6, g)
        batches.append({**{k: v.numpy() for k, v in data.items()},
                        'lens': np.array([6, 5], np.int32)})
    kw = dict(learning_rate=3e-4, seed=1)
    jtrainer = JBehaviorCloneTrainer(jm, {'params': params}, tokenizer=jt,
                                     tokenizer_variables=tok_vars, **kw)
    calls, j_step = [], jtrainer._train_step

    def spy(ts, batch, key, shortcut_train):
        calls.append((ts.params, batch, key, shortcut_train))
        return j_step(ts, batch, key, shortcut_train=shortcut_train)

    jtrainer._train_step = spy
    j_losses = [jtrainer.train_on_batch({k: jnp.asarray(v) for k, v in b_.items()})
                for b_ in batches]
    assert [c[3] for c in calls] == [True, False]
    records = [r for p_, b_, k_, s_ in calls for r in record_jax_draws(REACHER, p_, b_, k_, s_)]
    draw = replay(records)
    monkeypatch.setattr(world_model_module, 'draw', draw)
    trainer = BehaviorCloneTrainer(tm, tokenizer=tt, device='cpu', **kw)
    t_losses = [trainer.train_on_batch(to_torch(b_)) for b_ in batches]
    assert draw.remaining == []
    for (jl, jls), (tl, tls) in zip(j_losses, t_losses):
        close(jl, tl, 2e-5, 1e-4)
        for field in WorldModelLosses._fields:
            close(getattr(jls, field), getattr(tls, field), 2e-5, 1e-4, field)
    # the parameters after two steps (tests/test_torch_train.py's bounds)
    first_grads = jax.jit(jax.grad(lambda p: jm.apply(
        {'params': p}, **calls[0][1], shortcut_train=True, rngs={'sample': calls[0][2]})))(
            params)
    small = {n: np.abs(g_.numpy()) < 1e-7
             for n, g_ in flax_params_to_torch(first_grads, tm).items()}
    got = dict(tm.named_parameters())
    for name, want in flax_params_to_torch(jtrainer.ts.params, tm).items():
        diff = np.abs(want.numpy() - got[name].detach().numpy())
        assert not (diff[~small[name]] > 1e-5).any(), name
        assert (diff <= 7e-4).all(), name

    # the forced-action dreams, from the JAX-trained weights in both
    trained = jax.tree.map(np.asarray, jtrainer.ts.params)
    tm.load_state_dict(flax_params_to_torch(trained, tm))
    first = batches[0]
    prompt_latents = np.asarray(jt.apply(tok_vars, jnp.asarray(first['video'][:1, :, :3]),
                                         return_latents=True))
    prompt = dict(prompt_latents=prompt_latents,
                  prompt_continuous_actions=first['continuous_actions'][:1, :3],
                  prompt_proprio=first['proprio'][:1, :3])
    outs = {}
    monkeypatch.setattr(generate_module, 'draw', jax_generate_draws(jax.random.PRNGKey(42)))
    for name, val in (('pos', 0.9), ('neg', -0.9)):
        forced = np.full((1, 10, 6), val, np.float32)
        tm_dream = generate(tm, torch.Generator(), time_steps=10, num_steps=4, batch_size=1,
                            forced_continuous_actions=T(forced),
                            **{k: T(v.copy()) for k, v in prompt.items()})
        jexp = jax.jit(lambda p, f: jgenerate(jm, {'params': p}, jax.random.PRNGKey(42),
                                              time_steps=10, num_steps=4, batch_size=1,
                                              forced_continuous_actions=f, **prompt))(
            trained, forced)
        close(jexp.latents, tm_dream.latents, 2e-4, err_msg=name)
        close(jexp.proprio, tm_dream.proprio, 2e-4, err_msg=name)
        outs[name] = (jexp, tm_dream)
    for side in (0, 1):
        pos, neg = (as_np(outs[k][side].latents) for k in ('pos', 'neg'))
        lat_div = np.abs(pos - neg)[:, 3:].mean()
        lat_scale = np.abs(pos)[:, 3:].mean()
        assert lat_div > 0.01 * max(lat_scale, 1e-6), (side, lat_div, lat_scale)


def test_continuous_model_checkpoint_roundtrip(tmp_path):
    """The new options go through a checkpoint's config (the norm stats
    and ranges as JSON lists) and come back as the same model."""
    from dreamer4_torch.train import checkpoint

    kw = dict(continuous_norm_stats=((0.0, 1.0),) * 6, state_entropy_bonus_weight=0.2,
              eps_latent_pred=1e-5, state_pred_loss_weight=0.3)
    torch.manual_seed(0)
    model = DynamicsWorldModel(**CFG, **kw, device='cpu')
    checkpoint.save_model(tmp_path / 'm', model)
    back = checkpoint.load_model(tmp_path / 'm', DynamicsWorldModel, device='cpu')
    assert back.config == model.config and back.add_state_entropy_bonus
    assert back.tokens_per_frame == model.tokens_per_frame == 17
    for (name, a), b_ in zip(model.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a, b_), name
    assert torch.equal(back.action_embedder.continuous_norm_stats,
                       model.action_embedder.continuous_norm_stats)
    assert tuple(back.action_embedder.target_action_range) == (-1.0, 1.0)


# ---------------------------------------------------------------- refusals

def test_remaining_refusals():
    """What stays refused (the GRU time layer and multi-view world models,
    refused here before, now build): a `tasks` batch entry for a model
    without tasks, and
    proprioception in the interactor and the wrapper, whose JAX
    counterparts cannot drive such a model. The agent's state prediction
    builds with continuous actions."""
    assert hasattr(DynamicsWorldModel(**CFG, use_time_rnn=True, device='cpu').transformer,
                   'rnn_1')
    assert DynamicsWorldModel(**CFG, num_video_views=2, device='cpu').view_emb.shape == (2, 64)
    assert DynamicsWorldModel(**CFG, agent_predicts_state=True,
                              device='cpu').agent_state_pred_net.Dense_0.in_features == 2 * 64
    _, _, tm = build_pair()
    with pytest.raises(NotImplementedError, match='EnvInteractor.*proprio'):
        EnvInteractor(tm, device='cpu')
    with pytest.raises(NotImplementedError, match='dim_proprio'):
        SimTrainer(tm, MockStateEnv(), device='cpu')
    with pytest.raises(NotImplementedError, match='dream_frame'):
        DynamicsWorldModelWrapper(tm, device='cpu')
    trainer = BehaviorCloneTrainer(tm, device='cpu')
    batch = to_torch(reacher_batch(0, b=1, t=3))
    with pytest.raises(ValueError, match='num_tasks'):
        trainer.train_on_batch({**batch, 'tasks': torch.zeros(1, dtype=torch.long)})
    with pytest.raises(ValueError, match='proprio'):
        tm(**{k: v for k, v in batch.items() if k != 'proprio'}, shortcut_train=False)
    with pytest.raises(ValueError, match='continuous dist type'):
        ActionEmbedder(8, num_continuous_actions=2, continuous_dist_type='laplace')
    DreamTrainer(tm, device='cpu')   # dreams carry proprio: no refusal
