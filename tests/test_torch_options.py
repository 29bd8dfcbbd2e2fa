"""The RL options of the imagination-only CartPole recipe in the port
(`agent_predicts_state`, `actor_critic_latent_input`, `actor_spr`) against
the JAX package, at float32 on the CPU, and the constructors' handling of
every field of the JAX dataclasses.

The model is tests/test_torch_env.py's small state-vector world model
(dim 16, depth 2) with the options that
examples/train_cartpole_dream_rl.py:136-159 sets, and `actor_spr`. Both
packages get the JAX model's weights, converted; the JAX draws are
replayed as in tests/test_torch_env.py and tests/test_torch_rl.py (the
training forward's through `models.world_model.draw`, the rollouts'
through `models.generate.draw` and `envs.interact.draw`). None of the new
losses draws.

Tolerances, all float32, those of the files the helpers come from:
  - training losses 2e-5 absolute and 1e-4 relative; gradients 2e-5
    absolute and 1e-3 relative (tests/test_torch_train.py);
  - `ActorSPR` alone: its losses 1e-6 absolute and 1e-5 relative,
    gradients 2e-6 absolute and 1e-4 relative (a few small MLPs, no trunk);
  - rollouts: actions and lens exactly equal, latents, values, log probs
    and agent embeddings 1e-5 absolute and 1e-4 relative
    (tests/test_torch_env.py); a dream's as tests/test_torch_generate.py
    (2e-4, rewards and values 2e-3);
  - RL losses and stats 1e-5 absolute and 1e-4 relative, gradients 2e-5
    absolute and 1e-3 relative (tests/test_torch_rl.py);
  - trainer steps: parameters as tests/test_torch_rl.py and
    tests/test_torch_env.py (1e-6, Muon's 1e-5, within rounding-of-zero
    gradients 2.01 lr per update).
"""
import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamer4_tpu.train.trainers as jtrainers
from test_torch_env import (SMALL, assert_experience_matches, env_factory,
                            record_jax_training_draws, replay, run_pair, run_sim_pair, spy_flash)
from test_torch_rl import (assert_outputs_close, assert_updates_close, jax_draws, small_grads,
                           to_torch_experience)
from dreamer4_tpu.envs.mocks import MockStateEnv as JMockStateEnv
from dreamer4_tpu.models.generate import generate as jgenerate
from dreamer4_tpu.models.rl import ReturnStats as JReturnStats
from dreamer4_tpu.models.rl import rl_losses as j_rl_losses
from dreamer4_tpu.models.tokenizer import VideoTokenizer as JTokenizer
from dreamer4_tpu.models.transformer import AxialSpaceTimeTransformer as JTransformer
from dreamer4_tpu.models.world_model import DynamicsWorldModel as JWorldModel
from dreamer4_tpu.nn.action_embedder import ActionEmbedder as JActionEmbedder
from dreamer4_tpu.nn.ssl import ActorSPR as JActorSPR
from dreamer4_tpu.ops import utils as jutils
from dreamer4_torch import DreamTrainer, VideoTokenizer
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.envs.mocks import MockStateEnv
from dreamer4_torch.models import generate as generate_module
from dreamer4_torch.models import world_model as world_model_module
from dreamer4_torch.models.generate import generate
from dreamer4_torch.models.rl import ReturnStats, rl_losses
from dreamer4_torch.models.transformer import AxialSpaceTimeTransformer
from dreamer4_torch.models.world_model import DynamicsWorldModel, WorldModelLosses
from dreamer4_torch.nn.action_embedder import ActionEmbedder
from dreamer4_torch.nn.ssl import ActorSPR
from dreamer4_torch.ops import utils as tutils
from dreamer4_torch.train import checkpoint
from dreamer4_torch.train.trainers import BehaviorCloneTrainer, rl_param_labels

torch.set_num_threads(1)
T = torch.from_numpy
# examples/train_cartpole_dream_rl.py:136-159 (its defaults, --latent-actor,
# the reward range of 150-step episodes), and the actor's SPR
RECIPE = dict(dim_state=4, actor_critic_latent_input=True, add_action_embed_to_spatial=True,
              add_state_pred_head=True, agent_predicts_state=True,
              agent_predicts_state_frac_gradient=0.5, keep_reward_ema_stats=True,
              reward_range=(-180.0, 180.0), actor_spr=True, actor_spr_num_rollouts=2)


def close(a, b, atol, rtol=0.0, err_msg=''):
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
    np.testing.assert_allclose(np.asarray(a), b, atol=atol, rtol=rtol, err_msg=err_msg)


def grad_of(p):
    return p.grad if p.grad is not None else torch.zeros_like(p)


# ------------------------------------------------------------------ models

@functools.cache
def _jax_params(items):
    cfg = dict(items)
    jm = JWorldModel(**cfg)
    b, t = 2, 4
    kw = dict(latents=jnp.zeros((b, t, 4, 8)), shortcut_train=False, rewards=jnp.zeros((b, t)),
              terminals=jnp.zeros((b,), bool))
    if cfg.get('num_discrete_actions'):
        kw['discrete_actions'] = jnp.zeros((b, t - 1, 1), jnp.int32)
    init = jax.jit(lambda rngs: jm.init(rngs, **kw))
    params = init({'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)})['params']
    return jax.tree.map(np.asarray, params)


def build_pair(**kw):
    """The JAX world model and the port's with its weights: the converter
    maps every leaf of the four new flax subtrees, or raises."""
    cfg = {**SMALL, **kw}
    params = _jax_params(tuple(sorted(cfg.items())))
    tm = DynamicsWorldModel(**cfg, device='cpu')
    tm.load_state_dict(flax_params_to_torch(params, tm))
    return JWorldModel(**cfg), params, tm


# ------------------------------------------------------------ constructors

def jax_fields(cls):
    return {f.name: f.default for f in dataclasses.fields(cls) if f.name not in ('parent', 'name')}


# each class with values for the JAX fields that have no default
CLASSES = {
    'world_model': (JWorldModel, DynamicsWorldModel,
                    dict(dim=16, dim_latent=8, num_latent_tokens=4)),
    'tokenizer': (JTokenizer, VideoTokenizer,
                  dict(dim=16, dim_latent=8, patch_size=16, image_height=32, image_width=32)),
    'transformer': (JTransformer, AxialSpaceTimeTransformer, dict(dim=16, depth=2)),
}
# a value other than the default for some field of each class that the port
# does not implement
NOT_PORTED_VALUES = {
    'world_model': {},
    'tokenizer': {},
    'transformer': dict(time_ring_axis='time'),
}
# values the port refused before the trunk's subsystems were ported: they build
PORTED_VALUES = {
    'world_model': dict(use_time_rnn=True,
                        mot_temporal=True, h_net_layer=1, h_net_depth=3,
                        h_net_compression_ratio=8, h_net_loss_weight=2.0),
    'tokenizer': dict(use_time_rnn=True, h_net_layer=1, h_net_depth=3,
                      h_net_compression_ratio=8, h_net_loss_weight=2.0),
    'transformer': dict(mot_temporal=True, h_net_layer=1, h_net_dynamic=True,
                        h_net_heads=2, rnn_time=True),
}


@pytest.mark.parametrize('which', list(CLASSES))
def test_constructors_take_every_jax_field_at_its_default(which, tmp_path):
    """Every field of the JAX dataclass, each at its JAX default, builds the
    port's class and stays in its config, which a checkpoint round-trips."""
    jcls, tcls, required = CLASSES[which]
    fields = jax_fields(jcls)
    missing = {n for n, d in fields.items() if d is dataclasses.MISSING}
    assert missing == set(required)
    kw = {**{n: d for n, d in fields.items() if n not in missing}, **required}
    torch.manual_seed(0)
    module = tcls(**kw, device='cpu')
    for name, value in kw.items():
        assert module.config[name] == value, name
    assert module.config == tcls(**required, device='cpu').config | kw
    checkpoint.save_model(tmp_path / which, module)
    assert checkpoint.load_model(tmp_path / which, tcls, device='cpu').config == module.config


@pytest.mark.parametrize('which', list(CLASSES))
def test_constructors_refuse_unported_values_and_unknown_names(which):
    """A field the port does not implement raises NotImplementedError
    naming it when set off its default (only the trunk's ring attention is
    left); the fields ported since build and keep their values; a name the
    JAX class does not have raises TypeError."""
    jcls, tcls, required = CLASSES[which]
    fields = jax_fields(jcls)
    for name, value in NOT_PORTED_VALUES[which].items():
        assert value != fields[name], name
        with pytest.raises(NotImplementedError, match=name):
            tcls(**required, **{name: value}, device='cpu')
    ported = PORTED_VALUES[which]
    assert all(ported[name] != fields[name] for name in ported)
    assert tcls(**required, **ported, device='cpu').config.items() >= ported.items()
    with pytest.raises(TypeError, match='agent_predicts_stat\\b'):
        tcls(**required, agent_predicts_stat=True, device='cpu')


@pytest.mark.parametrize('flags', ['default', 'no_state_pred', 'latent_actor', 'actor_spr'])
def test_recipe_keyword_sets_build(flags):
    """The exact keyword set of examples/train_cartpole_dream_rl.py:136-159
    (CartPole: 2 actions, a 4-dim state) under its flags builds in the port
    with the tokens per frame of the JAX model."""
    no_state_pred, latent_actor = flags == 'no_state_pred', flags == 'latent_actor'
    kw = dict(dim=64, dim_latent=16, num_latent_tokens=4, num_spatial_tokens=4, max_steps=16,
              depth=2, time_block_every=2, attn_heads=4, attn_dim_head=16,
              num_discrete_actions=(2,), multi_token_pred_len=4, num_register_tokens=4,
              dim_state=4, actor_critic_latent_input=latent_actor,
              add_action_embed_to_spatial=True, add_state_pred_head=not no_state_pred,
              agent_predicts_state=not no_state_pred, agent_predicts_state_frac_gradient=0.5,
              predict_terminals=True, policy_entropy_weight=0.01, keep_reward_ema_stats=True,
              reward_range=(-180.0, 180.0))
    if flags == 'actor_spr':
        kw.update(actor_spr=True, actor_spr_num_rollouts=2)
    tm = DynamicsWorldModel(**kw, device='cpu')
    assert tm.tokens_per_frame == JWorldModel(**kw).tokens_per_frame
    for prefix, on in (('actor_latent_encoder.', latent_actor),
                       ('agent_state_pred_net.', not no_state_pred),
                       ('actor_spr_module.', flags == 'actor_spr')):
        assert any(n.startswith(prefix) for n, _ in tm.named_parameters()) == on, prefix


# ------------------------------------------------------- training forward

def recipe_batch(seed, b=2, t=5, lens=None, actions=True, action_len=None):
    rng = np.random.default_rng(seed)
    batch = dict(latents=np.tanh(rng.standard_normal((b, t, 4, 8))).astype(np.float32),
                 rewards=rng.standard_normal((b, t)).astype(np.float32),
                 terminals=np.array([True, False][:b]))
    if actions:
        batch['discrete_actions'] = rng.integers(0, 3, (b, action_len or t - 1, 1)).astype(
            np.int32)
    if lens is not None:
        batch['lens'] = np.asarray(lens, np.int32)
    return batch


# case: (model options, batch options, shortcut step)
LOSS_CASES = {
    'frac0': (dict(agent_predicts_state=True), dict(), False),
    'frac_half_lens_shortcut': (dict(agent_predicts_state=True,
                                     agent_predicts_state_frac_gradient=0.5),
                                dict(lens=[5, 3]), True),
    'frac1_actions_of_every_frame': (dict(agent_predicts_state=True,
                                          agent_predicts_state_frac_gradient=1.0),
                                     dict(action_len=5), False),
    'frac_half_no_actions': (dict(agent_predicts_state=True, num_discrete_actions=(),
                                  agent_predicts_state_frac_gradient=0.5),
                             dict(actions=False, lens=[4, 5]), False),
    'latent_actor_bc': (dict(RECIPE), dict(lens=[5, 4]), False),
}


@pytest.mark.parametrize('case', list(LOSS_CASES))
def test_agent_state_and_bc_losses_and_grads_match_jax(case, monkeypatch):
    """tests/test_world_model.py:58-80 with the agent's state prediction:
    every loss, the total and every gradient; 'latent_actor_bc' trains the
    policy head through the actor's latent encoder."""
    cfg_kw, batch_kw, shortcut = LOSS_CASES[case]
    jm, params, tm = build_pair(**cfg_kw)
    batch = recipe_batch(0, **batch_kw)
    key = jax.random.PRNGKey(7)

    def j_loss(p):
        loss, losses, _ = jm.apply({'params': p}, **batch, shortcut_train=shortcut,
                                   return_intermediates=True, rngs={'sample': key})
        return loss, losses

    (j_total, j_losses), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    records = record_jax_training_draws(jm, params, batch, key, shortcut)
    draw = replay(records)
    monkeypatch.setattr(world_model_module, 'draw', draw)
    t_total, t_losses, _ = tm(**{k: T(v) for k, v in batch.items()}, shortcut_train=shortcut,
                              return_intermediates=True)
    t_total.backward()
    assert draw.remaining == []
    assert float(t_losses.agent_state_pred) > 0
    close(j_total, t_total, 2e-5, 1e-4)
    for field in WorldModelLosses._fields:
        close(getattr(j_losses, field), getattr(t_losses, field), 2e-5, 1e-4, field)
    want = flax_params_to_torch(j_grads, tm)
    for name, p in tm.named_parameters():
        close(want[name], grad_of(p), 2e-5, 1e-3, name)
    assert tm.agent_state_pred_net.Dense_0.weight.grad.abs().sum() > 0
    if case == 'latent_actor_bc':
        assert tm.actor_latent_encoder.Dense_0.weight.grad.abs().sum() > 0
        assert tm.critic_latent_encoder.Dense_0.weight.grad is None
    # frac 0 stops the agent-state loss at the trunk: only the other
    # losses reach it
    if case == 'frac0':
        tm.zero_grad(set_to_none=True)
        monkeypatch.setattr(world_model_module, 'draw', replay(records))
        _, losses, _ = tm(**{k: T(v) for k, v in batch.items()}, shortcut_train=shortcut,
                          return_intermediates=True)
        losses.agent_state_pred.backward()
        assert all(p.grad is None or not p.grad.any() for p in tm.transformer.parameters())


def test_latent_actor_inputs_match_jax():
    jm, params, tm = build_pair(**RECIPE)
    latents = np.tanh(np.random.default_rng(2).standard_normal((3, 5, 4, 8))).astype(np.float32)
    want = jm.apply({'params': params}, jnp.asarray(latents), method=jm.latent_actor_inputs)
    with torch.no_grad():
        got = tm.latent_actor_inputs(T(latents))
    for w, g in zip(want, got):
        assert g.shape == (3, 5, 16)
        close(w, g, 1e-6, 1e-5)


# ---------------------------------------------------------------- rollouts

def test_generate_with_latent_inputs_matches_jax(monkeypatch):
    """tests/test_rl.py:166: a dream of the recipe's model, whose policy and
    value read the denoised frame through the latent encoders."""
    jm, params, tm = build_pair(**RECIPE)
    key = jax.random.PRNGKey(5)
    kw = dict(time_steps=5, num_steps=2, batch_size=2, hard_terminals=False)
    jexp = jax.jit(lambda p: jgenerate(jm, {'params': p}, key, **kw))(params)
    monkeypatch.setattr(generate_module, 'draw', jax_draws(key, 1))
    with torch.no_grad():
        texp = generate(tm, torch.Generator(), **kw)
    np.testing.assert_array_equal(np.asarray(jexp.actions.discrete), texp.actions.discrete)
    for name, tol in (('latents', 2e-4), ('agent_embed', 2e-4), ('rewards', 2e-3),
                      ('values', 2e-3)):
        close(getattr(jexp, name), getattr(texp, name), tol, err_msg=name)
    close(jexp.log_probs.discrete, texp.log_probs.discrete, 2e-4, 1e-5)
    # the values are the critic encoder's, not the agent token's
    with torch.no_grad():
        token_values = tm.value_encoder.decode(tm.value_head(texp.agent_embed))
    assert not torch.allclose(token_values, texp.values, atol=1e-3)


def test_env_interactor_with_latent_inputs_matches_jax(monkeypatch):
    """The recipe's model against MockStateEnv b3: the policy and the value
    (plus the critic state's embedding) read the frame's latents."""
    jm, params, tm = build_pair(**RECIPE, dim_critic_state=4)
    make_env = env_factory(JMockStateEnv, MockStateEnv, dim_state=4, num_actions=3,
                           max_steps=6, batch=3, seed=2)
    jexp, exp = run_pair(jm, params, tm, make_env, jax.random.PRNGKey(9), monkeypatch,
                         max_timesteps=5, num_steps=2)
    assert_experience_matches(jexp, exp)


# --------------------------------------------------------------------- RL

@functools.cache
def jax_dream(items):
    """A b2 x T8 dream of the JAX model (hard terminals after 4 frames: the
    lengths vary, and each row has frames to learn on)."""
    jm, params, _ = build_pair(**dict(items))
    run = jax.jit(lambda p: jgenerate(jm, {'params': p}, jax.random.PRNGKey(0), time_steps=8,
                                      num_steps=2, batch_size=2, min_dream_length=4))
    return run(params)


# case: (model options, heads only)
RL_CASES = {
    'latent_full_model': (dict(actor_critic_latent_input=True), False),
    'spr1_heads_only': (dict(actor_spr=True), True),
    'spr2_full_model': (dict(actor_spr=True, actor_spr_num_rollouts=2), False),
    'recipe_heads_only': (dict(RECIPE), True),
}


@pytest.mark.parametrize('case', list(RL_CASES))
def test_rl_losses_with_options_match_jax(case):
    """tests/test_rl.py:322 and tests/test_world_model_features.py:94:
    losses, stats and every gradient. Latent-input full-model RL never
    replays the trunk, whose gradient is zero; the SPR term's gradients
    reach `actor_spr_module`, and in full-model RL the trunk."""
    cfg_kw, heads_only = RL_CASES[case]
    jm, params, tm = build_pair(**cfg_kw)
    jexp = jax_dream(tuple(sorted(cfg_kw.items())))
    kw = {} if heads_only else dict(latent_input_full_model_ok=True)
    stats = (0.2, 1.5)

    def loss_fn(p):
        out = j_rl_losses(jm, {'params': p}, jexp, only_learn_policy_value_heads=heads_only,
                          return_stats=JReturnStats(*map(jnp.float32, stats)), **kw)
        return out.policy_loss + out.value_loss, out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    assert (np.asarray(jexp.lens) >= 4).all()
    out = rl_losses(tm, to_torch_experience(jexp), only_learn_policy_value_heads=heads_only,
                    return_stats=ReturnStats(*(torch.tensor(x) for x in stats)), **kw)
    (out.policy_loss + out.value_loss).backward()
    assert_outputs_close(jout, out)
    want = flax_params_to_torch(jgrads, tm)
    for name, p in tm.named_parameters():
        close(want[name], grad_of(p), 2e-5, 1e-3, err_msg=name)
    trunk_grad = sum(float(grad_of(p).abs().sum()) for p in tm.transformer.parameters())
    if tm.actor_critic_latent_input:
        assert trunk_grad == 0.0
        for name in ('actor_latent_encoder', 'critic_latent_encoder'):
            assert tm.get_submodule(name).Dense_0.weight.grad.abs().sum() > 0, name
    else:
        assert (trunk_grad > 0) == (not heads_only)
    if tm.actor_spr:
        assert tm.actor_spr_module.dynamics_mlp.Dense_0.weight.grad.abs().sum() > 0


def test_latent_input_full_model_needs_acknowledgement():
    jm, params, tm = build_pair(actor_critic_latent_input=True)
    jexp = jax_dream((('actor_critic_latent_input', True),))
    with pytest.raises(ValueError, match='latent_input_full_model_ok'):
        j_rl_losses(jm, {'params': params}, jexp, only_learn_policy_value_heads=False)
    with pytest.raises(ValueError, match='latent_input_full_model_ok'):
        rl_losses(tm, to_torch_experience(jexp), only_learn_policy_value_heads=False)
    # heads-only RL needs no acknowledgement, and the flag changes nothing there
    a = rl_losses(tm, to_torch_experience(jexp))
    b = rl_losses(tm, to_torch_experience(jexp), latent_input_full_model_ok=True)
    assert torch.equal(a.policy_loss, b.policy_loss)


@pytest.mark.parametrize('rollouts,masked', [(1, True), (3, True), (2, False)])
def test_actor_spr_matches_jax(rollouts, masked):
    """`ActorSPR` alone, with an action embedder's unembedding and KL as its
    callables: the SPR and KL terms and every gradient, over a mask that
    ends some rows early."""
    rng = np.random.default_rng(rollouts)
    b, t, dim, da = 3, 6, 12, 8
    embed = rng.standard_normal((b, t, dim)).astype(np.float32)
    actions = rng.integers(0, 4, (b, t, 1)).astype(np.int32)
    mask = np.arange(t)[None] < np.array([[6], [4], [2]]) if masked else None
    jae = JActionEmbedder(dim=da, num_discrete_actions=(4,), can_unembed=True, unembed_dim=dim,
                          num_unembed_preds=2)
    ae_params = jax.tree.map(np.asarray, jae.init(
        jax.random.PRNGKey(0), discrete_actions=jnp.asarray(actions))['params'])
    ae_params['discrete_action_unembed'] = (rng.standard_normal(
        ae_params['discrete_action_unembed'].shape) * 0.3).astype(np.float32)
    jspr = JActorSPR(dim=dim, num_rollouts=rollouts)
    spr_params = jax.tree.map(np.asarray, jspr.init(
        jax.random.PRNGKey(1), jnp.zeros((1, t, dim)), jnp.zeros((1, t, da)))['params'])

    def j_loss(params, embed):
        apply = partial(jae.apply, {'params': params['ae']})
        action_embeds = apply(discrete_actions=jnp.asarray(actions))
        total, parts = jspr.apply(
            {'params': params['spr']}, embed, action_embeds,
            unembed_fn=lambda e: apply(e, pred_head_index=0, method=jae.unembed),
            kl_fn=jae.kl_div, mask=None if mask is None else jnp.asarray(mask))
        return total, parts

    (j_total, j_parts), (j_grads, j_embed_grad) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))({'ae': ae_params, 'spr': spr_params},
                                               jnp.asarray(embed))
    tae = ActionEmbedder(da, num_discrete_actions=(4,), can_unembed=True, unembed_dim=dim,
                         num_unembed_preds=2, device='cpu')
    tae.load_state_dict(flax_params_to_torch(ae_params, tae))
    tspr = ActorSPR(dim, num_rollouts=rollouts, dim_action_embed=da, device='cpu')
    tspr.load_state_dict(flax_params_to_torch(spr_params, tspr))
    t_embed = T(embed.copy()).requires_grad_()
    total, parts = tspr(t_embed, tae(discrete_actions=T(actions)),
                        unembed_fn=lambda e: tae.unembed(e, pred_head_index=0),
                        kl_fn=tae.kl_div, mask=None if mask is None else T(mask))
    total.backward()
    close(j_total, total, 1e-6, 1e-5)
    for j, g in zip(j_parts, parts):
        close(j, g, 1e-6, 1e-5)
    assert float(parts[0]) > 0 and float(parts[1]) > 0
    close(j_embed_grad, t_embed.grad, 2e-6, 1e-4, 'policy embed')
    for module, grads in ((tspr, j_grads['spr']), (tae, j_grads['ae'])):
        want = flax_params_to_torch(grads, module)
        for name, p in module.named_parameters():
            close(want[name], grad_of(p), 2e-6, 1e-4, err_msg=name)
    # the actions enter the rollout without a gradient, the targets' side
    # of the KL through a frozen unembedding
    assert tae.discrete_action_embed.weight.grad is None
    pred = torch.randn(4, 5)
    np.testing.assert_allclose(np.asarray(jutils.smooth_l1_loss(jnp.asarray(pred.numpy()),
                                                                jnp.zeros((4, 5)), 0.5)),
                               tutils.smooth_l1_loss(pred, torch.zeros(4, 5), 0.5).numpy(),
                               atol=1e-7)


def test_actor_spr_refuses_sigreg_and_short_sequences():
    """A sequence needs more steps than rollouts. The sigreg term is ported
    now (tests/test_torch_tokenizer_options.py holds it against JAX), so a
    nonzero weight builds. The JAX world model touches its SPR module at
    init with 3 steps, so it cannot be initialized with 3 or more rollouts
    (pinned); the port builds it."""
    assert ActorSPR(8, sigreg_loss_weight=0.1, device='cpu').sigreg_loss_weight == 0.1
    spr = ActorSPR(8, num_rollouts=3, device='cpu')
    with pytest.raises(ValueError, match='num_rollouts'):
        spr(torch.zeros(1, 3, 8), torch.zeros(1, 3, 8))
    cfg = {**SMALL, 'actor_spr': True, 'actor_spr_num_rollouts': 3}
    with pytest.raises(AssertionError):
        JWorldModel(**cfg).init(jax.random.PRNGKey(0), latents=jnp.zeros((1, 4, 4, 8)),
                                shortcut_train=False)
    assert DynamicsWorldModel(**cfg, device='cpu').actor_spr_module.num_rollouts == 3


# ------------------------------------------------------- labels, trainers

def labels_through_converter(params, tm, full_model):
    labels = jtrainers.rl_param_labels(params, None, full_model=full_model)
    codes = {'policy': 0.0, 'value': 1.0, 'frozen': 2.0, 'trunk': 3.0}
    marks = jax.tree.map(lambda p, label: np.full(p.shape, codes[label], np.float32),
                         params, labels)
    names = {v: k for k, v in codes.items()}
    return {n: names[float(t.flatten()[0])] for n, t in flax_params_to_torch(marks, tm).items()}


@pytest.mark.parametrize('full_model', [False, True])
def test_rl_param_labels_of_the_options_match_jax(full_model):
    """The latent encoders belong to the policy and the value; the SPR
    module is the rest, so heads-only RL leaves it frozen, as in JAX."""
    _, params, tm = build_pair(**RECIPE, dim_critic_state=4)
    labels = rl_param_labels(tm, full_model=full_model)
    assert labels == labels_through_converter(params, tm, full_model)
    rest = 'trunk' if full_model else 'frozen'
    assert labels['actor_latent_encoder.Dense_0.weight'] == 'policy'
    assert labels['critic_latent_encoder.Dense_0.weight'] == 'value'
    assert labels['actor_spr_module.dynamics_mlp.Dense_0.weight'] == rest
    assert labels['agent_state_pred_net.Dense_0.weight'] == rest


def test_dream_trainer_recipe_step_matches_jax(monkeypatch):
    """One heads-only `DreamTrainer` step of the recipe's model: the losses
    and the moved parameters as JAX's, and only the policy and value heads,
    the action unembedding and the two latent encoders move. The SPR
    module's gradient is not zero, and it stays where it was."""
    jm, params, tm = build_pair(**RECIPE)
    kw = dict(time_steps=6, num_steps=2, batch_size=2,
              generate_kwargs=dict(min_dream_length=4))
    jtrainer = jtrainers.DreamTrainer(jm, {'params': params}, **kw)
    trainer = DreamTrainer(tm, **kw, device='cpu')
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    key = jax.random.fold_in(jax.random.PRNGKey(4), 0)
    jexp, jout = jtrainer.step(key)

    def loss_fn(p):
        out = j_rl_losses(jm, {'params': p}, jexp, return_stats=JReturnStats.create())
        return out.policy_loss + out.value_loss

    jgrads = jax.jit(jax.grad(loss_fn))(params)
    monkeypatch.setattr(generate_module, 'draw', jax_draws(key, 1))
    _, tout = trainer.step()
    assert_outputs_close(jout, tout)
    labels = rl_param_labels(tm)
    moving = {n for n, label in labels.items() if label != 'frozen'}
    assert {n.partition('.')[0] for n in moving} == {
        'policy_head', 'value_head', 'action_embedder', 'actor_latent_encoder',
        'critic_latent_encoder'}
    want = flax_params_to_torch(jax.tree.map(np.asarray, jtrainer.rl_state.params), tm)
    lrs = {n: 1e-4 if n in moving else 0.0 for n in labels}
    assert_updates_close(want, tm, small_grads(jgrads, tm), lrs, names=moving)
    for name, p in tm.named_parameters():
        assert torch.equal(p, before[name]) == (name not in moving), name
    assert tm.actor_spr_module.dynamics_mlp.Dense_0.weight.grad.abs().sum() > 0


def test_sim_trainer_recipe_step_matches_jax(monkeypatch):
    """One heads-only `SimTrainer` step of the recipe's model (the dynamics
    step, the agent-state loss included, then an RL update) against JAX's:
    rollouts, losses and every parameter."""
    counts = spy_flash(monkeypatch)
    trainer, shortcuts = run_sim_pair(
        dict(env=dict(max_steps=5, batch=3, seed=3),
             trainer=dict(max_timesteps=5, update_epochs=1),
             model={k: v for k, v in RECIPE.items() if k != 'dim_state'}),
        monkeypatch, steps=1)
    assert trainer.rl_state.step == 1 and len(shortcuts) == 1
    assert counts == dict.fromkeys(counts, 0)


def test_recipe_model_checkpoint_save_and_resume(tmp_path):
    """The recipe's options go through a checkpoint's config, and a
    `BehaviorCloneTrainer` restored from it continues bit for bit."""
    torch.manual_seed(0)
    cfg = {**SMALL, **RECIPE}
    make = lambda: BehaviorCloneTrainer(DynamicsWorldModel(**cfg, device='cpu'),
                                        learning_rate=1e-3, seed=0, device='cpu')
    batches = [{k: T(v) for k, v in recipe_batch(30 + i).items()} for i in range(3)]
    trainer = make()
    trainer.train_on_batch(batches[0])
    target = trainer.save_checkpoint(tmp_path)
    for batch in batches[1:]:
        _, losses = trainer.train_on_batch(batch)
    assert float(losses.agent_state_pred) > 0

    torch.manual_seed(1)
    trainer2 = make()
    trainer2.restore(tmp_path)
    for batch in batches[1:]:
        trainer2.train_on_batch(batch)
    got = dict(trainer2.model.named_parameters())
    for name, p in trainer.model.named_parameters():
        assert torch.equal(p, got[name]), name
    back = checkpoint.load_model(target, DynamicsWorldModel, device='cpu')
    assert back.config == trainer.model.config
    for name in ('actor_critic_latent_input', 'agent_predicts_state', 'actor_spr'):
        assert back.config[name] is True and getattr(back, name) is True
    assert back.config['actor_spr_num_rollouts'] == 2
    assert any(n.startswith('actor_spr_module.') for n, _ in back.named_parameters())
