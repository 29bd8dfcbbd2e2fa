"""RL over dreams in the port (`models/rl.py`, the RL optimizer and update
step, `DreamTrainer`) against the JAX package, at float32 on the CPU.

Both packages get the same inputs: the JAX model's parameters converted
into the port, and one experience dreamed by the JAX `generate` (or made
from a seed with numpy) handed to both as arrays, so no RNG stream is
shared. `DreamTrainer` steps replay the JAX rollout's draws into the port
through `models.generate.draw`. Then copies of the JAX package's own RL
cases (discrete actions), run on the port alone.

Tolerances, all float32:
  - `calc_gae`: 1e-5 (a doubling scan against `associative_scan`: other
    summation orders over up to 192 steps of returns of size about 10);
  - entropies, KL divergences, `z_score`, log probs: 1e-6;
  - losses, stats and return statistics: 1e-5 absolute, 1e-4 relative;
  - gradients: 2e-5 absolute, 1e-3 relative (those of the world model's
    training, tests/test_torch_train.py: float32 through the trunk and the
    255-bin heads in two frameworks);
  - parameters after AdamW steps on the same gradients as `optax.adamw`:
    1e-6; after update steps from gradients computed apart (an update step,
    `DreamTrainer` steps): 1e-6 where the JAX gradient is at least 1e-7 in
    size, else 2.01 lr per step (`assert_updates_close`: Adam's first steps
    turn a rounding difference of a gradient near zero into a sign flip).
"""
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dreamer4_tpu.data.experience import index_experience as jindex_experience
from dreamer4_tpu.models.generate import generate as jgenerate
from dreamer4_tpu.models.rl import ReturnStats as JReturnStats
from dreamer4_tpu.models.rl import rl_losses as j_rl_losses
from dreamer4_tpu.models.world_model import DynamicsWorldModel as JWorldModel
from dreamer4_tpu.nn.action_embedder import ActionEmbedder as JActionEmbedder
from dreamer4_tpu.ops import dists as jdists
from dreamer4_tpu.ops import scan as jscan
from dreamer4_tpu.ops import utils as jutils
from dreamer4_tpu.ops.flash_attention import flash_attend_bwd as j_flash_attend_bwd
import dreamer4_tpu.ops.flash_attention as jflash
import dreamer4_tpu.train.trainers as jtrainers
from dreamer4_torch import DreamTrainer
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.data.experience import Experience, index_experience
from dreamer4_torch.models import generate as generate_module
from dreamer4_torch.models.generate import generate
from dreamer4_torch.models.rl import ReturnStats, rl_losses
from dreamer4_torch.models.world_model import DynamicsWorldModel
from dreamer4_torch.nn.action_embedder import ActionEmbedder, Actions
from dreamer4_torch.ops import dists as tdists
from dreamer4_torch.ops import flash_attention as fa
from dreamer4_torch.ops import scan as tscan
from dreamer4_torch.ops import utils as tutils
from dreamer4_torch.train.trainers import (create_rl_state, make_rl_optimizer,
                                           make_rl_update_step, rl_param_labels)

torch.set_num_threads(1)
T = torch.from_numpy
# tests/test_rl.py:13-31
SMALL = dict(dim=16, dim_latent=8, num_latent_tokens=4, max_steps=16, depth=1,
             time_block_every=1, num_spatial_tokens=4, num_discrete_actions=(4,),
             attn_dim_head=8, attn_heads=2, multi_token_pred_len=2, num_register_tokens=2,
             predict_terminals=True)
OBJECTIVES = ('ppo', 'pmpo', 'spo')
HEADS = ('policy_head.', 'value_head.', 'action_embedder.discrete_action_unembed')


def close(a, b, atol, rtol=0.0, err_msg=''):
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
    np.testing.assert_allclose(np.asarray(a), b, atol=atol, rtol=rtol, err_msg=err_msg)


# ------------------------------------------------------------------ models

_PARAMS = {}


def jax_params(cfg):
    """The JAX model's initial parameters (numpy) for one configuration, as
    tests/test_rl.py initializes them; the RL hyperparameters leave them
    unchanged, as do the attention options, so they are shared by every
    case of a width."""
    key = tuple(sorted((k, v) for k, v in cfg.items() if k in SMALL))
    if key not in _PARAMS:
        jm = JWorldModel(**cfg)
        rngs = {'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)}
        init = jax.jit(lambda rngs: jm.init(
            rngs, latents=jnp.zeros((2, 3, 4, 8)), shortcut_train=False,
            rewards=jnp.zeros((2, 3)), terminals=jnp.zeros((2,), bool),
            discrete_actions=jnp.zeros((2, 2, 1), jnp.int32))['params'])
        _PARAMS[key] = jax.tree.map(np.asarray, init(rngs))
    return _PARAMS[key]


def build_pair(**kw):
    cfg = {**SMALL, **kw}
    jm = JWorldModel(**cfg)
    params = jax_params(cfg)
    tm = DynamicsWorldModel(**cfg, device='cpu')
    tm.load_state_dict(flax_params_to_torch(params, tm))
    return jm, params, tm


def _t(x):
    return None if x is None else T(np.array(x))


def to_torch_experience(jexp) -> Experience:
    """The JAX experience as the port's, array for array."""
    unembeds = jexp.old_action_unembeds
    return Experience(
        latents=_t(jexp.latents), agent_embed=_t(jexp.agent_embed), rewards=_t(jexp.rewards),
        terminals=_t(jexp.terminals), terminal_probs=_t(jexp.terminal_probs),
        actions=Actions(_t(jexp.actions.discrete).long(), None),
        log_probs=Actions(_t(jexp.log_probs.discrete), None),
        old_action_unembeds=(None if unembeds is None
                             else (tuple(_t(l) for l in unembeds[0]), None)),
        values=_t(jexp.values), step_size=jexp.step_size, lens=_t(jexp.lens).long(),
        is_truncated=_t(jexp.is_truncated), agent_index=jexp.agent_index,
        prompt_len=jexp.prompt_len, episode_return=_t(jexp.episode_return))


@functools.cache
def jax_experience(prompted: bool = False, time_steps: int = 6, **model_kw):
    """A b2 dream of the JAX model (hard terminals on, so the lengths vary),
    with a 2-frame prompt when `prompted`."""
    jm, params, _ = build_pair(**model_kw)
    prompt = {}
    if prompted:
        rng = np.random.default_rng(5)
        prompt = dict(prompt_latents=rng.uniform(-1, 1, (2, 2, 4, 8)).astype(np.float32),
                      prompt_discrete_actions=rng.integers(0, 4, (2, 2, 1)).astype(np.int32))
    run = jax.jit(lambda p, pr: jgenerate(jm, {'params': p}, jax.random.PRNGKey(0),
                                          time_steps=time_steps, num_steps=2, batch_size=2,
                                          **pr))
    return run(params, prompt)


# ------------------------------------------------------------ small parts

@pytest.mark.parametrize('t', [1, 7, 192])
def test_calc_gae_matches_jax(t):
    rng = np.random.default_rng(t)
    rewards = rng.standard_normal((3, t)).astype(np.float32)
    values = (rng.standard_normal((3, t)) * 3).astype(np.float32)
    masks = (rng.random((3, t)) < 0.9).astype(np.float32) * rng.uniform(0.5, 1.0, (3, t))
    learn = rng.random((3, t)) < 0.8
    jgae = jax.jit(partial(jscan.calc_gae, gamma=0.997, lam=0.95))
    for m, lm in ((None, None), (masks.astype(np.float32), learn)):
        want = jgae(jnp.asarray(rewards), jnp.asarray(values),
                    masks=None if m is None else jnp.asarray(m),
                    learn_masks=None if lm is None else jnp.asarray(lm))
        got = tscan.calc_gae(T(rewards), T(values), masks=None if m is None else T(m),
                             learn_masks=None if lm is None else T(lm), gamma=0.997, lam=0.95)
        close(want, got, 1e-5)
    # the forward direction and another axis
    gates = rng.uniform(0, 1, (t, 2)).astype(np.float32)
    vals = rng.standard_normal((t, 2)).astype(np.float32)
    close(jax.jit(partial(jscan.linear_recurrence_scan, axis=0))(jnp.asarray(gates),
                                                                 jnp.asarray(vals)),
          tscan.linear_recurrence_scan(T(gates), T(vals), dim=0), 1e-5)


def test_calc_gae_has_no_gradient_to_rewards_or_values():
    rewards = torch.randn(2, 5, requires_grad=True)
    values = torch.randn(2, 5, requires_grad=True)
    assert not tscan.calc_gae(rewards, values).requires_grad


def test_entropy_kl_z_score_match_jax():
    rng = np.random.default_rng(0)
    src = [rng.standard_normal((2, 5, n)).astype(np.float32) * 3 for n in (4, 7)]
    tgt = [rng.standard_normal((2, 5, n)).astype(np.float32) for n in (4, 7)]
    close(jdists.multi_categorical_entropy([jnp.asarray(x) for x in src]),
          tdists.multi_categorical_entropy([T(x) for x in src]), 1e-6)
    close(jdists.multi_categorical_kl([jnp.asarray(x) for x in src], [jnp.asarray(x) for x in tgt]),
          tdists.multi_categorical_kl([T(x) for x in src], [T(x) for x in tgt]), 1e-6)
    x = (rng.standard_normal((3, 6)) * 4 + 1).astype(np.float32)
    weights = (rng.random((3, 6)) < 0.7) * rng.uniform(0.2, 1.0, (3, 6)).astype(np.float32)
    for m in (None, weights.astype(np.float32), weights > 0, np.zeros((3, 6), np.float32)):
        close(jutils.z_score(jnp.asarray(x), None if m is None else jnp.asarray(m), eps=1e-6),
              tutils.z_score(T(x), None if m is None else T(m), eps=1e-6), 1e-6)


def test_action_embedder_entropies_and_kl_div_match_jax():
    sizes = (4, 3)
    jae = JActionEmbedder(dim=8, num_discrete_actions=sizes, can_unembed=True, unembed_dim=12,
                          num_unembed_preds=2)
    rng = np.random.default_rng(1)
    embeds = rng.standard_normal((2, 5, 12)).astype(np.float32)
    targets = rng.integers(0, 3, (2, 5, 2)).astype(np.int32)
    params = jae.init(jax.random.PRNGKey(0), discrete_actions=jnp.asarray(targets))['params']
    # unembedding weights of a useful size (the initializer's are 1e-2)
    params = jax.tree.map(np.asarray, params)
    params['discrete_action_unembed'] = rng.standard_normal(
        params['discrete_action_unembed'].shape).astype(np.float32) * 0.3
    tae = ActionEmbedder(dim=8, num_discrete_actions=sizes, can_unembed=True, unembed_dim=12,
                         num_unembed_preds=2, device='cpu')
    tae.load_state_dict(flax_params_to_torch(params, tae))
    other = rng.standard_normal((2, 5, 12)).astype(np.float32)

    @jax.jit
    def jax_side(params, embeds, targets, other):
        apply = partial(jae.apply, {'params': params})
        lps = [apply(embeds, discrete_targets=targets, pred_head_index=head,
                     return_entropies=True, soft_validate_range=True, method=jae.log_probs)
               for head in (0, None)]
        src = apply(embeds, pred_head_index=0, method=jae.unembed)
        tgt = apply(other, pred_head_index=0, method=jae.unembed)
        kls = [jae.kl_div(src, tgt, reduce_across_num_actions=r)[0] for r in (True, False)]
        return lps, kls

    j_lps, j_kls = jax_side(params, embeds, targets, other)
    for head, (jlp, jent) in zip((0, None), j_lps):
        tlp, tent = tae.log_probs(T(embeds), discrete_targets=T(targets), pred_head_index=head,
                                  return_entropies=True, soft_validate_range=True)
        close(jlp.discrete, tlp.discrete, 1e-6)
        close(jent.discrete, tent.discrete, 1e-6)
        assert tlp.continuous is None and tent.continuous is None
    assert isinstance(tae.log_probs(T(embeds), discrete_targets=T(targets)), Actions)
    tsrc = tae.unembed(T(embeds), pred_head_index=0)
    ttgt = tae.unembed(T(other), pred_head_index=0)
    for reduce, jkl in zip((True, False), j_kls):
        tkl, tckl = tae.kl_div(tsrc, ttgt, reduce_across_num_actions=reduce)
        close(jkl, tkl, 1e-6)
        assert tckl is None
    # a discrete-only embedder has no continuous half to score or compare
    assert tae.kl_div((tsrc[0], torch.zeros(2, 5, 1, 2)), ttgt)[1] is None
    assert tae.log_probs(T(embeds), continuous_targets=torch.zeros(2, 5, 1)).continuous is None


def test_index_experience_matches_jax():
    jexp = jax_experience()
    want = to_torch_experience(jindex_experience(jexp, np.array([1])))
    got = index_experience(to_torch_experience(jexp), torch.tensor([1]))
    for name, value in vars(want).items():
        other = getattr(got, name)
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, other), name
        elif name in ('actions', 'log_probs'):
            assert torch.equal(value.discrete, other.discrete) and other.continuous is None
        elif name == 'old_action_unembeds':
            assert torch.equal(value[0][0], other[0][0]) and other[1] is None
        else:
            assert value == other, name
    assert got.latents.shape[0] == 1 and got.step_size == jexp.step_size


def test_rl_hyperparameters_are_constructor_arguments():
    rl = dict(gae_lambda=0.9, ppo_eps_clip=0.1, pmpo_pos_to_neg_weight=0.6,
              pmpo_reverse_kl=False, pmpo_kl_div_loss_weight=0.2, use_delight_gating=False,
              delight_temperature=2.0, value_clip=0.3, clip_values=True,
              policy_entropy_weight=0.02, agent_policy_gradient_frac=0.5,
              agent_value_gradient_frac=0.25, keep_reward_ema_stats=True,
              reward_ema_decay=0.99, reward_quantile_filter=(0.1, 0.9),
              normalize_advantages=False)
    tm = DynamicsWorldModel(**SMALL, **rl, device='cpu')
    jm = JWorldModel(**SMALL)
    for name, value in rl.items():
        assert getattr(tm, name) == value and tm.config[name] == value
    default = DynamicsWorldModel(**SMALL, device='cpu')
    for name in rl:
        assert getattr(default, name) == getattr(jm, name), name


# ------------------------------------------------------ rl_losses parity

def jax_losses_and_grads(jm, params, jexp, objectives, heads_only, return_stats, **kw):
    """{objective: (outputs, gradients)} of the JAX losses, all objectives in
    one jitted call."""
    def loss_fn(objective, p):
        out = j_rl_losses(jm, {'params': p}, jexp, objective=objective,
                          only_learn_policy_value_heads=heads_only,
                          return_stats=return_stats, **kw)
        return out.policy_loss + out.value_loss, out

    def run(p):
        return {o: jax.value_and_grad(partial(loss_fn, o), has_aux=True)(p) for o in objectives}

    return {o: (out, grads) for o, ((_, out), grads) in jax.jit(run)(params).items()}


def port_losses_and_grads(tm, exp, objective, heads_only, return_stats, **kw):
    tm.zero_grad(set_to_none=True)
    out = rl_losses(tm, exp, objective=objective, only_learn_policy_value_heads=heads_only,
                    return_stats=return_stats, **kw)
    (out.policy_loss + out.value_loss).backward()
    return out


def assert_outputs_close(jout, tout):
    close(jout.policy_loss, tout.policy_loss, 1e-5, 1e-4)
    close(jout.value_loss, tout.value_loss, 1e-5, 1e-4)
    assert set(jout.stats) == set(tout.stats)
    for name, value in jout.stats.items():
        close(value, tout.stats[name], 1e-5, 1e-4, err_msg=name)
    close(jout.return_stats.mean, tout.return_stats.mean, 1e-5, 1e-4)
    close(jout.return_stats.var, tout.return_stats.var, 1e-5, 1e-4)


def assert_grads_close(jgrads, tm, heads_only):
    want = flax_params_to_torch(jgrads, tm)
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        close(want[name].numpy(), got, 2e-5, 1e-3, err_msg=name)
        if heads_only and not name.startswith(HEADS):
            assert p.grad is None or not p.grad.any(), name
    for prefix in HEADS if heads_only else ('',):
        assert any(p.grad is not None and p.grad.any() for n, p in tm.named_parameters()
                   if n.startswith(prefix)), prefix


def terminals_2d(jexp):
    rng = np.random.default_rng(3)
    seq = rng.random(jexp.rewards.shape) < 0.25
    return jexp.replace(terminals=jnp.asarray(seq))


# case: (model options, rl_losses options, experience change, return stats)
LOSS_CASES = {
    'default': (dict(), dict(), None, None),
    'reward_ema': (dict(keep_reward_ema_stats=True), dict(), None, (0.3, 1.7)),
    'hard_continuation': (dict(), dict(soft_continuation=False), None, None),
    'terminals_2d': (dict(), dict(), terminals_2d, None),
    'prompted': (dict(), dict(), 'prompted', None),
    'clip_values': (dict(clip_values=True), dict(), None, None),
}


def case_stats(stats):
    jstats = JReturnStats.create() if stats is None else JReturnStats(*map(jnp.float32, stats))
    return jstats, ReturnStats(*(T(np.array(x)) for x in jstats))


@functools.cache
def jax_case(case):
    """The JAX outputs and gradients of one case, heads-only, for every
    objective."""
    cfg_kw, kw, change, stats = LOSS_CASES[case]
    jm, params, _ = build_pair(**cfg_kw)
    jexp = jax_experience(prompted=change == 'prompted')
    if callable(change):
        jexp = change(jexp)
    return jexp, jax_losses_and_grads(jm, params, jexp, OBJECTIVES, True,
                                      case_stats(stats)[0], **kw)


@pytest.mark.parametrize('case', list(LOSS_CASES))
@pytest.mark.parametrize('objective', OBJECTIVES)
def test_rl_losses_and_head_grads_match_jax(objective, case):
    cfg_kw, kw, change, stats = LOSS_CASES[case]
    _, _, tm = build_pair(**cfg_kw)
    jexp, results = jax_case(case)
    jout, jgrads = results[objective]
    tout = port_losses_and_grads(tm, to_torch_experience(jexp), objective, True,
                                 case_stats(stats)[1], **kw)
    assert_outputs_close(jout, tout)
    assert_grads_close(jgrads, tm, heads_only=True)
    if change == 'prompted':
        assert jexp.prompt_len == 2
    if cfg_kw.get('keep_reward_ema_stats'):
        assert float(tout.return_stats.mean) != 0.3


@functools.cache
def jax_full_model():
    """The JAX outputs and gradients of full-model PPO on the default dream."""
    jm, params, _ = build_pair()
    return jax_losses_and_grads(jm, params, jax_experience(), ('ppo',), False,
                                JReturnStats.create())['ppo']


def test_full_model_rl_grads_match_jax():
    """only_learn_policy_value_heads=False re-forwards the trunk in both
    packages: every gradient, the trunk's included."""
    _, _, tm = build_pair()
    jout, jgrads = jax_full_model()
    tout = port_losses_and_grads(tm, to_torch_experience(jax_experience()), 'ppo', False,
                                 ReturnStats.create())
    assert_outputs_close(jout, tout)
    assert_grads_close(jgrads, tm, heads_only=False)
    assert any(p.grad is not None and p.grad.any() for p in tm.transformer.parameters())


def test_heads_only_replay_without_stored_embeds_matches_jax():
    """An experience without agent embeddings: both packages replay the
    trunk, without gradients to it."""
    jm, params, tm = build_pair()
    jexp = jax_experience().replace(agent_embed=None)
    jout, jgrads = jax_losses_and_grads(jm, params, jexp, ('pmpo',), True,
                                        JReturnStats.create())['pmpo']
    tout = port_losses_and_grads(tm, to_torch_experience(jexp), 'pmpo', True,
                                 ReturnStats.create())
    assert_outputs_close(jout, tout)
    assert_grads_close(jgrads, tm, heads_only=True)


def test_full_model_rl_through_flash_matches_jax(monkeypatch):
    """A b2 x T128 dream with the flash gate lowered to 1024 scores: the
    time layer's replay takes the flash branch in both packages, the JAX
    Pallas kernels in interpret mode (forward and fused backward), the
    port's autograd Function on the plain versions of K1-K3. Space
    attention (81 scores) and the dream's decode steps (1 x 128) stay
    under the gate."""
    flash = dict(use_flash_attention=True, flash_min_scores=1024)
    jexp = jax_experience(time_steps=128, **flash)
    counts = {'jax_fused_bwd': 0, 'port_fwd': 0, 'port_dq': 0, 'port_dkv': 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jflash, 'flash_attend_bwd', spy('jax_fused_bwd', j_flash_attend_bwd))
    monkeypatch.setattr(fa, 'flash_attend_reference', spy('port_fwd', fa.flash_attend_reference))
    monkeypatch.setattr(fa, 'bwd_dq_reference', spy('port_dq', fa.bwd_dq_reference))
    monkeypatch.setattr(fa, 'bwd_dkv_reference', spy('port_dkv', fa.bwd_dkv_reference))
    jm, params, tm = build_pair(**flash)
    jout, jgrads = jax_losses_and_grads(jm, params, jexp, ('pmpo',), False,
                                        JReturnStats.create())['pmpo']
    tout = port_losses_and_grads(tm, to_torch_experience(jexp), 'pmpo', False,
                                 ReturnStats.create())
    assert counts == {'jax_fused_bwd': 1, 'port_fwd': 1, 'port_dq': 1, 'port_dkv': 1}
    assert_outputs_close(jout, tout)
    assert_grads_close(jgrads, tm, heads_only=False)


# ------------------------------------------------------ optimizer, trainer

def port_labels_through_converter(params, tm, full_model):
    labels = jtrainers.rl_param_labels(params, None, full_model=full_model)
    codes = {'policy': 0.0, 'value': 1.0, 'frozen': 2.0, 'trunk': 3.0}
    marks = jax.tree.map(lambda p, label: np.full(p.shape, codes[label], np.float32),
                         params, labels)
    names = {v: k for k, v in codes.items()}
    return {n: names[float(t.flatten()[0])] for n, t in flax_params_to_torch(marks, tm).items()}


@pytest.mark.parametrize('full_model', [False, True])
def test_rl_param_labels_match_jax(full_model):
    _, params, tm = build_pair()
    labels = rl_param_labels(tm, full_model=full_model)
    assert labels == port_labels_through_converter(params, tm, full_model)
    assert labels['action_embedder.discrete_action_unembed'] == 'policy'
    assert labels['action_embedder.discrete_action_embed.weight'] == ('trunk' if full_model
                                                                     else 'frozen')


LRS = dict(policy_lr=1e-3, value_lr=2e-3)


def group_lrs(tm, trunk_lr, policy_lr=LRS['policy_lr'], value_lr=LRS['value_lr']):
    lrs = {'policy': policy_lr, 'value': value_lr, 'trunk': trunk_lr, 'frozen': 0.0}
    return {n: lrs[label] for n, label in rl_param_labels(tm, trunk_lr is not None).items()}


@pytest.mark.parametrize('mode', ['heads_only', 'full_model'])
def test_rl_optimizer_matches_optax_on_identical_gradients(mode):
    """Two steps of the AdamW groups against `optax.multi_transform` of
    `optax.adamw` (and `set_to_zero` for the frozen group) on the same
    gradients: every parameter within 1e-6; the frozen ones bit-identical
    and in no group."""
    trunk_lr = None if mode == 'heads_only' else 5e-4
    _, params, tm = build_pair()
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tx = jtrainers.make_rl_optimizer(None, **LRS, trunk_lr=trunk_lr)(params)
    state = tx.init(params)

    @jax.jit
    def jax_step(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    opt = make_rl_optimizer(tm, **LRS, trunk_lr=trunk_lr)
    rng = np.random.default_rng(0)
    for std in (1e-2, 1e-3):
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * std).astype(np.float32),
                             params)
        params, state = jax_step(grads, state, params)
        for name, g in flax_params_to_torch(grads, tm).items():
            tm.get_parameter(name).grad = g
        opt.step()
        want = flax_params_to_torch(jax.tree.map(np.asarray, params), tm)
        for name, p in tm.named_parameters():
            close(want[name].numpy(), p, 1e-6, err_msg=name)
    in_optimizer = {id(p) for g in opt.param_groups for p in g['params']}
    for name, p in tm.named_parameters():
        frozen = trunk_lr is None and not name.startswith(HEADS)
        assert (id(p) not in in_optimizer) == frozen, name
        assert torch.equal(p, before[name]) == frozen, name


def small_grads(jgrads, tm):
    return {n: np.abs(g.numpy()) < 1e-7 for n, g in flax_params_to_torch(jgrads, tm).items()}


def assert_updates_close(want, tm, small_grad, lrs, steps=1, names=None):
    """Parameters after `steps` Adam updates from gradients computed apart:
    within 1e-6 wherever the JAX gradient of every step was at least 1e-7
    in size. Below that a step, lr * m / (sqrt(v) + 1e-8) with |m / sqrt(v)|
    at most 1.0015 in the first two steps, turns a rounding difference of
    the gradient into up to 2 lr (a sign flip), so there the bound is
    2.01 lr per step."""
    for name, p in tm.named_parameters():
        if names is not None and name not in names:
            continue
        diff = np.abs(want[name].numpy() - p.detach().numpy())
        assert not (diff[~small_grad[name]] > 1e-6).any(), name
        assert (diff <= 2.01 * steps * lrs[name] + 1e-6).all(), name


@pytest.mark.parametrize('mode', ['heads_only', 'full_model'])
def test_rl_update_step_matches_jax(mode):
    """One `make_rl_update_step` from the same experience in both packages
    (`assert_updates_close`); in heads-only mode the trunk is
    bit-identical."""
    heads_only = mode == 'heads_only'
    trunk_lr = None if heads_only else 1e-3
    jm, params, tm = build_pair()
    jexp = jax_experience()
    tx = jtrainers.make_rl_optimizer(jm, **LRS, trunk_lr=trunk_lr)(params)
    jstep = jtrainers.make_rl_update_step(jm, tx, 'ppo', only_learn_policy_value_heads=heads_only)
    jstate = jtrainers.RLState(params=params, opt_state=tx.init(params),
                               return_stats=JReturnStats.create(), step=jnp.zeros((), jnp.int32))
    jstate, jout = jstep(jstate, jexp)
    jgrads = jax_case('default')[1]['ppo'][1] if heads_only else jax_full_model()[1]

    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt = make_rl_optimizer(tm, **LRS, trunk_lr=trunk_lr)
    step = make_rl_update_step(tm, opt, 'ppo', only_learn_policy_value_heads=heads_only)
    state, tout = step(create_rl_state(tm, opt), to_torch_experience(jexp))
    assert state.step == 1
    assert_outputs_close(jout, tout)
    want = flax_params_to_torch(jax.tree.map(np.asarray, jstate.params), tm)
    assert_updates_close(want, tm, small_grads(jgrads, tm), group_lrs(tm, trunk_lr))
    for name, p in tm.named_parameters():
        if heads_only and not name.startswith(HEADS):
            assert torch.equal(p, before[name]), name
    moved = [n for n, p in tm.named_parameters() if not torch.equal(p, before[n])]
    assert any(n.startswith('transformer.') for n in moved) == (not heads_only)


def jax_draws(key, num_action_types: int):
    """The draws of the JAX `generate` for `key` in the port's `draw`
    signature, unprompted (as tests/test_torch_generate.py records them):
    per frame fold_in(key, i) split five ways (noise, proprio noise, terminal,
    action, forward) after the split that draws the prompt's context."""
    key, _ = jax.random.split(key)

    def draw(kind, frame, shape, *, generator, device, part=0):
        k_noise, _, k_term, k_act, _ = jax.random.split(jax.random.fold_in(key, frame), 5)
        if kind == 'noise':
            x = jax.random.normal(k_noise, shape)
        elif kind == 'terminal':
            x = jax.random.uniform(k_term, shape)
        elif kind == 'action':
            k_discrete, _ = jax.random.split(k_act)
            x = jax.random.gumbel(jax.random.split(k_discrete, num_action_types)[part], shape)
        else:
            raise AssertionError(f'unexpected draw {kind}')
        return torch.from_numpy(np.array(x)).to(device)

    return draw


def test_dream_trainer_two_steps_match_jax(monkeypatch):
    """Two `DreamTrainer` steps in both packages, the JAX draws of
    fold_in(key, i) replayed into step i's dream: the losses and the heads
    match after each step (`assert_updates_close`, with the JAX gradients
    of each step) and nothing else moves."""
    jm, params, tm = build_pair()
    kw = dict(time_steps=4, num_steps=2, batch_size=2)
    jtrainer = jtrainers.DreamTrainer(jm, {'params': params}, **kw)
    trainer = DreamTrainer(tm, **kw, device='cpu')

    @jax.jit
    def jax_grads(params, jexp):
        def loss_fn(p):
            out = j_rl_losses(jm, {'params': p}, jexp, return_stats=JReturnStats.create())
            return out.policy_loss + out.value_loss
        return jax.grad(loss_fn)(params)

    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    heads = {n for n in before if n.startswith(HEADS)}
    small = {n: np.zeros(p.shape, bool) for n, p in before.items()}
    key = jax.random.PRNGKey(4)
    for i in range(2):
        jparams = jtrainer.rl_state.params
        jexp, jout = jtrainer.step(jax.random.fold_in(key, i))
        small = {n: small[n] | m for n, m in small_grads(jax_grads(jparams, jexp), tm).items()}
        monkeypatch.setattr(generate_module, 'draw', jax_draws(jax.random.fold_in(key, i), 1))
        _, tout = trainer.step()
        assert_outputs_close(jout, tout)
        want = flax_params_to_torch(jax.tree.map(np.asarray, jtrainer.rl_state.params), tm)
        assert_updates_close(want, tm, small, group_lrs(tm, None, 1e-4, 1e-4), steps=i + 1,
                             names=heads)
        for name, p in tm.named_parameters():
            assert torch.equal(p, before[name]) == (name not in heads), name
    assert trainer.rl_state.step == 2


# ---------------------------------------------- the JAX package's RL cases

def make_port_model(**kw):
    torch.manual_seed(0)
    return DynamicsWorldModel(**{**SMALL, **kw}, device='cpu')


def port_dream(model, seed, time_steps=6, **kw):
    gen = torch.Generator().manual_seed(seed)
    return generate(model, gen, time_steps=time_steps, num_steps=2, batch_size=2, **kw)


@pytest.fixture(scope='module')
def model_and_experience():
    model = make_port_model()
    return model, port_dream(model, 0)


def grad_sum(model, prefix):
    return sum(float(p.grad.abs().sum()) for n, p in model.named_parameters()
               if n.startswith(prefix) and p.grad is not None)


def rl_loss(model, exp, **kw):
    out = rl_losses(model, exp, **{'objective': 'ppo', **kw})
    return out.policy_loss + out.value_loss


@pytest.mark.parametrize('objective', OBJECTIVES)
def test_torch_rl_losses(model_and_experience, objective):
    model, exp = model_and_experience
    out = rl_losses(model, exp, objective=objective, return_stats=ReturnStats.create())
    assert torch.isfinite(out.policy_loss) and torch.isfinite(out.value_loss)
    for v in out.stats.values():
        assert torch.isfinite(v)


def test_torch_rl_gradient_flows_to_heads(model_and_experience):
    model, exp = model_and_experience
    model.zero_grad(set_to_none=True)
    rl_loss(model, exp).backward()
    assert grad_sum(model, 'policy_head.') > 0
    assert grad_sum(model, 'value_head.') > 0
    assert grad_sum(model, 'action_embedder.discrete_action_unembed') > 0
    # with only_learn_policy_value_heads the trunk receives no gradient
    assert grad_sum(model, 'transformer.') == 0.0
    model.zero_grad(set_to_none=True)


def test_torch_return_ema_stats():
    model = make_port_model(keep_reward_ema_stats=True)
    exp = port_dream(model, 0, time_steps=4)
    out = rl_losses(model, exp, return_stats=ReturnStats.create())
    assert float(out.return_stats.mean) != 0.0 or float(out.return_stats.var) != 1.0
    with pytest.raises(ValueError, match='return_stats'):
        rl_losses(model, exp)


def test_torch_soft_continuation_discounts_gae(model_and_experience):
    """A terminal probability of 1 at frame 2 cuts every influence of later
    frames on the policy loss (DreamerV3 soft continuation)."""
    model, _ = model_and_experience
    exp = port_dream(model, 2, hard_terminals=False)
    probs = torch.zeros_like(exp.rewards)
    probs[:, 2] = 1.0
    exp.terminal_probs = probs
    out1 = rl_losses(model, exp, return_stats=ReturnStats.create())
    rewards = exp.rewards.clone()
    rewards[:, 4:] += 100.0
    out2 = rl_losses(model, Experience(**{**vars(exp), 'rewards': rewards}),
                     return_stats=ReturnStats.create())
    np.testing.assert_allclose(out1.policy_loss.item(), out2.policy_loss.item(), rtol=1e-5)
    assert torch.isfinite(out1.value_loss)
    assert float(out1.stats['mean_alive']) < 1.0


def test_torch_prompt_frames_not_learned(model_and_experience):
    """Frames before prompt_len carry replayed actions with zeroed values
    and log probs: they do not reach the losses."""
    model, _ = model_and_experience
    exp = port_dream(model, 4, hard_terminals=False)
    exp.prompt_len = 2
    out1 = rl_losses(model, exp, return_stats=ReturnStats.create())

    def with_log_probs(frames):
        lp = exp.log_probs.discrete.clone()
        lp[:, frames] += 3.21
        return Experience(**{**vars(exp), 'log_probs': Actions(lp, None)})

    out2 = rl_losses(model, with_log_probs(slice(0, 2)), return_stats=ReturnStats.create())
    np.testing.assert_allclose(out1.policy_loss.item(), out2.policy_loss.item(), rtol=1e-6)
    out3 = rl_losses(model, with_log_probs(3), return_stats=ReturnStats.create())
    assert abs(out1.policy_loss.item() - out3.policy_loss.item()) > 1e-6


def test_torch_soft_continuation_flag(model_and_experience):
    model, _ = model_and_experience
    exp = port_dream(model, 11, hard_terminals=False)
    assert exp.terminal_probs is not None
    out_soft = rl_losses(model, exp, return_stats=ReturnStats.create())
    out_hard = rl_losses(model, exp, soft_continuation=False, return_stats=ReturnStats.create())
    assert 'mean_alive' in out_soft.stats and 'mean_alive' not in out_hard.stats
    assert out_soft.policy_loss.item() != out_hard.policy_loss.item()


def test_torch_full_model_rl_reforwards_trunk(model_and_experience):
    """only_learn_policy_value_heads=False re-forwards the trunk with
    gradients even when agent embeddings were stored; heads-only keeps the
    trunk frozen."""
    model, exp = model_and_experience
    assert exp.agent_embed is not None
    model.zero_grad(set_to_none=True)
    rl_loss(model, exp, only_learn_policy_value_heads=False).backward()
    assert grad_sum(model, 'transformer.') > 0.0
    model.zero_grad(set_to_none=True)
    rl_loss(model, exp, only_learn_policy_value_heads=True).backward()
    assert grad_sum(model, 'transformer.') == 0.0
    model.zero_grad(set_to_none=True)


def test_torch_image_encoder_rl_path(model_and_experience):
    """An experience without latents: video -> encode_video_fn(video) inside
    the loss; full-model RL trains the encoder, heads-only freezes it."""
    model, exp = model_and_experience
    b, t = exp.rewards.shape
    n, d = model.num_latent_tokens, model.dim_latent
    gen = torch.Generator().manual_seed(9)
    video = torch.rand((b, 3, t, 8, 8), generator=gen)
    encoder = torch.nn.Linear(3 * 8 * 8, n * d, bias=False)
    torch.nn.init.normal_(encoder.weight, std=0.05, generator=gen)

    def encode(vid):
        x = vid.movedim(2, 1).reshape(vid.shape[0], vid.shape[2], -1)
        return torch.tanh(encoder(x)).reshape(vid.shape[0], vid.shape[2], n, d)

    exp_v = Experience(**{**vars(exp), 'latents': None, 'video': video, 'agent_embed': None})
    for heads_only in (False, True):
        encoder.zero_grad(set_to_none=True)
        rl_loss(model, exp_v, only_learn_policy_value_heads=heads_only,
                encode_video_fn=encode).backward()
        g = encoder.weight.grad
        assert (g is None or float(g.abs().sum()) == 0.0) == heads_only
    model.zero_grad(set_to_none=True)
    with pytest.raises(ValueError, match='encode_video_fn'):
        rl_losses(model, exp_v)


def test_torch_make_rl_optimizer_trunk_mode(model_and_experience):
    """trunk_lr adds a 'trunk' group: a full-model update moves the trunk;
    the heads-only optimizer keeps it bit-identical."""
    model, exp = model_and_experience
    state = {n: p.detach().clone() for n, p in model.named_parameters()}

    def run(trunk_lr, heads_only):
        opt = make_rl_optimizer(model, policy_lr=1e-3, value_lr=1e-3, trunk_lr=trunk_lr)
        step = make_rl_update_step(model, opt, 'ppo', only_learn_policy_value_heads=heads_only)
        step(create_rl_state(model, opt), exp)
        moved = max(float((p - state[n]).abs().max()) for n, p in model.named_parameters()
                    if n.startswith('transformer.'))
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(state[n])
        return moved

    assert run(trunk_lr=1e-3, heads_only=False) > 0.0
    assert run(trunk_lr=None, heads_only=True) == 0.0
    assert {g['name'] for g in make_rl_optimizer(model).param_groups} == {'policy', 'value'}


def test_torch_dream_trainer_updates_heads_only():
    """tests/test_trainers.py's DreamTrainer case on the port."""
    torch.manual_seed(0)
    model = DynamicsWorldModel(**{**SMALL, 'max_steps': 8, 'num_discrete_actions': (3,)},
                               device='cpu')
    trainer = DreamTrainer(model, time_steps=4, num_steps=2, batch_size=2, device='cpu')
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    logs = trainer(2)
    assert len(logs) == 2 and all(np.isfinite(v) for log in logs for v in log.values())

    def delta(prefix):
        return sum(float((p - before[n]).abs().sum()) for n, p in model.named_parameters()
                   if n.startswith(prefix))

    assert delta('policy_head.') > 0
    assert delta('value_head.') > 0
    assert delta('transformer.') == 0.0   # trunk frozen in heads-only RL


def test_torch_dream_trainer_prompt_fn():
    """`prompt_fn(generator)` starts each dream from its prompt, which the
    losses do not learn on."""
    model = make_port_model()
    seen = []

    def prompt_fn(gen):
        seen.append(gen)
        return dict(prompt_latents=torch.rand((2, 2, 4, 8), generator=gen) * 2 - 1,
                    prompt_discrete_actions=torch.randint(0, 4, (2, 2, 1), generator=gen))

    trainer = DreamTrainer(model, time_steps=5, num_steps=2, batch_size=2, prompt_fn=prompt_fn,
                           update_epochs=2, generate_kwargs=dict(hard_terminals=False),
                           device='cpu')
    exp, out = trainer.step()
    assert seen == [trainer.generator] and exp.prompt_len == 2
    assert trainer.rl_state.step == 2 and torch.isfinite(out.policy_loss)


# ---------------------------------------------------------------- refusals

def test_rl_losses_refuses_unported_inputs(model_and_experience):
    """What stays refused: an unknown objective (the world model's options
    that were refused here, the trunk's subsystems, now build), full-model
    RL of latent-input heads without
    `latent_input_full_model_ok` (it cannot train the trunk), and a
    full-model replay of proprio by a model without `dim_proprio` (its
    forward has no proprio token to take it)."""
    model, exp = model_and_experience
    with pytest.raises(ValueError, match='objective'):
        rl_losses(model, exp, objective='a2c')
    for name, value in (('mot_temporal', True), ('h_net_layer', 1),
                        ('use_time_rnn', True)):
        assert DynamicsWorldModel(**SMALL, **{name: value}, device='cpu').config[name] == value
    latent = DynamicsWorldModel(**SMALL, actor_critic_latent_input=True, device='cpu')
    with pytest.raises(ValueError, match='latent_input_full_model_ok'):
        rl_losses(latent, exp, only_learn_policy_value_heads=False)
    model_p = DynamicsWorldModel(**SMALL, dim_proprio=3, device='cpu')
    with pytest.raises(ValueError, match='proprio'):
        rl_losses(model_p, exp, only_learn_policy_value_heads=False)


def test_dream_trainer_device(monkeypatch):
    model = make_port_model()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        DreamTrainer(model)
    with pytest.raises(RuntimeError, match='CUDA'):
        DreamTrainer(model, device='cuda')
    assert DreamTrainer(model, device='cpu').generator.device.type == 'cpu'
