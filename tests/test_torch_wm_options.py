"""The world model's remaining options in the port against the JAX package,
at float32 on the CPU: `SEM`, the flax-layout GRU cell, `LAPO`, `TEM`,
`LatentAutoregressiveLoss`, and the world model with tasks and latent genes,
actor and critic trunks, the spatial and action pre-encoders, aug
conditioning, the latent AR loss, LAPO and TEM, each alone and all together:
its losses and every gradient, the cached forward through every trunk's
cache, `generate` with tasks and latent genes, two `BehaviorCloneTrainer`
steps with a `tasks` batch entry and self-flow, full-model `rl_losses`, the
weight converter, and two faults of the JAX package that the port keeps.

The model is small (dim 32, depth 2 with its time layer second, 2 heads x
16, 4 latents of 8, 4 spatial tokens, 4 discrete actions). Both packages
get the JAX model's weights, converted. The JAX training forward's draws
(`randint` signal levels and step sizes, `normal` noise and sigreg slices,
`bernoulli` reward keep and aug dropout) are recorded while a jitted JAX
function is traced, by wrapping `jax.random` (the names at trace time, the
values returned by the function), and replayed in order into the port's
`models.world_model.draw` and `ops.losses.draw`. The rollouts' draws come
from the JAX key chain (tests/test_torch_generate.py's `jax_draws`).

Tolerances, all float32:
  - SEM, the GRU cell, LAPO, TEM, the latent AR loss: values and every
    gradient 1e-5 absolute and 1e-4 relative (a few small layers);
  - the world model's losses and embeddings 2e-5 absolute and 1e-4
    relative, its gradients 2e-5 absolute and 1e-3 relative
    (tests/test_torch_train.py's). The action pre-encoder reads the zero
    action token that the shift puts at frame 0, and its normed keys
    (`l2norm`, eps 1e-12) turn that zero into gradients of about 1e8 in
    both packages; a float32 sum of such terms keeps about 7 digits of the
    tensor's scale, so a gradient's absolute tolerance is also 1e-5 of
    the largest entry of its tensor (which is below 2e-5 wherever the
    gradients are of order 1);
  - the cached forward 2e-5 absolute and 1e-4 relative; `generate`'s
    latents 2e-4, agent embeddings 1e-4, values 2e-3, actions, terminals
    and lengths exact (tests/test_torch_generate.py's);
  - trainer steps: losses as above, parameters and EMA 1e-5 except where
    the first Adam-atan2 step sees a gradient within rounding of zero
    (tests/test_torch_train.py); save and resume: exact;
  - RL losses 1e-5 absolute and 1e-4 relative, gradients 2e-5 absolute and
    1e-3 relative (tests/test_torch_rl.py's).
"""
import contextlib
import dataclasses
import functools
from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamer4_tpu.train.optim as joptim
from test_torch_env import assert_experience_matches, env_factory, run_pair
from test_torch_generate import jax_draws
from test_torch_rl import assert_outputs_close, jax_losses_and_grads, to_torch_experience
from dreamer4_tpu.envs.mocks import MockStateEnv as JMockStateEnv
from dreamer4_tpu.models.generate import generate as jgenerate
from dreamer4_tpu.models.rl import ReturnStats as JReturnStats
from dreamer4_tpu.models.rl import rl_losses as j_rl_losses
from dreamer4_tpu.models.world_model import DynamicsWorldModel as JWorldModel
from dreamer4_tpu.nn.latent_ar import LatentAutoregressiveLoss as JLatentAR
from dreamer4_tpu.nn.sem import SEM as JSEM
from dreamer4_tpu.nn.ssl import LAPO as JLAPO
from dreamer4_tpu.nn.ssl import TEM as JTEM
from dreamer4_tpu.train.trainers import BehaviorCloneTrainer as JBehaviorCloneTrainer
import dreamer4_torch.train.optim as toptim
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.envs.mocks import MockStateEnv
from dreamer4_torch.envs.world_model_env import DynamicsWorldModelWrapper
from dreamer4_torch.models import generate as generate_module
from dreamer4_torch.models import world_model as world_model_module
from dreamer4_torch.models.generate import generate
from dreamer4_torch.models.rl import ReturnStats, rl_losses
from dreamer4_torch.models.self_flow import SelfFlowHead
from dreamer4_torch.models.world_model import DynamicsCache, DynamicsWorldModel, WorldModelLosses
from dreamer4_torch.nn.gru import GRUCell
from dreamer4_torch.nn.latent_ar import LatentAutoregressiveLoss
from dreamer4_torch.nn.sem import SEM
from dreamer4_torch.nn.ssl import LAPO, TEM
from dreamer4_torch.ops import losses as losses_module
from dreamer4_torch.train.checkpoint import load_model
from dreamer4_torch.train.trainers import BehaviorCloneTrainer

torch.set_num_threads(1)
T = torch.from_numpy
SMALL = dict(dim=32, dim_latent=8, num_latent_tokens=4, num_spatial_tokens=4, max_steps=16,
             depth=2, time_block_every=2, attn_heads=2, attn_dim_head=16,
             num_discrete_actions=(4,), multi_token_pred_len=2, num_register_tokens=2,
             predict_terminals=True)
# every option above at once
ALL = dict(num_tasks=3, num_latent_genes=2, actor_depth=2, critic_depth=2,
           spatial_pre_encoder_depth=1, action_pre_encoder_depth=1, has_aug_conditioning=True,
           aug_cfg_dropout_prob=0.5, latent_ar=True, latent_ar_layer=(2, 4),
           latent_ar_action_conditioned=True, latent_ar_loss_weight=0.1, ssl_lapo=True,
           ssl_tem=True, tem_learn_relative_actions=True, lapo_fdm_loss_weight=0.5,
           tem_loss_weight=0.7)
CONDITIONS = dict(tasks=np.array([0, 2], np.int32), latent_gene_ids=np.array([1, 0], np.int32))


def close(a, b, atol, rtol, err_msg=''):
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
    np.testing.assert_allclose(np.asarray(a), b, atol=atol, rtol=rtol, err_msg=err_msg)


def grad_of(p):
    return p.grad if p.grad is not None else torch.zeros_like(p)


def close_grad(want, got, err_msg=''):
    want = np.asarray(want)
    atol = max(2e-5, 1e-5 * float(np.abs(want).max(initial=0.0)))
    close(want, got, atol, 1e-3, err_msg=err_msg)


def to_torch(d):
    return {k: T(np.asarray(v)) if isinstance(v, np.ndarray) else v for k, v in d.items()}


# ----------------------------------------------------------- draw replay

_JAX_DRAWS = ('randint', 'normal', 'bernoulli')
_PORT_DRAW_OF = {'step_sizes_log2': 'randint', 'signal_levels': 'randint', 'noise': 'normal',
                 'reward_keep': 'bernoulli', 'aug_drop': 'bernoulli', 'slices': 'normal'}


class Draws:
    """The draws a jitted JAX function makes through `jax.random`: their
    names, noted while it is traced, and their values, which the function
    returns from inside `recording()` (also from under `value_and_grad`)."""

    def __init__(self):
        self.names = []

    @contextlib.contextmanager
    def recording(self):
        values, real = [], {name: getattr(jax.random, name) for name in _JAX_DRAWS}

        def wrap(name):
            def fn(*args, **kwargs):
                out = real[name](*args, **kwargs)
                self.names.append(name)
                values.append(out)
                return out
            return fn

        with pytest.MonkeyPatch.context() as mp:
            for name in _JAX_DRAWS:
                mp.setattr(jax.random, name, wrap(name))
            yield values

    def records(self, values):
        assert len(values) == len(self.names)
        return [(name, np.asarray(v)) for name, v in zip(self.names, values)]


def replay(monkeypatch, records):
    """Hand `records` out in order to the world model's and the losses'
    draws, checking that the port asks for the same kind and shape."""
    queue = list(records)

    def draw(kind, shape, *, generator, device, low=0, high=0, prob=0.0):
        name, x = queue.pop(0)
        assert name == _PORT_DRAW_OF[kind] and x.shape == tuple(shape), (kind, name, x.shape)
        out = torch.from_numpy(np.array(x))
        return (out.long() if name == 'randint' else out).to(device)

    draw.remaining = queue
    for module in (world_model_module, losses_module):
        monkeypatch.setattr(module, 'draw', draw)
    return draw


# ------------------------------------------------------------ modules

def module_pair(jmod, tmod, *args, rngs=None, **kwargs):
    params = jax.tree.map(np.asarray, jmod.init(
        rngs or jax.random.PRNGKey(0), *args, **kwargs).get('params', {}))
    tmod.load_state_dict(flax_params_to_torch(params, tmod))
    return params


def assert_module_grads(j_grads, tmod):
    want = flax_params_to_torch(j_grads, tmod)
    for name, p in tmod.named_parameters():
        close(want[name], grad_of(p), 1e-5, 1e-4, err_msg=name)


SEM_CASES = {'plain': dict(dim=16), 'projected': dict(dim=16, dim_in=12),
             'layernorm': dict(dim=16, dim_in=12, project_out=False, pre_layernorm=True,
                               dim_simplex=4, temperature=0.5)}


@pytest.mark.parametrize('case', list(SEM_CASES))
def test_sem_matches_jax(case):
    kw = SEM_CASES[case]
    dim_in = kw.get('dim_in', kw['dim'])
    x = np.random.default_rng(0).standard_normal((2, 3, dim_in)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal(
        (kw['dim'] if kw.get('project_out') is False else dim_in,)).astype(np.float32)
    jsem = JSEM(**kw)
    tsem = SEM(**kw, device='cpu')
    params = module_pair(jsem, tsem, x)
    f = lambda p, x: (jsem.apply({'params': p}, x) * w).sum()
    j_out = jsem.apply({'params': params}, x)
    j_grads, j_xgrad = jax.grad(f, argnums=(0, 1))(params, x)
    tx = T(x.copy()).requires_grad_()
    out = tsem(tx)
    (out * T(w)).sum().backward()
    close(j_out, out, 1e-5, 1e-4)
    close(j_xgrad, tx.grad, 1e-5, 1e-4)
    if params:
        assert_module_grads(j_grads, tsem)


def test_gru_cell_matches_flax():
    """The cell over 5 steps against flax's `GRUCell` under `nn.RNN` (the
    TEM's use): the hidden states and every gradient, through the cell's
    six Denses named as flax names them."""
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((3, 5, 6)).astype(np.float32)
    h0 = rng.standard_normal((3, 10)).astype(np.float32)
    w = rng.standard_normal((3, 5, 10)).astype(np.float32)
    rnn = fnn.RNN(fnn.GRUCell(10), return_carry=True)
    params = jax.tree.map(np.asarray, rnn.init(jax.random.PRNGKey(0), xs,
                                               initial_carry=h0)['params'])
    assert set(params['cell']) == {'ir', 'iz', 'in', 'hr', 'hz', 'hn'}
    cell = GRUCell(6, 10, device='cpu')
    cell.load_state_dict(flax_params_to_torch(params['cell'], cell))
    assert cell.hr.bias is None and cell.hn.bias is not None

    def f(p, xs, h0):
        _, out = rnn.apply({'params': p}, xs, initial_carry=h0)
        return (out * w).sum(), out

    (_, j_out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(params, xs, h0)
    txs, th0 = T(xs.copy()).requires_grad_(), T(h0.copy()).requires_grad_()
    out = cell.scan(th0, txs)
    (out * T(w)).sum().backward()
    close(j_out, out, 1e-5, 1e-4)
    close(grads[1], txs.grad, 1e-5, 1e-4)
    close(grads[2], th0.grad, 1e-5, 1e-4)
    assert_module_grads(grads[0]['cell'], cell)
    close(j_out[:, 0], cell(T(h0), T(xs[:, 0])), 1e-5, 1e-4)


LAPO_CASES = {
    'discrete_fdm': dict(num_discrete_actions=(4, 0, 3)),
    'continuous_fdm': dict(num_continuous_actions=2),
    'both_no_fdm': dict(num_discrete_actions=(4,), num_continuous_actions=2, use_fdm=False),
    'no_actions_raw': dict(num_discrete_actions=(4,), pred_actions=False),
}


@pytest.mark.parametrize('case', list(LAPO_CASES))
def test_lapo_matches_jax(case):
    kw = dict(dim_embed=16, dim_latent_action=16, dim_raw_latent=8, num_raw_latent_tokens=4,
              **LAPO_CASES[case])
    rng = np.random.default_rng(3)
    space = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    nd = kw.get('num_discrete_actions', ())
    disc = (np.stack([rng.integers(0, max(n, 1), (2, 5)) for n in nd], -1).astype(np.int32)
            if nd else None)
    cont = rng.standard_normal((2, 5, 2)).astype(np.float32) if 'num_continuous_actions' in kw \
        else None
    raw = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    jl, tl = JLAPO(**kw), LAPO(**kw, device='cpu')
    params = module_pair(jl, tl, space, disc, cont, raw)

    def f(p, space):
        out = jl.apply({'params': p}, space, disc, cont, raw)
        return out[0] + 2.0 * out[1] + 3.0 * out[2], out

    (_, j_out), (j_grads, j_sgrad) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, space)
    tspace = T(space.copy()).requires_grad_()
    out = tl(tspace, None if disc is None else T(disc), None if cont is None else T(cont), T(raw))
    (out[0] + 2.0 * out[1] + 3.0 * out[2]).backward()
    for j, t in zip(j_out, out):
        close(j, t, 1e-5, 1e-4)
    assert (float(out[0]) > 0) == (kw.get('pred_actions', True))
    assert (float(out[1]) > 0) == kw.get('use_fdm', True)
    close(j_sgrad, tspace.grad, 1e-5, 1e-4)
    assert_module_grads(j_grads, tl)


@pytest.mark.parametrize('first_state', [True, False])
@pytest.mark.parametrize('relative', [False, True])
def test_tem_matches_jax(first_state, relative):
    """The loss, the predicted latents and every gradient, the action
    tokens' included, with next action tokens of shape (b, t, 1, d)."""
    kw = dict(dim_action_embed=16, dim_raw_latent=8, num_raw_latent_tokens=4, heads=4,
              dim_head=8, first_state_as_init_hidden=first_state,
              learn_relative_actions=relative)
    rng = np.random.default_rng(4)
    actions = rng.standard_normal((2, 5, 1, 16)).astype(np.float32)
    raw = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    jt, tt = JTEM(**kw), TEM(**kw, device='cpu')
    params = module_pair(jt, tt, actions, raw)
    # the talking heads start at the identity: move them to see their mix
    params['talking_heads'] = (params['talking_heads']
                               + 0.1 * rng.standard_normal((4, 4)).astype(np.float32))
    tt.load_state_dict(flax_params_to_torch(params, tt))
    w = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)

    def f(p, actions):
        loss, preds = jt.apply({'params': p}, actions, raw, return_preds=True)
        return loss + (preds * w).sum(), (loss, preds)

    (_, (j_loss, j_preds)), (j_grads, j_agrad) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, actions)
    tactions = T(actions.copy()).requires_grad_()
    loss, preds = tt(tactions, T(raw), return_preds=True)
    (loss + (preds * T(w)).sum()).backward()
    close(j_loss, loss, 1e-5, 1e-4)
    close(j_preds, preds, 1e-5, 1e-4)
    close(j_agrad, tactions.grad, 1e-5, 1e-4)
    assert_module_grads(j_grads, tt)


LATENT_AR_CASES = {
    'same_layer': (dict(dim=16), dict()),
    'cross_layer_masked': (dict(dim=16), dict(target=True, mask=True)),
    'cosine_residual': (dict(dim=16, loss_type='cosine', predict_residual=True,
                             use_rmsnorm=True), dict(mask=True)),
    'cond': (dict(dim=16, dim_in=32), dict(cond=True, target=True)),
    'subspaces': (dict(dim=16, sigreg_num_subspaces=2, sigreg_num_slices=8),
                  dict(mask=True)),
    'cross_layer_subspaces': (dict(dim=16, sigreg_num_subspaces=4, sigreg_num_slices=8,
                                   detach_target=False), dict(target=True, mask=True)),
}


@pytest.mark.parametrize('case', list(LATENT_AR_CASES))
def test_latent_ar_loss_matches_jax(case, monkeypatch):
    """Loss, sigreg and the prediction, and every gradient (the inputs', the
    targets' and the condition's too), the sigreg slices replayed."""
    kw, inputs = LATENT_AR_CASES[case]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    target = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) if inputs.get('target') \
        else None
    cond = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) if inputs.get('cond') else None
    mask = (np.arange(5)[None] < np.array([[5], [3]])) if inputs.get('mask') else None
    jmod = JLatentAR(**kw)
    tmod = LatentAutoregressiveLoss(**kw, conditioned=cond is not None, device='cpu')
    rngs = {'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)}
    params = module_pair(jmod, tmod, x, target, mask, cond, rngs=rngs)
    draws = Draws()

    def f(p, x, target, cond):
        with draws.recording() as values:
            loss, sig, pred = jmod.apply({'params': p}, x, target, mask, cond,
                                         rngs={'sample': jax.random.PRNGKey(2)})
        return loss + sig + 0.1 * pred.sum(), (loss, sig, pred, values)

    (_, (j_loss, j_sig, j_pred, values)), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2, 3), has_aux=True))(params, x, target, cond)
    draw = replay(monkeypatch, draws.records(values))
    leaf = lambda a: None if a is None else T(a.copy()).requires_grad_()
    tx, ttarget, tcond = leaf(x), leaf(target), leaf(cond)
    loss, sig, pred = tmod(tx, ttarget, mask=None if mask is None else T(mask), cond=tcond)
    (loss + sig + 0.1 * pred.sum()).backward()
    assert draw.remaining == [] and float(sig) > 0
    close(j_loss, loss, 1e-5, 1e-4)
    close(j_sig, sig, 1e-5, 1e-4)
    close(j_pred, pred, 1e-5, 1e-4)
    for j, t in zip(grads[1:], (tx, ttarget, tcond)):
        if t is not None:
            close(j, t.grad, 1e-5, 1e-4)
    assert_module_grads(grads[0], tmod)


# -------------------------------------------------------- world model

@functools.cache
def _jax_params(items):
    jm = JWorldModel(**dict(items))
    init = jax.jit(lambda rngs: jm.init(
        rngs, latents=jnp.zeros((2, 3, 4, 8)), shortcut_train=False,
        rewards=jnp.zeros((2, 3)), terminals=jnp.zeros((2,), bool),
        discrete_actions=jnp.zeros((2, 2, 1), jnp.int32))['params'])
    params = init({'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)})
    return jax.tree.map(np.asarray, params)


def build_pair(**kw):
    """The JAX world model and the port's with its weights: the converter
    maps every leaf of the JAX tree, or raises."""
    cfg = {**SMALL, **kw}
    params = _jax_params(tuple(sorted(cfg.items())))
    tm = DynamicsWorldModel(**cfg, device='cpu')
    tm.load_state_dict(flax_params_to_torch(params, tm))
    return JWorldModel(**cfg), params, tm


def make_batch(seed, b=2, t=5, lens=None, tasks=False):
    rng = np.random.default_rng(seed)
    batch = dict(latents=(rng.standard_normal((b, t, 4, 8)) * 0.5).astype(np.float32),
                 rewards=rng.standard_normal((b, t)).astype(np.float32),
                 discrete_actions=rng.integers(0, 4, (b, t, 1)).astype(np.int32),
                 terminals=rng.random((b, t)) < 0.4)
    if lens is not None:
        batch['lens'] = np.asarray(lens, np.int32)
    if tasks:
        batch['tasks'] = rng.integers(0, 3, (b,)).astype(np.int32)
    return batch


# each option alone, and all together: (config, forward inputs, shortcut)
WM_CASES = {
    'tasks_and_genes': (dict(num_tasks=3, num_latent_genes=2), CONDITIONS, False),
    'actor_critic_trunks': (dict(actor_depth=2, critic_depth=2), {}, False),
    'pre_encoders': (dict(spatial_pre_encoder_depth=1, action_pre_encoder_depth=1), {}, False),
    'aug_conditioning': (dict(has_aug_conditioning=True, aug_cfg_dropout_prob=0.5),
                         dict(aug_id=np.array([1, 2], np.int32)), True),
    'latent_ar': (dict(latent_ar=True, latent_ar_layer=(2, 4), latent_ar_action_conditioned=True,
                       latent_ar_loss_weight=0.1), dict(lens=np.array([5, 4], np.int32)), False),
    'lapo': (dict(spatial_pre_encoder_depth=1, ssl_lapo=True, lapo_action_loss_weight=0.5),
             {}, False),
    'tem': (dict(action_pre_encoder_depth=1, ssl_tem=True, tem_first_state_as_init_hidden=False),
            {}, False),
    'all_options': (ALL, dict(**CONDITIONS, aug_id=True, lens=np.array([5, 3], np.int32)),
                    True),
}
NEW_LOSSES = {'latent_ar': ('latent_ar', 'latent_ar_sigreg'),
              'lapo': ('lapo_action', 'lapo_fdm', 'lapo_raw_latent_fdm'), 'tem': ('tem',),
              'all_options': ('latent_ar', 'latent_ar_sigreg', 'lapo_action', 'lapo_fdm',
                              'lapo_raw_latent_fdm', 'tem')}


def jax_training_forward(jm, params, batch, key, shortcut, grads=True):
    """-> (total, losses, embeds, gradients, draws) of the JAX training
    forward, in one jitted call."""
    draws = Draws()

    def j_loss(p):
        with draws.recording() as values:
            loss, losses, embeds = jm.apply({'params': p}, **batch, shortcut_train=shortcut,
                                            return_intermediates=True, rngs={'sample': key})
        return loss, (losses, embeds, values)

    fn = jax.value_and_grad(j_loss, has_aux=True) if grads else lambda p: (j_loss(p), None)
    (loss, (losses, embeds, values)), g = jax.jit(fn)(params)
    return loss, losses, embeds, g, draws.records(values)


def port_training_forward(tm, batch, shortcut, records, monkeypatch):
    draw = replay(monkeypatch, records)
    total, losses, embeds = tm(**to_torch(batch), shortcut_train=shortcut,
                               return_intermediates=True)
    total.backward()
    assert draw.remaining == []
    return total, losses, embeds


@pytest.mark.parametrize('case', list(WM_CASES))
def test_world_model_option_losses_and_grads_match_jax(case, monkeypatch):
    """Every `WorldModelLosses` field, the agent, actor and critic
    embeddings and every parameter's gradient; the new loss terms are
    nonzero where their option is on."""
    cfg, inputs, shortcut = WM_CASES[case]
    jm, params, tm = build_pair(**cfg)
    batch = {**make_batch(0), **inputs}
    j_total, j_losses, j_embeds, j_grads, records = jax_training_forward(
        jm, params, batch, jax.random.PRNGKey(7), shortcut)
    t_total, t_losses, t_embeds = port_training_forward(tm, batch, shortcut, records,
                                                        monkeypatch)
    close(j_total, t_total, 2e-5, 1e-4)
    for field in WorldModelLosses._fields:
        close(getattr(j_losses, field), getattr(t_losses, field), 2e-5, 1e-4, err_msg=field)
    for field in ('agent', 'actor', 'critic'):
        close(getattr(j_embeds, field), getattr(t_embeds, field), 2e-5, 1e-4, err_msg=field)
    for field in NEW_LOSSES.get(case, ()):
        assert float(getattr(t_losses, field)) > 0, field
    want = flax_params_to_torch(j_grads, tm)
    for name, p in tm.named_parameters():
        close_grad(want[name], grad_of(p), err_msg=name)
    if shortcut:
        assert float(t_losses.shortcut) > 0


def test_cached_forward_through_every_trunk_matches_jax():
    """A 3-frame prompt pass that builds the caches, then two frames one at
    a time on them, with tasks, latent genes and an aug id: the flow
    predictions and the agent, actor and critic embeddings against JAX at
    every call, every trunk's cache against JAX's after the last, and the
    cached frames against one uncached pass over all five."""
    jm, params, tm = build_pair(**ALL)
    rng = np.random.default_rng(8)
    lat = rng.uniform(-1, 1, (2, 5, 4, 8)).astype(np.float32)
    acts = rng.integers(0, 4, (2, 5, 1)).astype(np.int32)
    common = dict(signal_levels=15, step_sizes=4, latent_is_noised=True, is_training=False,
                  return_intermediates=True, aug_id=2, **CONDITIONS)
    t_common = to_torch(common)

    @partial(jax.jit, static_argnames=('first',))
    def jax_call(lat, acts, cache, first):
        kw = dict(max_time=5) if first else dict(cache=cache)
        return jm.apply({'params': params}, latents=lat, discrete_actions=acts, **common, **kw,
                        rngs={'sample': jax.random.PRNGKey(0)})

    j_pred, (j_emb, j_cache) = jax_call(lat[:, :3], acts[:, :3], None, first=True)
    with torch.no_grad():
        t_pred, (t_emb, t_cache) = tm(latents=T(lat[:, :3]), discrete_actions=T(acts[:, :3]),
                                      max_time=5, **t_common)
        assert isinstance(t_cache, DynamicsCache)
        assert all(getattr(t_cache, f) is not None for f in DynamicsCache._fields)
        outs = [(j_pred, j_emb, t_pred, t_emb)]
        for i in (3, 4):
            # a frame on the cache takes the action before it, unshifted
            j_pred, (j_emb, j_cache) = jax_call(lat[:, i:i + 1], acts[:, i - 1:i], j_cache,
                                                first=False)
            t_pred, (t_emb, t_cache) = tm(latents=T(lat[:, i:i + 1]),
                                          discrete_actions=T(acts[:, i - 1:i]), cache=t_cache,
                                          **t_common)
            outs.append((j_pred, j_emb, t_pred, t_emb))
        full_pred, (full_emb, _) = tm(latents=T(lat), discrete_actions=T(acts), **t_common)
    for j_pred, j_emb, t_pred, t_emb in outs:
        close(j_pred.flow, t_pred.flow, 2e-5, 1e-4)
        for field in ('agent', 'actor', 'critic'):
            close(getattr(j_emb, field), getattr(t_emb, field), 2e-5, 1e-4, err_msg=field)
    for field in DynamicsCache._fields:
        jc, tc = getattr(j_cache, field), getattr(t_cache, field)
        assert tc.token_count == 5, field
        for layer_j, layer_t in zip(jc.kv, tc.kv):
            close(layer_j.k, layer_t.k, 2e-5, 1e-4, err_msg=field)
            close(layer_j.v, layer_t.v, 2e-5, 1e-4, err_msg=field)
    close(full_pred.flow[:, 3:], torch.cat([outs[1][2].flow, outs[2][2].flow], 1), 2e-5, 1e-4)
    close(full_emb.critic[:, 3:], torch.cat([outs[1][3].critic, outs[2][3].critic], 1),
          2e-5, 1e-4)


def test_generate_with_tasks_and_latent_genes_matches_jax(monkeypatch):
    """A prompted b2 dream of the all-options model, conditioned on each
    row's task and latent gene, the JAX key chain's draws replayed."""
    jm, params, tm = build_pair(**ALL)
    rng = np.random.default_rng(9)
    prompt = dict(prompt_latents=rng.uniform(-1, 1, (2, 2, 4, 8)).astype(np.float32),
                  prompt_discrete_actions=rng.integers(0, 4, (2, 2, 1)).astype(np.int32))
    key = jax.random.PRNGKey(3)
    kw = dict(time_steps=5, num_steps=2, batch_size=2, min_dream_length=2)
    jexp = jax.jit(lambda p, pr, c: jgenerate(jm, {'params': p}, key, **kw, **pr, **c))(
        params, prompt, CONDITIONS)
    monkeypatch.setattr(generate_module, 'draw', jax_draws(key, 1))
    texp = generate(tm, torch.Generator(), **kw, **to_torch(prompt), **to_torch(CONDITIONS))
    np.testing.assert_array_equal(np.asarray(jexp.lens), texp.lens.numpy())
    np.testing.assert_array_equal(np.asarray(jexp.actions.discrete),
                                  texp.actions.discrete.numpy())
    close(jexp.latents, texp.latents, 2e-4, 0)
    close(jexp.agent_embed, texp.agent_embed, 1e-4, 0)
    close(jexp.values, texp.values, 2e-3, 0)
    close(jexp.log_probs.discrete, texp.log_probs.discrete, 2e-4, 0)
    # the conditioning reaches the dream
    texp2 = generate(tm, torch.Generator(), **kw, **to_torch(prompt))
    assert not torch.allclose(texp.agent_embed, texp2.agent_embed, atol=1e-3)


def test_interactor_and_wrapper_run_every_trunk(monkeypatch):
    """`EnvInteractor` on a state-vector env with the all-options model
    (every trunk over its cache from `init_cache`) against the JAX
    interactor, the JAX action draws replayed; then the port's
    `DynamicsWorldModelWrapper` dreams 3 frames through the same caches."""
    jm, params, tm = build_pair(**ALL, dim_state=4, dim_critic_state=4)
    make_env = env_factory(JMockStateEnv, MockStateEnv, dim_state=4, num_actions=4,
                           max_steps=5, batch=2, seed=3)
    jexp, exp = run_pair(jm, params, tm, make_env, jax.random.PRNGKey(7), monkeypatch,
                         max_timesteps=5, num_steps=2)
    assert_experience_matches(jexp, exp)
    env = DynamicsWorldModelWrapper(tm, batch_size=2, num_steps=2, max_timesteps=4,
                                    device='cpu')
    obs, _ = env.reset(seed=0)
    assert all(getattr(env.cache, f) is not None for f in DynamicsCache._fields)
    for a in range(3):
        obs, reward, terminated, truncated, _ = env.step(np.array([a, 3 - a]))
    assert obs.shape == (2, 4, 8) and np.isfinite(np.asarray(obs)).all()
    assert env.cache.main.token_count == env.cache.actor.token_count == 4


# ------------------------------------------------------------ trainer

SELF_FLOW = dict(num_tasks=3, latent_ar=True, latent_ar_layer=(2, 4),
                 latent_ar_action_conditioned=True, latent_ar_loss_weight=0.1)


def f32_newton_schulz(monkeypatch):
    monkeypatch.setattr(joptim, '_batched_orthogonalize',
                        partial(joptim._batched_orthogonalize, ns_dtype=jnp.float32))
    monkeypatch.setattr(toptim, 'batched_orthogonalize',
                        partial(toptim.batched_orthogonalize, ns_dtype=torch.float32))


def jax_self_flow_draws(jm, params, batch, key, shortcut):
    """The draws of one JAX train step with self-flow: the training
    forward's on `key`, then the student's on `fold_in(key, 17)`; the EMA
    teacher's are the student's again."""
    draws = [Draws(), Draws()]

    def run(p):
        out = []
        for d, k in zip(draws, (key, jax.random.fold_in(key, 17))):
            with d.recording() as values:
                jm.apply({'params': p}, **batch, shortcut_train=shortcut,
                         return_intermediates=True, rngs={'sample': k})
            out.append(values)
        return out

    main, student = (d.records(v) for d, v in zip(draws, jax.jit(run)(params)))
    return main + student + student


def test_behavior_clone_trainer_with_tasks_and_self_flow_match_jax(monkeypatch, tmp_path):
    """Two steps (seed 1: a shortcut step, then a plain one) on batches
    with `tasks`, with `use_self_flow` (student layer -3, teacher -1,
    weight 0.5): losses, the model's and the head's parameters and their
    EMA against the JAX trainer's. The head's initial weights are the JAX
    trainer's, converted from their own tree. Then a checkpoint of the
    port's trainer resumes into a fresh trainer exactly, and both take one
    more step alike."""
    f32_newton_schulz(monkeypatch)
    jm, params, tm = build_pair(**SELF_FLOW)
    batches = [make_batch(10 + i, lens=[5, 4], tasks=True) for i in range(2)]
    kw = dict(learning_rate=3e-4, clip_grad_norm=1.0, ema_decay=0.9, seed=1,
              use_self_flow=True, self_flow_weight=0.5)
    jtrainer = JBehaviorCloneTrainer(jm, {'params': params}, **kw, with_ema=False)
    calls, j_step = [], jtrainer._train_step

    def spy(ts, batch, key, shortcut_train):
        calls.append((key, shortcut_train))
        return j_step(ts, batch, key, shortcut_train=shortcut_train)

    jtrainer._train_step = spy
    head_params = jax.tree.map(np.asarray, jtrainer.ts.params['self_flow_head'])
    j_out = [jtrainer.train_on_batch(b) for b in batches]
    assert [s for _, s in calls] == [True, False]
    records = []
    for (key, shortcut), batch in zip(calls, batches):
        records += jax_self_flow_draws(jm, params, batch, key, shortcut)

    draw = replay(monkeypatch, records)
    trainer = BehaviorCloneTrainer(tm, **kw, with_ema=False, device='cpu')
    head = trainer.self_flow_head
    assert isinstance(head, SelfFlowHead) and trainer.ts.ema_params is not None
    head.load_state_dict(flax_params_to_torch(head_params, head))
    with torch.no_grad():   # the EMA starts from the loaded weights
        for name, p in trainer.ts.named_parameters().items():
            trainer.ts.ema_params[name].copy_(p)
    t_out = [trainer.train_on_batch(to_torch(batches[0]))]
    # a first-step gradient within rounding of zero may flip Adam's sign
    # (the port's gradients, which the loss tests hold against JAX's)
    small = {n: np.abs(grad_of(p).numpy()) < 1e-7 for n, p in trainer.ts.named_parameters().items()}
    t_out.append(trainer.train_on_batch(to_torch(batches[1])))
    assert draw.remaining == [] and trainer.ts.step == int(jtrainer.ts.step) == 2
    for (jl, jls), (tl, tls) in zip(j_out, t_out):
        close(jl, tl, 2e-5, 1e-4)
        for field in WorldModelLosses._fields:
            close(getattr(jls, field), getattr(tls, field), 2e-5, 1e-4, err_msg=field)

    def port_names(tree):
        out = {n: t.numpy() for n, t in flax_params_to_torch(
            {k: v for k, v in tree.items() if k != 'self_flow_head'}, tm).items()}
        out.update({f'self_flow_head.{n}': t.numpy() for n, t in flax_params_to_torch(
            tree['self_flow_head'], head).items()})
        return out

    got_params = trainer.ts.named_parameters()
    for tree, got in ((jtrainer.ts.params, got_params), (jtrainer.ts.ema_params,
                                                         trainer.ts.ema_params)):
        want = port_names(tree)
        assert set(want) == set(got)
        for name, w in want.items():
            diff = np.abs(w - got[name].detach().numpy())
            assert not (diff[~small[name]] > 1e-5).any(), name
            assert (diff <= 7e-4).all(), name
    # the head moved
    initial = flax_params_to_torch(head_params, head)
    assert all(not torch.equal(p, initial[n]) for n, p in head.named_parameters())

    # save, resume into a fresh trainer, one more step each (the port's own
    # draws from here)
    monkeypatch.undo()
    target = trainer.save_checkpoint(tmp_path)
    torch.manual_seed(5)
    trainer2 = BehaviorCloneTrainer(DynamicsWorldModel(**SMALL, **SELF_FLOW, device='cpu'),
                                    **kw, with_ema=False, device='cpu')
    trainer2.restore(tmp_path)
    assert trainer2.ts.step == 2 and (target / 'ema').is_dir()
    for a, b in ((trainer.ts.named_parameters(), trainer2.ts.named_parameters()),
                 (trainer.ts.ema_params, trainer2.ts.ema_params)):
        assert set(a) == set(b)
        for name in a:
            assert torch.equal(a[name], b[name]), name
    batch = to_torch(make_batch(30, tasks=True))
    for tr in (trainer, trainer2):
        tr.train_on_batch(batch)
    for name, p in trainer.ts.named_parameters().items():
        assert torch.equal(p, trainer2.ts.named_parameters()[name]), name


def test_self_flow_train_state_names_and_refusals(tmp_path):
    """The trained parameters are the model's under their own names and the
    head's under `self_flow_head.`, alike in the optimizer and the EMA; the
    model's EMA (and its `ema` checkpoint) leaves the head out. The
    self-flow step refuses a missing generator (the teacher could not
    replay the student's draws) and missing EMA weights, and a checkpoint
    with the head does not resume into a trainer without one."""
    torch.manual_seed(0)
    model = DynamicsWorldModel(**SMALL, **SELF_FLOW, device='cpu')
    trainer = BehaviorCloneTrainer(model, use_self_flow=True, device='cpu')
    ts = trainer.ts
    own = {n for n, _ in model.named_parameters()}
    head = {f'self_flow_head.{n}' for n, _ in trainer.self_flow_head.named_parameters()}
    assert set(ts.named_parameters()) == set(ts.ema_params) == own | head
    assert set(trainer.optimizer.labels()) == own | head
    assert set(ts.model_ema()) == own
    batch = to_torch(make_batch(40, tasks=True))
    with pytest.raises(ValueError, match='generator'):
        trainer._train_step(ts, batch, shortcut_train=False)
    with pytest.raises(ValueError, match='EMA'):
        trainer._train_step(ts._replace(ema_params=None), batch, shortcut_train=False,
                            generator=trainer.generator)
    assert ts.step == 0
    target = trainer.save_checkpoint(tmp_path)
    ema_model = load_model(target / 'ema', DynamicsWorldModel, device='cpu')
    for name, p in ema_model.named_parameters():
        assert torch.equal(p, ts.model_ema()[name]), name
    plain = BehaviorCloneTrainer(DynamicsWorldModel(**SMALL, **SELF_FLOW, device='cpu'),
                                 device='cpu')
    with pytest.raises(ValueError, match='self_flow_head'):
        plain.restore(tmp_path)


# -------------------------------------------------------------- RL

@functools.cache
def jax_dream(tasks: bool, **model_kw):
    """A b2 dream of the JAX model, with each row's task when `tasks`."""
    jm, params, _ = build_pair(**model_kw)
    cond = {'tasks': CONDITIONS['tasks']} if tasks else {}
    run = jax.jit(lambda p, c: jgenerate(jm, {'params': p}, jax.random.PRNGKey(0),
                                         time_steps=5, num_steps=2, batch_size=2,
                                         min_dream_length=3, **c))
    return run(params, cond)


def test_full_model_rl_losses_on_every_option_match_jax():
    """Full-model PPO over a dream of the all-options model: the replay runs
    every trunk with gradients; the outputs and every gradient."""
    jm, params, tm = build_pair(**ALL)
    jexp = jax_dream(True, **ALL)
    jout, jgrads = jax_losses_and_grads(jm, params, jexp, ('ppo',), False,
                                        JReturnStats.create())['ppo']
    out = rl_losses(tm, to_torch_experience(jexp), objective='ppo',
                    only_learn_policy_value_heads=False, return_stats=ReturnStats.create())
    (out.policy_loss + out.value_loss).backward()
    assert_outputs_close(jout, out)
    want = flax_params_to_torch(jgrads, tm)
    for name, p in tm.named_parameters():
        close_grad(want[name], grad_of(p), err_msg=name)
    assert any(grad_of(p).any() for p in tm.transformer.parameters())


def test_converter_maps_the_all_options_tree():
    """Every leaf of the all-options JAX tree maps one to one onto the
    port's parameters, and the self-flow head's tree onto `SelfFlowHead`;
    a leaf the port lacks raises."""
    _, params, tm = build_pair(**ALL)
    state = flax_params_to_torch(params, tm)
    assert set(state) == {n for n, _ in tm.named_parameters()}
    for top in ('task_embed', 'latent_genes', 'actor_transformer', 'critic_transformer',
                'spatial_pre_encoder', 'action_pre_encoder', 'aug_cond_embedding',
                'latent_ar_module', 'ssl_lapo_module', 'ssl_tem_module'):
        assert top in params and any(n.startswith(top) for n in state), top
    assert state['ssl_tem_module.GRUCell_0.in.weight'].shape == (32, 32)
    jhead = jax.tree.map(np.asarray, JBehaviorCloneTrainer(
        JWorldModel(**SMALL), {'params': _jax_params(tuple(sorted(SMALL.items())))},
        use_self_flow=True).ts.params['self_flow_head'])
    head = SelfFlowHead(32, device='cpu')
    head.load_state_dict(flax_params_to_torch(jhead, head))
    with pytest.raises(KeyError):
        flax_params_to_torch({**params, 'ssl_tem_module': {
            **params['ssl_tem_module'], 'extra': np.zeros(3, np.float32)}}, tm)


# ------------------------------------------------- the JAX faults, pinned

def test_critic_trunk_gets_no_gradient_and_dreams_read_the_main_trunk(monkeypatch):
    """Two faults of the JAX package that the port keeps, shown in both:
    no loss reads `embeds.critic`, so BC gives `critic_transformer` a zero
    gradient; and `generate` and `rl_losses` read `embeds.agent` (the main
    trunk's output), while BC's action loss reads `embeds.actor` (the actor
    trunk's gradient is nonzero): moving the actor trunk's weights leaves
    the dream and the RL losses as they were."""
    cfg = dict(actor_depth=2, critic_depth=2)
    jm, params, tm = build_pair(**cfg)
    batch = make_batch(0)
    _, _, _, j_grads, records = jax_training_forward(jm, params, batch, jax.random.PRNGKey(7),
                                                     False)
    port_training_forward(tm, batch, False, records, monkeypatch)
    assert not any(np.asarray(g).any() for g in jax.tree.leaves(j_grads['critic_transformer']))
    assert not any(grad_of(p).any() for p in tm.critic_transformer.parameters())
    assert all(np.asarray(g).any() for g in jax.tree.leaves(
        j_grads['actor_transformer']['attn_1']))
    assert all(grad_of(p).any() for p in tm.actor_transformer.attn_1.parameters())

    moved = jax.tree.map(lambda x: x, params)
    moved['actor_transformer'] = jax.tree.map(lambda x: x * 1.5 + 0.01,
                                              params['actor_transformer'])
    tm_moved = DynamicsWorldModel(**SMALL, **cfg, device='cpu')
    tm_moved.load_state_dict(flax_params_to_torch(moved, tm_moved))
    kw = dict(time_steps=4, num_steps=2, batch_size=2, min_dream_length=4)
    key = jax.random.PRNGKey(1)
    run = jax.jit(lambda p: jgenerate(jm, {'params': p}, key, **kw))
    j_exps = [run(params), run(moved)]
    monkeypatch.setattr(generate_module, 'draw', jax_draws(key, 1))
    t_exps = [generate(m, torch.Generator(), **kw) for m in (tm, tm_moved)]
    for a, b in (j_exps, t_exps):
        np.testing.assert_array_equal(np.asarray(a.latents), np.asarray(b.latents))
        np.testing.assert_array_equal(np.asarray(a.log_probs.discrete),
                                      np.asarray(b.log_probs.discrete))
    j_rl = jax.jit(lambda p: j_rl_losses(jm, {'params': p}, j_exps[0],
                                         only_learn_policy_value_heads=False).policy_loss)
    exp = to_torch_experience(j_exps[0])
    with torch.no_grad():
        t_rl = [rl_losses(m, exp, only_learn_policy_value_heads=False).policy_loss
                for m in (tm, tm_moved)]
    for a, b in (([j_rl(params), j_rl(moved)]), t_rl):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize('tasks', [False, True])
def test_full_model_replay_drops_the_task(tasks):
    """The JAX fault the port keeps: the full-model replay of `rl_losses`
    forwards the trunk without the dream's tasks (`Experience` has no field
    for them). Its policy loss equals the heads-only loss over agent
    embeddings of a forward without tasks, and for a task-conditioned dream
    differs from the heads-only loss over those of a forward with the
    dream's tasks, the embeddings `generate` conditions on; without tasks
    all three agree. In both packages."""
    jm, params, tm = build_pair(num_tasks=3)
    jexp = jax_dream(tasks, num_tasks=3)
    cond = {'tasks': CONDITIONS['tasks']} if tasks else {}
    fw = dict(signal_levels=15, step_sizes=jexp.step_size, latent_is_noised=True,
              return_pred_only=True, return_intermediates=True)
    data = {k: np.asarray(v) for k, v in (('latents', jexp.latents), ('rewards', jexp.rewards),
                                          ('discrete_actions', jexp.actions.discrete))}

    def j_losses(p):
        out = [j_rl_losses(jm, {'params': p}, jexp, only_learn_policy_value_heads=False)]
        for c in ({}, cond):
            _, (emb, _) = jm.apply({'params': p}, **data, **fw, **c,
                                   rngs={'sample': jax.random.PRNGKey(0)})
            out.append(j_rl_losses(jm, {'params': p}, dataclasses.replace(
                jexp, agent_embed=emb.agent[:, :, 0])))
        return [o.policy_loss for o in out]

    exp = to_torch_experience(jexp)
    t_out = []
    with torch.no_grad():
        t_out.append(rl_losses(tm, exp, only_learn_policy_value_heads=False))
        for c in ({}, cond):
            _, (emb, _) = tm(**to_torch(data), **fw, **to_torch(c))
            t_out.append(rl_losses(tm, dataclasses.replace(exp, agent_embed=emb.agent[:, :, 0])))
    for full, without, with_tasks in (jax.jit(j_losses)(params), [o.policy_loss for o in t_out]):
        full, without, with_tasks = (float(np.asarray(x)) for x in (full, without, with_tasks))
        assert abs(full - without) < 1e-6
        assert (abs(full - with_tasks) > 1e-4) if tasks else (abs(full - with_tasks) < 1e-6)
    close(jax.jit(j_losses)(params)[0], t_out[0].policy_loss, 1e-5, 1e-4)
