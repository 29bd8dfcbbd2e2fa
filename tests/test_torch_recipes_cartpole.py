"""The port's CartPole recipes (`dreamer4_torch/examples/`) against the JAX
recipes in `examples/`, at float32 on the CPU.

  - flags: each port recipe's parser has the JAX recipe's flags and
    defaults, `--device` in place of `--cpu` (and, in the pixel recipe, of
    `--env-device`: every model runs on `--device`);
  - models: each `build_model` passes exactly the JAX recipe's keywords
    (copied below with their file:line); with the JAX init's weights
    (`flax_params_to_torch`) one training loss agrees at rtol 1e-5, the
    JAX draws replayed;
  - adapters: the same observations, rewards, terminations and frames as
    the JAX recipe's, exactly, for the same seeds and actions;
  - the world-model optimizer of the dream recipes: one update from the
    same gradients against `optax.multi_transform` with `set_to_zero` on
    the heads, at 1e-6 where the JAX gradient is at least 1e-7 (below, 2.01
    lr, `assert_updates_close`), the heads bitwise unmoved, also under a
    weight decay and with EMA weights;
  - every recipe's `main` runs at tiny flags with `--device cpu` and
    gymnasium, and returns its exit code.
"""
import argparse
import runpy
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dreamer4_tpu.train.optim as joptim
from dreamer4_tpu.models.tokenizer import VideoTokenizer as JTokenizer
from dreamer4_tpu.models.world_model import DynamicsWorldModel as JWorldModel
from dreamer4_tpu.train.trainers import rl_param_labels as j_rl_param_labels
import dreamer4_torch.train.optim as toptim
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.examples import common
from dreamer4_torch.examples import train_cartpole_dream_rl as t_dream
from dreamer4_torch.examples import train_cartpole_offline_dream_rl as t_offline
from dreamer4_torch.examples import train_cartpole_pixels_dream_rl as t_pixels
from dreamer4_torch.examples import train_cartpole_with_dynamics_rl as t_online
from dreamer4_torch.models import tokenizer as tokenizer_module
from dreamer4_torch.models import world_model as world_model_module
from dreamer4_torch.models.world_model import DynamicsWorldModel
from dreamer4_torch.train.trainers import TrainState, make_world_model_train_step
from test_torch_rl import assert_updates_close
from test_torch_tokenizer import record_jax_draws as record_tokenizer_draws
from test_torch_tokenizer import replay as replay_tokenizer

EXAMPLES = Path(__file__).resolve().parent.parent / 'examples'
sys.path.insert(0, str(EXAMPLES))

import train_cartpole_pixels_dream_rl as j_pixels  # noqa: E402
import train_cartpole_with_dynamics_rl as j_online  # noqa: E402

torch.set_num_threads(1)
T = torch.from_numpy


# ------------------------------------------------------------------ flags

class _Parsed(Exception):
    pass


def flag_defaults(run, monkeypatch) -> dict:
    """{dest: default} of the parser `run()` builds, caught at its
    `parse_args` before anything else runs."""
    def grab(self, args=None, namespace=None):
        raise _Parsed({a.dest: a.default for a in self._actions if a.dest != 'help'})

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, 'parse_args', grab)
        with pytest.raises(_Parsed) as caught:
            run()
    return caught.value.args[0]


def jax_main(name):
    return lambda: runpy.run_path(str(EXAMPLES / f'{name}.py'), run_name='__main__')


def assert_same_flags(jax_run, port_main, monkeypatch, dropped=('cpu',)):
    """The port parser: the JAX flags and defaults, without `dropped`, plus
    `--device` (default None: the card)."""
    want = {k: v for k, v in flag_defaults(jax_run, monkeypatch).items() if k not in dropped}
    got = flag_defaults(lambda: port_main([]), monkeypatch)
    assert got.pop('device', 'absent') is None
    assert got == want


FLAG_CASES = {
    'train_cartpole_with_dynamics_rl': (t_online.main, ()),
    'train_cartpole_dream_rl': (t_dream.main, ('cpu',)),
    'train_cartpole_offline_dream_rl': (t_offline.main, ('cpu',)),
    'train_cartpole_pixels_dream_rl': (t_pixels.main, ('cpu', 'env_device')),
}


@pytest.mark.parametrize('name', list(FLAG_CASES))
def test_cartpole_recipe_flags_match_jax(name, monkeypatch):
    port_main, dropped = FLAG_CASES[name]
    assert_same_flags(jax_main(name), port_main, monkeypatch, dropped)


# ----------------------------------------------------------------- models

class FakeEnv:
    """CartPole's sizes, without gymnasium."""
    dim_state, num_actions = 4, 2


def recorded_kwargs(monkeypatch, module, cls_name, build) -> tuple[dict, torch.nn.Module]:
    """The keywords `build()` hands the model class, and the model."""
    seen = {}
    real = getattr(module, cls_name)

    def record(**kw):
        seen.update(kw)
        return real(**kw)

    monkeypatch.setattr(module, cls_name, record)
    model = build()
    monkeypatch.setattr(module, cls_name, real)
    assert torch.device(seen.pop('device')) == torch.device('cpu')
    return seen, model


def jax_world_model_variables(kw, seed=0, continuous=False):
    """The JAX recipes' init (e.g. examples/train_cartpole_with_dynamics_rl.py:
    127-131) of the model with keywords `kw`."""
    jm = JWorldModel(**kw)
    n, d = kw['num_latent_tokens'], kw['dim_latent']
    inputs = dict(latents=jnp.zeros((1, 4, n, d)), shortcut_train=False,
                  rewards=jnp.zeros((1, 4)))
    if kw.get('predict_terminals'):
        inputs['terminals'] = jnp.zeros((1,), bool)
    if continuous:
        inputs.update(proprio=jnp.zeros((1, 4, kw['dim_proprio'])),
                      continuous_actions=jnp.full((1, 3, kw['num_continuous_actions']), 0.1))
    else:
        inputs['discrete_actions'] = jnp.zeros((1, 3, 1), jnp.int32)
    init = jax.jit(lambda rngs: jm.init(rngs, **inputs))
    variables = init({'params': jax.random.PRNGKey(seed),
                      'sample': jax.random.PRNGKey(seed + 1)})
    return jm, jax.tree.map(np.asarray, variables)


def wm_batch(kw, seed=3, b=2, t=6):
    """A training batch for the world model with keywords `kw`."""
    rng = np.random.default_rng(seed)
    n, d = kw['num_latent_tokens'], kw['dim_latent']
    batch = dict(latents=np.tanh(rng.standard_normal((b, t, n, d))).astype(np.float32),
                 rewards=rng.standard_normal((b, t)).astype(np.float32),
                 lens=np.array([t, t - 2], np.int32))
    if kw.get('predict_terminals'):
        batch['terminals'] = np.array([True, False])
    if kw.get('num_continuous_actions'):
        batch['continuous_actions'] = rng.uniform(
            -0.9, 0.9, (b, t - 1, kw['num_continuous_actions'])).astype(np.float32)
        batch['proprio'] = rng.standard_normal((b, t, kw['dim_proprio'])).astype(np.float32)
    else:
        n_act = kw['num_discrete_actions'][0]
        batch['discrete_actions'] = rng.integers(0, n_act, (b, t, 1)).astype(np.int32)
    return batch


_WM_DRAWS = ('randint', 'normal', 'bernoulli')
_PORT_WM_DRAW_OF = {'step_sizes_log2': 'randint', 'signal_levels': 'randint',
                    'noise': 'normal', 'proprio_noise': 'normal', 'reward_keep': 'bernoulli'}


def jax_wm_loss_and_draws(jm, variables, batch, key, shortcut):
    """The JAX training loss and its draws, in call order, from one jitted
    `apply` (the wrappers note each draw while it is traced)."""
    names, real = [], {name: getattr(jax.random, name) for name in _WM_DRAWS}

    def run(variables, batch, key):
        values = []

        def recording(name):
            def fn(*args, **kwargs):
                out = real[name](*args, **kwargs)
                names.append(name)
                values.append(out)
                return out
            return fn

        with pytest.MonkeyPatch.context() as mp:
            for name in _WM_DRAWS:
                mp.setattr(jax.random, name, recording(name))
            loss = jm.apply(variables, **batch, shortcut_train=shortcut,
                            return_intermediates=True, rngs={'sample': key})[0]
        return loss, values

    loss, values = jax.jit(run)(variables, batch, key)
    return float(loss), [(name, np.asarray(v)) for name, v in zip(names, values)]


def replay_wm(records):
    queue = list(records)

    def draw(kind, shape, *, generator, device, low=0, high=0, prob=0.0):
        name, x = queue.pop(0)
        assert name == _PORT_WM_DRAW_OF[kind] and x.shape == tuple(shape), (kind, name)
        out = torch.from_numpy(np.array(x))
        return (out.long() if name == 'randint' else out).to(device)

    draw.remaining = queue
    return draw


def to_torch(batch):
    out = {}
    for k, v in batch.items():
        t = T(np.asarray(v))
        out[k] = t.long() if k in ('discrete_actions', 'lens') else t
    return out


def assert_wm_loss_matches_jax(kw, tm, monkeypatch, continuous=False):
    """The port model `tm` with the JAX init's weights: one training loss
    (a shortcut step: its draws and passes include a plain step's) at rtol
    1e-5."""
    jm, variables = jax_world_model_variables(kw, continuous=continuous)
    tm.load_state_dict(flax_params_to_torch(variables['params'], tm,
                                            state=variables.get('state')))
    batch = wm_batch(kw)
    j_loss, records = jax_wm_loss_and_draws(jm, variables, batch, jax.random.PRNGKey(6), True)
    draw = replay_wm(records)
    monkeypatch.setattr(world_model_module, 'draw', draw)
    t_loss = tm(**to_torch(batch), shortcut_train=True, return_intermediates=True)[0]
    assert draw.remaining == []
    np.testing.assert_allclose(t_loss.item(), j_loss, rtol=1e-5)


def assert_tokenizer_loss_matches_jax(kw, tt, monkeypatch, video_shape):
    """The port tokenizer `tt` with the JAX init's weights: one training
    loss at rtol 1e-5."""
    jt = JTokenizer(**kw)
    video = np.random.default_rng(4).random(video_shape).astype(np.float32)
    variables = jax.jit(lambda rngs: jt.init(rngs, jnp.asarray(video[:1])))(
        {'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)})
    variables = jax.tree.map(np.asarray, variables)
    tt.load_state_dict(flax_params_to_torch(variables['params'], tt,
                                            state=variables.get('state')))
    lens = np.array([video_shape[2], video_shape[2] - 1], np.int32)
    key = jax.random.PRNGKey(7)
    j_loss = jax.jit(lambda v, tl: jt.apply(variables, v, time_lens=tl, rngs={'sample': key},
                                            mutable=['state'])[0])(video, lens)
    records = record_tokenizer_draws(
        lambda v, tl: jt.apply(variables, v, time_lens=tl, rngs={'sample': key},
                               mutable=['state']), video, lens)
    draw = replay_tokenizer(records)
    monkeypatch.setattr(tokenizer_module, 'draw', draw)
    t_loss = tt(T(video), time_lens=T(lens).long())
    assert draw.remaining == []
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)


def online_args(**kw):
    return t_online.parse_args(['--device', 'cpu', *kw.get('argv', [])])


# The JAX recipes' keywords at their default flags, CartPole's 2 actions
# and 4-dim state.
# examples/train_cartpole_with_dynamics_rl.py:108-126
ONLINE_KW = dict(dim=64, dim_latent=16, num_latent_tokens=4, num_spatial_tokens=4, max_steps=16,
                 depth=2, time_block_every=2, attn_heads=4, attn_dim_head=16,
                 num_discrete_actions=(2,), multi_token_pred_len=4, num_register_tokens=4,
                 dim_state=4, dim_critic_state=4, predict_terminals=True,
                 use_delight_gating=False, policy_entropy_weight=0.01,
                 keep_reward_ema_stats=True, reward_range=(-180.0, 180.0))
# examples/train_cartpole_dream_rl.py:136-160
DREAM_KW = dict(dim=64, dim_latent=16, num_latent_tokens=4, num_spatial_tokens=4, max_steps=16,
                depth=2, time_block_every=2, attn_heads=4, attn_dim_head=16,
                num_discrete_actions=(2,), multi_token_pred_len=4, num_register_tokens=4,
                dim_state=4, actor_critic_latent_input=False, add_action_embed_to_spatial=True,
                add_state_pred_head=True, agent_predicts_state=True,
                agent_predicts_state_frac_gradient=0.5, predict_terminals=True,
                policy_entropy_weight=0.01, keep_reward_ema_stats=True,
                reward_range=(-180.0, 180.0))
# examples/train_cartpole_offline_dream_rl.py:106-115 (expert: entropy
# 0.01, no injection; offline WM: --entropy-weight 0.001, injection on)
OFFLINE_KW = dict(dim=64, dim_latent=16, num_latent_tokens=4, num_spatial_tokens=4,
                  max_steps=16, depth=2, time_block_every=2, attn_heads=4, attn_dim_head=16,
                  num_discrete_actions=(2,), multi_token_pred_len=4, num_register_tokens=4,
                  dim_state=4, dim_critic_state=4, predict_terminals=True,
                  keep_reward_ema_stats=True, reward_range=(-180.0, 180.0))
# examples/train_cartpole_pixels_dream_rl.py:287-294
PIXEL_STATE_KW = dict(dim=64, dim_latent=16, num_latent_tokens=4, num_spatial_tokens=4,
                      max_steps=16, depth=2, time_block_every=2, attn_heads=4, attn_dim_head=16,
                      num_discrete_actions=(2,), multi_token_pred_len=4, num_register_tokens=4,
                      dim_state=4, dim_critic_state=4, predict_terminals=True,
                      policy_entropy_weight=0.01, keep_reward_ema_stats=True,
                      reward_range=(-180.0, 180.0))
# examples/train_cartpole_pixels_dream_rl.py:300-315
PIXEL_WM_KW = dict(dim=64, dim_latent=16, num_latent_tokens=4, num_spatial_tokens=4,
                   max_steps=16, depth=2, time_block_every=2, attn_heads=4, attn_dim_head=16,
                   num_discrete_actions=(2,), multi_token_pred_len=4, num_register_tokens=4,
                   dim_state=None, dim_critic_state=None, predict_terminals=True,
                   add_action_embed_to_spatial=True, terminal_pos_weight=30.0,
                   policy_entropy_weight=0.01, keep_reward_ema_stats=True,
                   reward_range=(-180.0, 180.0))
# examples/train_cartpole_pixels_dream_rl.py:496-502
PIXEL_TOKENIZER_KW = dict(dim=64, dim_latent=16, patch_size=8, image_height=64, image_width=64,
                          channels=3, num_latent_tokens=4, encoder_depth=3, decoder_depth=3,
                          time_block_every=2, attn_heads=4, attn_dim_head=16,
                          decoder_flow_steps=2, use_causal_conv3d=True,
                          use_shifted_patch_tokenization=True, lpips_loss_weight=0.0)

MODEL_CASES = {
    'online': (t_online, lambda: t_online.build_model(online_args(), FakeEnv, 'cpu'),
               ONLINE_KW),
    'dream': (t_dream, lambda: t_dream.build_model(t_dream.parse_args([]), FakeEnv, 'cpu'),
              DREAM_KW),
    'offline_expert': (t_offline, lambda: t_offline.build_model(
        t_offline.parse_args([]), FakeEnv, 'cpu', 0.01, action_inject=False),
        dict(OFFLINE_KW, add_action_embed_to_spatial=False, policy_entropy_weight=0.01)),
    'offline_wm': (t_offline, lambda: t_offline.build_model(
        t_offline.parse_args([]), FakeEnv, 'cpu', 0.001, action_inject=True),
        dict(OFFLINE_KW, add_action_embed_to_spatial=True, policy_entropy_weight=0.001)),
    'pixel_state': (t_pixels, lambda: t_pixels.build_state_model(
        t_pixels.parse_args([]), 'cpu', 0), PIXEL_STATE_KW),
    'pixel_wm': (t_pixels, lambda: t_pixels.build_pixel_model(
        t_pixels.parse_args([]), 'cpu', 0), PIXEL_WM_KW),
}


@pytest.mark.parametrize('case', list(MODEL_CASES))
def test_cartpole_world_models_match_jax(case, monkeypatch):
    """`build_model` passes the JAX recipe's keywords; from the JAX init's
    weights a training loss agrees at rtol 1e-5."""
    module, build, want = MODEL_CASES[case]
    got, tm = recorded_kwargs(monkeypatch, module, 'DynamicsWorldModel', build)
    assert got == want
    assert_wm_loss_matches_jax(want, tm, monkeypatch)


def test_pixel_recipe_tokenizer_matches_jax(monkeypatch):
    """The pixel recipe's tokenizer: keywords and one training loss."""
    got, tt = recorded_kwargs(monkeypatch, t_pixels, 'VideoTokenizer',
                              lambda: t_pixels.build_tokenizer(t_pixels.parse_args([]), 'cpu'))
    assert got == PIXEL_TOKENIZER_KW
    assert_tokenizer_loss_matches_jax(PIXEL_TOKENIZER_KW, tt, monkeypatch, (2, 3, 3, 64, 64))


def test_models_are_built_from_the_seed():
    """One seed gives the same weights, another seed others; building
    leaves the global generator where it was."""
    state = torch.random.get_rng_state()
    a = t_online.build_model(online_args(), FakeEnv, torch.device('cpu'))
    b = t_online.build_model(online_args(), FakeEnv, torch.device('cpu'))
    c = t_online.build_model(t_online.parse_args(['--seed', '1']), FakeEnv, torch.device('cpu'))
    assert torch.equal(torch.random.get_rng_state(), state)
    for (name, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
    assert not all(torch.equal(x, z) for x, z in zip(a.parameters(), c.parameters()))
    g1, g2 = (common.stream(0, 3, device='cpu') for _ in range(2))
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    assert not torch.equal(torch.rand(4, generator=common.stream(0, 3, device='cpu')),
                           torch.rand(4, generator=common.stream(0, 4, device='cpu')))


# --------------------------------------------------------------- adapters

def drive(env, steps=60, seed=11):
    """Reset, then `steps` random actions; -> every output, in order."""
    rng = np.random.default_rng(seed)
    outs = [env.reset()[0]]
    for i in range(steps):
        if i == 30:
            outs.append(env.reset(seed=100)[0])
        obs, r, term, trunc, _ = env.step(rng.integers(0, 2, env.n_envs))
        outs += [obs, r, term, trunc]
    return outs


def assert_same_outputs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k])
        else:
            np.testing.assert_array_equal(x, y)


ADAPTER_CASES = {
    'state': lambda m: m.GymnasiumVectorAdapter(n_envs=3, max_timesteps=150, seed=5),
    'rendering': lambda m: m.RenderingCartPoleAdapter(n_envs=2, max_timesteps=150, seed=5),
    'pixel': lambda m: m.PixelCartPoleAdapter(n_envs=2, max_timesteps=150, seed=5),
}


@pytest.mark.parametrize('case', list(ADAPTER_CASES))
def test_cartpole_adapters_match_jax(case):
    """The same observations, rewards and flags (and recorded frames) as
    the JAX recipe's adapter, exactly."""
    make = ADAPTER_CASES[case]
    jax_side, port_side = (j_online, t_online) if case == 'state' else (j_pixels, t_pixels)
    steps = 60 if case == 'state' else 12
    a, b = make(jax_side), make(port_side)
    assert_same_outputs(drive(a, steps), drive(b, steps))
    if case != 'pixel':
        assert (a.dim_state, a.num_actions) == (b.dim_state, b.num_actions) == (4, 2)
    if case == 'rendering':
        fa, fb = a.take_frames(), b.take_frames()
        assert fa.shape == (2, steps + 1, 64, 64, 3) and fa.dtype == np.uint8
        np.testing.assert_array_equal(fa, fb)


# ------------------------------------------ the dream recipes' WM optimizer

def jax_grads(jm, variables, batch, key):
    def loss(params):
        return jm.apply({**variables, 'params': params}, **batch, shortcut_train=False,
                        return_intermediates=True, rngs={'sample': key})[0]
    return jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(variables['params']))


@pytest.mark.parametrize('case', ['recipe', 'decay_and_ema'])
def test_dream_world_model_optimizer_matches_multi_transform(case, monkeypatch):
    """`common.WorldModelUpdates`'s optimizer (examples/train_cartpole_dream_rl.py:
    173-183): one update from the JAX gradients against
    `optax.multi_transform({'frozen': muon_adam_atan2(lr, clip 1), 'policy':
    set_to_zero(), 'value': set_to_zero()})`. The heads, whose gradient is
    nonzero, stay bitwise where they were; with 'decay_and_ema' also under a
    weight decay of 0.1 and through a train step that keeps EMA weights."""
    monkeypatch.setattr(joptim, '_batched_orthogonalize',
                        partial(joptim._batched_orthogonalize, ns_dtype=jnp.float32))
    monkeypatch.setattr(toptim, 'batched_orthogonalize',
                        partial(toptim.batched_orthogonalize, ns_dtype=torch.float32))
    decay = 0.1 if case == 'decay_and_ema' else 0.0
    jm, variables = jax_world_model_variables(DREAM_KW)
    tm = DynamicsWorldModel(**DREAM_KW, device='cpu')
    tm.load_state_dict(flax_params_to_torch(variables['params'], tm,
                                            state=variables.get('state')))
    batch = wm_batch(DREAM_KW)
    grads = jax_grads(jm, variables, batch, jax.random.PRNGKey(2))
    lr = 3e-4
    base = joptim.muon_adam_atan2(learning_rate=lr, clip_grad_norm=1.0, weight_decay=decay)
    tx = optax.multi_transform({'frozen': base, 'policy': optax.set_to_zero(),
                                'value': optax.set_to_zero()},
                               lambda p: j_rl_param_labels(p, jm))
    new_params = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        grads, variables['params'])
    want = flax_params_to_torch(jax.tree.map(np.asarray, new_params), tm)

    wm = common.WorldModelUpdates(tm, lr, torch.Generator(), np.random.default_rng(0))
    optimizer = wm.optimizer
    if decay:
        optimizer = toptim.MuonAdamAtan2(tm, learning_rate=lr, clip_grad_norm=1.0,
                                         weight_decay=decay, only=wm.optimizer.labels())
    labels = {n: l for n, l in wm.optimizer.labels().items()}
    heads = [n for n, _ in tm.named_parameters() if n not in labels]
    assert heads and all(n.startswith(('policy_head', 'value_head', 'action_embedder'))
                         for n in heads)
    t_grads = flax_params_to_torch(grads, tm)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    for name, p in tm.named_parameters():
        p.grad = t_grads[name].clone()
    assert any(t_grads[n].abs().max() > 0 for n in heads)
    optimizer.step()
    small = {n: np.abs(g.numpy()) < 1e-7 for n, g in t_grads.items()}
    lrs = {n: (10 * lr if kind == 'muon' else lr) for n, kind in labels.items()}
    assert_updates_close(want, tm, small, lrs, names=set(labels))
    for name in heads:
        assert torch.equal(dict(tm.named_parameters())[name], before[name]), name
        assert torch.equal(want[name], before[name]), name

    if decay:   # a train step with EMA weights: the heads still do not move
        ts = TrainState(model=tm, optimizer=optimizer,
                        ema_params={n: p.detach().clone() for n, p in tm.named_parameters()},
                        step=0)
        step = make_world_model_train_step(tm, optimizer)
        ts, loss, _ = step(ts, to_torch(batch), shortcut_train=False,
                           generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(loss) and ts.step == 1
        for name in heads:
            assert torch.equal(dict(tm.named_parameters())[name], before[name]), name


# ------------------------------------------------------------------- mains

def main_cases(tmp_path):
    tiny = ['--device', 'cpu', '--n-envs', '2', '--max-timesteps', '8']
    dream = ['--dream-batch', '4', '--num-denoise-steps', '4']
    return {
        'online': (t_online.main, [*tiny, '--max-iterations', '2']),
        'dream': (t_dream.main, [*tiny, *dream, '--max-iterations', '2', '--warmup-iters', '1',
                                 '--wm-updates-per-iter', '1', '--dream-updates-per-iter',
                                 '1', '--diag-every', '1', '--dream-timesteps', '6',
                                 '--log-dir', str(tmp_path / 'log'),
                                 '--save-dir', str(tmp_path / 'save')]),
        'offline': (t_offline.main, [*tiny, *dream, '--expert-iterations', '1',
                                     '--dataset-batches-expert', '1',
                                     '--dataset-batches-random', '1', '--wm-steps', '1',
                                     '--dream-updates', '1', '--eval-every', '1',
                                     '--window', '1', '--dream-timesteps', '6',
                                     '--expert-checkpoint', str(tmp_path / 'expert'),
                                     '--dataset-cache', str(tmp_path / 'data.npz')]),
        'pixels': (t_pixels.main, [*tiny, *dream, '--workdir', str(tmp_path / 'work'),
                                   '--expert-iterations', '1', '--batches-expert', '1',
                                   '--batches-random', '1', '--tok-steps', '1',
                                   '--tok-batch', '2', '--tok-clip-t', '4', '--wm-steps', '1',
                                   '--dream-updates', '1', '--eval-every', '1',
                                   '--window', '1', '--dream-timesteps', '6',
                                   '--online-rounds', '1', '--online-collect-batches', '1',
                                   '--online-wm-steps', '1', '--online-dream-updates', '1']),
    }


@pytest.mark.parametrize('case', ['online', 'dream', 'offline', 'pixels'])
def test_cartpole_recipe_mains_run_on_the_cpu(case, tmp_path, capsys):
    """Each recipe's `main` at tiny flags on gymnasium CartPole: exit code
    1 (no gate at 2 iterations), its files written."""
    main, argv = main_cases(tmp_path)[case]
    assert main(argv) == 1
    out = capsys.readouterr().out
    if case == 'online':
        assert 'iter 0: avg return' in out and 'did not reach target_return=70.0' in out
    if case == 'dream':
        assert 'diag p_term L' in out and (tmp_path / 'save' / 'config.json').exists()
        assert (tmp_path / 'log' / 'metrics.jsonl').read_text().count('\n') == 2
    if case == 'offline':
        assert '[dream] update 1: eval return' in out
        assert (tmp_path / 'data.npz').exists() and (tmp_path / 'expert' / 'config.json').exists()
        assert main(argv) == 1   # from the caches
        assert '[dataset] loaded 2 batches' in capsys.readouterr().out
    if case == 'pixels':
        work = tmp_path / 'work'
        for name in ('expert_ckpt', 'tokenizer_ckpt', 'wm_ckpt'):
            assert (work / name / 'config.json').exists(), name
        assert '[online 1] wm fine-tune step 0' in out
        assert len(np.load(work / 'latents_dataset.npz').files) == 2
