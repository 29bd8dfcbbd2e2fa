"""World-model training in the port against the JAX package, at float32 on
the CPU, with converted weights and the JAX draws replayed.

The JAX training forward draws from flax's `make_rng('sample')`; those keys
are not practical to rebuild, so each JAX draw is recorded by wrapping
`jax.random.randint` / `normal` / `bernoulli` around an un-jitted `apply`
with the same key and inputs, and replayed into the port through its
module-level `models.world_model.draw`. The draws depend on the key and the
shapes only, so they are recorded with flash attention off.

Tolerances, all float32:
  - ops (MTP targets, ramp weight, masked mean, lens mask): exact, or 1e-7;
    the HL-Gauss reward targets 2e-5 (differences of float32 erf values of
    two libraries, near the clamped ends of the range).
  - losses: 2e-5 absolute, 1e-4 relative; gradients: 2e-5 absolute, 1e-3
    relative (float32 through the trunk, its backward and the 255-bin
    heads, in two frameworks that sum in different orders).
  - the optimizer on identical gradients, Newton-Schulz in float32 (the
    JAX `_batched_orthogonalize` wrapped with `ns_dtype=float32`, as its
    default binds the bf16 `NS_DTYPE` when it is defined): 1e-6; with the
    bf16 default in both: 1e-3 in any entry over three steps, a third of
    the Muon learning rate, and 1e-5 on average (the bf16 matmuls of the
    iteration round differently in the two libraries, and five iterations
    amplify a few entries by tens of bf16 steps).
  - two trainer steps: losses as above; parameters 1e-5, except where the
    first Adam-atan2 step sees a gradient within rounding of zero:
    atan2(m, sqrt(v)) is +-pi/4 for any nonzero gradient, so a gradient of
    1e-9 in one package and -1e-9 in the other moves a parameter by
    2 * lr * 1.27 * pi/4 = 6e-4. Such entries are counted, and allowed only
    where the JAX gradient is below 1e-7 in size.
  - save -> restore -> step within the port: exact.
"""
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dreamer4_tpu.train.optim as joptim
from dreamer4_tpu.models.world_model import DynamicsWorldModel as JWorldModel
from dreamer4_tpu.ops import mtp as jmtp
from dreamer4_tpu.ops import utils as jutils
from dreamer4_tpu.ops.codecs import HLGauss as JHLGauss
from dreamer4_tpu.ops.flash_attention import flash_attend_bwd as j_flash_attend_bwd
from dreamer4_tpu.train import ema as jema
from dreamer4_tpu.train.trainers import BehaviorCloneTrainer as JBehaviorCloneTrainer
import dreamer4_tpu.ops.flash_attention as jflash
import dreamer4_torch.train.optim as toptim
from dreamer4_torch import BehaviorCloneTrainer
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.models import world_model as world_model_module
from dreamer4_torch.models.world_model import DynamicsWorldModel, WorldModelLosses
from dreamer4_torch.ops import flash_attention as fa
from dreamer4_torch.ops import mtp as tmtp
from dreamer4_torch.ops import utils as tutils
from dreamer4_torch.ops.codecs import HLGauss
from dreamer4_torch.train import checkpoint as tcheckpoint
from dreamer4_torch.train import ema as tema

torch.set_num_threads(1)
SMALL = dict(dim=64, dim_latent=8, num_latent_tokens=4, num_spatial_tokens=4, max_steps=16,
             depth=4, time_block_every=2, attn_heads=2, attn_dim_head=32,
             num_discrete_actions=(4,), multi_token_pred_len=2, num_register_tokens=2,
             predict_terminals=True, terminal_pos_weight=3.0)
T = torch.from_numpy


def close(a, b, atol, rtol):
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
    np.testing.assert_allclose(np.asarray(a), b, atol=atol, rtol=rtol)


@functools.lru_cache(maxsize=None)
def _jax_params(cfg_items):
    """The JAX model's initial parameters (numpy) for one configuration,
    from a jitted `init`; shared by the tests of this file."""
    jm = JWorldModel(**dict(cfg_items))
    rngs = {'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)}
    init = jax.jit(lambda rngs: jm.init(
        rngs, latents=jnp.zeros((2, 3, 4, 8)), shortcut_train=False,
        rewards=jnp.zeros((2, 3)), terminals=jnp.zeros((2,), bool),
        discrete_actions=jnp.zeros((2, 2, 1), jnp.int32))['params'])
    return jax.tree.map(np.asarray, init(rngs))


def build_pair(**kw):
    cfg = {**SMALL, **kw}
    jm = JWorldModel(**cfg)
    params = _jax_params(tuple(sorted(cfg.items())))
    tm = DynamicsWorldModel(**cfg, device='cpu')
    tm.load_state_dict(flax_params_to_torch(params, tm))
    return jm, params, tm


def make_batch(seed, b, t, terminals_1d=False, lens=None):
    rng = np.random.default_rng(seed)
    batch = dict(latents=(rng.standard_normal((b, t, 4, 8)) * 0.5).astype(np.float32),
                 rewards=rng.standard_normal((b, t)).astype(np.float32),
                 discrete_actions=rng.integers(0, 4, (b, t, 1)).astype(np.int32),
                 terminals=rng.random(b if terminals_1d else (b, t)) < 0.4)
    if lens is not None:
        batch['lens'] = np.asarray(lens, np.int32)
    return batch


def to_torch(batch):
    return {k: T(np.asarray(v)) for k, v in batch.items()}


# ------------------------------------------------------------ draw replay

_JAX_DRAWS = ('randint', 'normal', 'bernoulli')
_PORT_DRAW_OF = {'step_sizes_log2': 'randint', 'signal_levels': 'randint', 'noise': 'normal',
                 'reward_keep': 'bernoulli'}


def record_jax_draws(cfg, params, batch, key, shortcut):
    """The JAX training forward's draws for `key`, in call order: the
    wrappers note each draw's name while `apply` is traced and return its
    value from the jitted function (which then computes little else)."""
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
    """A `draw` for the port that hands out `records` in order, checking
    that the port asks for the same kind and shape of draw."""
    queue = list(records)

    def draw(kind, shape, *, generator, device, low=0, high=0, prob=0.0):
        name, x = queue.pop(0)
        assert name == _PORT_DRAW_OF[kind] and x.shape == tuple(shape), (kind, name, x.shape)
        out = torch.from_numpy(np.array(x))
        return (out.long() if name == 'randint' else out).to(device)

    draw.remaining = queue
    return draw


# -------------------------------------------------------------------- ops

def test_mtp_targets_match_jax():
    x = np.random.default_rng(0).standard_normal((3, 7, 5)).astype(np.float32)
    for steps in (1, 3, 9):
        jt, jmask = jmtp.create_multi_token_prediction_targets(jnp.asarray(x), steps)
        tt, tmask = tmtp.create_multi_token_prediction_targets(T(x), steps)
        np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
        np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy())


def test_ramp_masked_mean_and_lens_mask_match_jax():
    rng = np.random.default_rng(1)
    times = rng.random((2, 6)).astype(np.float32)
    close(jutils.ramp_weight(jnp.asarray(times)), tutils.ramp_weight(T(times)), 1e-7, 0)
    lens = np.array([0, 3, 6], np.int32)
    np.testing.assert_array_equal(np.asarray(jutils.lens_to_mask(jnp.asarray(lens), 6)),
                                  tutils.lens_to_mask(T(lens), 6).numpy())
    x = rng.standard_normal((3, 6, 4)).astype(np.float32)
    mask = np.asarray(jutils.lens_to_mask(jnp.asarray(lens), 6))
    for m, dim in ((None, None), (None, 1), (mask[..., None], None), (mask[..., None], 1),
                   (mask[..., None], (1, 2))):
        jm_ = jutils.masked_mean(jnp.asarray(x), None if m is None else jnp.asarray(m), axis=dim)
        tm_ = tutils.masked_mean(T(x), None if m is None else T(m), dim=dim)
        close(jm_, tm_, 1e-7, 1e-6)


def test_hl_gauss_encode_matches_jax():
    """The reward targets of the reward loss."""
    values = np.array([-25.0, -20.0, -3.3, 0.0, 0.01, 7.5, 20.0, 31.0], np.float32)
    close(JHLGauss().encode(jnp.asarray(values)), HLGauss().encode(T(values)), 2e-5, 0)


# ------------------------------------------------- training losses, grads

LOSS_CASES = {
    'plain': (dict(), dict(b=2, t=5), False),
    'shortcut_lens': (dict(), dict(b=2, t=5, lens=[5, 3]), True),
    'reward_embed_1d_terminals': (dict(add_reward_embed_to_agent_token=True),
                                  dict(b=3, t=4, terminals_1d=True, lens=[4, 2, 3]), False),
    'v_space_shortcut': (dict(pred_orig_latent=False), dict(b=2, t=5), True),
}


def loss_and_grads_pair(cfg_kw, batch, shortcut, monkeypatch, key=jax.random.PRNGKey(7)):
    jm, params, tm = build_pair(**cfg_kw)
    cfg = {**SMALL, **cfg_kw}

    def j_loss(p):
        loss, losses, _ = jm.apply({'params': p}, **batch, shortcut_train=shortcut,
                                   return_intermediates=True, rngs={'sample': key})
        return loss, losses

    (j_total, j_losses), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)

    draw = replay(record_jax_draws(cfg, params, batch, key, shortcut))
    monkeypatch.setattr(world_model_module, 'draw', draw)
    t_total, t_losses, _ = tm(**to_torch(batch), shortcut_train=shortcut,
                              return_intermediates=True)
    t_total.backward()
    assert draw.remaining == []
    return (j_total, j_losses, j_grads), (t_total, t_losses, tm)


def assert_losses_and_grads_close(jax_side, port_side):
    (j_total, j_losses, j_grads), (t_total, t_losses, tm) = jax_side, port_side
    assert isinstance(t_losses, WorldModelLosses)
    close(j_total, t_total, 2e-5, 1e-4)
    for field in WorldModelLosses._fields:
        close(getattr(j_losses, field), getattr(t_losses, field), 2e-5, 1e-4)
    want = flax_params_to_torch(j_grads, tm)
    for name, p in tm.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(want[name].numpy(), got.numpy(), atol=2e-5, rtol=1e-3,
                                   err_msg=name)


@pytest.mark.parametrize('case', list(LOSS_CASES))
def test_training_losses_and_grads_match_jax(case, monkeypatch):
    cfg_kw, batch_kw, shortcut = LOSS_CASES[case]
    batch = make_batch(0, **batch_kw)
    jax_side, port_side = loss_and_grads_pair(cfg_kw, batch, shortcut, monkeypatch)
    assert float(port_side[1].flow.detach()) > 0
    if shortcut:
        assert float(port_side[1].shortcut.detach()) > 0
    assert_losses_and_grads_close(jax_side, port_side)


def test_training_through_flash_backward_matches_jax(monkeypatch):
    """T = 128 with the flash gate lowered to 1024 scores: both time layers
    take the flash branch, where JAX runs its fused backward (the Pallas
    kernels in interpret mode) and the port its `autograd.Function` (the
    plain versions of K2 and K3 on the CPU). Space attention (81 scores)
    stays under the gate."""
    counts = {'jax_fused_bwd': 0, 'port_dq': 0, 'port_dkv': 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jflash, 'flash_attend_bwd', spy('jax_fused_bwd', j_flash_attend_bwd))
    monkeypatch.setattr(fa, 'bwd_dq_reference', spy('port_dq', fa.bwd_dq_reference))
    monkeypatch.setattr(fa, 'bwd_dkv_reference', spy('port_dkv', fa.bwd_dkv_reference))
    batch = make_batch(1, b=1, t=128)
    jax_side, port_side = loss_and_grads_pair(
        dict(use_flash_attention=True, flash_min_scores=1024), batch, False, monkeypatch)
    n_time = SMALL['depth'] // SMALL['time_block_every']
    assert counts['jax_fused_bwd'] == n_time      # traced once per time layer
    assert counts['port_dq'] == counts['port_dkv'] == n_time
    assert_losses_and_grads_close(jax_side, port_side)


# --------------------------------------------------------------- optimizer

def label_tree_through_converter(params, tm):
    """JAX's Muon / Adam labels mapped onto the port's parameter names by
    the weight converter itself."""
    labels = jax.tree_util.tree_map_with_path(joptim.muon_label_fn, params)
    marks = jax.tree.map(lambda p, label: np.full(p.shape, float(label == 'muon'), np.float32),
                         params, labels)
    return {name: 'muon' if bool(t.flatten()[0]) else 'adam'
            for name, t in flax_params_to_torch(marks, tm).items()}


def test_muon_labels_match_jax():
    _, params, tm = build_pair()
    labels = toptim.MuonAdamAtan2(tm).labels()
    assert labels == label_tree_through_converter(params, tm)
    # the pools' raw flax-layout kernels go to Muon, as in the counterpart
    assert labels['transformer.attn_pool_0.attn.to_v.kernel'] == 'muon'
    assert labels['transformer.attn_pool_0.attn.to_k.kernel'] == 'adam'


@pytest.mark.parametrize('ns', ['float32', 'bf16'])
def test_optimizer_matches_optax_on_identical_gradients(ns, monkeypatch):
    _, params, tm = build_pair()
    if ns == 'float32':
        monkeypatch.setattr(joptim, '_batched_orthogonalize',
                            partial(joptim._batched_orthogonalize, ns_dtype=jnp.float32))
        monkeypatch.setattr(toptim, 'batched_orthogonalize',
                            partial(toptim.batched_orthogonalize, ns_dtype=torch.float32))
    tol, mean_tol = (1e-6, 1e-6) if ns == 'float32' else (1e-3, 1e-5)
    tx = joptim.muon_adam_atan2(learning_rate=3e-4, clip_grad_norm=1.0)
    opt = toptim.MuonAdamAtan2(tm, learning_rate=3e-4, clip_grad_norm=1.0)
    state = tx.init(params)
    rng = np.random.default_rng(0)
    # the first two steps are clipped (global norm about 5 and 0.5 x 5),
    # the third is not
    for std in (1e-2, 5e-3, 1e-4):
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * std).astype(np.float32),
                             params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for name, g in flax_params_to_torch(grads, tm).items():
            tm.get_parameter(name).grad = g
        opt.step()
        want = flax_params_to_torch(params, tm)
        diffs = []
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(want[name].numpy(), p.detach().numpy(), atol=tol, rtol=0,
                                       err_msg=name)
            diffs.append((want[name] - p.detach()).abs().flatten())
        assert float(torch.cat(diffs).mean()) <= mean_tol


def test_ema_matches_jax():
    _, params, tm = build_pair()
    rng = np.random.default_rng(2)
    new = jax.tree.map(lambda p: (p + rng.standard_normal(p.shape)).astype(np.float32), params)
    want = flax_params_to_torch(jema.update_ema(params, new, 0.99), tm)
    ema = tema.init_ema(dict(tm.named_parameters()))
    got = tema.update_ema(ema, flax_params_to_torch(new, tm), 0.99)
    assert got is ema
    for name, t in want.items():
        close(t.numpy(), got[name], 1e-7, 1e-6)


# ---------------------------------------------------------------- trainer

def test_behavior_clone_trainer_two_steps_match_jax(monkeypatch):
    """Seed 1 draws a shortcut step, then a plain one, in both packages."""
    monkeypatch.setattr(joptim, '_batched_orthogonalize',
                        partial(joptim._batched_orthogonalize, ns_dtype=jnp.float32))
    monkeypatch.setattr(toptim, 'batched_orthogonalize',
                        partial(toptim.batched_orthogonalize, ns_dtype=torch.float32))
    jm, params, tm = build_pair()
    batches = [make_batch(10 + i, b=2, t=5, lens=[5, 4]) for i in range(2)]
    kw = dict(learning_rate=3e-4, clip_grad_norm=1.0, with_ema=True, ema_decay=0.9, seed=1)

    jtrainer = JBehaviorCloneTrainer(jm, {'params': params}, **kw)
    calls, j_step = [], jtrainer._train_step

    def spy(ts, batch, key, shortcut_train):
        calls.append((key, shortcut_train))
        return j_step(ts, batch, key, shortcut_train=shortcut_train)

    jtrainer._train_step = spy
    j_losses = [jtrainer.train_on_batch(b) for b in batches]
    assert [s for _, s in calls] == [True, False]
    records = [r for (key, s), b in zip(calls, batches)
               for r in record_jax_draws(SMALL, params, b, key, s)]

    draw = replay(records)
    monkeypatch.setattr(world_model_module, 'draw', draw)
    trainer = BehaviorCloneTrainer(tm, **kw, device='cpu')
    t_losses = [trainer.train_on_batch(to_torch(b)) for b in batches]
    assert draw.remaining == [] and trainer.ts.step == int(jtrainer.ts.step) == 2

    for (jl, jls), (tl, tls) in zip(j_losses, t_losses):
        close(jl, tl, 2e-5, 1e-4)
        for field in WorldModelLosses._fields:
            close(getattr(jls, field), getattr(tls, field), 2e-5, 1e-4)
    first_grads = jax.jit(jax.grad(lambda p: jm.apply(
        {'params': p}, **batches[0], shortcut_train=True, rngs={'sample': calls[0][0]})))(params)
    small_grad = {n: np.abs(g.numpy()) < 1e-7
                  for n, g in flax_params_to_torch(first_grads, tm).items()}
    for tree, got in ((jtrainer.ts.params, dict(tm.named_parameters())),
                      (jtrainer.ts.ema_params, trainer.ts.ema_params)):
        for name, want in flax_params_to_torch(tree, tm).items():
            diff = np.abs(want.numpy() - got[name].detach().numpy())
            assert not (diff[~small_grad[name]] > 1e-5).any(), name
            assert (diff <= 7e-4).all(), name


def small_batches(n):
    return [to_torch(make_batch(20 + i, b=2, t=4)) for i in range(n)]


def test_save_restore_step_is_exact(tmp_path):
    """Kill/restart: save after 3 steps and go on; a fresh trainer restored
    from the checkpoint and fed the same batches reproduces the parameters,
    the EMA and the step bit for bit."""
    torch.manual_seed(0)
    make = lambda: BehaviorCloneTrainer(DynamicsWorldModel(**SMALL, device='cpu'),
                                        learning_rate=1e-3, seed=0, device='cpu')
    batches = small_batches(5)
    trainer = make()
    for b in batches[:3]:
        trainer.train_on_batch(b)
    target = trainer.save_checkpoint(tmp_path, extra=dict(note='mid-run'))
    assert target.name == 'ckpt-3' and (tmp_path / 'latest').resolve() == target.resolve()
    for b in batches[3:]:
        trainer.train_on_batch(b)

    torch.manual_seed(1)   # other initial weights: the restore must replace them
    trainer2 = make()
    extra = trainer2.restore(tmp_path)
    assert extra['note'] == 'mid-run' and trainer2.ts.step == 3
    for b in batches[3:]:
        trainer2.train_on_batch(b)
    assert trainer2.ts.step == trainer.ts.step == 5
    got = dict(trainer2.model.named_parameters())
    for name, p in trainer.model.named_parameters():
        assert torch.equal(p, got[name]), name
        assert torch.equal(trainer.ts.ema_params[name], trainer2.ts.ema_params[name]), name

    ema_model = tcheckpoint.load_model(target / 'ema', DynamicsWorldModel, device='cpu')
    assert ema_model.config == trainer.model.config


def test_config_roundtrip_with_dtypes(tmp_path):
    model = DynamicsWorldModel(**{**SMALL, 'num_discrete_actions': (4, 3)},
                               dtype=torch.bfloat16, device='cpu')
    tcheckpoint.save_model(tmp_path / 'm', model, extra=dict(step=7))
    model2 = tcheckpoint.load_model(tmp_path / 'm', DynamicsWorldModel, device='cpu')
    assert model2.config == model.config
    assert model2.dtype is torch.bfloat16 and model2.num_discrete_actions == (4, 3)
    assert tcheckpoint.load_config(tmp_path / 'm')['extra'] == dict(step=7)
    for (name, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(a, b), name


def test_trainer_device_and_unported_options():
    model = DynamicsWorldModel(**SMALL, device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            BehaviorCloneTrainer(model)
    for kw in (dict(aux_image_encoder_fn=lambda v: v), dict(use_self_flow=True)):
        with pytest.raises(NotImplementedError):
            BehaviorCloneTrainer(model, device='cpu', **kw)
    trainer = BehaviorCloneTrainer(model, device='cpu')
    with pytest.raises(ValueError):   # video needs a tokenizer to become latents
        trainer.train_on_batch({'video': torch.zeros(1)})
