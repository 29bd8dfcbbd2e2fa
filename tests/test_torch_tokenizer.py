"""The port's video tokenizer and its training against the JAX package, at
float32 on the CPU, with converted weights and the JAX draws replayed.

The tokenizer is small (dim 32, 4 heads x 16, 32 x 32 RGB, patch 8, 4
latents, depth 2, a time layer every 2, 2 flow steps), so space attention
(16 patches + 4 latents, n*h = 80) takes the small path too, with the
decoder's latents-only-attend-themselves mask. The JAX draws (`uniform`
mask rates, the `bernoulli` patch mask, `randint` flow steps, `normal`
noise; for tests/test_torch_tokenizer_options.py also the `normal` sigreg
slices, the LPIPS frames and the decorrelation's `permutation`) are
recorded by wrapping `jax.random` while a jitted `apply` is traced, as
`tests/test_torch_train.py` does, and replayed into the port's
`models.tokenizer.draw` (and `ops.losses.draw`, `nn.lpips.draw`).

Tolerances, all float32:
  - encode and decode (the Euler loop over both flow steps): 2e-4;
  - training losses 1e-5 absolute; every gradient within 1e-3 relative L2
    distance of the JAX one (float32 through two trunks and their backward,
    summed in another order by each framework);
  - two trainer steps: losses as above, parameters 1e-5 except where the
    first Adam-atan2 step sees a gradient within rounding of zero (see
    `tests/test_torch_train.py`);
  - gradient accumulation against `optax.MultiSteps` on identical
    gradients, Newton-Schulz in float32: 1e-6;
  - training on video through a tokenizer against training on its latents,
    and save -> restore -> step: exact.
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
from dreamer4_tpu.models.tokenizer import VideoTokenizer as JTokenizer
from dreamer4_tpu.train.trainers import TokenizerTrainer as JTokenizerTrainer
from dreamer4_tpu.train.trainers import with_grad_accum as j_with_grad_accum
import dreamer4_torch.train.optim as toptim
from dreamer4_torch import BehaviorCloneTrainer, DynamicsWorldModel, TokenizerTrainer
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.models import tokenizer as tokenizer_module
from dreamer4_torch.models.tokenizer import TokenizerLosses, VideoTokenizer
from dreamer4_torch.ops import small_attention as sa
from dreamer4_torch.train import checkpoint as tcheckpoint

torch.set_num_threads(1)
SMALL = dict(dim=32, dim_latent=8, patch_size=8, image_height=32, image_width=32,
             num_latent_tokens=4, encoder_depth=2, decoder_depth=2, time_block_every=2,
             attn_dim_head=16, attn_heads=4, decoder_flow_steps=2)
T = torch.from_numpy


def make_video(seed, b=2, t=3):
    return np.random.default_rng(seed).random((b, 3, t, 32, 32)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_variables(options=()):
    jm = JTokenizer(**{**SMALL, **dict(options)})
    init = jax.jit(lambda rngs: jm.init(rngs, jnp.zeros((1, 3, 2, 32, 32))))
    variables = init({'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)})
    return jax.tree.map(np.asarray, variables)


def build_pair(fused=True, jax_fused=False, **options):
    """The JAX tokenizer and the port's with the same weights. The port
    takes the small path (K4/K5's plain versions) unless `fused` is off;
    the JAX side runs its Pallas small kernels (interpret mode) only with
    `jax_fused`, as they are slow on the CPU and compute what its generic
    path computes (`tests/test_torch_small_attention.py` holds the port's
    small path against them)."""
    variables = _jax_variables(tuple(sorted(options.items())))
    cfg = {**SMALL, **options}
    jm = JTokenizer(**cfg, use_fused_small=jax_fused)
    tm = VideoTokenizer(**cfg, use_fused_small=fused, device='cpu')
    tm.load_state_dict(flax_params_to_torch(variables['params'], tm,
                                            state=variables.get('state')))
    return jm, variables, tm


# ------------------------------------------------------------ draw replay

_JAX_DRAWS = ('uniform', 'bernoulli', 'randint', 'normal', 'permutation')
# the port's draws (models.tokenizer.draw, ops.losses.draw, nn.lpips.draw) by
# the JAX draw each replays
_PORT_DRAW_OF = {'mask_prob': 'uniform', 'patch_mask': 'bernoulli', 'time_indices': 'randint',
                 'noise': 'normal', 'slices': 'normal', 'permutation': 'permutation',
                 'frame_batch': 'randint', 'frame_time': 'randint',
                 'frame_time_frac': 'uniform'}


def record_jax_draws(fn, *args):
    """The draws `fn(*args)` makes through `jax.random`, in call order: the
    wrappers note each draw's name while the jitted function is traced and
    return its values."""
    names, real = [], {name: getattr(jax.random, name) for name in _JAX_DRAWS}

    def run(*args):
        values = []

        def recording(name):
            def wrapped(*a, **kw):
                out = real[name](*a, **kw)
                names.append(name)
                values.append(out)
                return out
            return wrapped

        with pytest.MonkeyPatch.context() as mp:
            for name in _JAX_DRAWS:
                mp.setattr(jax.random, name, recording(name))
            fn(*args)
        return values

    values = jax.jit(run)(*args)
    return [(name, np.asarray(v)) for name, v in zip(names, values)]


def replay(records):
    """A `draw` for the port that hands out `records` in order, checking
    that the port asks for the same kind and shape of draw."""
    queue = list(records)

    def draw(kind, shape, *, generator, device, low=0.0, high=0.0, prob=None):
        name, x = queue.pop(0)
        assert name == _PORT_DRAW_OF[kind] and x.shape == tuple(shape), (kind, name, x.shape)
        out = torch.from_numpy(np.array(x))
        return (out.long() if name in ('randint', 'permutation') else out).to(device)

    draw.remaining = queue
    return draw


def training_draws(jm, variables, video, time_lens, key):
    return record_jax_draws(
        lambda v, tl: jm.apply(variables, v, time_lens=tl, rngs={'sample': key},
                               mutable=['state']), video, time_lens)


# ---------------------------------------------------------- encode, decode

def test_encode_and_decode_match_jax(monkeypatch):
    jm, variables, tm = build_pair()
    video = make_video(0)
    encode = jax.jit(lambda v: jm.apply(variables, v, method=jm.encode))
    latents = encode(video)
    with torch.no_grad():
        got = tm.encode(T(video))
    np.testing.assert_allclose(np.asarray(latents), got.numpy(), atol=2e-4, rtol=0)

    key = jax.random.PRNGKey(4)
    decode = lambda lat: jm.apply(variables, lat, method=jm.decode, rngs={'sample': key})
    want = jax.jit(decode)(latents)
    draw = replay(record_jax_draws(decode, latents))
    monkeypatch.setattr(tokenizer_module, 'draw', draw)
    with torch.no_grad():
        recon = tm.decode(T(np.array(latents)))
    assert draw.remaining == [] and recon.shape == video.shape
    np.testing.assert_allclose(np.asarray(want), recon.numpy(), atol=2e-4, rtol=0)

    # an image (b, c, h, w) encodes to (b, n, d_latent)
    with torch.no_grad():
        image_latents = tm.encode(T(video[:, :, 0]))
    np.testing.assert_allclose(np.asarray(encode(video[:, :, 0])), image_latents.numpy(),
                               atol=2e-4, rtol=0)


# ------------------------------------------------------ losses, gradients

def rel_l2(want, got):
    return float(np.linalg.norm(want - got) / max(np.linalg.norm(want), 1e-12))


# (port and JAX on the small path, options of the tokenizer): the default
# options with and without the small path, then the options off by default
# that the port has: temporal-difference input channels, the decoder's
# latent gradient only at the noise step, an x-space loss; no flow decoder
# and no loss normalization
LOSS_CASES = {
    'plain': (False, {}),
    'fused': (True, {}),
    'options': (False, dict(encode_temporal_diff=True, latent_grad_only_at_noise=True,
                            decoder_v_space_loss=False)),
    'no_flow': (False, dict(decoder_flow_steps=0, use_loss_normalization=False)),
}


@pytest.mark.parametrize('case', list(LOSS_CASES))
def test_training_losses_and_grads_match_jax(case, monkeypatch):
    fused, options = LOSS_CASES[case]
    jm, variables, tm = build_pair(fused=fused, jax_fused=fused, **options)
    video, time_lens = make_video(1), np.array([3, 2], np.int32)
    key = jax.random.PRNGKey(7)

    def j_loss(params):
        (loss, interm), state = jm.apply({'params': params, 'state': variables.get('state', {})},
                                         video,
                                         time_lens=time_lens, return_intermediates=True,
                                         rngs={'sample': key}, mutable=['state'])
        return loss, (interm.losses, state)

    (j_total, (j_losses, j_state)), j_grads = jax.jit(
        jax.value_and_grad(j_loss, has_aux=True))(variables['params'])
    j_state = j_state.get('state', {})

    draw = replay(training_draws(jm, variables, video, time_lens, key))
    monkeypatch.setattr(tokenizer_module, 'draw', draw)
    calls = []
    real = sa._forward
    monkeypatch.setattr(sa, '_forward', lambda *a: calls.append(1) or real(*a))
    t_total, interm = tm(T(video), time_lens=T(time_lens), return_intermediates=True)
    t_total.backward()
    assert draw.remaining == []
    # both trunks' space and time layers take the small path when fused
    assert len(calls) == (4 if fused else 0)

    np.testing.assert_allclose(float(j_total), t_total.item(), atol=1e-5, rtol=0)
    assert isinstance(interm.losses, TokenizerLosses)
    for field in TokenizerLosses._fields:
        np.testing.assert_allclose(float(getattr(j_losses, field)),
                                   getattr(interm.losses, field).item(), atol=1e-5, rtol=0)
    if tm.use_loss_normalization:
        np.testing.assert_allclose(np.asarray(j_state['recon_loss_normalizer']['exp_avg_sq']),
                                   tm.recon_loss_normalizer.exp_avg_sq.numpy(), rtol=1e-5)
    want = flax_params_to_torch(j_grads, tm)
    for name, p in tm.named_parameters():
        assert p.grad is not None, name
        assert rel_l2(want[name].numpy(), p.grad.numpy()) <= 1e-3, name


# ---------------------------------------------------------------- trainer

def f32_newton_schulz(monkeypatch):
    monkeypatch.setattr(joptim, '_batched_orthogonalize',
                        partial(joptim._batched_orthogonalize, ns_dtype=jnp.float32))
    monkeypatch.setattr(toptim, 'batched_orthogonalize',
                        partial(toptim.batched_orthogonalize, ns_dtype=torch.float32))


def test_tokenizer_trainer_two_steps_match_jax(monkeypatch):
    f32_newton_schulz(monkeypatch)
    jm, variables, tm = build_pair()
    videos = [make_video(10 + i) for i in range(2)]
    lens = np.array([3, 2], np.int32)
    kw = dict(learning_rate=3e-4, clip_grad_norm=1.0, with_ema=True, ema_decay=0.9, seed=1)

    jtrainer = JTokenizerTrainer(jm, variables, **kw)
    keys, j_step = [], jtrainer._train_step
    jtrainer._train_step = lambda ts, v, tl, key, **k: keys.append(key) or j_step(ts, v, tl, key, **k)
    j_out = [jtrainer.train_on_batch(v, lens) for v in videos]
    records = [r for key, v in zip(keys, videos)
               for r in training_draws(jm, variables, v, lens, key)]

    draw = replay(records)
    monkeypatch.setattr(tokenizer_module, 'draw', draw)
    trainer = TokenizerTrainer(tm, **kw, device='cpu')
    t_out = [trainer.train_on_batch(T(v), T(lens)) for v in videos]
    assert draw.remaining == [] and trainer.ts.step == int(jtrainer.ts.step) == 2

    for (jl, jls), (tl, tls) in zip(j_out, t_out):
        np.testing.assert_allclose(float(jl), float(tl), atol=1e-5, rtol=0)
        np.testing.assert_allclose(float(jls.recon), float(tls.recon), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        np.asarray(jtrainer.ts.state['recon_loss_normalizer']['exp_avg_sq']),
        tm.recon_loss_normalizer.exp_avg_sq.numpy(), rtol=1e-5)
    first_grads = jax.jit(jax.grad(lambda p: jm.apply(
        {'params': p, 'state': variables['state']}, videos[0], time_lens=lens,
        rngs={'sample': keys[0]}, mutable=['state'])[0]))(variables['params'])
    small_grad = {n: np.abs(g.numpy()) < 1e-7
                  for n, g in flax_params_to_torch(first_grads, tm).items()}
    for tree, got in ((jtrainer.ts.params, dict(tm.named_parameters())),
                      (jtrainer.ts.ema_params, trainer.ts.ema_params)):
        for name, want in flax_params_to_torch(tree, tm).items():
            diff = np.abs(want.numpy() - got[name].detach().numpy())
            assert not (diff[~small_grad[name]] > 1e-5).any(), name
            assert (diff <= 7e-4).all(), name


def test_grad_accum_matches_optax_multisteps(monkeypatch):
    """`MultiSteps(MuonAdamAtan2, 2)` against `optax.MultiSteps` on the same
    gradients, the tokenizer's parameters: nothing moves on the first
    micro-step of each pair, the update of the mean on the second."""
    f32_newton_schulz(monkeypatch)
    _, variables, tm = build_pair()
    params = variables['params']
    tx = j_with_grad_accum(joptim.muon_adam_atan2(learning_rate=3e-4, clip_grad_norm=1.0), 2)
    assert isinstance(tx, optax.MultiSteps)
    opt = toptim.with_grad_accum(toptim.MuonAdamAtan2(tm, learning_rate=3e-4,
                                                      clip_grad_norm=1.0), 2)
    state = tx.init(params)
    rng = np.random.default_rng(0)
    for i, std in enumerate((1e-2, 3e-3, 1e-4, 2e-4)):
        grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * std).astype(np.float32),
                             params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        before = {n: p.detach().clone() for n, p in tm.named_parameters()}
        for name, g in flax_params_to_torch(grads, tm).items():
            tm.get_parameter(name).grad = g
        opt.step()
        assert opt.mini_step == int(state.mini_step) == (i + 1) % 2
        for name, want in flax_params_to_torch(params, tm).items():
            p = tm.get_parameter(name).detach()
            np.testing.assert_allclose(want.numpy(), p.numpy(), atol=1e-6, rtol=0, err_msg=name)
            assert torch.equal(p, before[name]) == (i % 2 == 0), name


def wm_config():
    return dict(dim=32, dim_latent=SMALL['dim_latent'], num_latent_tokens=4,
                num_spatial_tokens=4, max_steps=16, depth=2, time_block_every=2, attn_heads=2,
                attn_dim_head=16, num_discrete_actions=(4,), multi_token_pred_len=2,
                num_register_tokens=2)


def wm_batch(seed, tokenizer=None):
    rng = np.random.default_rng(seed)
    batch = dict(video=T(make_video(seed)),
                 rewards=T(rng.standard_normal((2, 3)).astype(np.float32)),
                 discrete_actions=T(rng.integers(0, 4, (2, 3, 1))))
    if tokenizer is not None:
        with torch.no_grad():
            batch['latents'] = tokenizer.encode(batch.pop('video'))
    return batch


@pytest.mark.parametrize('kind', ['tokenizer', 'world_model'])
def test_grad_accum_in_both_trainers(kind):
    """grad_accum = 2: the parameters, the EMA and the step move on every
    second batch only; the tokenizer's loss normalizer on every batch."""
    torch.manual_seed(0)
    if kind == 'tokenizer':
        trainer = TokenizerTrainer(VideoTokenizer(**SMALL, device='cpu'), grad_accum=2,
                                   device='cpu')
        batches = [(T(make_video(20 + i)),) for i in range(4)]
    else:
        trainer = BehaviorCloneTrainer(DynamicsWorldModel(**wm_config(), device='cpu'),
                                       tokenizer=VideoTokenizer(**SMALL, device='cpu'),
                                       grad_accum=2, device='cpu')
        batches = [(wm_batch(20 + i),) for i in range(4)]
    assert isinstance(trainer.optimizer, toptim.MultiSteps)
    model = trainer.model
    for i, args in enumerate(batches):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        ema_before = {n: e.clone() for n, e in trainer.ts.ema_params.items()}
        norm_before = [b.clone() for b in model.buffers()]
        trainer.train_on_batch(*args)
        applied = i % 2 == 1
        assert trainer.ts.step == (i + 1) // 2
        moved = [not torch.equal(p, before[n]) for n, p in model.named_parameters()]
        ema_moved = [not torch.equal(e, ema_before[n]) for n, e in trainer.ts.ema_params.items()]
        assert (any(moved), any(ema_moved)) == (applied, applied)
        if kind == 'tokenizer':
            assert not torch.equal(model.recon_loss_normalizer.exp_avg_sq, norm_before[0])


def test_behavior_clone_on_video_equals_training_on_its_latents():
    torch.manual_seed(0)
    tokenizer = VideoTokenizer(**SMALL, use_fused_small=True, device='cpu')
    torch.manual_seed(1)
    wm_a = DynamicsWorldModel(**wm_config(), device='cpu')
    wm_b = DynamicsWorldModel(**wm_config(), device='cpu')
    wm_b.load_state_dict(wm_a.state_dict())
    on_video = BehaviorCloneTrainer(wm_a, tokenizer=tokenizer, seed=3, device='cpu')
    on_latents = BehaviorCloneTrainer(wm_b, seed=3, device='cpu')
    tok_before = {n: p.clone() for n, p in tokenizer.state_dict().items()}
    for seed in (30, 31):
        la, _ = on_video.train_on_batch(wm_batch(seed))
        lb, _ = on_latents.train_on_batch(wm_batch(seed, tokenizer))
        assert torch.equal(la, lb)
    for (name, a), b in zip(wm_a.named_parameters(), wm_b.parameters()):
        assert torch.equal(a, b), name
    for name, t in tokenizer.state_dict().items():
        assert torch.equal(t, tok_before[name]), name   # encoded without training it
    with pytest.raises(ValueError):
        on_latents.train_on_batch(wm_batch(32))


def test_tokenizer_trainer_resume_continues_bit_for_bit(tmp_path):
    """Save in the middle of a gradient accumulation (after 3 micro-steps of
    2), go on; a fresh trainer restored from the checkpoint and fed the same
    batches ends with the same parameters, EMA, loss normalizer and step."""
    make = lambda: TokenizerTrainer(VideoTokenizer(**SMALL, device='cpu'), learning_rate=1e-3,
                                    grad_accum=2, seed=0, device='cpu')
    videos = [T(make_video(40 + i, b=1, t=2)) for i in range(5)]
    torch.manual_seed(0)
    trainer = make()
    for v in videos[:3]:
        trainer.train_on_batch(v)
    target = trainer.save_checkpoint(tmp_path, extra=dict(note='mid-run'))
    assert target.name == 'ckpt-1'
    for v in videos[3:]:
        trainer.train_on_batch(v)

    torch.manual_seed(1)   # other initial weights: the restore must replace them
    trainer2 = make()
    assert trainer2.restore(tmp_path)['note'] == 'mid-run' and trainer2.ts.step == 1
    for v in videos[3:]:
        trainer2.train_on_batch(v)
    assert trainer2.ts.step == trainer.ts.step == 2
    state2 = trainer2.model.state_dict()
    for name, t in trainer.model.state_dict().items():
        assert torch.equal(t, state2[name]), name
    for name, e in trainer.ts.ema_params.items():
        assert torch.equal(e, trainer2.ts.ema_params[name]), name

    ema_model = tcheckpoint.load_model(target / 'ema', VideoTokenizer, device='cpu')
    assert ema_model.config == trainer.model.config
    assert ema_model.per_image_patch_mask_prob == (0.0, 0.9)


def test_unported_tokenizer_options_raise():
    """The GRU time layer and the H-Net fields, refused here before, build
    (the H-Net's with a splice layer); an unknown name is a TypeError."""
    for name, value in (('use_time_rnn', True), ('h_net_layer', 1), ('h_net_depth', 3),
                        ('h_net_compression_ratio', 8), ('h_net_dynamic', True)):
        extra = {} if name in ('use_time_rnn', 'h_net_layer') else dict(h_net_layer=0)
        assert VideoTokenizer(**SMALL, **extra, **{name: value},
                              device='cpu').config[name] == value
    with pytest.raises(TypeError):
        VideoTokenizer(**SMALL, no_such_option=1, device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            VideoTokenizer(**SMALL)
