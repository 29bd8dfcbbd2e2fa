"""The pixel CartPole recipe's tokenizer options and the remaining loss terms
in the port against the JAX package, at float32 on the CPU, with converted
weights and the JAX draws replayed: the causal depthwise conv3d, shifted
patch tokenization, the four-part streaming cache, LPIPS, sigreg, the
decorrelation, orthogonality and latent consistency losses, the world
model's loss normalization and `ActorSPR`'s sigreg term.

The tokenizer is small (dim 32, 2 heads x 16, 16 x 16 RGB, patch 4, 4
latents, an encoder of a space and a time layer, a decoder of one space
layer, 2 flow steps). The JAX draws
(`uniform` mask rates, the `bernoulli` patch mask, the `normal` sigreg
slices, `randint` flow steps, `normal` noise, the LPIPS frames'
`randint` / `uniform`, the decorrelation's `permutation`) are recorded while
a jitted JAX function is traced, by wrapping `jax.random` (the names at
trace time, the values returned by the function), and replayed in order
into the port's `models.tokenizer.draw`, `ops.losses.draw` and
`nn.lpips.draw`. VGG16 runs on seeded random features, converted from the
JAX trunk, or on one npz written from seeded arrays into a temporary
directory and loaded by both packages: no weights are downloaded.

Tolerances, all float32:
  - conv3d, SPT, sigreg, decorrelation, orthogonality, VGG16 features,
    LPIPS, ActorSPR: 1e-5 absolute and 1e-5 relative on values and
    gradients (a few small layers; the VGG trunk 1e-4 relative on its
    features, thirteen 3 x 3 convolutions summed in other orders);
  - the tokenizer's losses 1e-5 absolute and relative, every gradient
    within 1e-3 relative L2 distance of the JAX one, the normalizers' state
    1e-5 relative (tests/test_torch_tokenizer.py's tolerances);
  - streaming against parallel, in the port and against JAX: 2e-5 absolute
    and 1e-4 relative (tests/test_tokenizer_features.py's);
  - trainer steps: losses as above, parameters 1e-5 except where the first
    Adam-atan2 step sees a gradient within rounding of zero
    (tests/test_torch_train.py);
  - the world model with loss normalization: losses 2e-5 absolute and 1e-4
    relative, gradients 2e-5 absolute and 1e-3 relative
    (tests/test_torch_train.py's), the normalizers' state 1e-5 relative;
  - checkpoint round trip: exact.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tokenizer import _JAX_DRAWS, f32_newton_schulz, rel_l2, replay
from test_torch_train import SMALL as WM_SMALL
from test_torch_train import make_batch as wm_batch
from test_torch_train import to_torch as wm_to_torch
from dreamer4_tpu.models.tokenizer import VideoTokenizer as JTokenizer
from dreamer4_tpu.models.tokenizer import latent_consistency_loss as j_latent_consistency_loss
from dreamer4_tpu.models.world_model import DynamicsWorldModel as JWorldModel
from dreamer4_tpu.nn.conv import CausalDepthwiseConv3d as JConv3d
from dreamer4_tpu.nn.lpips import VGG16Features as JVGG16Features
from dreamer4_tpu.nn.lpips import init_lpips as j_init_lpips
from dreamer4_tpu.nn.lpips import load_vgg16_npz as j_load_vgg16_npz
from dreamer4_tpu.nn.lpips import lpips_loss as j_lpips_loss
from dreamer4_tpu.nn.spt import ShiftedPatchTokenization as JSPT
from dreamer4_tpu.nn.ssl import ActorSPR as JActorSPR
from dreamer4_tpu.ops import losses as jlosses
from dreamer4_tpu.ops import utils as jutils
from dreamer4_tpu.train.trainers import BehaviorCloneTrainer as JBehaviorCloneTrainer
from dreamer4_tpu.train.trainers import TokenizerTrainer as JTokenizerTrainer
from dreamer4_torch import BehaviorCloneTrainer, TokenizerTrainer
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.models import tokenizer as tokenizer_module
from dreamer4_torch.models import world_model as world_model_module
from dreamer4_torch.models.tokenizer import (TokenizerCache, TokenizerLosses, VideoTokenizer,
                                             latent_consistency_loss)
from dreamer4_torch.models.world_model import DynamicsWorldModel, WorldModelLosses
from dreamer4_torch.nn import lpips as lpips_module
from dreamer4_torch.nn.conv import CausalDepthwiseConv3d
from dreamer4_torch.nn.lpips import VGG16Features, init_lpips, load_vgg16_npz, lpips_loss
from dreamer4_torch.nn.spt import ShiftedPatchTokenization
from dreamer4_torch.nn.ssl import ActorSPR
from dreamer4_torch.ops import losses as losses_module
from dreamer4_torch.ops.utils import orthogonal_loss
from dreamer4_torch.train import checkpoint

torch.set_num_threads(1)
T = torch.from_numpy
OPT = dict(dim=32, dim_latent=8, patch_size=4, image_height=16, image_width=16,
           num_latent_tokens=4, encoder_depth=2, decoder_depth=1, time_block_every=2,
           attn_dim_head=16, attn_heads=2, decoder_flow_steps=2)
# examples/train_cartpole_pixels_dream_rl.py:497-502, on 16 x 16 frames
RECIPE = dict(use_causal_conv3d=True, use_shifted_patch_tokenization=True)


def close(a, b, atol, rtol, err_msg=''):
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
    np.testing.assert_allclose(np.asarray(a), b, atol=atol, rtol=rtol, err_msg=err_msg)


def grad_of(p):
    return p.grad if p.grad is not None else torch.zeros_like(p)


def make_video(seed, b=2, t=3):
    return np.random.default_rng(seed).random((b, 3, t, 16, 16)).astype(np.float32)


# ----------------------------------------------------------- draw replay

class Draws:
    """The draws a jitted JAX function makes through `jax.random`: their
    names, noted while it is traced, and their values, which the function
    returns from inside `recording()` (also from under `value_and_grad`,
    as an aux output)."""

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


def replay_draws(monkeypatch, records):
    """Hand `records` out in order to every draw of the port's tokenizer
    path: the tokenizer's, the losses' and LPIPS's."""
    draw = replay(records)
    for module in (tokenizer_module, losses_module, lpips_module):
        monkeypatch.setattr(module, 'draw', draw)
    return draw


# ------------------------------------------------------------------ conv3d

@pytest.mark.parametrize('cached', [False, True])
@pytest.mark.parametrize('k', [3, 5])
def test_causal_conv3d_matches_jax(k, cached):
    """Output and next cache, with zeros as the past or a given cache of
    k - 1 normed frames, and at k = 3 (the recipe's) every gradient. At
    k = 5 the JAX gradient program of the 125 unrolled shifted products
    takes half a minute to compile on the CPU, so that size holds values
    and caches; the port's gradient is autograd's through one conv3d at
    either size."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 4, 5, 6, 8)).astype(np.float32)
    cache = rng.standard_normal((2, k - 1, 5, 6, 8)).astype(np.float32) if cached else None
    jconv = JConv3d(8, k)
    params = jax.tree.map(np.asarray, jconv.init(jax.random.PRNGKey(k), x)['params'])
    params['bias'] = rng.standard_normal(8).astype(np.float32) * 0.1

    def j_fn(params, x):
        out, next_cache = jconv.apply({'params': params}, x, time_cache=cache,
                                      return_time_cache=True)
        return (out * np.linspace(-1, 1, 8, dtype=np.float32)).sum(), (out, next_cache)

    if k == 3:
        (_, (j_out, j_cache)), (j_grads, j_xgrad) = jax.jit(jax.value_and_grad(
            j_fn, argnums=(0, 1), has_aux=True))(params, x)
    else:
        j_out, j_cache = jax.jit(j_fn)(params, x)[1]
    tconv = CausalDepthwiseConv3d(8, k, device='cpu')
    tconv.load_state_dict(flax_params_to_torch(params, tconv))
    tx = T(x.copy()).requires_grad_()
    out, next_cache = tconv(tx, time_cache=None if cache is None else T(cache),
                            return_time_cache=True)
    (out * torch.linspace(-1, 1, 8)).sum().backward()
    close(j_out, out, 1e-5, 1e-5)
    close(j_cache, next_cache, 1e-6, 0)
    assert next_cache.shape == (2, k - 1, 5, 6, 8)
    if k != 3:
        return
    close(j_xgrad, tx.grad, 1e-5, 1e-5)
    want = flax_params_to_torch(j_grads, tconv)
    for name, p in tconv.named_parameters():
        close(want[name], p.grad, 1e-5, 1e-5, err_msg=name)


# --------------------------------------------------------------------- SPT

@pytest.mark.parametrize('channels', [3, 6])
@pytest.mark.parametrize('temporal_shift', [True, False])
def test_shifted_patch_tokenization_matches_jax(temporal_shift, channels):
    """Tokens, the cache (the last frame) and every gradient; with the
    temporal shift also a call continuing from a given cache."""
    rng = np.random.default_rng(channels)
    video = rng.random((2, 3, 8, 12, channels)).astype(np.float32)
    prev = rng.random((2, 1, 8, 12, channels)).astype(np.float32)
    jspt = JSPT(dim=16, patch_size=4, channels=channels, temporal_shift=temporal_shift)
    params = jax.tree.map(np.asarray, jspt.init(jax.random.PRNGKey(0), video)['params'])
    tspt = ShiftedPatchTokenization(16, 4, channels=channels, temporal_shift=temporal_shift,
                                    device='cpu')
    tspt.load_state_dict(flax_params_to_torch(params, tspt))
    weights = np.linspace(-1, 1, 16, dtype=np.float32)
    for time_cache in ((None, prev) if temporal_shift else (None,)):
        def j_fn(params, video):
            out, cache = jspt.apply({'params': params}, video, time_cache=time_cache,
                                    return_time_cache=True)
            return (out * weights).sum(), (out, cache)

        (_, (j_out, j_cache)), (j_grads, j_vgrad) = jax.jit(jax.value_and_grad(
            j_fn, argnums=(0, 1), has_aux=True))(params, video)
        tspt.zero_grad()
        tv = T(video.copy()).requires_grad_()
        out, cache = tspt(tv, time_cache=None if time_cache is None else T(time_cache),
                          return_time_cache=True)
        (out * T(weights)).sum().backward()
        assert out.shape == (2, 3, 2, 3, 16)
        close(j_out, out, 1e-5, 1e-5)
        if temporal_shift:
            close(j_cache, cache, 0, 0)
        else:
            assert cache is None and j_cache is None
        close(j_vgrad, tv.grad, 1e-5, 1e-5)
        want = flax_params_to_torch(j_grads, tspt)
        for name, p in tspt.named_parameters():
            close(want[name], p.grad, 1e-5, 1e-5, err_msg=name)


# --------------------------------------------------------------- loss ops

def j_loss_op(case, x, key, mask):
    if case == 'sigreg':
        return jlosses.sigreg(key, x[None], num_slices=32)
    if case == 'sigreg_masked':
        return jlosses.sigreg(key, x[None], num_slices=32, mask=mask[None])
    if case == 'decorrelation':
        return jlosses.decorrelation_loss(key, x, 0.3)
    return jutils.orthogonal_loss(x)


def t_loss_op(case, x, mask):
    if case == 'sigreg':
        return losses_module.sigreg(x[None], num_slices=32)
    if case == 'sigreg_masked':
        return losses_module.sigreg(x[None], num_slices=32, mask=mask[None])
    if case == 'decorrelation':
        return losses_module.decorrelation_loss(x, 0.3)
    return orthogonal_loss(x)


@pytest.mark.parametrize('case', ['sigreg', 'sigreg_masked', 'decorrelation', 'orthogonal'])
def test_loss_ops_match_jax(case, monkeypatch):
    """sigreg (its slices replayed; with a mask over rows), the
    decorrelation loss (its permutation replayed) and the orthogonality
    loss: values and gradients."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 4, 6)).astype(np.float32)
    mask = rng.random((3, 5, 4)) < 0.7
    draws = Draws()

    def j_fn(x):
        with draws.recording() as values:
            loss = j_loss_op(case, x, jax.random.PRNGKey(5), mask)
        return loss, values

    (j_val, values), j_grad = jax.jit(jax.value_and_grad(j_fn, has_aux=True))(x)
    draw = replay(draws.records(values))
    monkeypatch.setattr(losses_module, 'draw', draw)
    tx = T(x.copy()).requires_grad_()
    val = t_loss_op(case, tx, T(mask))
    val.backward()
    assert draw.remaining == [] and float(val) > 0
    close(j_val, val, 1e-5, 1e-5)
    close(j_grad, tx.grad, 1e-5, 1e-5)


# ------------------------------------------------------------------- LPIPS

@functools.cache
def _jax_vgg(seed=7):
    return jax.tree.map(np.asarray, j_init_lpips(jax.random.PRNGKey(seed))[1])


def port_vgg(params):
    vgg = VGG16Features(device='cpu')
    vgg.load_state_dict(flax_params_to_torch(params, vgg))
    return vgg.requires_grad_(False)


@pytest.fixture(scope='module')
def vgg_npz(tmp_path_factory):
    """A torchvision-layout VGG16 npz of seeded weights (features.N.weight,
    OIHW), scaled as He-normal so the features stay O(1)."""
    path = tmp_path_factory.mktemp('vgg') / 'vgg16.npz'
    rng = np.random.default_rng(0)
    arrays, dim_in, layer = {}, 3, 0
    for out_ch, n_convs in lpips_module.VGG16_PLAN:
        for _ in range(n_convs):
            arrays[f'features.{layer}.weight'] = (rng.standard_normal((out_ch, dim_in, 3, 3))
                                                  * np.sqrt(2.0 / (9 * dim_in))).astype(np.float32)
            arrays[f'features.{layer}.bias'] = (rng.standard_normal(out_ch) * 0.01).astype(
                np.float32)
            dim_in, layer = out_ch, layer + 2
        layer += 1
    np.savez(path, **arrays)
    return str(path)


def test_vgg16_features_match_jax():
    """The flax trunk's HWIO kernels through the converter: every stage's
    features of the same images."""
    params = _jax_vgg()['params']
    x = np.random.default_rng(0).random((2, 16, 16, 3)).astype(np.float32)
    want = jax.jit(lambda x: JVGG16Features().apply({'params': params}, x))(x)
    with torch.no_grad():
        got = port_vgg(params)(T(x))
    assert [tuple(f.shape) for f in got] == [(2, 64, 16, 16), (2, 128, 8, 8), (2, 256, 4, 4),
                                             (2, 512, 2, 2), (2, 512, 1, 1)]
    for w, g in zip(want, got):
        close(np.transpose(np.asarray(w), (0, 3, 1, 2)), g, 1e-5, 1e-4)


def test_load_vgg16_npz_and_init_lpips_match_jax(vgg_npz):
    """One seeded npz loaded by both packages gives the same trunk;
    `init_lpips` without a file gives a frozen float32 trunk from its seed."""
    path = vgg_npz
    jvars = j_load_vgg16_npz(path)
    state = load_vgg16_npz(path)
    for name, want in flax_params_to_torch(jvars['params'], port_vgg(_jax_vgg()['params'])).items():
        assert torch.equal(state[name], want), name
    module = init_lpips(0, weights_path=path, device='cpu')
    assert not any(p.requires_grad for p in module.parameters()) and not module.training
    assert torch.equal(module.conv_12.weight, state['conv_12.weight'])
    a, b = init_lpips(3, device='cpu'), init_lpips(3, device='cpu')
    assert all(torch.equal(p, q) and p.dtype == torch.float32
               for p, q in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.conv_0.weight, init_lpips(4, device='cpu').conv_0.weight)


@pytest.mark.parametrize('with_lens', [False, True])
def test_lpips_loss_matches_jax(with_lens, monkeypatch, vgg_npz):
    """The loss and its gradient to the prediction, the frames drawn
    (within `time_lens` when given) replayed; the target gets none."""
    params = j_load_vgg16_npz(vgg_npz)['params']
    rng = np.random.default_rng(1)
    pred = rng.random((3, 4, 16, 16, 3)).astype(np.float32)
    target = rng.random((3, 4, 16, 16, 3)).astype(np.float32)
    lens = np.array([4, 1, 2], np.int32) if with_lens else None
    draws = Draws()

    def j_fn(pred):
        with draws.recording() as values:
            loss = j_lpips_loss(JVGG16Features(), {'params': params}, pred, jnp.asarray(target),
                                jax.random.PRNGKey(2), sampled_frames=2,
                                time_lens=None if lens is None else jnp.asarray(lens))
        return loss, values

    (j_val, values), j_grad = jax.jit(jax.value_and_grad(j_fn, has_aux=True))(pred)
    records = draws.records(values)
    assert [n for n, _ in records] == ['randint', 'uniform' if with_lens else 'randint']
    draw = replay(records)
    monkeypatch.setattr(lpips_module, 'draw', draw)
    tpred, ttarget = T(pred.copy()).requires_grad_(), T(target.copy()).requires_grad_()
    val = lpips_loss(port_vgg(params), tpred, ttarget, sampled_frames=2,
                     time_lens=None if lens is None else T(lens))
    val.backward()
    assert draw.remaining == [] and float(val) > 0 and ttarget.grad is None
    close(j_val, val, 1e-5, 1e-5)
    close(j_grad, tpred.grad, 1e-6, 1e-4)


# --------------------------------------------------------------- tokenizer

# the options that change the parameters' shapes; one JAX initialization per
# setting of them, with every loss module on, serves every configuration
# with that setting, which takes the modules it has
SHAPE_OPTIONS = ('use_causal_conv3d', 'use_shifted_patch_tokenization', 'spt_temporal_shift',
                 'encode_temporal_diff')
ALL_LOSSES = dict(encoder_add_decorr_aux_loss=True, latent_ortho_loss_weight=0.1,
                  latent_sigreg_loss_weight=0.1)


@functools.lru_cache(maxsize=None)
def _jax_variables(shape_options=()):
    jm = JTokenizer(**OPT, **dict(shape_options), **ALL_LOSSES)
    init = jax.jit(lambda rngs: jm.init(rngs, jnp.zeros((1, 3, 2, 16, 16))))
    variables = init({'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)})
    return jax.tree.map(np.asarray, variables)


def build_pair(**options):
    cfg = {**OPT, **options}
    jm = JTokenizer(**cfg)
    tm = VideoTokenizer(**cfg, device='cpu')
    full = _jax_variables(tuple(sorted((k, v) for k, v in options.items()
                                       if k in SHAPE_OPTIONS)))
    modules = {name.split('.')[0] for name in tm.state_dict()}
    variables = {'params': {k: v for k, v in full['params'].items() if k in modules},
                 'state': {k: v for k, v in full['state'].items() if k in modules}}
    tm.load_state_dict(flax_params_to_torch(variables['params'], tm,
                                            state=variables['state']))
    return jm, variables, tm


def jax_lpips_fn(params):
    module = JVGG16Features()
    return lambda recon, clean, key, lens: j_lpips_loss(module, {'params': params}, recon,
                                                        clean, key, time_lens=lens)


def port_lpips_fn(params):
    module = port_vgg(params)
    return lambda recon, clean, gen, lens: lpips_loss(module, recon, clean, generator=gen,
                                                      time_lens=lens)


def jax_training(jm, variables, lpips_fn=None):
    """A function (video, time_lens, key) -> the JAX training forward's
    value, losses, new state and gradients at `variables`, and the draws
    it made; calls at the same shapes share one compile."""
    draws = Draws()

    def j_loss(params, video, time_lens, key):
        with draws.recording() as values:
            (loss, interm), new_vars = jm.apply(
                {'params': params, 'state': variables.get('state', {})}, video,
                time_lens=time_lens, return_intermediates=True, lpips_fn=lpips_fn,
                rngs={'sample': key}, mutable=['state'])
        return loss, (interm.losses, new_vars.get('state', {}), values)

    step = jax.jit(jax.value_and_grad(j_loss, has_aux=True))

    def run(video, time_lens, key):
        (total, (losses, new_state, values)), grads = step(variables['params'], video,
                                                           jnp.asarray(time_lens), key)
        return total, losses, new_state, grads, draws.records(values)

    return run


def assert_states_close(j_state, tm):
    assert j_state, 'the JAX model has no normalizer state'
    for name, leaves in j_state.items():
        close(leaves['exp_avg_sq'], getattr(tm, name).exp_avg_sq, 0, 1e-5, err_msg=name)


# case: (options, LPIPS on); each option of this slice on its own, then
# all of them with and without the loss normalization
LOSS_CASES = {
    'conv': (dict(use_causal_conv3d=True), False),
    'spt': (dict(use_shifted_patch_tokenization=True), False),
    'spt_diff': (dict(use_shifted_patch_tokenization=True, spt_temporal_shift=False,
                      encode_temporal_diff=True), False),
    'decorr': (dict(encoder_add_decorr_aux_loss=True, decorr_sample_frac=0.5), False),
    'ortho_sigreg': (dict(latent_ortho_loss_weight=0.1, latent_sigreg_loss_weight=0.1,
                          latent_sigreg_num_slices=16), False),
    'lpips': (dict(), True),
    'all_unnormalized': (dict(RECIPE, encoder_add_decorr_aux_loss=True,
                              latent_ortho_loss_weight=0.1, latent_sigreg_loss_weight=0.1,
                              latent_sigreg_num_slices=16, use_loss_normalization=False), True),
}


@pytest.mark.parametrize('case', list(LOSS_CASES))
def test_tokenizer_option_losses_and_grads_match_jax(case, monkeypatch):
    options, use_lpips = LOSS_CASES[case]
    jm, variables, tm = build_pair(**options)
    video, time_lens = make_video(1), np.array([3, 2], np.int32)
    vgg = _jax_vgg()['params']
    j_total, j_losses, j_state, j_grads, records = jax_training(
        jm, variables, lpips_fn=jax_lpips_fn(vgg) if use_lpips else None)(
        video, time_lens, jax.random.PRNGKey(7))

    draw = replay_draws(monkeypatch, records)
    t_total, interm = tm(T(video), time_lens=T(time_lens), return_intermediates=True,
                         lpips_fn=port_lpips_fn(vgg) if use_lpips else None)
    t_total.backward()
    assert draw.remaining == []

    close(j_total, t_total, 1e-5, 1e-5)
    on = [f for f in TokenizerLosses._fields if float(getattr(j_losses, f)) != 0.0]
    for field in TokenizerLosses._fields:
        close(getattr(j_losses, field), getattr(interm.losses, field), 1e-5, 1e-5,
              err_msg=field)
    expected_on = {'recon', *(['lpips'] if use_lpips else [])}
    expected_on |= {'time_decorr', 'space_decorr'} if options.get(
        'encoder_add_decorr_aux_loss') else set()
    expected_on |= {n for n in ('latent_ortho', 'latent_sigreg') if options.get(f'{n}_loss_weight')}
    assert set(on) == expected_on
    if tm.use_loss_normalization:
        # the LPIPS normalizer exists at the default weight, used or not
        assert_states_close(j_state, tm)
        assert {n for n, _ in tm.named_buffers()} == {f'{n}_loss_normalizer.exp_avg_sq'
                                                      for n in expected_on | {'lpips'}}
    want = flax_params_to_torch(j_grads, tm)
    for name, p in tm.named_parameters():
        assert rel_l2(want[name].numpy(), grad_of(p).numpy()) <= 1e-3, name


# ------------------------------------------------------------- streaming

def test_streaming_encode_through_four_caches_matches_parallel_and_jax():
    """Frame by frame through the four cache parts (the SPT frame, the
    pre-conv and post-conv frames, the trunk's KV cache) equals the parallel
    encode, in the port and in JAX, whose caches the port's parts equal."""
    jm, variables, tm = build_pair(**RECIPE)
    video = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (1, 3, 4, 16, 16)))
    j_parallel = jax.jit(lambda v: jm.apply(variables, v, return_latents=True))(video)
    with torch.no_grad():
        parallel = tm.encode(T(video))
    close(j_parallel, parallel, 2e-5, 1e-4)

    j_first = jax.jit(lambda f: jm.apply(variables, f, method=jm.encode, max_time=4,
                                         return_cache=True))
    j_next = jax.jit(lambda f, c: jm.apply(variables, f, method=jm.encode, cache=c,
                                           return_cache=True))
    j_cache = cache = None
    frames = []
    for i in range(4):
        frame = video[:, :, i:i + 1]
        kw = dict(max_time=4) if cache is None else {}
        j_latents, j_cache = j_first(frame) if j_cache is None else j_next(frame, j_cache)
        with torch.no_grad():
            latents, cache = tm.encode(T(frame.copy()), return_cache=True, cache=cache, **kw)
        assert isinstance(cache, TokenizerCache)
        assert cache.spt.shape == (1, 1, 16, 16, 3)
        assert cache.pre_conv.shape == cache.post_conv.shape == (1, 2, 4, 4, 32)
        assert cache.transformer.token_count == i + 1
        close(j_latents, latents, 2e-5, 1e-4)
        for part in ('spt', 'pre_conv', 'post_conv'):
            close(getattr(j_cache, part), getattr(cache, part), 2e-5, 1e-4, err_msg=part)
        frames.append(latents)
    close(parallel, torch.cat(frames, dim=1), 2e-5, 1e-4)


# ----------------------------------------------------------- consistency

def test_latent_consistency_matches_jax_and_spares_the_encoder(monkeypatch):
    """The term's value and every gradient against JAX (through the
    reconstruction the gradient reaches the decoder, and the encoder only
    through the latents the decoder read); from the re-encode itself the
    encoder gets none: with the reconstruction as a leaf, no parameter
    gets a gradient and the reconstruction does."""
    jm, variables, tm = build_pair(**RECIPE, latent_consistency_loss_weight=0.1)
    video, time_lens = make_video(2), np.array([3, 2], np.int32)
    key = jax.random.PRNGKey(3)
    draws = Draws()

    def j_lc(params):
        v = {'params': params, 'state': variables['state']}
        with draws.recording() as values:
            (_, interm), _ = jm.apply(v, video, time_lens=time_lens, return_intermediates=True,
                                      rngs={'sample': key}, mutable=['state'])
        lc = j_latent_consistency_loss(jm, v, interm.recon, interm.latents, time_lens=time_lens)
        return lc, values

    (j_val, values), j_grads = jax.jit(jax.value_and_grad(j_lc, has_aux=True))(
        variables['params'])
    draw = replay_draws(monkeypatch, draws.records(values))
    _, interm = tm(T(video), time_lens=T(time_lens), return_intermediates=True)
    lc = latent_consistency_loss(tm, interm.recon, interm.latents, time_lens=T(time_lens))
    lc.backward()
    assert draw.remaining == [] and float(lc) > 0
    close(j_val, lc, 1e-6, 1e-5)
    want = flax_params_to_torch(j_grads, tm)
    for name, p in tm.named_parameters():
        assert rel_l2(want[name].numpy(), grad_of(p).numpy()) <= 1e-3, name
    assert all(bool(p.grad.abs().sum() > 0) for n, p in tm.named_parameters()
               if n.startswith('decoder.transformer.') and n.endswith('to_out.weight'))

    tm.zero_grad(set_to_none=True)
    recon = interm.recon.detach().requires_grad_()
    latent_consistency_loss(tm, recon, interm.latents).backward()
    assert all(p.grad is None for p in tm.parameters())
    assert float(recon.grad.abs().sum()) > 0


# ----------------------------------------------------------------- trainer

def test_tokenizer_trainer_every_option_two_steps_match_jax(monkeypatch, vgg_npz):
    """Two `TokenizerTrainer` steps with every option of this slice on: the
    recipe's conv3d and SPT, LPIPS from one npz (`lpips_weights_path`),
    both decorrelations, ortho, sigreg, latent consistency and the loss
    normalization; losses, parameters, EMA and every normalizer against
    the JAX trainer. The LPIPS trunk is not among the tokenizer's
    parameters."""
    f32_newton_schulz(monkeypatch)
    options = dict(RECIPE, encoder_add_decorr_aux_loss=True, latent_ortho_loss_weight=0.1,
                   latent_sigreg_loss_weight=0.1, latent_sigreg_num_slices=16,
                   latent_consistency_loss_weight=0.1)
    jm, variables, tm = build_pair(**options)
    # the LPIPS normalizer's state as flax makes it at its first use (ones),
    # so the JAX train step keeps one state structure and compiles once
    variables['state']['lpips_loss_normalizer'] = {'exp_avg_sq': np.ones(1, np.float32)}
    path = vgg_npz
    videos = [make_video(10 + i) for i in range(2)]
    lens = np.array([3, 2], np.int32)
    kw = dict(learning_rate=3e-4, clip_grad_norm=1.0, with_ema=True, ema_decay=0.9, seed=1,
              use_lpips=True, lpips_weights_path=path)

    jtrainer = JTokenizerTrainer(jm, variables, **kw)
    keys, j_step = [], jtrainer._train_step
    jtrainer._train_step = lambda ts, v, tl, key, **k: keys.append(key) or j_step(ts, v, tl,
                                                                                   key, **k)
    j_out = [jtrainer.train_on_batch(v, lens) for v in videos]
    run = jax_training(jm, variables, lpips_fn=jax_lpips_fn(j_load_vgg16_npz(path)['params']))
    steps = [run(v, lens, key) for key, v in zip(keys, videos)]
    records = [r for step in steps for r in step[4]]

    draw = replay_draws(monkeypatch, records)
    trainer = TokenizerTrainer(tm, **kw, device='cpu')
    assert trainer.lpips is not None
    assert not set(map(id, trainer.lpips.parameters())) & set(map(id, tm.parameters()))
    t_out = [trainer.train_on_batch(T(v), T(lens)) for v in videos]
    assert draw.remaining == [] and trainer.ts.step == int(jtrainer.ts.step) == 2

    for (jl, jls), (tl, tls) in zip(j_out, t_out):
        close(jl, tl, 1e-5, 1e-5)
        for field in TokenizerLosses._fields:
            close(getattr(jls, field), getattr(tls, field), 1e-5, 1e-5, err_msg=field)
        assert all(float(getattr(tls, f)) != 0 for f in (
            'recon', 'lpips', 'time_decorr', 'space_decorr', 'latent_ortho', 'latent_sigreg'))
    assert_states_close(jtrainer.ts.state, tm)
    small_grad = {n: np.abs(g.numpy()) < 1e-7
                  for n, g in flax_params_to_torch(steps[0][3], tm).items()}
    for tree, got in ((jtrainer.ts.params, dict(tm.named_parameters())),
                      (jtrainer.ts.ema_params, trainer.ts.ema_params)):
        for name, want in flax_params_to_torch(tree, tm).items():
            diff = np.abs(want.numpy() - got[name].detach().numpy())
            assert not (diff[~small_grad[name]] > 1e-5).any(), name
            assert (diff <= 7e-4).all(), name


def test_conv_spt_tokenizer_checkpoint_round_trip(tmp_path):
    """A conv3d + SPT tokenizer with every loss option saves and loads with
    its config, parameters and normalizers, and encodes the same."""
    torch.manual_seed(0)
    tm = VideoTokenizer(**OPT, **RECIPE, causal_conv3d_kernel_size=5,
                        encoder_add_decorr_aux_loss=True, latent_sigreg_loss_weight=0.1,
                        latent_ortho_loss_weight=0.1, latent_consistency_loss_weight=0.1,
                        device='cpu')
    tm(T(make_video(5)), generator=torch.Generator().manual_seed(0))   # moves the normalizers
    checkpoint.save_model(tmp_path / 'tok', tm)
    loaded = checkpoint.load_model(tmp_path / 'tok', VideoTokenizer, device='cpu')
    assert loaded.config == tm.config
    state = loaded.state_dict()
    assert set(state) == set(tm.state_dict())
    for name, t in tm.state_dict().items():
        assert torch.equal(t, state[name]), name
    video = T(make_video(6))
    with torch.no_grad():
        assert torch.equal(tm.encode(video), loaded.encode(video))


# ------------------------------------------------------------ world model

def test_world_model_loss_normalization_two_steps_match_jax(monkeypatch):
    """`use_loss_normalization`: two `BehaviorCloneTrainer` steps (seed 1: a
    shortcut step, then a plain one) against JAX, with the losses and every
    gradient of the first step's training forward and the normalizers'
    buffers after one forward and after both steps. The init batch has no
    continuous actions, so that normalizer has no JAX state: its buffer
    keeps its ones."""
    f32_newton_schulz(monkeypatch)
    cfg = {**WM_SMALL, 'depth': 2, 'use_loss_normalization': True}
    jm = JWorldModel(**cfg)
    init = jax.jit(lambda rngs: jm.init(
        rngs, latents=jnp.zeros((2, 3, 4, 8)), shortcut_train=False,
        rewards=jnp.zeros((2, 3)), terminals=jnp.zeros((2,), bool),
        discrete_actions=jnp.zeros((2, 2, 1), jnp.int32)))
    variables = jax.tree.map(np.asarray, init({'params': jax.random.PRNGKey(0),
                                               'sample': jax.random.PRNGKey(1)}))
    assert set(variables['state']) == {'flow_loss_normalizer', 'shortcut_loss_normalizer',
                                       'reward_loss_normalizer', 'terminal_loss_normalizer',
                                       'discrete_actions_loss_normalizer'}
    tm = DynamicsWorldModel(**cfg, device='cpu')
    tm.load_state_dict(flax_params_to_torch(variables['params'], tm, state=variables['state']))
    assert torch.equal(tm.continuous_actions_loss_normalizer.exp_avg_sq, torch.ones(2))

    batches = [wm_batch(10 + i, b=2, t=5, lens=[5, 4]) for i in range(2)]
    kw = dict(learning_rate=3e-4, clip_grad_norm=1.0, with_ema=True, ema_decay=0.9, seed=1)
    jtrainer = JBehaviorCloneTrainer(jm, variables, **kw)
    calls, j_step = [], jtrainer._train_step

    def spy(ts, batch, key, shortcut_train):
        calls.append((key, shortcut_train))
        return j_step(ts, batch, key, shortcut_train=shortcut_train)

    jtrainer._train_step = spy
    j_out = [jtrainer.train_on_batch(b) for b in batches]
    assert [c[1] for c in calls] == [True, False]

    def jax_forward(batch, key, shortcut, grads):
        draws = Draws()

        def j_loss(params):
            with draws.recording() as values:
                (loss, losses, _), new_vars = jm.apply(
                    {'params': params, 'state': variables['state']}, **batch,
                    shortcut_train=shortcut, return_intermediates=True, rngs={'sample': key},
                    mutable=['state'])
            return loss, (losses, new_vars['state'], values)

        fn = jax.value_and_grad(j_loss, has_aux=True) if grads else lambda p: (j_loss(p), None)
        (loss, (losses, new_state, values)), g = jax.jit(fn)(variables['params'])
        return loss, losses, new_state, g, draws.records(values)

    # the first step's training forward from the initial weights and state
    j_total, j_losses, j_state, j_grads, first = jax_forward(batches[0], calls[0][0], True, True)
    draw = replay_wm_draws(first)
    monkeypatch.setattr(world_model_module, 'draw', draw)
    t_total, t_losses, _ = tm(**wm_to_torch(batches[0]), shortcut_train=True,
                              return_intermediates=True)
    t_total.backward()
    assert draw.remaining == [] and float(t_losses.shortcut) > 0
    close(j_total, t_total, 2e-5, 1e-4)
    for field in WorldModelLosses._fields:
        close(getattr(j_losses, field), getattr(t_losses, field), 2e-5, 1e-4, err_msg=field)
    want = flax_params_to_torch(j_grads, tm)
    for name, p in tm.named_parameters():
        close(want[name], grad_of(p), 2e-5, 1e-3, err_msg=name)
    assert_states_close(j_state, tm)

    # the two trainer steps from the initial weights and state
    tm.load_state_dict(flax_params_to_torch(variables['params'], tm, state=variables['state']))
    tm.zero_grad(set_to_none=True)
    second = jax_forward(batches[1], calls[1][0], False, False)[4]
    draw = replay_wm_draws(first + second)
    monkeypatch.setattr(world_model_module, 'draw', draw)
    trainer = BehaviorCloneTrainer(tm, **kw, device='cpu')
    t_out = [trainer.train_on_batch(wm_to_torch(b)) for b in batches]
    assert draw.remaining == [] and trainer.ts.step == 2
    for (jl, jls), (tl, tls) in zip(j_out, t_out):
        close(jl, tl, 2e-5, 1e-4)
        for field in WorldModelLosses._fields:
            close(getattr(jls, field), getattr(tls, field), 2e-5, 1e-4, err_msg=field)
    assert_states_close(jtrainer.ts.state, tm)
    small_grad = {n: np.abs(g.numpy()) < 1e-7 for n, g in want.items()}
    for name, want_p in flax_params_to_torch(jtrainer.ts.params, tm).items():
        diff = np.abs(want_p.numpy() - tm.get_parameter(name).detach().numpy())
        assert not (diff[~small_grad[name]] > 1e-5).any(), name
        assert (diff <= 7e-4).all(), name


_WM_DRAW_OF = {'step_sizes_log2': 'randint', 'signal_levels': 'randint', 'noise': 'normal',
               'reward_keep': 'bernoulli'}


def replay_wm_draws(records):
    """A `draw` for the port's world model handing out `records` in order."""
    queue = list(records)

    def draw(kind, shape, *, generator, device, low=0, high=0, prob=0.0):
        name, x = queue.pop(0)
        assert name == _WM_DRAW_OF[kind] and x.shape == tuple(shape), (kind, name, x.shape)
        out = torch.from_numpy(np.array(x))
        return (out.long() if name == 'randint' else out).to(device)

    draw.remaining = queue
    return draw


# ---------------------------------------------------------------- ActorSPR

@pytest.mark.parametrize('masked', [False, True])
def test_actor_spr_sigreg_matches_jax(masked, monkeypatch):
    """`ActorSPR` with `sigreg_loss_weight`: the SPR and sigreg terms and
    every gradient, the slices replayed, over a mask that ends rows early."""
    rng = np.random.default_rng(4)
    b, t, dim, da = 3, 6, 12, 8
    embed = rng.standard_normal((b, t, dim)).astype(np.float32)
    actions = rng.standard_normal((b, t, da)).astype(np.float32)
    mask = np.arange(t)[None] < np.array([[6], [4], [2]]) if masked else None
    jspr = JActorSPR(dim=dim, num_rollouts=2, sigreg_loss_weight=0.5)
    rngs = {'params': jax.random.PRNGKey(1), 'sample': jax.random.PRNGKey(2)}
    params = jax.tree.map(np.asarray, jspr.init(rngs, jnp.zeros((1, t, dim)),
                                                jnp.zeros((1, t, da)))['params'])
    draws = Draws()

    def j_loss(params, embed):
        with draws.recording() as values:
            total, parts = jspr.apply({'params': params}, embed, actions, mask=mask,
                                      rngs={'sample': jax.random.PRNGKey(3)})
        return total, (parts, values)

    (j_total, (j_parts, values)), (j_grads, j_embed_grad) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(params, embed)
    draw = replay(draws.records(values))
    monkeypatch.setattr(losses_module, 'draw', draw)
    tspr = ActorSPR(dim, num_rollouts=2, sigreg_loss_weight=0.5, dim_action_embed=da,
                    device='cpu')
    tspr.load_state_dict(flax_params_to_torch(params, tspr))
    t_embed = T(embed.copy()).requires_grad_()
    total, parts = tspr(t_embed, T(actions), mask=None if mask is None else T(mask))
    total.backward()
    assert draw.remaining == [] and float(parts[2]) > 0
    close(j_total, total, 1e-5, 1e-5)
    for j, g in zip(j_parts, parts):
        close(j, g, 1e-5, 1e-5)
    close(j_embed_grad, t_embed.grad, 1e-5, 1e-5)
    want = flax_params_to_torch(j_grads, tspr)
    for name, p in tspr.named_parameters():
        close(want[name], p.grad, 1e-5, 1e-5, err_msg=name)
