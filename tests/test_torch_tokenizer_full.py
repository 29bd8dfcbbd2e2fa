"""The tokenizer's remaining options, PoPE and MOSS in the trunk, and the
SUGAR gradient's users, in the port against the JAX package at float32 on
the CPU: `l1norm`, `SlotAttention`, `PoPE`, `AxialPoPE`, `MOSS`, the trunk
with time and space PoPE and MOSS on the plain and the small path (K4's
plain version), parallel and cached; the tokenizer with the latent init
patch, slot attention in the encoder and the decoder, the separate flow
decoder, Beta flow times, aug conditioning, BYOL with SEM and the latent AR
loss, each alone and all together (losses, every gradient, encode with
each kind of aug id and the pre-bottleneck hiddens, decode through the
flow decoder, the streaming encode, `latent_disagreement`); two
`TokenizerTrainer` steps with BYOL and the flow decoder, then a resume; the
world model with time PoPE; the converter; and one fault of the JAX
package.

The tokenizer is small (dim 32, 2 heads x 16, 16 x 16 RGB, patch 4, 4
latents of 8, an encoder and a decoder of a space and a time layer each, 2
flow steps). Both packages get the JAX model's weights, converted. The JAX
draws (`uniform` mask rates, `bernoulli` patch masks and aug dropout,
`normal` sigreg slices and noise, `randint` flow steps, the two `gamma`
draws of a Beta) are recorded while a jitted JAX function is traced, by
wrapping `jax.random`, and replayed in order into the port's
`models.tokenizer.draw` and `ops.losses.draw`; a Beta draw is replayed as
the ratio of its two gammas, as the JAX package forms it.

The JAX tokenizer cannot be initialized with a separate flow decoder whose
trunk has MOSS layers (its init runs the flow decoder on a one-patch frame,
which the MOSS grid does not fit; pinned below), so a JAX model with the
flow decoder takes the parameters of one initialized without it, its
`flow_decoder` a perturbed copy of its `decoder`.

Tolerances, all float32:
  - l1norm, slot attention, PoPE, AxialPoPE, MOSS: values 1e-5 absolute and
    1e-5 relative, every gradient 1e-5 absolute and 1e-4 relative (a few
    small layers);
  - the trunk, parallel and cached: 2e-5 absolute and 1e-4 relative on
    values (tests/test_torch_transformer.py's), gradients 2e-5 absolute
    and 1e-3 relative;
  - the tokenizer's losses 2e-5 absolute and 1e-5 relative, every gradient
    within 1e-3 relative L2 distance of the JAX one
    (tests/test_torch_tokenizer.py's), encode, decode and stream 2e-5
    absolute and 1e-4 relative (tests/test_tokenizer_features.py's);
  - trainer steps: losses as above, parameters and EMA 1e-5 except where
    the first Adam-atan2 step sees a gradient within rounding of zero
    (tests/test_torch_train.py); save and resume: exact;
  - the world model with PoPE: losses 2e-5 / 1e-4, gradients 2e-5 / 1e-3,
    `generate`'s latents 2e-4 (tests/test_torch_wm_options.py's).
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tokenizer import f32_newton_schulz, rel_l2
from test_torch_wm_options import build_pair as wm_build_pair
from test_torch_wm_options import close_grad
from test_torch_generate import jax_draws
from test_torch_wm_options import jax_training_forward as wm_jax_training_forward
from test_torch_wm_options import make_batch as wm_make_batch
from test_torch_wm_options import port_training_forward as wm_port_training_forward
from test_torch_wm_options import to_torch
from dreamer4_tpu.models.generate import generate as jgenerate
from dreamer4_tpu.models.tokenizer import VideoTokenizer as JTokenizer
from dreamer4_tpu.models.transformer import AxialSpaceTimeTransformer as JTrunk
from dreamer4_tpu.nn.moss import MOSS as JMOSS
from dreamer4_tpu.nn.pope import PoPE as JPoPE
from dreamer4_tpu.nn.pope import AxialPoPE as JAxialPoPE
from dreamer4_tpu.nn.slot_attention import SlotAttention as JSlotAttention
from dreamer4_tpu.ops import utils as jutils
from dreamer4_tpu.train.trainers import TokenizerTrainer as JTokenizerTrainer
from dreamer4_torch import TokenizerTrainer
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.models import generate as generate_module
from dreamer4_torch.models import tokenizer as tokenizer_module
from dreamer4_torch.models.generate import generate
from dreamer4_torch.models.tokenizer import TokenizerLosses, VideoTokenizer
from dreamer4_torch.models.transformer import AxialSpaceTimeTransformer
from dreamer4_torch.models.world_model import WorldModelLosses
from dreamer4_torch.nn.moss import MOSS
from dreamer4_torch.nn.pope import AxialPoPE, PoPE
from dreamer4_torch.nn.slot_attention import SlotAttention
from dreamer4_torch.ops import losses as losses_module
from dreamer4_torch.ops import small_attention as small_module
from dreamer4_torch.ops.utils import l1norm

torch.set_num_threads(1)
T = torch.from_numpy
OPT = dict(dim=32, dim_latent=8, patch_size=4, image_height=16, image_width=16,
           num_latent_tokens=4, encoder_depth=2, decoder_depth=2, time_block_every=2,
           attn_dim_head=16, attn_heads=2, decoder_flow_steps=2)
# every option of this slice at once
ALL = dict(latent_init_patch_size=2, slot_attention_initted_latents=True,
           decoder_slot_attention_initted_spatial_tokens=True, separate_flow_decoder=True,
           has_aug_conditioning=True, aug_cfg_dropout_prob=0.5, has_byol=True,
           byol_use_sem=True, latent_ar_loss_weight=0.1, latent_ar_num_slices=16,
           time_attention_use_pope=True, space_attention_use_pope=True,
           encoder_moss_layers=(1,), decoder_moss_layers=(1,))


def close(a, b, atol, rtol, err_msg=''):
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
    np.testing.assert_allclose(np.asarray(a), b, atol=atol, rtol=rtol, err_msg=err_msg)


def grad_of(p):
    return p.grad if p.grad is not None else torch.zeros_like(p)


def perturb(params, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: np.asarray(p) + scale * rng.standard_normal(
        np.shape(p)).astype(np.float32), params)


def module_pair(jmod, tmod, *args, seed=0, **kwargs):
    params = perturb(jmod.init(jax.random.PRNGKey(seed), *args, **kwargs)['params'], seed)
    tmod.load_state_dict(flax_params_to_torch(params, tmod))
    return params


def assert_grads(j_grads, tmod, atol=1e-5, rtol=1e-4):
    want = flax_params_to_torch(j_grads, tmod)
    for name, p in tmod.named_parameters():
        close(want[name], grad_of(p), atol, rtol, err_msg=name)


# ----------------------------------------------------------- draw replay

_JAX_DRAWS = ('uniform', 'bernoulli', 'randint', 'normal', 'permutation', 'gamma')
_PORT_DRAW_OF = {'mask_prob': 'uniform', 'patch_mask': 'bernoulli', 'aug_dropout': 'bernoulli',
                 'time_indices': 'randint', 'noise': 'normal', 'slices': 'normal',
                 'permutation': 'permutation'}


class Draws:
    """The draws a jitted JAX function makes through `jax.random`: their
    names, noted while it is traced, and their values, which the function
    returns from inside `recording()`."""

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
    """Hand `records` out in order to the tokenizer's and the losses'
    draws, checking the kind and shape of each; a Beta draw takes two
    gamma records, X / (X + Y)."""
    queue = list(records)

    def draw(kind, shape, *, generator, device, low=0.0, high=0.0, prob=None,
             concentration=None):
        if kind == 'flow_times':
            (na, ga), (nb, gb) = queue.pop(0), queue.pop(0)
            assert na == nb == 'gamma' and ga.shape == tuple(shape), (kind, na, nb)
            return torch.from_numpy(ga / (ga + gb)).to(device)
        name, x = queue.pop(0)
        assert name == _PORT_DRAW_OF[kind] and x.shape == tuple(shape), (kind, name, x.shape)
        out = torch.from_numpy(np.array(x))
        return (out.long() if name in ('randint', 'permutation') else out).to(device)

    draw.remaining = queue
    for module in (tokenizer_module, losses_module):
        monkeypatch.setattr(module, 'draw', draw)
    return draw


# ---------------------------------------------------------------- modules

def test_l1norm_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 5, 7)).astype(np.float32)
    x[1, 2] = 0.0                                  # the eps floor
    for axis in (-1, 1):
        close(jutils.l1norm(jnp.asarray(x), axis=axis), l1norm(T(x), dim=axis), 1e-6, 1e-6)


@pytest.mark.parametrize('inverted', [True, False])
@pytest.mark.parametrize('spatial_mix', [True, False])
def test_slot_attention_matches_jax(inverted, spatial_mix):
    """Two iterations over 5 slots reading 7 context tokens: values, every
    parameter's gradient and both inputs' gradients."""
    rng = np.random.default_rng(1)
    slots = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    context = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    w = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    kw = dict(dim=16, heads=2, dim_head=8, num_slots=5, spatial_mix=spatial_mix,
              inverted_attention=inverted)
    jmod, tmod = JSlotAttention(**kw), SlotAttention(**kw, device='cpu')
    params = module_pair(jmod, tmod, slots, context)
    fn = lambda p, s, c: (jmod.apply({'params': p}, s, c) * w).sum()
    j_val, j_grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2)))(params, slots, context)
    ts, tc = T(slots.copy()).requires_grad_(), T(context.copy()).requires_grad_()
    t_val = (tmod(ts, tc) * T(w)).sum()
    t_val.backward()
    close(j_val, t_val, 1e-5, 1e-5)
    assert_grads(j_grads[0], tmod)
    close(j_grads[1], ts.grad, 1e-5, 1e-4)
    close(j_grads[2], tc.grad, 1e-5, 1e-4)
    assert {n.split('.')[0] for n, _ in tmod.named_parameters()} == (
        {'attn', 'ff'} | ({'mixer_norm', 'mixer_down', 'mixer_up'} if spatial_mix else set()))


# (module, call arguments): the time table at an offset; the axial table
# with special tokens, at a head dim whose table fills it and at one that
# needs zero padding
POPE_CASES = {
    'pope': (lambda cls: cls[0](dim_head=16, heads=3), (5,), dict(offset=3)),
    'axial': (lambda cls: cls[1](dim_head=16, heads=2), (3, 4), dict(num_special=3)),
    'axial_padded': (lambda cls: cls[1](dim_head=18, heads=2), (2, 3), dict(num_special=2)),
}


@pytest.mark.parametrize('case', list(POPE_CASES))
def test_pope_tables_match_jax(case):
    make, args, kwargs = POPE_CASES[case]
    jmod, tmod = make((JPoPE, JAxialPoPE)), make((
        functools.partial(PoPE, device='cpu'), functools.partial(AxialPoPE, device='cpu')))
    params = module_pair(jmod, tmod, *args, **kwargs)
    assert all(p.dtype == torch.float32 for p in tmod.parameters())
    j_table = jmod.apply({'params': params}, *args, **kwargs)
    w = np.random.default_rng(2).standard_normal(j_table.shape).astype(np.float32)
    j_grads = jax.grad(lambda p: (jmod.apply({'params': p}, *args, **kwargs) * w).sum())(params)
    t_table = tmod(*args, **kwargs)
    (t_table * T(w)).sum().backward()
    close(j_table, t_table, 1e-5, 1e-5)
    assert_grads(j_grads, tmod)
    if 'num_special' in kwargs:
        assert not t_table[:, -kwargs['num_special']:].any()


def test_moss_matches_jax_in_parallel_and_streamed():
    """The parallel pass with every gradient, then the same frames one at a
    time through the conv's time cache, against the parallel pass and
    against JAX's streamed outputs and caches."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 3, 3, 16)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jmod, tmod = JMOSS(16), MOSS(16, device='cpu')
    params = module_pair(jmod, tmod, x)
    fn = lambda p, x: (jmod.apply({'params': p}, x) * w).sum()
    j_val, (j_grads, j_xgrad) = jax.jit(jax.value_and_grad(fn, argnums=(0, 1)))(params, x)
    tx = T(x.copy()).requires_grad_()
    t_out = tmod(tx)
    (t_out * T(w)).sum().backward()
    close(j_val, (t_out * T(w)).sum(), 1e-5, 1e-5)
    assert_grads(j_grads, tmod)
    close(j_xgrad, tx.grad, 1e-5, 1e-4)

    j_step = jax.jit(lambda f, c: jmod.apply({'params': params}, f, cache=c, return_cache=True))
    j_cache = jnp.zeros((2, 2, 3, 3, 16))
    cache, frames = None, []
    with torch.no_grad():
        for i in range(4):
            j_frame, j_cache = j_step(x[:, i:i + 1], j_cache)
            frame, cache = tmod(T(x[:, i:i + 1].copy()), cache=cache, return_cache=True)
            close(j_frame, frame, 1e-5, 1e-5)
            close(j_cache, cache, 1e-5, 1e-5)
            frames.append(frame)
    close(t_out.detach(), torch.cat(frames, dim=1), 2e-5, 1e-4)


MODULES = {'slot_attention': lambda **kw: SlotAttention(16, heads=2, dim_head=8, **kw),
           'pope': lambda **kw: PoPE(16, 2, **kw),
           'axial_pope': lambda **kw: AxialPoPE(16, 2, **kw),
           'moss': lambda **kw: MOSS(16, **kw)}


@pytest.mark.parametrize('name', list(MODULES))
def test_new_modules_default_to_the_card(name):
    """Each new public module is built on the card unless the caller asks
    for the CPU, and raises without a card rather than fall back."""
    make = MODULES[name]
    if torch.cuda.is_available():
        assert all(p.device.type == 'cuda' for p in make().parameters())
    else:
        with pytest.raises(RuntimeError):
            make()
    assert all(p.device.type == 'cpu' for p in make(device='cpu').parameters())


# ------------------------------------------------------------------ trunk

TRUNK = dict(dim=32, depth=2, attn_heads=2, attn_dim_head=16, time_block_every=2,
             num_special_tokens=2, time_attention_use_pope=True, space_attention_use_pope=True,
             space_height=3, space_width=3, spatial_module_layers=(0, 1))


@pytest.mark.parametrize('small', [False, True])
def test_trunk_with_pope_and_moss_matches_jax(small, monkeypatch):
    """The trunk (a space and a time layer, 9 grid tokens and 2 special,
    MOSS after both layers): the parallel pass and every gradient, on the
    plain attention or the small path (whose every attention here takes
    K4's plain version on the CPU, counted); then a 3-frame prefill that
    builds the cache and two cached frames, against JAX's outputs, KV
    caches and MOSS caches, and against the parallel pass."""
    cfg = dict(TRUNK, use_fused_small=small)
    jm, tm = JTrunk(**cfg), AxialSpaceTimeTransformer(**cfg, device='cpu')
    x = np.random.default_rng(4).standard_normal((2, 5, 11, 32)).astype(np.float32)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    params = module_pair(jm, tm, x, seed=1)
    fn = lambda p: (jm.apply({'params': p}, x)[0] * w).sum()
    j_val, j_grads = jax.jit(jax.value_and_grad(fn))(params)
    calls = []
    plain = small_module.small_attend_flat_reference
    monkeypatch.setattr(small_module, 'small_attend_flat_reference',
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    t_out, _ = tm(T(x))
    (t_out * T(w)).sum().backward()
    assert len(calls) == (2 if small else 0)
    close(j_val, (t_out * T(w)).sum(), 2e-5, 1e-4)
    want = flax_params_to_torch(j_grads, tm)
    for name, p in tm.named_parameters():
        close(want[name], grad_of(p), 2e-5, 1e-3, err_msg=name)
    assert float(tm.time_pope.inv_freq.grad.abs().sum()) > 0
    assert float(tm.space_pope.inv_freq_y.grad.abs().sum()) > 0

    japply = jax.jit(jm.apply, static_argnames=['max_time'])
    with torch.no_grad():
        _, jcache = japply({'params': params}, x[:, :3], max_time=5)
        _, tcache = tm(T(x[:, :3]), max_time=5)
        outs = []
        for i in (3, 4):
            jstep, jcache = japply({'params': params}, x[:, i:i + 1], cache=jcache)
            tstep, tcache = tm(T(x[:, i:i + 1].copy()), cache=tcache)
            close(jstep, tstep, 2e-5, 1e-4)
            outs.append(tstep)
    assert tcache.token_count == 5 and len(tcache.spatial_modules) == 2
    for jkv, tkv in zip(jcache.kv, tcache.kv):
        close(jkv.k, tkv.k, 2e-5, 1e-4)
        close(jkv.v, tkv.v, 2e-5, 1e-4)
    for jsm, tsm in zip(jcache.spatial_modules, tcache.spatial_modules):
        close(jsm, tsm, 2e-5, 1e-4)
    close(t_out.detach()[:, 3:], torch.cat(outs, dim=1), 2e-5, 1e-4)


# -------------------------------------------------------------- tokenizer

@functools.lru_cache(maxsize=None)
def _jax_variables(options):
    """JAX variables for OPT + options; with the separate flow decoder,
    those of the model without it and a perturbed copy of its decoder as
    the flow decoder (see the module docstring)."""
    options = dict(options)
    flow = options.pop('separate_flow_decoder', False)
    jm = JTokenizer(**{**OPT, **options})
    init = jax.jit(lambda rngs: jm.init(rngs, jnp.zeros((1, 3, 2, 16, 16))))
    variables = jax.tree.map(np.asarray, init({'params': jax.random.PRNGKey(0),
                                               'sample': jax.random.PRNGKey(1)}))
    if flow:
        variables['params']['flow_decoder'] = perturb(variables['params']['decoder'], 9,
                                                      scale=0.05)
    return variables


def build_pair(**options):
    cfg = {**OPT, **options}
    variables = jax.tree.map(np.copy, _jax_variables(tuple(sorted(options.items()))))
    tm = VideoTokenizer(**cfg, device='cpu')
    tm.load_state_dict(flax_params_to_torch(variables['params'], tm, state=variables['state']))
    return JTokenizer(**cfg), variables, tm


def make_video(seed, b=2, t=3):
    return np.random.default_rng(seed).random((b, 3, t, 16, 16)).astype(np.float32)


def byol_targets(seed, b=2, t=3):
    return np.random.default_rng(seed).uniform(-1, 1, (b, t, 4, 8)).astype(np.float32)


# case: (options, forward inputs); each option alone, then all of them
TOK_CASES = {
    'slots_latent_init': (dict(latent_init_patch_size=2, slot_attention_initted_latents=True,
                               decoder_slot_attention_initted_spatial_tokens=True,
                               decoder_slot_spatial_mix=True), {}),
    'slots_from_tokens': (dict(slot_attention_initted_latents=True, slot_attention_inverted=False,
                               encoder_slot_spatial_mix=False), {}),
    'flow_decoder_main': (dict(separate_flow_decoder=True), dict(train_flow_decoder=False)),
    'flow_decoder_flow': (dict(separate_flow_decoder=True), dict(train_flow_decoder=True)),
    'beta_times': (dict(decoder_flow_times_beta=(2.0, 1.0), decoder_flow_steps=4), {}),
    'aug': (dict(has_aug_conditioning=True, aug_cfg_dropout_prob=0.5),
            dict(aug_id=np.array([1, 2], np.int32))),
    'byol_latent_ar': (dict(has_byol=True, byol_use_sem=True, latent_ar_loss_weight=0.1,
                            latent_ar_num_slices=16), dict(byol=True)),
    'pope_moss': (dict(time_attention_use_pope=True, space_attention_use_pope=True,
                       encoder_moss_layers=(0, 1), decoder_moss_layers=(1,)), {}),
    'all_main': (ALL, dict(train_flow_decoder=False, aug_id=True, byol=True)),
    'all_flow': (ALL, dict(train_flow_decoder=True, aug_id=np.array([0, 2], np.int32),
                           byol=True)),
}


def expected_nonzero(options, inputs):
    flow = options.get('separate_flow_decoder') and inputs.get('train_flow_decoder')
    on = {'flow_recon' if flow else 'recon'}
    if options.get('latent_ar_loss_weight'):
        on |= {'latent_ar', 'latent_ar_sigreg'}
    if options.get('has_byol') and inputs.get('byol'):
        on.add('byol')
    return on


def jax_training(jm, variables, video, time_lens, key, inputs):
    """The JAX training forward's total, losses, new state and gradients,
    and the draws it made, in one jitted call."""
    draws = Draws()
    kw = {k: v for k, v in inputs.items() if k in ('train_flow_decoder', 'aug_id')}
    if inputs.get('byol'):
        kw['byol_target_latents'] = byol_targets(5)

    def j_loss(params):
        with draws.recording() as values:
            (loss, interm), new_vars = jm.apply(
                {'params': params, 'state': variables['state']}, video, time_lens=time_lens,
                return_intermediates=True, rngs={'sample': key}, mutable=['state'], **kw)
        return loss, (interm.losses, new_vars['state'], values)

    (total, (losses, state, values)), grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        variables['params'])
    return total, losses, state, grads, draws.records(values)


@pytest.mark.parametrize('case', list(TOK_CASES))
def test_tokenizer_full_option_losses_and_grads_match_jax(case, monkeypatch):
    """Every `TokenizerLosses` field, every parameter's gradient and the
    normalizers' state; the terms an option turns on are nonzero, the
    decoder a step does not train gets no gradient and its normalizer does
    not move."""
    options, inputs = TOK_CASES[case]
    jm, variables, tm = build_pair(**options)
    video, time_lens = make_video(1), np.array([3, 2], np.int32)
    j_total, j_losses, j_state, j_grads, records = jax_training(
        jm, variables, video, time_lens, jax.random.PRNGKey(7), inputs)

    draw = replay_draws(monkeypatch, records)
    kw = {k: v for k, v in inputs.items() if k == 'train_flow_decoder'}
    if 'aug_id' in inputs:
        kw['aug_id'] = inputs['aug_id']
    if inputs.get('byol'):
        kw['byol_target_latents'] = T(byol_targets(5))
    t_total, interm = tm(T(video), time_lens=T(time_lens), return_intermediates=True, **kw)
    t_total.backward()
    assert draw.remaining == []

    close(j_total, t_total, 2e-5, 1e-5)
    for field in TokenizerLosses._fields:
        close(getattr(j_losses, field), getattr(interm.losses, field), 2e-5, 1e-5,
              err_msg=field)
    on = {f for f in TokenizerLosses._fields if float(getattr(interm.losses, f)) != 0.0}
    assert on == expected_nonzero(options, inputs)
    for name, leaves in j_state.items():
        close(leaves['exp_avg_sq'], getattr(tm, name).exp_avg_sq, 0, 1e-5, err_msg=name)
    want = flax_params_to_torch(j_grads, tm)
    for name, p in tm.named_parameters():
        assert rel_l2(want[name].numpy(), grad_of(p).numpy()) <= 1e-3, name
    if options.get('separate_flow_decoder'):
        idle = 'decoder.' if inputs['train_flow_decoder'] else 'flow_decoder.'
        assert all(p.grad is None for n, p in tm.named_parameters() if n.startswith(idle))
        if inputs['train_flow_decoder']:
            assert torch.equal(tm.recon_loss_normalizer.exp_avg_sq, torch.ones(1))
            # the encoder learns only from step-0 reconstructions
            assert tm.encoder_transformer.attn_1.to_v.weight.grad is not None


def test_all_options_inference_matches_jax(monkeypatch):
    """On the all-options model: encode with an int, a bool, an int array
    and a bool array of aug ids (the ids differ, so do the latents) and the
    pre-bottleneck hiddens; a 2-step decode, whose second step runs on the
    flow decoder; `latent_disagreement` with the clip; the JAX noise draws
    replayed."""
    jm, variables, tm = build_pair(**ALL)
    video = make_video(2)
    aug_ids = (0, True, np.array([0, 1], np.int32), np.array([True, False]))
    key = jax.random.PRNGKey(4)
    draws = Draws()

    def j_fn(latents):
        outs = [jm.apply(variables, video, method=jm.encode, aug_id=a) for a in aug_ids]
        pre = jm.apply(variables, video, method=jm.encode, aug_id=2, return_pre_bottleneck=True)
        with draws.recording() as values:
            decoded = jm.apply(variables, latents, method=jm.decode, rngs={'sample': key})
            disagreement = jm.apply(variables, latents, clip_decoded=True,
                                    method=jm.latent_disagreement,
                                    rngs={'sample': jax.random.fold_in(key, 1)})
        return outs, (pre[0], pre[1], pre[3]), decoded, disagreement, values

    latents = np.random.default_rng(3).uniform(-1, 1, (2, 3, 4, 8)).astype(np.float32)
    j_outs, j_pre, j_decoded, j_dis, values = jax.jit(j_fn)(latents)
    draw = replay_draws(monkeypatch, draws.records(values))
    calls = {'decoder': 0, 'flow_decoder': 0}
    for name in calls:
        getattr(tm, name).register_forward_hook(
            lambda *a, name=name: calls.__setitem__(name, calls[name] + 1))
    with torch.no_grad():
        for a, j_latents in zip(aug_ids, j_outs):
            close(j_latents, tm.encode(T(video), aug_id=a), 2e-5, 1e-4)
        t_pre = tm.encode(T(video), aug_id=2, return_pre_bottleneck=True)
        decoded = tm.decode(T(latents))
        assert calls == {'decoder': 1, 'flow_decoder': 1}
        dis = tm.latent_disagreement(T(latents), clip_decoded=True)
    assert draw.remaining == []
    assert float((tm.encode(T(video), aug_id=0) - tm.encode(T(video), aug_id=2)).abs().max()) > 1e-4
    close(j_pre[0], t_pre[0], 2e-5, 1e-4)
    close(j_pre[1], t_pre[1], 2e-5, 1e-4)
    np.testing.assert_array_equal(np.asarray(j_pre[2]), t_pre[3].numpy())
    close(j_decoded, decoded, 2e-5, 1e-4)
    assert dis.shape == (2, 3)
    close(j_dis, dis, 2e-5, 1e-4)


def test_all_options_streaming_encode_matches_parallel_and_jax():
    """Frame by frame through the four-part cache, whose trunk part carries
    the MOSS layer's conv cache: each frame against JAX's, the MOSS cache
    against JAX's, and all frames against the parallel encode."""
    jm, variables, tm = build_pair(**ALL)
    video = make_video(3, b=1, t=4)
    j_first = jax.jit(lambda f: jm.apply(variables, f, method=jm.encode, max_time=4,
                                         return_cache=True))
    j_next = jax.jit(lambda f, c: jm.apply(variables, f, method=jm.encode, cache=c,
                                           return_cache=True))
    j_cache = cache = None
    frames = []
    with torch.no_grad():
        parallel = tm.encode(T(video))
        for i in range(4):
            frame = video[:, :, i:i + 1]
            j_latents, j_cache = j_first(frame) if j_cache is None else j_next(frame, j_cache)
            kw = dict(max_time=4) if cache is None else {}
            latents, cache = tm.encode(T(frame.copy()), cache=cache, return_cache=True, **kw)
            close(j_latents, latents, 2e-5, 1e-4)
            frames.append(latents)
    assert cache.transformer.token_count == 4
    (j_sm,), (t_sm,) = j_cache.transformer.spatial_modules, cache.transformer.spatial_modules
    assert t_sm.shape == (1, 2, 4, 4, 32)
    close(j_sm, t_sm, 2e-5, 1e-4)
    close(parallel, torch.cat(frames, dim=1), 2e-5, 1e-4)


TRAINER = dict(separate_flow_decoder=True, has_byol=True, byol_use_sem=True)


def test_tokenizer_trainer_byol_and_flow_decoder_match_jax(monkeypatch, tmp_path):
    """Two `TokenizerTrainer` steps (seed 0: the main decoder, then the flow
    decoder, as both packages' host draws choose) with BYOL through SEM
    against the EMA teacher: losses, parameters, EMA and the normalizers
    against the JAX trainer; then a checkpoint, restored into a new
    trainer, takes a third step exactly as the first trainer does."""
    f32_newton_schulz(monkeypatch)
    jm, variables, tm = build_pair(**TRAINER)
    # the flow decoder's normalizer as flax makes it at its first use
    variables['state']['flow_recon_loss_normalizer'] = {'exp_avg_sq': np.ones(1, np.float32)}
    videos = [make_video(10 + i) for i in range(2)]
    lens = np.array([3, 2], np.int32)
    kw = dict(learning_rate=3e-4, clip_grad_norm=1.0, with_ema=True, ema_decay=0.9, seed=0)

    jtrainer = JTokenizerTrainer(jm, variables, **kw)
    calls, j_step = [], jtrainer._train_step
    jtrainer._train_step = lambda ts, v, tl, key, train_flow_decoder: calls.append(
        (key, train_flow_decoder, ts.params, ts.ema_params, ts.state)) or j_step(
        ts, v, tl, key, train_flow_decoder=train_flow_decoder)
    j_out = [jtrainer.train_on_batch(v, lens) for v in videos]
    assert [c[1] for c in calls] == [False, True]

    records = []
    for (key, flow, params, ema, state), v in zip(calls, videos):
        draws = Draws()

        def j_fwd(params, ema, state):
            target = jm.apply({'params': ema, 'state': state}, v, return_latents=True)
            with draws.recording() as values:
                jm.apply({'params': params, 'state': state}, v, time_lens=lens,
                         byol_target_latents=target, train_flow_decoder=flow,
                         rngs={'sample': key}, mutable=['state'])
            return values

        records += draws.records(jax.jit(j_fwd)(params, ema, state))

    draw = replay_draws(monkeypatch, records)
    trainer = TokenizerTrainer(tm, **kw, device='cpu')
    t_out = [trainer.train_on_batch(T(v), T(lens)) for v in videos]
    assert draw.remaining == [] and trainer.ts.step == int(jtrainer.ts.step) == 2
    monkeypatch.undo()

    for (jl, jls), (tl, tls), flow in zip(j_out, t_out, (False, True)):
        close(jl, tl, 2e-5, 1e-5)
        for field in TokenizerLosses._fields:
            close(getattr(jls, field), getattr(tls, field), 2e-5, 1e-5, err_msg=field)
        assert float(tls.byol) > 0 and float(tls.flow_recon if flow else tls.recon) > 0
    for name, leaves in jtrainer.ts.state.items():
        close(leaves['exp_avg_sq'], getattr(tm, name).exp_avg_sq, 0, 1e-5, err_msg=name)
    for tree, got in ((jtrainer.ts.params, dict(tm.named_parameters())),
                      (jtrainer.ts.ema_params, trainer.ts.ema_params)):
        for name, want in flax_params_to_torch(tree, tm).items():
            diff = np.abs(want.numpy() - got[name].detach().numpy())
            assert (diff <= 1e-5).mean() > 0.99 and (diff <= 7e-4).all(), name

    trainer.save_checkpoint(tmp_path / 'ckpt')
    torch.manual_seed(1)
    resumed = TokenizerTrainer(VideoTokenizer(**OPT, **TRAINER, device='cpu'), **kw,
                               device='cpu')
    resumed.restore(tmp_path / 'ckpt')
    video = T(make_video(12))
    (l1, s1), (l2, s2) = trainer.train_on_batch(video), resumed.train_on_batch(video)
    assert float(s1.flow_recon) > 0   # the restored numpy draw picks the flow decoder again
    assert torch.equal(l1, l2)
    for name, p in tm.named_parameters():
        assert torch.equal(p, dict(resumed.model.named_parameters())[name]), name
    for name, e in trainer.ts.ema_params.items():
        assert torch.equal(e, resumed.ts.ema_params[name]), name


def test_converter_maps_the_all_options_tokenizer_tree():
    """Every leaf of the all-options JAX tree maps one to one onto the
    port's parameters and normalizer buffers, the new modules included."""
    jm, variables, tm = build_pair(**ALL)
    converted = flax_params_to_torch(variables['params'], tm, state=variables['state'])
    assert set(converted) == set(tm.state_dict())
    names = set(dict(tm.named_parameters()))
    for name in ('slot_attention.attn.to_qg.weight', 'slot_attention.mixer_down.weight',
                 'decoder.slot_attention.ff.proj_in.weight', 'flow_decoder.tokens_to_patch.bias',
                 'byol_predictor.Dense_3.weight', 'byol_sem.norm.scale',
                 'latent_ar.net.Dense_0.weight', 'latent_init_patch_proj.weight',
                 'latent_init_patch_norm.scale', 'latent_init_mask_token',
                 'aug_cond_embedding.weight', 'decoder.aug_cond_embedding.weight',
                 'encoder_transformer.time_pope.inv_freq',
                 'encoder_transformer.space_pope.inv_freq_y',
                 'flow_decoder.transformer.space_pope.inv_freq_x',
                 'encoder_transformer.spatial_module_1.conv.kernel',
                 'decoder.transformer.spatial_module_1.proj_out.weight'):
        assert name in names, name
    np.testing.assert_array_equal(
        converted['encoder_transformer.spatial_module_1.proj_in.weight'].numpy(),
        variables['params']['encoder_transformer']['spatial_module_1']['proj_in']['kernel'].T)


def test_jax_tokenizer_init_fails_with_flow_decoder_and_decoder_moss():
    """A fault of the JAX package, kept here so the port's workaround is
    visible: its init runs the separate flow decoder on a one-patch frame,
    and a decoder MOSS layer cannot lay 5 tokens out as its 4 x 4 grid. The
    port builds and runs the same model."""
    cfg = dict(OPT, separate_flow_decoder=True, decoder_moss_layers=(1,))
    with pytest.raises(TypeError, match='reshape'):
        jax.eval_shape(lambda: JTokenizer(**cfg).init(
            {'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)},
            jnp.zeros((1, 3, 2, 16, 16))))
    tm = VideoTokenizer(**cfg, device='cpu')
    loss = tm(T(make_video(0)), train_flow_decoder=True, generator=torch.Generator())
    assert torch.isfinite(loss)


# ------------------------------------------------------------ world model

def test_world_model_with_time_pope_matches_jax(monkeypatch):
    """`time_attention_use_pope` on the world model: the training losses and
    every gradient (the PoPE frequencies' included), then a prompted dream
    whose cached frames rotate at their offsets, against JAX."""
    jm, params, tm = wm_build_pair(time_attention_use_pope=True)
    batch = wm_make_batch(0)
    j_total, j_losses, _, j_grads, records = wm_jax_training_forward(
        jm, params, batch, jax.random.PRNGKey(7), False)
    t_total, t_losses, _ = wm_port_training_forward(tm, batch, False, records, monkeypatch)
    close(j_total, t_total, 2e-5, 1e-4)
    for field in WorldModelLosses._fields:
        close(getattr(j_losses, field), getattr(t_losses, field), 2e-5, 1e-4, err_msg=field)
    want = flax_params_to_torch(j_grads, tm)
    for name, p in tm.named_parameters():
        close_grad(want[name], grad_of(p), err_msg=name)
    assert float(tm.transformer.time_pope.inv_freq.grad.abs().sum()) > 0

    rng = np.random.default_rng(9)
    prompt = dict(prompt_latents=rng.uniform(-1, 1, (2, 2, 4, 8)).astype(np.float32),
                  prompt_discrete_actions=rng.integers(0, 4, (2, 2, 1)).astype(np.int32))
    key = jax.random.PRNGKey(3)
    kw = dict(time_steps=5, num_steps=2, batch_size=2, min_dream_length=2)
    jexp = jax.jit(lambda p, pr: jgenerate(jm, {'params': p}, key, **kw, **pr))(params, prompt)
    monkeypatch.setattr(generate_module, 'draw', jax_draws(key, 1))
    with torch.no_grad():
        texp = generate(tm, torch.Generator(), **kw, **to_torch(prompt))
    np.testing.assert_array_equal(np.asarray(jexp.lens), texp.lens.numpy())
    close(jexp.latents, texp.latents, 2e-4, 0)
