"""The trunk's remaining subsystems in the port against the JAX package, at
float32 on the CPU: the GRU time layer (`rnn_time`), MoT (`mot_temporal`),
the fixed-stride and the dynamic H-Net (`nn/hnet.py`), alone and spliced
into the trunk, in the world model (`use_time_rnn`, `mot_temporal`,
`h_net_*`; losses with `h_net`, gradients, `generate`) and in the
tokenizer's encoder (`encode`, the streamed encode, the loss).

Both packages get the JAX modules' weights, converted, each leaf moved by
seeded noise (0.1 standard deviation for the trunk and H-Net modules, as in
tests/test_torch_transformer.py) where the init leaves it at a constant.
The JAX training forward's draws are recorded and replayed
(tests/test_torch_wm_options.py's `Draws`), and the rollouts' from the JAX
key chain (tests/test_torch_generate.py's `jax_draws`).

The dynamic H-Net puts frame t in chunk floor(cumsum(p)_t): float32 sums
that differ in their last bits could move a frame to another chunk. The
tests assert the chunk ids equal and print the smallest distance of the
mass to an integer, so a future mismatch shows how close to the edge it was.

Tolerances: values 2e-5 absolute and 1e-4 relative; gradients 1e-3
relative (with 2e-5 absolute, or 1e-5 of the tensor's largest entry,
tests/test_torch_wm_options.py's `close_grad`); `generate`'s latents 2e-4.
"""
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_generate import jax_draws
from test_torch_tokenizer_full import build_pair as build_tokenizer
from test_torch_tokenizer_full import jax_training as jax_tokenizer_training
from test_torch_tokenizer_full import make_video, replay_draws
from test_torch_wm_options import (close, close_grad, grad_of, jax_training_forward,
                                   port_training_forward)
from dreamer4_tpu.models.generate import generate as jgenerate
from dreamer4_tpu.models.transformer import AxialSpaceTimeTransformer as JTrunk
from dreamer4_tpu.models.world_model import DynamicsWorldModel as JWorldModel
from dreamer4_tpu.nn.hnet import DynamicChunkingTemporalTransformer as JDynamicHNet
from dreamer4_tpu.nn.hnet import HierarchicalTemporalTransformer as JHNet
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.models import generate as generate_module
from dreamer4_torch.models.generate import generate
from dreamer4_torch.models.tokenizer import TokenizerLosses
from dreamer4_torch.models.transformer import AxialSpaceTimeTransformer
from dreamer4_torch.models.world_model import DynamicsWorldModel, WorldModelLosses
from dreamer4_torch.nn.attention import KVCache
from dreamer4_torch.nn.hnet import DynamicChunkingTemporalTransformer, HierarchicalTemporalTransformer

torch.set_num_threads(1)
T = torch.from_numpy


def perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32), params)


def assert_tree_close(j, t, name=''):
    """A cache of the JAX package against the port's: NamedTuples and tuples
    field by field, host ints and floats by value."""
    if isinstance(t, KVCache):
        assert int(j.length) == t.length, name
        close(j.k, t.k, 2e-5, 1e-4, err_msg=f'{name}.k')
        close(j.v, t.v, 2e-5, 1e-4, err_msg=f'{name}.v')
    elif hasattr(t, '_fields'):
        for field in t._fields:
            assert_tree_close(getattr(j, field), getattr(t, field), f'{name}.{field}')
    elif isinstance(t, tuple):
        assert len(j) == len(t), name
        for i, (a, b) in enumerate(zip(j, t)):
            assert_tree_close(a, b, f'{name}[{i}]')
    elif t is None:
        assert j is None, name
    else:
        close(j, t, 2e-5, 1e-4, err_msg=name)


def mass_margin(module, x):
    """The smallest distance of the port's cumulative boundary mass to an
    integer, and its chunk ids."""
    with torch.no_grad():
        mass = torch.cumsum(module.boundary_probs(x), dim=1)
    return float((mass - mass.round()).abs().min()), torch.floor(mass).long()


# ------------------------------------------------------------ H-Net modules

HNET_KW = dict(dim=16, depth=2, heads=2, dim_head=8, compression_ratio=2)


@pytest.mark.parametrize('dynamic', [False, True])
def test_hnet_module_matches_jax(dynamic):
    """The parallel pass (output, ratio loss, every gradient, the input's
    too), then eight frames streamed one at a time: each output and every
    field of the cache after each frame. The dynamic one's chunk ids too."""
    jcls, tcls = ((JDynamicHNet, DynamicChunkingTemporalTransformer) if dynamic
                  else (JHNet, HierarchicalTemporalTransformer))
    jm, tm = jcls(**HNET_KW), tcls(**HNET_KW, device='cpu')
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 16)).astype(np.float32)
    w = rng.standard_normal((3, 7, 16)).astype(np.float32)
    params = perturbed(jm.init(jax.random.PRNGKey(1), x)['params'], 2)
    tm.load_state_dict(flax_params_to_torch(params, tm))

    def f(p, x):
        out, loss, _ = jm.apply({'params': p}, x)
        return (out * w).sum() + 3.0 * loss, (out, loss)

    (_, (j_out, j_loss)), (j_grads, j_xgrad) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, x)
    tx = T(x.copy()).requires_grad_()
    out, loss, _ = tm(tx)
    ((out * T(w)).sum() + 3.0 * loss).backward()
    close(j_out, out, 2e-5, 1e-4)
    close(j_loss, loss, 2e-5, 1e-4)
    close_grad(j_xgrad, tx.grad)
    want = flax_params_to_torch(j_grads, tm)
    for name, p in tm.named_parameters():
        close_grad(want[name], grad_of(p), err_msg=name)
    if dynamic:
        j_ids = np.floor(np.cumsum(np.asarray(jm.apply(
            {'params': params}, x, method=jm.boundary_probs)), axis=1))
        margin, ids = mass_margin(tm, T(x))
        print(f'dynamic H-Net: smallest distance of the mass to an integer {margin:.3e}')
        np.testing.assert_array_equal(j_ids, ids.numpy())
        assert len(np.unique(ids.numpy())) > 2

    max_chunks = 8
    if dynamic:
        j_cache = jm.apply({'params': params}, 3, max_chunks, method=jm.init_cache)
    else:
        j_cache = jm.init_cache(3, max_chunks)
    t_cache = tm.init_cache(3, max_chunks)
    j_step = jax.jit(lambda c, xi: jm.apply({'params': params}, xi, cache=c))
    streamed = []
    with torch.no_grad():
        for i in range(7):
            j_o, _, j_cache = j_step(j_cache, x[:, i:i + 1])
            t_o, _, t_cache = tm(T(x[:, i:i + 1]), cache=t_cache)
            close(j_o, t_o, 2e-5, 1e-4, err_msg=f'frame {i}')
            assert_tree_close(j_cache, t_cache, f'frame {i}')
            streamed.append(t_o)
    close(out.detach(), torch.cat(streamed, dim=1), 2e-5, 1e-4)


# -------------------------------------------------------------------- trunk

TRUNK = dict(dim=32, depth=2, attn_heads=2, attn_dim_head=16, time_block_every=2,
             num_special_tokens=2)
TRUNK_CASES = {
    'rnn_time': dict(rnn_time=True),
    'mot_temporal': dict(mot_temporal=True),
    'h_net': dict(h_net_layer=1, h_net_depth=1, h_net_heads=2, h_net_dim_head=8,
                  h_net_compression_ratio=2),
    'h_net_dynamic': dict(h_net_layer=0, h_net_heads=2, h_net_dim_head=8,
                          h_net_compression_ratio=2, h_net_dynamic=True),
    'all_flash': dict(rnn_time=True, mot_temporal=True, h_net_layer=1, h_net_depth=1,
                      h_net_heads=2, h_net_dim_head=8, h_net_compression_ratio=2,
                      use_flash_attention=True, flash_min_scores=1),
}


@pytest.mark.parametrize('case', list(TRUNK_CASES))
def test_trunk_subsystem_matches_jax(case):
    """The parallel pass and its H-Net loss; a prefill of four frames that
    builds the cache; two frames on it. Outputs at every call and every
    field of the cache after each (the GRU carries, the MoT (main, special)
    KV pairs, the H-Net's streaming cache)."""
    cfg = {**TRUNK, **TRUNK_CASES[case]}
    jm = JTrunk(**cfg)
    x = np.random.default_rng(3).standard_normal((2, 6, 5, 32)).astype(np.float32)
    params = perturbed(jm.init(jax.random.PRNGKey(1), x)['params'], 2)
    tm = AxialSpaceTimeTransformer(**cfg, device='cpu')
    tm.load_state_dict(flax_params_to_torch(params, tm))
    japply = jax.jit(partial(jm.apply, {'params': params}),
                     static_argnames=('max_time', 'return_intermediates'))
    with torch.no_grad():
        j_out, j_interm = japply(x, return_intermediates=True)
        t_out, t_interm = tm(T(x), return_intermediates=True)
        close(j_out, t_out, 2e-5, 1e-4)
        close(j_interm.h_net_loss, t_interm.h_net_loss, 2e-5, 1e-4)
        assert len(t_interm.layer_hiddens) == len(j_interm.layer_hiddens)
        if 'h_net_layer' in cfg:
            assert float(t_interm.h_net_loss) > 0

        j_o, j_cache = japply(x[:, :4], max_time=6)
        t_o, t_cache = tm(T(x[:, :4]), max_time=6)
        close(j_o, t_o, 2e-5, 1e-4)
        assert_tree_close(j_cache, t_cache, 'prefill')
        cached = [t_o]
        for i in (4, 5):
            j_o, j_cache = japply(x[:, i:i + 1], cache=j_cache)
            t_o, t_cache = tm(T(x[:, i:i + 1]), cache=t_cache)
            close(j_o, t_o, 2e-5, 1e-4, err_msg=f'frame {i}')
            assert_tree_close(j_cache, t_cache, f'frame {i}')
            cached.append(t_o)
    # the prefill and the cached frames continue the parallel pass
    close(t_out, torch.cat(cached, dim=1), 2e-5, 1e-4)


# -------------------------------------------------------------- world model

WM = dict(dim=32, dim_latent=8, num_latent_tokens=4, num_spatial_tokens=4, max_steps=16,
          depth=2, time_block_every=2, attn_heads=2, attn_dim_head=16,
          num_discrete_actions=(4,), multi_token_pred_len=2, num_register_tokens=2,
          predict_terminals=True)
SUB = dict(use_time_rnn=True, mot_temporal=True, h_net_layer=1, h_net_compression_ratio=2,
           h_net_loss_weight=2.0)
# (config, shortcut): every subsystem with the actor and critic trunks (which
# take the GRU and MoT too), and the dynamic H-Net on a shortcut step
WM_SUB_CASES = {
    'fixed_h_net_trunks': (dict(SUB, actor_depth=2, critic_depth=2), False),
    'dynamic_h_net': (dict(SUB, h_net_layer=0, h_net_dynamic=True), True),
}


@functools.cache
def _wm_params(items):
    cfg = dict(items)
    jm = JWorldModel(**cfg)
    v = cfg.get('num_video_views', 1)
    lat = jnp.zeros((2, 3, v, 4, 8) if v > 1 else (2, 3, 4, 8))
    init = jax.jit(lambda rngs: jm.init(
        rngs, latents=lat, latent_has_view_dim=v > 1, shortcut_train=False,
        rewards=jnp.zeros((2, 3)), terminals=jnp.zeros((2,), bool),
        discrete_actions=jnp.zeros((2, 2, 1), jnp.int32))['params'])
    return jax.tree.map(np.asarray, init({'params': jax.random.PRNGKey(0),
                                          'sample': jax.random.PRNGKey(1)}))


def build_wm(**kw):
    """The JAX world model of WM + kw, its weights, and the port's with
    them (the converter maps every leaf or raises)."""
    cfg = {**WM, **kw}
    params = _wm_params(tuple(sorted(cfg.items())))
    tm = DynamicsWorldModel(**cfg, device='cpu')
    tm.load_state_dict(flax_params_to_torch(params, tm))
    return JWorldModel(**cfg), params, tm


def wm_batch(seed, b=2, t=6, views=1):
    rng = np.random.default_rng(seed)
    shape = (b, t, views, 4, 8) if views > 1 else (b, t, 4, 8)
    batch = dict(latents=(rng.standard_normal(shape) * 0.5).astype(np.float32),
                 rewards=rng.standard_normal((b, t)).astype(np.float32),
                 discrete_actions=rng.integers(0, 4, (b, t, 1)).astype(np.int32),
                 terminals=rng.random((b, t)) < 0.4)
    if views > 1:
        batch['latent_has_view_dim'] = True
    return batch


def assert_wm_step_matches(jm, params, tm, batch, shortcut, monkeypatch):
    """The JAX training forward and the port's with its draws replayed:
    the total, every `WorldModelLosses` field, the embeddings and every
    parameter's gradient. -> the port's losses."""
    j_total, j_losses, j_embeds, j_grads, records = jax_training_forward(
        jm, params, batch, jax.random.PRNGKey(7), shortcut)
    t_total, t_losses, t_embeds = port_training_forward(tm, batch, shortcut, records,
                                                        monkeypatch)
    close(j_total, t_total, 2e-5, 1e-4)
    for field in WorldModelLosses._fields:
        close(getattr(j_losses, field), getattr(t_losses, field), 2e-5, 1e-4, err_msg=field)
    for field in ('agent', 'actor', 'critic'):
        close(getattr(j_embeds, field), getattr(t_embeds, field), 2e-5, 1e-4, err_msg=field)
    want = flax_params_to_torch(j_grads, tm)
    for name, p in tm.named_parameters():
        close_grad(want[name], grad_of(p), err_msg=name)
    return t_losses


@pytest.mark.parametrize('case', list(WM_SUB_CASES))
def test_world_model_subsystems_losses_and_grads_match_jax(case, monkeypatch):
    """Every loss (the H-Net's at weight 2.0) and gradient; the GRU, the
    special tokens' attention and the H-Net's scoring head learn."""
    cfg, shortcut = WM_SUB_CASES[case]
    jm, params, tm = build_wm(**cfg)
    t_losses = assert_wm_step_matches(jm, params, tm, wm_batch(0), shortcut, monkeypatch)
    assert float(t_losses.h_net.detach()) > 0
    head = 'boundary_head' if cfg.get('h_net_dynamic') else 'to_scores'
    for name in ('transformer.rnn_1.GRUCell_0.hz.weight', 'transformer.special_attn_1.to_q.weight',
                 f'transformer.h_net.{head}.weight'):
        assert float(grad_of(dict(tm.named_parameters())[name]).abs().max()) > 0, name
    if shortcut:
        assert float(t_losses.shortcut) > 0


def test_generate_with_subsystems_matches_jax(monkeypatch):
    """A prompted b2 dream of the GRU / MoT / fixed H-Net model with actor
    and critic trunks (the prompt pass steps the H-Net frame by frame into
    its cache), the JAX key chain's draws replayed."""
    jm, params, tm = build_wm(**WM_SUB_CASES['fixed_h_net_trunks'][0])
    rng = np.random.default_rng(9)
    prompt = dict(prompt_latents=rng.uniform(-1, 1, (2, 3, 4, 8)).astype(np.float32),
                  prompt_discrete_actions=rng.integers(0, 4, (2, 3, 1)).astype(np.int32))
    key = jax.random.PRNGKey(3)
    kw = dict(time_steps=6, num_steps=2, batch_size=2, min_dream_length=3)
    jexp = jax.jit(lambda p, pr: jgenerate(jm, {'params': p}, key, **kw, **pr))(params, prompt)
    monkeypatch.setattr(generate_module, 'draw', jax_draws(key, 1))
    texp = generate(tm, torch.Generator(), **kw, **{k: T(v) for k, v in prompt.items()})
    np.testing.assert_array_equal(np.asarray(jexp.lens), texp.lens.numpy())
    np.testing.assert_array_equal(np.asarray(jexp.actions.discrete),
                                  texp.actions.discrete.numpy())
    close(jexp.latents, texp.latents, 2e-4, 0)
    close(jexp.agent_embed, texp.agent_embed, 1e-4, 0)
    close(jexp.values, texp.values, 2e-3, 0)


# ---------------------------------------------------------------- tokenizer

TOK_SUB = dict(use_time_rnn=True, h_net_layer=1, h_net_compression_ratio=2,
               h_net_loss_weight=2.0)


def test_tokenizer_encoder_subsystems_match_jax(monkeypatch):
    """The encoder's GRU and fixed H-Net: the training loss (the H-Net's
    ratio loss in the total at weight 2.0), every loss field and gradient,
    with the JAX draws replayed; then `encode` against JAX's, and the
    streamed encode frame by frame against JAX's (the trunk cache's GRU
    carries and H-Net cache too) and against the parallel encode."""
    jm, variables, tm = build_tokenizer(**TOK_SUB)
    video, time_lens = make_video(1, t=4), np.array([4, 3], np.int32)
    j_total, j_losses, _, j_grads, records = jax_tokenizer_training(
        jm, variables, video, time_lens, jax.random.PRNGKey(7), {})
    draw = replay_draws(monkeypatch, records)
    t_total, interm = tm(T(video), time_lens=T(time_lens), return_intermediates=True)
    t_total.backward()
    assert draw.remaining == []
    close(j_total, t_total, 2e-5, 1e-4)
    for field in TokenizerLosses._fields:
        close(getattr(j_losses, field), getattr(interm.losses, field), 2e-5, 1e-4,
              err_msg=field)
    want = flax_params_to_torch(j_grads, tm)
    for name, p in tm.named_parameters():
        close_grad(want[name], grad_of(p), err_msg=name)
    for name in ('encoder_transformer.rnn_1.GRUCell_0.in.weight',
                 'encoder_transformer.h_net.to_scores.weight'):
        assert float(grad_of(dict(tm.named_parameters())[name]).abs().max()) > 0, name

    video = make_video(3, b=1, t=4)
    j_encode = jax.jit(lambda v: jm.apply(variables, v, method=jm.encode))
    j_first = jax.jit(lambda f: jm.apply(variables, f, method=jm.encode, max_time=4,
                                         return_cache=True))
    j_next = jax.jit(lambda f, c: jm.apply(variables, f, method=jm.encode, cache=c,
                                           return_cache=True))
    j_cache = cache = None
    frames = []
    with torch.no_grad():
        parallel = tm.encode(T(video))
        close(j_encode(video), parallel, 2e-5, 1e-4)
        for i in range(4):
            frame = video[:, :, i:i + 1]
            j_latents, j_cache = j_first(frame) if j_cache is None else j_next(frame, j_cache)
            kw = dict(max_time=4) if cache is None else {}
            latents, cache = tm.encode(T(frame.copy()), cache=cache, return_cache=True, **kw)
            close(j_latents, latents, 2e-5, 1e-4, err_msg=f'frame {i}')
            frames.append(latents)
    assert_tree_close(j_cache.transformer.rnn, cache.transformer.rnn, 'rnn')
    assert_tree_close(j_cache.transformer.h_net, cache.transformer.h_net, 'h_net')
    close(parallel, torch.cat(frames, dim=1), 2e-5, 1e-4)


def test_jax_gru_time_layer_fails_in_bf16_and_the_port_runs():
    """A JAX fault the port does not share (ROADMAP queue 3): the JAX GRU
    time layer starts its carry in the stream's dtype while flax's
    `GRUCell` computes in float32, so a bf16 trunk with `rnn_time` fails in
    `lax.scan` (carry types differ). The port's cell computes in float32
    from the bf16 carry and returns the stream's dtype."""
    cfg = dict(TRUNK, rnn_time=True)
    x = np.random.default_rng(5).standard_normal((1, 3, 5, 32)).astype(np.float32)
    with pytest.raises(TypeError, match='carry'):
        JTrunk(**cfg, dtype=jnp.bfloat16).init(jax.random.PRNGKey(0), x)
    tm = AxialSpaceTimeTransformer(**cfg, dtype=torch.bfloat16, device='cpu')
    with torch.no_grad():
        out, _ = tm(T(x))
        _, cache = tm(T(x[:, :2]), max_time=3)
        step, cache = tm(T(x[:, 2:]), cache=cache)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())
    assert all(c.dtype == torch.bfloat16 for c in cache.rnn)
    assert float((step.float() - out[:, 2:].float()).abs().max()) < 0.1


def test_flash_branch_centers_values_that_barely_vary():
    """The bf16 flash backward takes delta = rowsum(dO * O) from the bf16
    output in both packages (JAX: ops/flash_attention.py:383; the port's
    K2 and its plain version). Where a token's values barely vary over the
    keys (MoT's special token over time), O's rounding swamps dP - delta
    and the q and k gradients lose their digits (ROADMAP queue 3). The
    port's flash branch centers the values (`flash_attend_centered`):
    exact at float32, and at bf16 its gradients are several times closer
    to float32's than JAX's and than the uncentered call's."""
    from dreamer4_tpu.ops.flash_attention import flash_attend as j_flash_attend
    from dreamer4_tpu.ops.flash_attention import make_config
    from dreamer4_torch.nn.attention import flash_attend_centered
    from dreamer4_torch.ops.flash_attention import flash_attend

    rng = np.random.default_rng(7)
    B, H, N, D = 1, 2, 256, 32
    bf = lambda x: torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    q, k, g = (bf(rng.standard_normal((B, H, N, D))) for _ in range(3))
    v = bf(3.0 * rng.standard_normal((B, H, 1, D)) + 0.05 * rng.standard_normal((B, H, N, D)))
    cfg = dict(softclamp_value=50.0, causal=True)

    def grads(fn, dtype):
        leaves = [t.to(dtype).clone().requires_grad_() for t in (q, k, v)]
        (fn(*leaves, 0, N, **cfg).float() * g.float()).sum().backward()
        return [t.grad.float() for t in leaves]

    want = grads(flash_attend, torch.float32)
    for a, b in zip(grads(flash_attend_centered, torch.float32), want):
        close(b.numpy(), a, 2e-5, 1e-4)
    rel = lambda a, b: float((a - b).norm() / b.norm())
    centered = grads(flash_attend_centered, torch.bfloat16)
    raw = grads(flash_attend, torch.bfloat16)
    jcfg = make_config(interpret=True, **cfg)
    j_loss = lambda q, k, v: (j_flash_attend(q, k, v, jnp.int32(0), jnp.int32(N), jcfg)
                              .astype(jnp.float32) * g.float().numpy()).sum()
    as_j = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(as_j(q), as_j(k), as_j(v))
    for i, name in ((0, 'dq'), (1, 'dk')):
        e_c, e_raw = rel(centered[i], want[i]), rel(raw[i], want[i])
        e_j = rel(torch.from_numpy(np.asarray(j_grads[i], np.float32)), want[i])
        print(f'{name}: centered {e_c:.2e}, uncentered {e_raw:.2e}, JAX {e_j:.2e}')
        assert e_c * 4 < min(e_raw, e_j), name
