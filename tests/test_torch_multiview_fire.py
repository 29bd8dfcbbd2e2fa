"""Multi-view world models, the aux image encoder of `BehaviorCloneTrainer`,
FIRE and latent-gene evolution in the port against the JAX package, at
float32 on the CPU.

The world models are tests/test_torch_subsystems.py's (`build_wm`: dim 32,
depth 2, 2 heads x 16, 4 latents of 8), their weights the JAX model's,
converted. The JAX draws are recorded and replayed as there. The aux
encoder is one fixed projection built from the same numpy weights in both
packages (as tests/test_aux_encoder.py builds it). FIRE's perturbation
noise is JAX's, leaf by leaf in flax's sorted order and layout, replayed
through `ops.fire.draw`; so are evolution's tournament scores and mixes.

Tolerances: values 2e-5 absolute and 1e-4 relative; gradients 1e-3
relative (tests/test_torch_wm_options.py's `close_grad`); `generate`'s
latents 2e-4; a trainer step's parameters 1e-5 except where Adam-atan2's
first step sees a gradient within rounding of zero (tests/test_torch_train.py);
FIRE's weights 2e-5 absolute and 1e-4 relative after its 20 Newton-Schulz
steps, their Frobenius norms within 1e-3 relative of the input's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_generate import jax_draws
from test_torch_subsystems import assert_wm_step_matches, build_wm, wm_batch
from test_torch_wm_options import (close, f32_newton_schulz, grad_of, jax_training_forward,
                                   replay, to_torch)
from dreamer4_tpu.models.generate import generate as jgenerate
from dreamer4_tpu.models.tokenizer import VideoTokenizer as JTokenizer
from dreamer4_tpu.ops import fire as jfire
from dreamer4_tpu.train.trainers import BehaviorCloneTrainer as JBehaviorCloneTrainer
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.models import generate as generate_module
from dreamer4_torch.models.generate import generate
from dreamer4_torch.models.tokenizer import VideoTokenizer
from dreamer4_torch.models.world_model import WorldModelLosses
from dreamer4_torch.ops import fire as fire_module
from dreamer4_torch.ops.fire import apply_fire, evolve_latent_genes, evolve_params
from dreamer4_torch.train.trainers import BehaviorCloneTrainer

torch.set_num_threads(1)
T = torch.from_numpy
# two views, the per-view state heads, the agent's state prediction and the
# latent-input policy and value heads, which mean their encoders over views
MULTI = dict(num_video_views=2, add_state_pred_head=True, state_pred_loss_weight=1.0,
             agent_predicts_state=True, actor_critic_latent_input=True)
# with every other option of this slice: the GRU, MoT, the dynamic H-Net
MULTI_ALL = dict(MULTI, use_time_rnn=True, mot_temporal=True, h_net_layer=1, h_net_dynamic=True,
                 h_net_compression_ratio=2, h_net_loss_weight=2.0)


# ---------------------------------------------------------------- multi-view

def test_multiview_world_model_matches_jax(monkeypatch):
    """With every option of this slice at once (so the converter maps that
    tree too): the training forward's losses (the per-view state losses
    and the H-Net's nonzero) and every gradient (the view embedding's
    nonzero); the prediction's per-view flow and state;
    `latent_actor_inputs` over both views."""
    jm, params, tm = build_wm(**MULTI_ALL)
    assert len(jax.tree_util.tree_leaves(params)) == len(list(tm.parameters()))
    batch = wm_batch(0, views=2)
    batch['lens'] = np.array([6, 4], np.int32)
    t_losses = assert_wm_step_matches(jm, params, tm, batch, False, monkeypatch)
    assert all(float(getattr(t_losses, f).detach()) != 0
               for f in ('state_pred', 'agent_state_pred', 'h_net'))
    assert float(tm.view_emb.grad.abs().max()) > 0

    lat = batch['latents']
    j_pred = jax.jit(lambda p: jm.apply({'params': p}, latents=lat, latent_has_view_dim=True,
                                        signal_levels=15, step_sizes=4, latent_is_noised=True))(
        params)
    j_in = jax.jit(lambda p: jm.apply({'params': p}, lat[:, 0],
                                      method=lambda m, l: m.latent_actor_inputs(l)))(params)
    with torch.no_grad():
        pred = tm(latents=T(lat), latent_has_view_dim=True, signal_levels=15, step_sizes=4,
                  latent_is_noised=True)
        t_in = tm.latent_actor_inputs(T(lat[:, 0]))
    assert pred.flow.shape == (2, 6, 2, 4, 8) and pred.state.shape == (2, 6, 2, 4, 8, 2)
    close(j_pred.flow, pred.flow, 2e-5, 1e-4)
    close(j_pred.state, pred.state, 2e-5, 1e-4)
    for j, t in zip(j_in, t_in):
        assert t.shape == (2, 32)
        close(j, t, 2e-5, 1e-4)


def test_multiview_generate_matches_jax(monkeypatch):
    """A dream from a (b, p, v, n, d) prompt: the views roll forward apart,
    the latent-input policy reads both; the JAX key chain's draws replayed."""
    jm, params, tm = build_wm(**MULTI)
    rng = np.random.default_rng(9)
    prompt = dict(prompt_latents=rng.uniform(-1, 1, (2, 2, 2, 4, 8)).astype(np.float32),
                  prompt_discrete_actions=rng.integers(0, 4, (2, 2, 1)).astype(np.int32))
    key = jax.random.PRNGKey(3)
    kw = dict(time_steps=5, num_steps=2, batch_size=2, min_dream_length=2)
    jexp = jax.jit(lambda p, pr: jgenerate(jm, {'params': p}, key, **kw, **pr))(params, prompt)
    monkeypatch.setattr(generate_module, 'draw', jax_draws(key, 1))
    texp = generate(tm, torch.Generator(), **kw, **to_torch(prompt))
    assert texp.latents.shape == (2, 5, 2, 4, 8)
    np.testing.assert_array_equal(np.asarray(jexp.lens), texp.lens.numpy())
    np.testing.assert_array_equal(np.asarray(jexp.actions.discrete),
                                  texp.actions.discrete.numpy())
    close(jexp.latents, texp.latents, 2e-4, 0)
    close(jexp.values, texp.values, 2e-3, 0)
    assert float((texp.latents[:, 2:, 0] - texp.latents[:, 2:, 1]).abs().max()) > 1e-4
    with pytest.raises(ValueError, match='multi-view'):
        generate(tm, torch.Generator(), **kw, prompt_latents=T(prompt['prompt_latents'][:, :, 0]))


# --------------------------------------------------------- aux image encoder

N_TOK, N_AUX = 2, 2
TOK = dict(dim=16, dim_latent=8, patch_size=8, image_height=16, image_width=16,
           num_latent_tokens=N_TOK, encoder_depth=1, decoder_depth=1, time_block_every=1,
           attn_dim_head=8, attn_heads=2, use_loss_normalization=False)
AUX_W = (np.random.default_rng(42).standard_normal((3, N_AUX * 8)) * 0.1).astype(np.float32)


def jax_aux(video):   # (b, c, t, h, w) -> (b, t, N_AUX, 8)
    pooled = jnp.moveaxis(jnp.mean(video, axis=(-2, -1)), 1, 2)
    return jnp.tanh(pooled @ AUX_W).reshape(*pooled.shape[:2], N_AUX, 8)


def torch_aux(video):
    pooled = video.mean(dim=(-2, -1)).transpose(1, 2)
    return torch.tanh(pooled @ T(AUX_W)).reshape(*pooled.shape[:2], N_AUX, 8)


def test_behavior_clone_trainer_with_aux_encoder_matches_jax(monkeypatch):
    """One step on a video batch: the tokenizer's 2 latents, then the aux
    encoder's 2 tokens, make the world model's 4. The loss, every loss
    field and the parameters after the step against the JAX trainer's."""
    f32_newton_schulz(monkeypatch)
    jtok = JTokenizer(**TOK)
    tok_vars = jax.tree.map(np.asarray, jtok.init(
        {'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)},
        jnp.zeros((1, 3, 2, 16, 16))))
    ttok = VideoTokenizer(**TOK, device='cpu')
    ttok.load_state_dict(flax_params_to_torch(tok_vars['params'], ttok,
                                              state=tok_vars.get('state')))
    jm, params, tm = build_wm()
    rng = np.random.default_rng(4)
    batch = dict(video=rng.random((2, 3, 4, 16, 16)).astype(np.float32),
                 rewards=rng.standard_normal((2, 4)).astype(np.float32),
                 discrete_actions=rng.integers(0, 4, (2, 4, 1)).astype(np.int32))
    kw = dict(learning_rate=3e-4, clip_grad_norm=1.0, with_ema=False, seed=1)

    jtrainer = JBehaviorCloneTrainer(jm, {'params': params}, tokenizer=jtok,
                                     tokenizer_variables=tok_vars, aux_image_encoder_fn=jax_aux,
                                     **kw)
    calls, j_step = [], jtrainer._train_step

    def spy(ts, b, key, shortcut_train):
        calls.append((key, shortcut_train, b['latents']))
        return j_step(ts, b, key, shortcut_train=shortcut_train)

    jtrainer._train_step = spy
    j_loss, j_losses = jtrainer.train_on_batch(batch)
    (key, shortcut, j_latents), = calls
    assert j_latents.shape == (2, 4, N_TOK + N_AUX, 8)
    wm_inputs = {k: v for k, v in batch.items() if k != 'video'}
    records = jax_training_forward(jm, params, {**wm_inputs, 'latents': np.asarray(j_latents)},
                                   key, shortcut, grads=False)[-1]

    draw = replay(monkeypatch, records)
    trainer = BehaviorCloneTrainer(tm, tokenizer=ttok, aux_image_encoder_fn=torch_aux, **kw,
                                   device='cpu')
    t_loss, t_losses = trainer.train_on_batch(to_torch(batch))
    assert draw.remaining == []
    # the port's gradients, which the loss tests hold against JAX's
    small = {n: np.abs(grad_of(p).numpy()) < 1e-7 for n, p in tm.named_parameters()}
    close(j_loss, t_loss, 2e-5, 1e-4)
    for field in WorldModelLosses._fields:
        close(getattr(j_losses, field), getattr(t_losses, field), 2e-5, 1e-4, err_msg=field)
    got = dict(tm.named_parameters())
    for name, want in flax_params_to_torch(jtrainer.ts.params, tm).items():
        diff = np.abs(want.numpy() - got[name].detach().numpy())
        assert not (diff[~small[name]] > 1e-5).any(), name
        assert (diff <= 7e-4).all(), name
    with torch.no_grad():
        combined = torch.cat([ttok.encode(T(batch['video'])), torch_aux(T(batch['video']))], -2)
    close(j_latents, combined, 2e-5, 1e-4)


# ------------------------------------------------------------- FIRE, evolution

def fire_replay(monkeypatch, noises):
    queue = list(noises)

    def draw(kind, shape, *, generator, device):
        x = queue.pop(0)
        assert kind in ('perturb', 'tournament', 'mix') and x.shape == tuple(shape), kind
        return T(np.array(x)).to(device)

    draw.remaining = queue
    monkeypatch.setattr(fire_module, 'draw', draw)
    return draw


@pytest.mark.parametrize('shrink_perturb', [False, True])
def test_apply_fire_on_a_world_model_matches_jax(shrink_perturb, monkeypatch):
    """Every parameter of a converted world model after FIRE (the square
    and the wide and tall Dense kernels, tables, learned tokens) against
    JAX's on its tree; every 2-D weight keeps its Frobenius norm."""
    jm, params, tm = build_wm(num_latent_genes=3)
    key = jax.random.PRNGKey(5) if shrink_perturb else None
    j_fire = jax.jit(lambda p, k: jfire.apply_fire(p, k, shrink_perturb=shrink_perturb))
    j_out = jax.tree.map(np.asarray, j_fire(params, key))
    leaves = jax.tree_util.tree_leaves(params)
    noises = []
    if shrink_perturb:
        keys = jax.random.split(key, len(leaves))
        noises = [np.asarray(jax.random.normal(k, leaf.shape)) for k, leaf in zip(keys, leaves)
                  if leaf.ndim == 2]
    draw = fire_replay(monkeypatch, noises)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    assert apply_fire(tm, shrink_perturb=shrink_perturb) is tm
    assert draw.remaining == []
    want = flax_params_to_torch(j_out, tm)
    for name, p in tm.named_parameters():
        close(want[name], p, 2e-5, 1e-4, err_msg=name)
        if p.ndim == 2 and not shrink_perturb:
            np.testing.assert_allclose(float(p.detach().norm()), float(before[name].norm()),
                                       rtol=1e-3)
        elif p.ndim != 2:
            assert torch.equal(p, before[name]), name
    assert not torch.equal(tm.transformer.attn_1.to_q.weight, before['transformer.attn_1.to_q.weight'])

    # a dict of tensors: its 2-D entries as given
    w = np.random.default_rng(0).standard_normal((6, 4)).astype(np.float32)
    out = apply_fire({'w': T(w), 'b': torch.ones(4)})
    close(jfire.apply_fire({'w': w, 'b': np.ones(4)})['w'], out['w'], 2e-5, 1e-4)
    assert torch.equal(out['b'], torch.ones(4))


EVOLVE_CASES = {
    'distinct': (np.arange(8, dtype=np.float32)[::-1].copy(), dict()),
    'tied': (np.array([1.0, 3.0, 3.0, 0.5, 3.0, 1.0, 1.0, 2.0], np.float32), dict()),
    'all_tied_wide': (np.zeros(9, np.float32), dict(select_frac=0.4, tournament_frac=0.8)),
}


@pytest.mark.parametrize('case', list(EVOLVE_CASES))
def test_evolve_latent_genes_matches_jax(case, monkeypatch):
    """Selection (tied fitness: the lower index first, as `lax.top_k`),
    the tournaments and the crossover, the JAX draws replayed; then
    `evolve_params` on a module's `latent_genes` and on a dict."""
    fitness, kw = EVOLVE_CASES[case]
    genes = np.random.default_rng(1).standard_normal((len(fitness), 5)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jfire.evolve_latent_genes(key, genes, fitness, **kw))
    pop = len(fitness)
    num_selected = max(1, int(np.ceil(pop * kw.get('select_frac', 0.5))))
    k1, k2 = jax.random.split(key)
    noises = [np.asarray(jax.random.normal(k1, (pop - num_selected, num_selected))),
              np.asarray(jax.random.normal(k2, (pop - num_selected, 5)))]
    fire_replay(monkeypatch, noises * 3)
    got = evolve_latent_genes(T(genes), T(fitness), **kw)
    close(want, got, 1e-6, 1e-6)
    # the selected keep their genes exactly
    np.testing.assert_array_equal(want[:num_selected], got[:num_selected].numpy())

    module = torch.nn.Module()
    module.latent_genes = torch.nn.Parameter(T(genes.copy()))
    assert evolve_params(module, T(fitness), **kw) is module
    close(want, module.latent_genes, 1e-6, 1e-6)
    out = evolve_params({'latent_genes': T(genes), 'other': torch.zeros(2)}, T(fitness), **kw)
    close(want, out['latent_genes'], 1e-6, 1e-6)
    assert torch.equal(out['other'], torch.zeros(2))


def test_converter_maps_the_subsystem_tokenizer_tree():
    """A JAX tokenizer with the GRU and the dynamic H-Net in its encoder
    (tests/test_torch_subsystems.py runs the fixed one; the world model
    with every option is `test_multiview_world_model_matches_jax`'s): the
    converter maps every leaf, none left over or missing, and the encode
    runs on the converted weights."""
    from test_torch_tokenizer_full import build_pair as build_tokenizer
    from test_torch_tokenizer_full import make_video

    _, variables, ttok = build_tokenizer(use_time_rnn=True, h_net_layer=1, h_net_dynamic=True)
    assert len(jax.tree_util.tree_leaves(variables['params'])) == len(list(ttok.parameters()))
    assert hasattr(ttok.encoder_transformer.h_net, 'inner_layers_1_ff')
    with torch.no_grad():
        assert bool(torch.isfinite(ttok.encode(T(make_video(2)))).all())
