"""The port's imagination rollout (`generate`) against the JAX rollout at f32
on the CPU, with converted weights and the JAX draws replayed into the port
through its module-level `draw`, with and without a prompt. The flash gate is
lowered in both packages so that the prompt pass's time attention takes the
flash branch (the port's `flash_attend` on the CPU, the Pallas kernel in
interpret mode on the JAX side). Also the port's own "cached rollout ==
eager fresh-forward rollout" check, copied from tests/test_generate.py.

Tolerances: latents 2e-4, decoded rewards and values 2e-3, log probs 2e-4
(those of the JAX package's own eager-vs-cached test: float32 through the
trunk, the Euler steps and the 255-bin decodes); the agent embeddings 1e-4.
Actions, terminals and lengths are exact.
"""
import jax
import numpy as np
import pytest
import torch

from dreamer4_tpu.models.generate import generate as jgenerate
from dreamer4_tpu.models.world_model import DynamicsWorldModel as JWorldModel
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.models import generate as generate_module
from dreamer4_torch.models.generate import generate
from dreamer4_torch.models.world_model import DynamicsWorldModel
from dreamer4_torch.ops import flash_attention as port_flash

torch.set_num_threads(1)
SMALL = dict(dim=64, dim_latent=8, num_latent_tokens=4, num_spatial_tokens=4, max_steps=16,
             depth=4, time_block_every=2, attn_heads=2, attn_dim_head=32,
             num_discrete_actions=(4,), multi_token_pred_len=2, num_register_tokens=2,
             predict_terminals=True)
# 9 tokens per frame. The prompt pass's time attention (P x T = 8 x 12 = 96
# scores) crosses this gate; space attention (81) and the decode steps'
# time attention (1 x 12) stay under it, as in the bench model's prompted
# rollout at its own sizes.
FLASH_GATE = 90
B, T_PROMPTED, P = 2, 12, 8
T_UNPROMPTED = 5
ROLLOUT = dict(num_steps=2, batch_size=B, min_dream_length=3)


def build_pair(**kw):
    cfg = {**SMALL, **kw}
    jm = JWorldModel(**cfg)
    rngs = {'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)}
    params = jm.init(rngs, latents=np.zeros((2, 3, 4, 8), np.float32), shortcut_train=False,
                     rewards=np.zeros((2, 3), np.float32), terminals=np.zeros((2,), bool),
                     discrete_actions=np.zeros((2, 2, 1), np.int32))['params']
    params = jax.tree.map(np.asarray, params)
    tm = DynamicsWorldModel(**cfg, device='cpu')
    tm.load_state_dict(flax_params_to_torch(params, tm))
    return jm, params, tm


def jax_draws(key, num_action_types: int):
    """The draws of the JAX `generate` for `key`, in the port's `draw`
    signature: split once for the prompt context, then per frame
    fold_in(key, i) split five ways (noise, proprio noise, terminal, action,
    forward)."""
    key, k_init = jax.random.split(key)
    k_ctx, _ = jax.random.split(k_init)

    def draw(kind, frame, shape, *, generator, device, part=0):
        if kind == 'context_noise':
            x = jax.random.normal(k_ctx, shape)
        else:
            k_noise, _, k_term, k_act, _ = jax.random.split(jax.random.fold_in(key, frame), 5)
            if kind == 'noise':
                x = jax.random.normal(k_noise, shape)
            elif kind == 'terminal':
                x = jax.random.uniform(k_term, shape)   # jax.random.bernoulli's draw
            else:
                k_discrete, _ = jax.random.split(k_act)
                x = jax.random.gumbel(jax.random.split(k_discrete, num_action_types)[part], shape)
        return torch.from_numpy(np.array(x)).to(device)

    return draw


def seeded_draws(kind, frame, shape, *, generator, device, part=0):
    """Draws that depend only on (kind, frame, part): a cached and an eager
    rollout that ask for the same draw get the same numbers."""
    rng = np.random.default_rng([('context_noise', 'noise', 'terminal', 'action').index(kind),
                                 frame, part])
    if kind == 'terminal':
        x = rng.uniform(size=shape)
    elif kind == 'action':
        x = -np.log(-np.log(rng.uniform(1e-12, 1.0, size=shape)))
    else:
        x = rng.standard_normal(shape)
    return torch.from_numpy(x.astype(np.float32)).to(device)


def prompt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, P, 4, 8)).astype(np.float32),
            rng.integers(0, 4, (B, P, 1)).astype(np.int32))


def close(a, b, atol):
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
    np.testing.assert_allclose(np.asarray(a), b, atol=atol, rtol=0)


@pytest.mark.parametrize('prompted', [False, True])
def test_generate_matches_jax(prompted, monkeypatch):
    jm, params, tm = build_pair(use_flash_attention=True, flash_min_scores=FLASH_GATE)
    T = T_PROMPTED if prompted else T_UNPROMPTED
    forced = np.random.default_rng(1).integers(0, 4, (B, T, 1)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    kw = dict(ROLLOUT, time_steps=T)
    prompt = {}
    if prompted:
        lat, acts = prompt_inputs()
        prompt = dict(prompt_latents=lat, prompt_discrete_actions=acts)

    jexp = jax.jit(lambda p, f, pr: jgenerate(jm, {'params': p}, key, forced_discrete_actions=f,
                                               **kw, **pr))(params, forced, prompt)

    flash_calls = []
    reference = port_flash.flash_attend_reference
    monkeypatch.setattr(port_flash, 'flash_attend_reference',
                        lambda *a, **k: flash_calls.append(a[0].shape) or reference(*a, **k))
    monkeypatch.setattr(generate_module, 'draw', jax_draws(key, 1))
    texp = generate(tm, torch.Generator(), forced_discrete_actions=torch.from_numpy(forced),
                    **kw, **{k: torch.from_numpy(v) for k, v in prompt.items()})

    # the flash branch ran once per time layer, on the prompt pass only
    n_time = SMALL['depth'] // SMALL['time_block_every']
    assert flash_calls == ([(B * 9, 2, P, 32)] * n_time if prompted else [])

    np.testing.assert_array_equal(np.asarray(jexp.lens), texp.lens.numpy())
    np.testing.assert_array_equal(np.asarray(jexp.terminals), texp.terminals.numpy())
    np.testing.assert_array_equal(np.asarray(jexp.actions.discrete), texp.actions.discrete.numpy())
    close(jexp.latents, texp.latents, 2e-4)
    close(jexp.agent_embed, texp.agent_embed, 1e-4)
    close(jexp.rewards, texp.rewards, 2e-3)
    close(jexp.values, texp.values, 2e-3)
    close(jexp.log_probs.discrete, texp.log_probs.discrete, 2e-4)
    close(jexp.terminal_probs, texp.terminal_probs, 2e-4)
    close(jexp.episode_return, texp.episode_return, 2e-2)
    close(jexp.old_action_unembeds[0][0], texp.old_action_unembeds[0][0], 2e-4)
    assert texp.prompt_len == P * prompted and texp.step_size == 8


def eager_generate(model, *, time_steps, num_steps, batch_size, prompt_latents=None,
                   prompt_discrete_actions=None, context_signal_noise=0.1,
                   min_dream_length=0):
    """Straight-line rollout with a FRESH parallel forward per step (no KV
    cache): at frame i every denoise step runs the prefix 0..i and takes the
    last frame's prediction. Same draws as `generate` (`seeded_draws`), so any
    cache or bookkeeping fault of the cached rollout shows as divergence."""
    K = model.max_steps
    step_size = K // num_steps
    b, T = batch_size, time_steps
    n, d = model.latent_shape
    rnd = lambda kind, frame, shape, part=0: seeded_draws(kind, frame, shape, generator=None,
                                                          device='cpu', part=part)
    P = 0
    lat_hist, clean_hist, act_hist = [], [], []
    if prompt_latents is not None:
        P = prompt_latents.shape[1]
        noised_prompt = prompt_latents + (rnd('context_noise', 0, (b, P, n, d))
                                          - prompt_latents) * context_signal_noise
        lat_hist = [noised_prompt[:, j] for j in range(P)]
        clean_hist = [prompt_latents[:, j] for j in range(P)]
        act_hist = [prompt_discrete_actions[:, j].long() for j in range(P)]
    rewards, values, lps, lens = [], [], [], torch.full((b,), T)
    terminals = torch.zeros((b,), dtype=torch.bool)

    def fwd(latents_seq, signal_levels, actions_seq):
        return model(latents=torch.stack(latents_seq, dim=1), signal_levels=signal_levels,
                     step_sizes=torch.full((b,), step_size),
                     discrete_actions=torch.stack(actions_seq, dim=1),
                     latent_is_noised=True, return_intermediates=True)

    for i in range(P, T):
        noised = rnd('noise', i, (b, 1, 1, n, d))[:, 0, 0]
        dummy_act = torch.zeros((b, 1), dtype=torch.long)
        for s in range(num_steps):
            signal_val = s * step_size
            sig = torch.cat([torch.full((b, i), K - 1), torch.full((b, 1), signal_val)], dim=1)
            pred, _ = fwd(lat_hist + [noised], sig, act_hist + [dummy_act])
            flow = (pred.flow[:, -1, 0] - noised) / (1.0 - signal_val / K)
            noised = noised + flow * (step_size / K)
        denoised = noised

        _, (embeds, _) = fwd(lat_hist + [denoised], torch.full((b, i + 1), K - 1),
                             act_hist + [dummy_act])
        agent = embeds.agent[:, -1, 0]
        rewards.append(model.reward_encoder.decode(model.to_reward_pred(agent)[0]))

        term_logits = model.to_state_terminal_pred(denoised.mean(dim=-2))[..., 0]
        is_terminal = rnd('terminal', i, (b,)) < torch.sigmoid(term_logits)
        is_terminal &= (i - P) >= (min_dream_length - 1)
        lens = torch.where(is_terminal & ~terminals, i + 1, lens)
        terminals = terminals | is_terminal

        policy_embed = model.policy_head(agent)
        sampled, _ = model.action_embedder.sample(policy_embed, [rnd('action', i, (b, 4))])
        lps.append(model.action_embedder.log_probs(policy_embed, discrete_targets=sampled,
                                                   pred_head_index=0).discrete)
        values.append(model.value_encoder.decode(model.value_head(agent)))
        act_hist.append(sampled)
        lat_hist.append(denoised)
        clean_hist.append(denoised)
        if bool(terminals.all()):
            break

    return dict(latents=torch.stack(clean_hist, dim=1).clamp(-1, 1),
                rewards=torch.stack(rewards, dim=1), actions=torch.stack(act_hist[P:], dim=1),
                log_probs=torch.stack(lps, dim=1), values=torch.stack(values, dim=1),
                terminals=terminals, lens=lens.clamp(max=len(clean_hist)))


@pytest.mark.parametrize('prompted', [False, True])
def test_cached_rollout_matches_eager_rollout(prompted, monkeypatch):
    torch.manual_seed(0)
    model = DynamicsWorldModel(**SMALL, device='cpu')
    monkeypatch.setattr(generate_module, 'draw', seeded_draws)
    kw = dict(time_steps=6, num_steps=2, batch_size=B, min_dream_length=2)
    prompt = {}
    if prompted:
        lat, acts = prompt_inputs(seed=2)
        prompt = dict(prompt_latents=torch.from_numpy(lat[:, :2]),
                      prompt_discrete_actions=torch.from_numpy(acts[:, :2]))
    with torch.no_grad():
        exp = generate(model, torch.Generator(), **kw, **prompt)
        ref = eager_generate(model, **kw, **prompt)

    Pn = exp.prompt_len
    m = int(exp.lens.max())   # frames both rollouts generated
    np.testing.assert_array_equal(exp.lens.numpy(), ref['lens'].numpy())
    np.testing.assert_array_equal(exp.terminals.numpy(), ref['terminals'].numpy())
    np.testing.assert_array_equal(exp.actions.discrete[:, Pn:m].numpy(),
                                  ref['actions'][:, :m - Pn].numpy())
    close(exp.latents[:, :m].numpy(), ref['latents'][:, :m], 2e-4)
    close(exp.rewards[:, Pn:m].numpy(), ref['rewards'][:, :m - Pn], 2e-3)
    close(exp.values[:, Pn:m].numpy(), ref['values'][:, :m - Pn], 2e-3)
    close(exp.log_probs.discrete[:, Pn:m].numpy(), ref['log_probs'][:, :m - Pn], 2e-4)


def test_generate_refuses_bad_arguments():
    model = DynamicsWorldModel(**SMALL, device='cpu')
    with pytest.raises(ValueError):
        generate(model, torch.Generator(), time_steps=4, num_steps=3)
    with pytest.raises(ValueError):
        generate(model, torch.Generator(), time_steps=2,
                 prompt_latents=torch.zeros(1, 2, 4, 8))


def test_generate_draws_from_generator():
    """Without a replaced `draw`, two seeds give two rollouts and one seed
    gives the same rollout twice."""
    torch.manual_seed(0)
    model = DynamicsWorldModel(**SMALL, device='cpu')
    run = lambda seed: generate(model, torch.Generator().manual_seed(seed), time_steps=3,
                                num_steps=2, batch_size=B, predict_terminals=False)
    a, b, c = run(0), run(0), run(1)
    torch.testing.assert_close(a.latents, b.latents, rtol=0, atol=0)
    assert not torch.allclose(a.latents, c.latents)
    assert a.latents.shape == (B, 3, 4, 8) and a.latents.abs().max() <= 1.0
