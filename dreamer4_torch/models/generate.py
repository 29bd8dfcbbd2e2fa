"""Imagination rollout (counterpart of `dreamer4_tpu/models/generate.py`).

The counterpart is one `lax.while_loop` over frames; here it is a Python
frame loop over preallocated output buffers and the model's preallocated KV
caches, with the same early stop. Per frame: `num_steps` Euler denoise
steps, one clean step that commits the frame to the cache and yields the
agent embedding, then reward decode, terminal draw, action sample, log prob
and value off that embedding. A prompt runs as one parallel prefill that
fills the cache; at long prompts its time attention is the flash kernel.

Every random draw goes through the module-level `draw`, so a test can
replace it to replay the counterpart's draws.
"""
from __future__ import annotations

import torch

from ..data.experience import Experience
from ..nn.action_embedder import Actions
from ..ops import dists
from .world_model import DynamicsWorldModel


def draw(kind: str, frame: int, shape, *, generator: torch.Generator, device,
         part: int = 0) -> torch.Tensor:
    """One random draw of the rollout.

    kind: 'context_noise' — normal noise of the prompt (frame 0);
          'noise'         — normal start of frame `frame`'s denoising;
          'terminal'      — uniform draw of the frame's terminal Bernoulli;
          'action'        — Gumbel noise of discrete action type `part`.
    """
    if kind in ('context_noise', 'noise'):
        return torch.randn(shape, generator=generator, device=device)
    if kind == 'terminal':
        return torch.rand(shape, generator=generator, device=device)
    if kind == 'action':
        return dists.gumbel(shape, generator=generator, device=device)
    raise ValueError(f'unknown draw {kind}')


@torch.no_grad()
def generate(model: DynamicsWorldModel, generator: torch.Generator, *, time_steps: int,
             num_steps: int = 4, batch_size: int = 1, agent_index: int = 0,
             context_signal_noise: float = 0.1,
             prompt_latents: torch.Tensor | None = None,            # (b, p, n, d)
             prompt_discrete_actions: torch.Tensor | None = None,   # (b, p, na)
             prompt_rewards: torch.Tensor | None = None,            # (b, p)
             discrete_temperature: float = 1.0,
             forced_discrete_actions: torch.Tensor | None = None,   # (b, T, na)
             return_agent_actions: bool | None = None,
             predict_terminals: bool | None = None,
             terminal_logit_offset: float = 0.0, min_dream_length: int = 0,
             hard_terminals: bool = True) -> Experience:
    """Roll `model` out for `time_steps` frames on the model's device, with
    random draws from `generator` (on the same device). Returns an
    `Experience` with buffers padded to `time_steps` and `lens` marking
    validity."""
    K = model.max_steps
    if num_steps <= 0 or K % num_steps != 0:
        raise ValueError(f'num_steps {num_steps} must divide max_steps {K}')
    step_size = K // num_steps
    T, b = time_steps, batch_size
    n, d_lat = model.latent_shape
    V = model.num_video_views
    dim = model.dim
    device = model.device
    if return_agent_actions is None:
        return_agent_actions = model.has_actions
    if predict_terminals is None:
        predict_terminals = model.predict_terminals
    na_d = len([x for x in model.num_discrete_actions if x > 0])
    rnd = lambda kind, frame, shape, part=0: draw(kind, frame, shape, generator=generator,
                                                  device=device, part=part)

    P = prompt_latents.shape[1] if prompt_latents is not None else 0
    if P >= T:
        raise ValueError('prompt must be shorter than requested time_steps')
    if prompt_latents is not None and prompt_latents.ndim == 4:
        prompt_latents = prompt_latents[:, :, None]

    # ------------------------------------------------------------- buffers
    # every buffer is written in place, one frame at a time
    f32 = dict(dtype=torch.float32, device=device)
    latents_buf = torch.zeros((b, T, V, n, d_lat), **f32)
    if P > 0:
        latents_buf[:, :P] = prompt_latents
    rewards_buf = torch.zeros((b, T), **f32)
    if prompt_rewards is not None:
        rewards_buf[:, :prompt_rewards.shape[1]] = prompt_rewards
    disc_buf = torch.zeros((b, T, max(na_d, 1)), dtype=torch.long, device=device)
    if prompt_discrete_actions is not None:
        disc_buf[:, :prompt_discrete_actions.shape[1]] = prompt_discrete_actions
    d_logprob_buf = torch.zeros((b, T, max(na_d, 1)), **f32)
    values_buf = torch.zeros((b, T), **f32)
    agent_embed_buf = torch.zeros((b, T, dim), **f32)
    policy_embed_buf = torch.zeros((b, T, dim * 4), **f32)
    term_prob_buf = torch.zeros((b, T), **f32)
    terminals = torch.zeros((b,), dtype=torch.bool, device=device)
    lens = torch.full((b,), T, dtype=torch.long, device=device)

    common = dict(latent_is_noised=True, latent_has_view_dim=True, agent_index=agent_index)

    # -------------------------------------------------- prompt pass -> cache
    if P > 0:
        ctx_noise = rnd('context_noise', 0, (b, P, V, n, d_lat))
        noised_prompt = prompt_latents + (ctx_noise - prompt_latents) * context_signal_noise
        prompt_kwargs = dict(latents=noised_prompt, signal_levels=K - 1, step_sizes=step_size)
        if model.has_actions and prompt_discrete_actions is not None:
            prompt_kwargs['discrete_actions'] = prompt_discrete_actions[:, :P]
        if model.add_reward_embed_to_agent_token and prompt_rewards is not None:
            prompt_kwargs['rewards'] = prompt_rewards[:, :P]
        _, (_, cache) = model(**common, **prompt_kwargs, return_intermediates=True,
                              max_time=T)
    else:
        cache = model.init_cache(b, T)

    # ----------------------------------------------------------- frame loop
    step_sizes = torch.full((b,), step_size, dtype=torch.long, device=device)
    i = P
    while i < T:
        noised = rnd('noise', i, (b, 1, V, n, d_lat))
        prev = max(i - 1, 0)
        prev_valid = torch.full((b, 1), float(i > 0), **f32)
        cond = {}
        if model.has_actions:
            cond['discrete_actions'] = disc_buf[:, prev:prev + 1]
            cond['action_token_mask'] = prev_valid
        if model.add_reward_embed_to_agent_token:
            cond['rewards'] = rewards_buf[:, prev:prev + 1]
            cond['reward_token_mask'] = prev_valid

        for s in range(num_steps):
            signal_val = s * step_size
            pred = model(**common, **cond, latents=noised, cache=cache,
                         signal_levels=torch.full((b, 1), signal_val, dtype=torch.long,
                                                  device=device),
                         step_sizes=step_sizes)
            t_frac = signal_val / K
            flow = ((pred.flow - noised) / (1.0 - t_frac) if model.pred_orig_latent
                    else pred.flow)
            noised = noised + flow * (step_size / K)
        denoised = noised

        # the clean step commits the frame to the cache
        _, (embeds, cache) = model(**common, **cond, latents=denoised, cache=cache,
                                   signal_levels=torch.full((b, 1), K - 1, dtype=torch.long,
                                                            device=device),
                                   step_sizes=step_sizes, return_intermediates=True)
        one_agent_embed = embeds.agent[:, 0, agent_index]                   # (b, dim)

        reward_logits = model.to_reward_pred(one_agent_embed)[0]
        rewards_buf[:, i] = model.reward_encoder.decode(reward_logits)

        if predict_terminals:
            pooled = denoised[:, 0].reshape(b, V * n, d_lat).mean(dim=-2)
            term_logits = model.to_state_terminal_pred(pooled)[..., 0]
            term_prob_buf[:, i] = torch.sigmoid(term_logits)
            if hard_terminals:
                p_term = torch.sigmoid(term_logits - terminal_logit_offset)
                is_terminal = rnd('terminal', i, (b,)) < p_term
                is_terminal &= (i - P) >= (min_dream_length - 1)
                just_terminated = is_terminal & ~terminals
                lens = torch.where(just_terminated, i + 1, lens)
                terminals = terminals | is_terminal

        agent_embed_buf[:, i] = one_agent_embed

        if return_agent_actions and model.has_actions:
            policy_embed = model.policy_head(one_agent_embed)
            policy_embed_buf[:, i] = policy_embed
            sizes = model.action_embedder.discrete_sizes
            gumbels = [rnd('action', i, (b, size), part=j) for j, size in enumerate(sizes)]
            sampled_d, _ = model.action_embedder.sample(
                policy_embed, gumbels, discrete_temperature=discrete_temperature)
            if forced_discrete_actions is not None:
                sampled_d = forced_discrete_actions[:, i].to(device=device, dtype=torch.long)
            disc_buf[:, i] = sampled_d
            lp = model.action_embedder.log_probs(policy_embed, discrete_targets=sampled_d,
                                                 pred_head_index=0)
            d_logprob_buf[:, i] = lp.discrete
            values_buf[:, i] = model.value_encoder.decode(model.value_head(one_agent_embed))

        latents_buf[:, i] = denoised[:, 0]
        i += 1
        # the counterpart's while-condition; a host sync only when it applies
        if predict_terminals and hard_terminals and bool(terminals.all()):
            break

    latents_buf = latents_buf.clamp(-1.0, 1.0)
    if V == 1:
        latents_buf = latents_buf[:, :, 0]
    lens = lens.clamp(max=i)
    step_mask = (torch.arange(T, device=device)[None] < lens[:, None]).float()
    episode_return = (rewards_buf * step_mask).sum(dim=1)

    with_actions = return_agent_actions and model.has_actions
    old_action_unembeds = (model.action_embedder.unembed(policy_embed_buf, pred_head_index=0)
                           if with_actions else None)
    return Experience(
        latents=latents_buf,
        agent_embed=agent_embed_buf,
        rewards=rewards_buf,
        terminals=terminals,
        terminal_probs=term_prob_buf if predict_terminals else None,
        prompt_len=P,
        actions=Actions(disc_buf, None) if with_actions else None,
        log_probs=Actions(d_logprob_buf, None) if with_actions else None,
        old_action_unembeds=old_action_unembeds,
        values=values_buf if with_actions else None,
        step_size=step_size,
        lens=lens,
        is_truncated=~terminals,
        agent_index=agent_index,
        is_from_world_model=True,
        episode_return=episode_return,
    )
