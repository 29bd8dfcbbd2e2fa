"""Imagination rollout (counterpart of `dreamer4_tpu/models/generate.py`).

The counterpart is one `lax.while_loop` over frames; here it is a Python
frame loop over preallocated output buffers and the model's preallocated KV
caches, with the same early stop. Per frame: `num_steps` Euler denoise
steps, one clean step that commits the frame to the cache and yields the
agent embedding, then reward decode, terminal draw, action sample, log prob
and value off that embedding (with `actor_critic_latent_input`, the policy
and value off the latent encoders' reading of the denoised frame). A prompt runs as one parallel prefill that
fills the cache; at long prompts its time attention is the flash kernel.

Every random draw goes through the module-level `draw`, so a test can
replace it to replay the counterpart's draws.
"""
from __future__ import annotations

from functools import partial

import torch

from ..data.experience import Experience
from ..nn.action_embedder import Actions
from ..ops import dists
from .world_model import DynamicsWorldModel


def draw(kind: str, frame: int, shape, *, generator: torch.Generator, device,
         part: int = 0, concentration=None) -> torch.Tensor:
    """One random draw of the rollout.

    kind: 'context_noise'         — normal noise of the prompt (frame 0);
          'context_proprio_noise' — normal noise of the prompt's proprio;
          'noise'                 — normal start of frame `frame`'s denoising;
          'proprio_noise'         — normal start of its proprio's denoising;
          'terminal'              — uniform draw of the frame's terminal Bernoulli;
          'action'                — Gumbel noise of discrete action type `part`;
          'continuous_action'     — standard normal noise of the Gaussian
                                    actions, or Beta draws where
                                    `concentration` gives (alpha, beta).
    """
    if kind in ('context_noise', 'context_proprio_noise', 'noise', 'proprio_noise'):
        return torch.randn(shape, generator=generator, device=device)
    if kind == 'terminal':
        return torch.rand(shape, generator=generator, device=device)
    if kind == 'action':
        return dists.gumbel(shape, generator=generator, device=device)
    if kind == 'continuous_action':
        if concentration is not None:
            return dists.beta_sample(*concentration, generator=generator)
        return torch.randn(shape, generator=generator, device=device)
    raise ValueError(f'unknown draw {kind}')


@torch.no_grad()
def generate(model: DynamicsWorldModel, generator: torch.Generator, *, time_steps: int,
             num_steps: int = 4, batch_size: int = 1, agent_index: int = 0,
             tasks: torch.Tensor | None = None,                      # (b,)
             latent_gene_ids: torch.Tensor | None = None,            # (b,)
             context_signal_noise: float = 0.1,
             prompt_latents: torch.Tensor | None = None,            # (b, p, [v,] n, d)
             prompt_discrete_actions: torch.Tensor | None = None,   # (b, p, na)
             prompt_continuous_actions: torch.Tensor | None = None,  # (b, p, na_c)
             prompt_rewards: torch.Tensor | None = None,            # (b, p)
             prompt_proprio: torch.Tensor | None = None,            # (b, p, dp)
             discrete_temperature: float = 1.0, continuous_temperature: float = 1.0,
             forced_discrete_actions: torch.Tensor | None = None,   # (b, T, na)
             forced_continuous_actions: torch.Tensor | None = None,  # (b, T, na_c)
             return_agent_actions: bool | None = None,
             predict_terminals: bool | None = None,
             terminal_logit_offset: float = 0.0, min_dream_length: int = 0,
             hard_terminals: bool = True) -> Experience:
    """Roll `model` out for `time_steps` frames on the model's device, with
    random draws from `generator` (on the same device). Returns an
    `Experience` with buffers padded to `time_steps` and `lens` marking
    validity. Forced actions replace the policy's samples; their log probs
    are those of the executed actions. `tasks` and `latent_gene_ids`
    condition the prompt pass and every denoise and clean step."""
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
    na_c = model.num_continuous_actions
    has_proprio = model.has_proprio
    rnd = lambda kind, frame, shape, **kw: draw(kind, frame, shape, generator=generator,
                                                device=device, **kw)

    P = prompt_latents.shape[1] if prompt_latents is not None else 0
    if P >= T:
        raise ValueError('prompt must be shorter than requested time_steps')
    if prompt_latents is not None and prompt_latents.ndim == 4:
        if V != 1:
            raise ValueError('a multi-view model needs (b, p, v, n, d) prompt latents')
        prompt_latents = prompt_latents[:, :, None]

    # ------------------------------------------------------------- buffers
    # every buffer is written in place, one frame at a time
    f32 = dict(dtype=torch.float32, device=device)
    latents_buf = torch.zeros((b, T, V, n, d_lat), **f32)
    if P > 0:
        latents_buf[:, :P] = prompt_latents
    proprio_buf = torch.zeros((b, T, model.dim_proprio), **f32) if has_proprio else None
    if has_proprio and prompt_proprio is not None:
        proprio_buf[:, :P] = prompt_proprio
    rewards_buf = torch.zeros((b, T), **f32)
    if prompt_rewards is not None:
        rewards_buf[:, :prompt_rewards.shape[1]] = prompt_rewards
    disc_buf = torch.zeros((b, T, max(na_d, 1)), dtype=torch.long, device=device)
    if prompt_discrete_actions is not None:
        disc_buf[:, :prompt_discrete_actions.shape[1]] = prompt_discrete_actions
    cont_buf = torch.zeros((b, T, max(na_c, 1)), **f32)
    if prompt_continuous_actions is not None:
        cont_buf[:, :prompt_continuous_actions.shape[1]] = prompt_continuous_actions
    d_logprob_buf = torch.zeros((b, T, max(na_d, 1)), **f32)
    c_logprob_buf = torch.zeros((b, T, max(na_c, 1)), **f32)
    values_buf = torch.zeros((b, T), **f32)
    agent_embed_buf = torch.zeros((b, T, dim), **f32)
    policy_embed_buf = torch.zeros((b, T, dim * 4), **f32)
    term_prob_buf = torch.zeros((b, T), **f32)
    terminals = torch.zeros((b,), dtype=torch.bool, device=device)
    lens = torch.full((b,), T, dtype=torch.long, device=device)

    common = dict(latent_is_noised=True, latent_has_view_dim=True, agent_index=agent_index,
                  tasks=tasks, latent_gene_ids=latent_gene_ids)

    # -------------------------------------------------- prompt pass -> cache
    if P > 0:
        ctx_noise = rnd('context_noise', 0, (b, P, V, n, d_lat))
        noised_prompt = prompt_latents + (ctx_noise - prompt_latents) * context_signal_noise
        prompt_kwargs = dict(latents=noised_prompt, signal_levels=K - 1, step_sizes=step_size)
        if model.has_actions and prompt_discrete_actions is not None:
            prompt_kwargs['discrete_actions'] = prompt_discrete_actions[:, :P]
        if model.has_actions and prompt_continuous_actions is not None:
            prompt_kwargs['continuous_actions'] = prompt_continuous_actions[:, :P]
        if model.add_reward_embed_to_agent_token and prompt_rewards is not None:
            prompt_kwargs['rewards'] = prompt_rewards[:, :P]
        if has_proprio:
            pp = (prompt_proprio[:, :P].to(device=device, dtype=torch.float32)
                  if prompt_proprio is not None else torch.zeros((b, P, model.dim_proprio), **f32))
            ctx_pnoise = rnd('context_proprio_noise', 0, pp.shape)
            prompt_kwargs['proprio'] = pp + (ctx_pnoise - pp) * context_signal_noise
        _, (_, cache) = model(**common, **prompt_kwargs, return_intermediates=True,
                              max_time=T)
    else:
        cache = model.init_cache(b, T)

    # ----------------------------------------------------------- frame loop
    step_sizes = torch.full((b,), step_size, dtype=torch.long, device=device)
    i = P
    while i < T:
        noised = rnd('noise', i, (b, 1, V, n, d_lat))
        noised_proprio = rnd('proprio_noise', i, (b, 1, model.dim_proprio)) if has_proprio else None
        prev = max(i - 1, 0)
        prev_valid = torch.full((b, 1), float(i > 0), **f32)
        cond = {}
        if model.has_actions:
            if na_d > 0:
                cond['discrete_actions'] = disc_buf[:, prev:prev + 1]
            if na_c > 0:
                cond['continuous_actions'] = cont_buf[:, prev:prev + 1]
            cond['action_token_mask'] = prev_valid
        if model.add_reward_embed_to_agent_token:
            cond['rewards'] = rewards_buf[:, prev:prev + 1]
            cond['reward_token_mask'] = prev_valid

        for s in range(num_steps):
            signal_val = s * step_size
            pred = model(**common, **cond, latents=noised, proprio=noised_proprio, cache=cache,
                         signal_levels=torch.full((b, 1), signal_val, dtype=torch.long,
                                                  device=device),
                         step_sizes=step_sizes)
            t_frac = signal_val / K
            flow = ((pred.flow - noised) / (1.0 - t_frac) if model.pred_orig_latent
                    else pred.flow)
            noised = noised + flow * (step_size / K)
            if has_proprio:
                pflow = ((pred.proprio - noised_proprio) / (1.0 - t_frac)
                         if model.pred_orig_latent else pred.proprio)
                noised_proprio = noised_proprio + pflow * (step_size / K)
        denoised, denoised_proprio = noised, noised_proprio

        # the clean step commits the frame to the cache
        _, (embeds, cache) = model(**common, **cond, latents=denoised, proprio=denoised_proprio,
                                   cache=cache,
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
            actor_src = critic_src = one_agent_embed
            if model.actor_critic_latent_input:
                # a multi-view model's encoders read every view
                actor_src, critic_src = model.latent_actor_inputs(
                    denoised[:, 0] if V > 1 else denoised[:, 0, 0])
            policy_embed = model.policy_head(actor_src)
            policy_embed_buf[:, i] = policy_embed
            sizes = model.action_embedder.discrete_sizes
            gumbels = [rnd('action', i, (b, size), part=j) for j, size in enumerate(sizes)]
            noise = (model.action_embedder.continuous_noise(
                partial(rnd, 'continuous_action', i), (b, na_c)) if na_c > 0 else None)
            sampled_d, sampled_c = model.action_embedder.sample(
                policy_embed, gumbels, noise, discrete_temperature=discrete_temperature,
                continuous_temperature=continuous_temperature)
            if forced_discrete_actions is not None and na_d > 0:
                sampled_d = forced_discrete_actions[:, i].to(device=device, dtype=torch.long)
            if forced_continuous_actions is not None and na_c > 0:
                sampled_c = forced_continuous_actions[:, i].to(device=device,
                                                               dtype=torch.float32)
            if na_d > 0:
                disc_buf[:, i] = sampled_d
            if na_c > 0:
                cont_buf[:, i] = sampled_c
            lp = model.action_embedder.log_probs(policy_embed, discrete_targets=sampled_d,
                                                 continuous_targets=sampled_c,
                                                 pred_head_index=0)
            if na_d > 0:
                d_logprob_buf[:, i] = lp.discrete
            if na_c > 0:
                c_logprob_buf[:, i] = lp.continuous
            values_buf[:, i] = model.value_encoder.decode(model.value_head(critic_src))

        latents_buf[:, i] = denoised[:, 0]
        if has_proprio:
            proprio_buf[:, i] = denoised_proprio[:, 0]
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
    pick = lambda d, c: Actions(d if na_d > 0 else None, c if na_c > 0 else None)
    return Experience(
        latents=latents_buf,
        proprio=proprio_buf,
        agent_embed=agent_embed_buf,
        rewards=rewards_buf,
        terminals=terminals,
        terminal_probs=term_prob_buf if predict_terminals else None,
        prompt_len=P,
        actions=pick(disc_buf, cont_buf) if with_actions else None,
        log_probs=pick(d_logprob_buf, c_logprob_buf) if with_actions else None,
        old_action_unembeds=old_action_unembeds,
        values=values_buf if with_actions else None,
        step_size=step_size,
        lens=lens,
        is_truncated=~terminals,
        agent_index=agent_index,
        is_from_world_model=True,
        episode_return=episode_return,
    )
