"""Policy and value learning from experience: PPO, PMPO and SPO
(counterpart of `dreamer4_tpu/models/rl.py`).

The counterpart is one pure loss function of (variables, experience); here
the model holds its parameters and the losses carry their autograd graph.
Experiences are padded buffers with `lens` / `is_truncated` marking
validity; bootstrap nodes are left out by masks. The EMA return statistics
are explicit state, passed in and returned.

Discrete and continuous actions are learned alike: their log probs are
summed over the action types, their entropies enter the entropy bonus, and
PMPO's KL term adds the continuous KL to the discrete one. A full-model
replay passes the experience's proprioception to the trunk. A critic state
(an environment's privileged state, `dim_critic_state`) is embedded and
added to the value head's input. With `actor_critic_latent_input` the
heads read `latent_actor_inputs(latents)` and the trunk is never replayed,
so full-model RL cannot train it (`latent_input_full_model_ok`). With
`actor_spr` the actor's self-predictive rollout loss joins the policy loss.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..data.experience import Experience
from ..ops.scan import calc_gae
from ..ops.utils import frac_gradient, lens_to_mask, masked_mean, z_score
from .world_model import DynamicsWorldModel

OBJECTIVES = ('ppo', 'pmpo', 'spo')


class ReturnStats(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor

    @classmethod
    def create(cls, device=None):
        return cls(mean=torch.zeros((), device=device), var=torch.ones((), device=device))


class RLLossOutputs(NamedTuple):
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    stats: dict
    return_stats: ReturnStats


def _masked_quantile_clip(x, mask, quantiles):
    """Clamp x to the quantiles of its values where `mask` holds (the others
    are NaN to `nanquantile`, which interpolates linearly, as
    `jnp.nanquantile` does)."""
    big = torch.where(mask, x, torch.nan)
    lo = torch.nanquantile(big.flatten(), quantiles[0])
    hi = torch.nanquantile(big.flatten(), quantiles[1])
    return torch.minimum(torch.maximum(x, lo), hi)


def _cat_actions(pair: tuple) -> torch.Tensor:
    """The discrete and continuous halves of an Actions pair, concatenated
    along the action types."""
    return torch.cat([p for p in pair if p is not None], dim=-1)


def rl_losses(model: DynamicsWorldModel, experience: Experience, objective: str = 'ppo',
              only_learn_policy_value_heads: bool = True,
              return_stats: ReturnStats | None = None,
              use_delight_gating: bool | None = None, delight_temperature: float | None = None,
              normalize_advantages: bool | None = None,
              encode_video_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
              soft_continuation: bool = True, latent_input_full_model_ok: bool = False,
              eps: float = 1e-6) -> RLLossOutputs:
    """Policy and value losses from an Experience.

    With `only_learn_policy_value_heads=False`, or when the experience holds
    no agent embeddings, the trunk is re-forwarded over the whole experience
    (the clean signal level, `is_training=False`): with gradients in
    full-model RL, under `torch.no_grad()` for the heads alone. An
    experience without latents is encoded from its video by
    `encode_video_fn(video)` (the image-encoder RL path; the callable owns
    its module), with the latents detached for the heads alone.

    `soft_continuation=False` ignores the terminal probabilities for the
    GAE discount and the alive weights, leaving the hard terminals as the
    only termination mechanism.

    A model with `actor_critic_latent_input` feeds the heads from its latent
    encoders and never replays the trunk: full-model RL then trains the
    encoders, the heads (and an `encode_video_fn`'s module), never the
    trunk, and needs `latent_input_full_model_ok=True` to say so.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f'objective must be one of {OBJECTIVES}, not {objective!r}')
    if (not only_learn_policy_value_heads and model.actor_critic_latent_input
            and not latent_input_full_model_ok):
        raise ValueError(
            'only_learn_policy_value_heads=False with actor_critic_latent_input=True trains '
            'the heads and the latent (and image) encoders but never the trunk: the heads do '
            'not read its embeddings in this mode. Pass latent_input_full_model_ok=True to '
            'acknowledge, or use only_learn_policy_value_heads=True.')
    if use_delight_gating is None:
        use_delight_gating = model.use_delight_gating
    if delight_temperature is None:
        delight_temperature = model.delight_temperature

    latents = experience.latents
    if latents is None:
        if encode_video_fn is None or experience.video is None:
            raise ValueError('an experience without latents needs video and encode_video_fn '
                             '(the image-encoder RL path)')
        latents = encode_video_fn(experience.video)
        if only_learn_policy_value_heads:
            latents = latents.detach()
    b, time = latents.shape[:2]
    device = latents.device

    rewards, old_values = experience.rewards, experience.values
    old_log_probs, actions = experience.log_probs, experience.actions
    agent_embeds = experience.agent_embed
    old_action_unembeds = experience.old_action_unembeds
    step_size = experience.step_size
    if rewards is None or old_values is None or old_log_probs is None:
        raise ValueError('the experience needs rewards, values and log_probs')
    if actions is None or step_size is None:
        raise ValueError('the experience needs actions and step_size')

    lens = (experience.lens if experience.lens is not None
            else torch.full((b,), time, dtype=torch.long, device=device))
    is_truncated = (experience.is_truncated if experience.is_truncated is not None
                    else torch.ones((b,), dtype=torch.bool, device=device))

    mask_for_gae = lens_to_mask(lens, time)
    rewards = torch.where(mask_for_gae, rewards, 0.0)
    old_values = torch.where(mask_for_gae, old_values, 0.0)

    # the final (possibly bootstrapped) node is not learned on
    mask = lens_to_mask(lens - is_truncated.to(lens.dtype), time)

    # dream prompts carry replayed actions with zeroed values and log probs:
    # they anchor the rollout but are not learned on
    positions = torch.arange(time, device=device)[None]
    if experience.prompt_len:
        mask = mask & (positions >= experience.prompt_len)

    # continuation masks for GAE from the terminals
    gae_masks = lens_to_mask((lens - 1).clamp_min(0), time)
    if experience.terminals is not None:
        terminals = experience.terminals
        if terminals.ndim == 1:
            pos = (lens - 1).clamp_min(0)
            terminals = (positions == pos[:, None]) & terminals.bool()[:, None]
        gae_masks = gae_masks & ~terminals.bool()

    # soft continuation: scale the GAE discount by (1 - p_term), and weight
    # each step's loss by the probability that the dream is still alive
    # there, w_t = prod_{s<t} (1 - p_term_s)
    continuation = gae_masks.float()
    alive = None
    if experience.terminal_probs is not None and soft_continuation:
        continuation = continuation * (1.0 - experience.terminal_probs.clamp(0.0, 1.0))
        shifted = F.pad(continuation[:, :-1], (1, 0), value=1.0)
        # prompt frames are real context, alive with certainty
        if experience.prompt_len:
            shifted = torch.where(positions < experience.prompt_len + 1, 1.0, shifted)
        alive = torch.cumprod(shifted, dim=1)

    loss_weights = mask.float() * (alive if alive is not None else 1.0)

    returns = calc_gae(rewards, old_values, masks=continuation, learn_masks=mask,
                       gamma=model.gae_discount_factor, lam=model.gae_lambda)

    # return normalization by EMA statistics (DreamerV3)
    new_return_stats = (return_stats if return_stats is not None
                        else ReturnStats.create(device=device))
    if model.keep_reward_ema_stats:
        if return_stats is None:
            raise ValueError('keep_reward_ema_stats needs return_stats')
        clipped = _masked_quantile_clip(returns, mask, model.reward_quantile_filter)
        r_mean = masked_mean(clipped, loss_weights)
        r_var = masked_mean((clipped - r_mean).square(), loss_weights)
        decay = 1.0 - model.reward_ema_decay
        new_mean = return_stats.mean + decay * (r_mean - return_stats.mean)
        new_var = return_stats.var + decay * (r_var - return_stats.var)
        new_return_stats = ReturnStats(new_mean, new_var)
        std = new_var.clamp_min(1e-5).sqrt()
        advantage = (returns - new_mean) / std - (old_values - new_mean) / std
    else:
        advantage = returns - old_values

    if normalize_advantages is None:
        normalize_advantages = (model.normalize_advantages
                                if model.normalize_advantages is not None
                                else objective != 'pmpo')
    if normalize_advantages:
        advantage = z_score(advantage, mask=loss_weights, eps=eps)

    # the heads' inputs read from the latents, which concurrent world-model
    # training cannot shift
    actor_in = critic_in = None
    if model.actor_critic_latent_input:
        actor_in, critic_in = model.latent_actor_inputs(latents)

    # replay the trunk when no embeddings were stored, or to fine-tune the
    # whole model (stored embeddings carry no gradient to the trunk); the
    # latent-input heads read no embedding
    need_replay = not only_learn_policy_value_heads or agent_embeds is None
    if need_replay and not model.actor_critic_latent_input:
        with torch.set_grad_enabled(torch.is_grad_enabled() and not only_learn_policy_value_heads):
            _, (embeds, _) = model(
                latents=latents, signal_levels=model.max_steps - 1, step_sizes=step_size,
                rewards=rewards, discrete_actions=actions.discrete,
                continuous_actions=actions.continuous, proprio=experience.proprio,
                agent_index=experience.agent_index, latent_is_noised=True, is_training=False,
                return_pred_only=True, return_intermediates=True)
        agent_embeds = embeds.agent[:, :, experience.agent_index]
    if only_learn_policy_value_heads and agent_embeds is not None:
        agent_embeds = agent_embeds.detach()

    # ------------------------------------------------------------ policy
    policy_embed = model.policy_head(
        actor_in if actor_in is not None
        else frac_gradient(agent_embeds, model.agent_policy_gradient_frac))
    lp, entropies = model.action_embedder.log_probs(
        policy_embed, discrete_targets=actions.discrete, continuous_targets=actions.continuous,
        pred_head_index=0, return_entropies=True, soft_validate_range=True)
    log_probs = _cat_actions(lp).sum(dim=-1)
    old_lp = _cat_actions(old_log_probs).sum(dim=-1)
    entropy = _cat_actions(entropies)

    if use_delight_gating:
        delight_gate = torch.sigmoid((-log_probs * advantage) / delight_temperature).detach()

    if objective == 'pmpo':
        gated_lp = log_probs * delight_gate if use_delight_gating else log_probs
        pos = (advantage >= 0.0) & mask
        neg = (advantage < 0.0) & mask
        scaled = gated_lp * torch.tanh(advantage).abs()
        if alive is not None:
            scaled = scaled * alive
        pos_loss = torch.where(pos, scaled, 0.0).sum()
        neg_loss = torch.where(neg, scaled, 0.0).sum()
        num_adv = loss_weights.sum().clamp_min(1.0)
        policy_loss = -model.pmpo_pos_to_neg_weight * (pos_loss - neg_loss) / num_adv

        if model.pmpo_kl_div_loss_weight > 0.0 and old_action_unembeds is not None:
            new_unembeds = model.action_embedder.unembed(policy_embed, pred_head_index=0)
            kl_in, kl_tgt = new_unembeds, old_action_unembeds
            if model.pmpo_reverse_kl:
                kl_in, kl_tgt = kl_tgt, kl_in
            kl_loss = sum(masked_mean(kl, loss_weights)
                          for kl in model.action_embedder.kl_div(kl_in, kl_tgt)
                          if kl is not None)
            policy_loss = policy_loss + kl_loss * model.pmpo_kl_div_loss_weight

    elif objective == 'spo':
        ratio = torch.exp(log_probs - old_lp)
        loss = -(ratio * advantage
                 - (advantage.abs() * (ratio - 1.0).square()) / (2.0 * model.ppo_eps_clip))
        if use_delight_gating:
            loss = loss * delight_gate
        policy_loss = masked_mean(loss, loss_weights)

    else:  # ppo
        ratio = torch.exp(log_probs - old_lp)
        clipped = ratio.clamp(1.0 - model.ppo_eps_clip, 1.0 + model.ppo_eps_clip)
        loss = -torch.minimum(ratio * advantage, clipped * advantage)
        if use_delight_gating:
            loss = loss * delight_gate
        policy_loss = masked_mean(loss, loss_weights)

    entropy_loss = masked_mean(-entropy.sum(dim=-1), loss_weights)
    total_policy_loss = policy_loss + entropy_loss * model.policy_entropy_weight

    # the actor's self-predictive rollout, its KL read through the action
    # unembedding of the first prediction head
    if model.actor_spr:
        embedder = model.action_embedder
        action_embeds = embedder(discrete_actions=actions.discrete,
                                 continuous_actions=actions.continuous)
        actor_spr_loss, _ = model.actor_spr_module(
            policy_embed, action_embeds,
            unembed_fn=lambda e: embedder.unembed(e, pred_head_index=0),
            kl_fn=embedder.kl_div, mask=mask)
        total_policy_loss = total_policy_loss + actor_spr_loss

    # ------------------------------------------------------------- value
    # distributional cross entropy against the return's HL-Gauss bins
    value_embeds = (critic_in if critic_in is not None
                    else frac_gradient(agent_embeds, model.agent_value_gradient_frac))
    if experience.critic_state is not None and model.dim_critic_state is not None:
        value_embeds = value_embeds + model.critic_state_embedder(experience.critic_state)
    value_bins = model.value_head(value_embeds)
    values = model.value_encoder.decode(value_bins)
    return_bins = model.value_encoder.encode(returns.detach())
    value_loss_t = -(return_bins * torch.log_softmax(value_bins, dim=-1)).sum(dim=-1)

    if model.clip_values:
        clipped_values = old_values + (values - old_values).clamp(-model.value_clip,
                                                                  model.value_clip)
        clipped_bins = model.value_encoder.encode(clipped_values)
        clipped_loss = -(return_bins * clipped_bins.clamp_min(1e-20).log()).sum(dim=-1)
        value_loss_t = torch.maximum(value_loss_t, clipped_loss)

    value_loss = masked_mean(value_loss_t, loss_weights)

    with torch.no_grad():
        mean_advantage = masked_mean(advantage, mask)
        stats = dict(
            mean_return=masked_mean(returns, mask),
            mean_advantage=mean_advantage,
            adv_std=masked_mean((advantage - mean_advantage).square(), mask).sqrt(),
            mean_value=masked_mean(values, mask),
            entropy=masked_mean(entropy.sum(dim=-1), mask),
            approx_kl=masked_mean(old_lp - log_probs, mask),
        )
        if experience.terminal_probs is not None:
            stats['mean_terminal_prob'] = masked_mean(experience.terminal_probs, mask)
        if alive is not None:
            stats['mean_alive'] = masked_mean(alive, mask)

    return RLLossOutputs(policy_loss=total_policy_loss, value_loss=value_loss, stats=stats,
                         return_stats=new_return_stats)
