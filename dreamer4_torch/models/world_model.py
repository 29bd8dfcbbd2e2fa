"""DynamicsWorldModel (counterpart of `dreamer4_tpu/models/world_model.py`).

Per-frame token layout:
  [flow token][latent spatial tokens][registers][action][reward][agent tokens]
with the agent tokens as the trunk's special tokens. Ported: the heads,
`init_cache`, the reward and action tokens, `_predict`, the inference branch
of the forward (`latent_is_noised=True` with given signal levels) and the
training branch: diffusion-forcing signal levels, noising, the shortcut
self-consistency pass, the ramp weight, var-len masks, and the flow,
shortcut, reward MTP, terminal and discrete-action MTP losses. The options
listed in `_NOT_PORTED` come with later slices; setting one of them raises.

Every random draw of the training forward goes through the module-level
`draw`, so a test can replace it to replay the counterpart's draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from ..nn.action_embedder import ActionEmbedder
from ..nn.attention import LearnedQueriesAttentionPool
from ..nn.dense import Dense
from ..nn.init import embed_normal_, normal_
from ..nn.mlp import EnsembleHead, create_mlp
from ..nn.norms import RMSNorm
from ..ops.codecs import get_reward_encoder
from ..ops.mtp import create_multi_token_prediction_targets
from ..ops.utils import lens_to_mask, masked_mean, ramp_weight
from .transformer import AxialSpaceTimeTransformer, TransformerCache


class WorldModelLosses(NamedTuple):
    """The counterpart's loss record; the losses of options not ported yet
    are zeros."""
    flow: torch.Tensor
    shortcut: torch.Tensor
    rewards: torch.Tensor             # (multi_token_pred_len,)
    terminals: torch.Tensor
    discrete_actions: torch.Tensor    # (multi_token_pred_len,)
    continuous_actions: torch.Tensor
    state_pred: torch.Tensor
    agent_state_pred: torch.Tensor
    latent_ar: torch.Tensor
    latent_ar_sigreg: torch.Tensor
    lapo_action: torch.Tensor
    lapo_fdm: torch.Tensor
    lapo_raw_latent_fdm: torch.Tensor
    tem: torch.Tensor
    h_net: torch.Tensor


class Predictions(NamedTuple):
    flow: torch.Tensor
    proprio: torch.Tensor | None
    state: torch.Tensor | None


class Embeds(NamedTuple):
    agent: torch.Tensor            # (b, t, num_agents, d)
    state_pred: torch.Tensor | None
    actor: torch.Tensor | None
    critic: torch.Tensor | None


class DynamicsCache(NamedTuple):
    main: TransformerCache


# options of the counterpart that are off by default and not ported yet
_NOT_PORTED = (
    'num_tasks', 'num_latent_genes', 'actor_depth', 'critic_depth',
    'spatial_pre_encoder_depth', 'action_pre_encoder_depth', 'dim_proprio', 'dim_state',
    'dim_critic_state', 'num_continuous_actions', 'actor_critic_latent_input',
    'add_state_pred_head', 'agent_predicts_state', 'latent_ar', 'has_aug_conditioning',
    'ssl_lapo', 'ssl_tem', 'actor_spr', 'use_loss_normalization',
    'time_attention_use_pope', 'use_time_rnn', 'mot_temporal', 'h_net_layer',
)


def draw(kind: str, shape, *, generator: torch.Generator | None, device, low: int = 0,
         high: int = 0, prob: float = 0.0) -> torch.Tensor:
    """One random draw of the training forward.

    kind: 'step_sizes_log2', 'signal_levels' — integers in [low, high);
          'noise'       — standard normal noise of the latents;
          'reward_keep' — Bernoulli(prob) keep of the reward embedding.
    """
    if kind in ('step_sizes_log2', 'signal_levels'):
        return torch.randint(low, high, shape, generator=generator, device=device)
    if kind == 'noise':
        return torch.randn(shape, generator=generator, device=device)
    if kind == 'reward_keep':
        return torch.rand(shape, generator=generator, device=device) < prob
    raise ValueError(f'unknown draw {kind}')


class DynamicsWorldModel(nn.Module):
    def __init__(self, *, dim: int, dim_latent: int, num_latent_tokens: int,
                 max_steps: int = 64, num_register_tokens: int = 8,
                 num_spatial_tokens: int = 4, num_agents: int = 1, num_video_views: int = 1,
                 depth: int = 4, time_block_every: int = 4, attn_heads: int = 8,
                 attn_dim_head: int = 64, query_heads: int | None = None,
                 attn_softclamp_value: float = 50.0, pred_orig_latent: bool = True,
                 identity_latents_to_spatial: bool = False,
                 reward_encoder_type: str = 'hl_gauss',
                 reward_range: tuple[float, float] = (-20.0, 20.0), reward_num_bins: int = 255,
                 value_num_bins: int | None = None,
                 add_reward_embed_to_agent_token: bool = False,
                 add_reward_embed_dropout: float = 0.1, predict_terminals: bool = True,
                 num_discrete_actions: tuple[int, ...] = (), multi_token_pred_len: int = 8,
                 add_action_embed_to_spatial: bool = False, policy_head_mlp_depth: int = 3,
                 value_head_mlp_depth: int = 3, latent_flow_loss_weight: float = 1.0,
                 shortcut_loss_weight: float = 1.0, reward_loss_weight: float = 1.0,
                 terminal_loss_weight: float = 1.0, terminal_pos_weight: float = 1.0,
                 discrete_action_loss_weight: float = 1.0,
                 continuous_action_loss_weight: float = 1.0, gae_discount_factor: float = 0.997,
                 use_flash_attention: bool = False, flash_min_scores: int = 128 * 128,
                 use_fused_small: bool | None = None, use_attn_pool: bool = True, dtype=None,
                 device=None, **not_ported):
        # the constructor's arguments, for checkpoints (train/checkpoint.py)
        config = {k: v for k, v in locals().items()
                  if k not in ('self', '__class__', 'device', 'not_ported')}
        super().__init__()
        self.config = {**config, **not_ported}
        for name, value in not_ported.items():
            if name not in _NOT_PORTED:
                raise TypeError(f'unexpected argument {name}')
            if value:
                raise NotImplementedError(f'{name} is not ported to dreamer4_torch yet')
        if num_video_views != 1:
            raise NotImplementedError('multi-view world models are not ported yet')
        if max_steps & (max_steps - 1) != 0:
            raise ValueError('max_steps must be a power of 2')
        if dim % 2 != 0:
            raise ValueError('dim must be even')
        device = resolve_device(device)

        self.dim, self.dim_latent = dim, dim_latent
        self.num_latent_tokens = num_latent_tokens
        self.num_spatial_tokens = num_spatial_tokens
        self.num_register_tokens = num_register_tokens
        self.num_agents = num_agents
        self.num_video_views = num_video_views
        self.max_steps = max_steps
        self.pred_orig_latent = pred_orig_latent
        self.add_reward_embed_to_agent_token = add_reward_embed_to_agent_token
        self.add_reward_embed_dropout = add_reward_embed_dropout
        self.loss_weights = dict(flow=latent_flow_loss_weight, shortcut=shortcut_loss_weight,
                                 rewards=reward_loss_weight, terminals=terminal_loss_weight,
                                 discrete_actions=discrete_action_loss_weight,
                                 continuous_actions=continuous_action_loss_weight)
        self.terminal_pos_weight = terminal_pos_weight
        self.gae_discount_factor = gae_discount_factor
        self.predict_terminals = predict_terminals
        self.num_discrete_actions = tuple(num_discrete_actions)
        self.add_action_embed_to_spatial = add_action_embed_to_spatial
        self.multi_token_pred_len = multi_token_pred_len
        self.dtype = dtype
        self.reward_encoder = get_reward_encoder(reward_encoder_type, reward_range=reward_range,
                                                 num_bins=reward_num_bins)
        value_bins = value_num_bins if value_num_bins is not None else reward_num_bins
        self.value_encoder = get_reward_encoder(reward_encoder_type, reward_range=reward_range,
                                                num_bins=value_bins)

        same_len = num_spatial_tokens == num_latent_tokens
        if identity_latents_to_spatial:
            if dim != dim_latent or not same_len:
                raise ValueError('identity_latents_to_spatial needs dim == dim_latent and '
                                 'as many spatial as latent tokens')
            self.latents_to_spatial_tokens = None
        elif same_len:
            self.latents_to_spatial_tokens = Dense(dim_latent, dim, device=device)
        else:
            self.latents_to_spatial_tokens = LearnedQueriesAttentionPool(
                num_spatial_tokens, dim, dim_kv_input=dim_latent, heads=attn_heads,
                dim_head=attn_dim_head, device=device)

        self.latent_pred_norm = RMSNorm(dim, device=device)
        self.latent_pred_pool = None if same_len else LearnedQueriesAttentionPool(
            num_latent_tokens, dim, heads=attn_heads, dim_head=attn_dim_head, device=device)
        self.to_latent_pred = Dense(dim, dim_latent, bias=False, device=device)

        def param(shape, std):
            p = nn.Parameter(torch.empty(shape, device=device))
            normal_(p, std)
            return p

        self.register_tokens = param((num_register_tokens, dim), 1e-2)
        self.signal_levels_embed = nn.Embedding(max_steps, dim // 2, device=device)
        self.step_size_embed = nn.Embedding(self.num_step_sizes_log2 + 1, dim // 2,
                                            device=device)
        embed_normal_(self.signal_levels_embed.weight)
        embed_normal_(self.step_size_embed.weight)
        self.agent_learned_embed = param((num_agents, dim), 1.0)
        self.action_learned_embed = param((num_agents, dim), 1.0)
        self.reward_learned_embed = param((num_agents, dim), 1.0)

        self.policy_head = create_mlp(dim, dim * 4, policy_head_mlp_depth, dim * 4,
                                      device=device)
        self.action_embedder = ActionEmbedder(
            dim, num_discrete_actions=self.num_discrete_actions, can_unembed=True,
            unembed_dim=dim * 4, num_unembed_preds=multi_token_pred_len, device=device)
        if add_reward_embed_to_agent_token:
            self.reward_bin_embed = nn.Embedding(reward_num_bins, dim, device=device)
            embed_normal_(self.reward_bin_embed.weight)
        self.to_reward_pred = EnsembleHead(dim, multi_token_pred_len, reward_num_bins,
                                           device=device)
        if predict_terminals:
            self.to_state_terminal_pred = create_mlp(dim_latent, dim_latent * 4, 1, 1,
                                                     device=device)
        self.value_head = create_mlp(dim, dim * 4, value_head_mlp_depth, value_bins,
                                     device=device)

        self.transformer = AxialSpaceTimeTransformer(
            dim=dim, depth=depth, attn_heads=attn_heads, attn_dim_head=attn_dim_head,
            query_heads=query_heads, attn_softclamp_value=attn_softclamp_value,
            time_block_every=time_block_every, num_special_tokens=num_agents,
            final_norm=False, use_flash_attention=use_flash_attention,
            flash_min_scores=flash_min_scores, use_fused_small=use_fused_small,
            use_attn_pool=use_attn_pool, dtype=dtype, device=device)

    # ------------------------------------------------------------ properties

    @property
    def device(self) -> torch.device:
        return self.register_tokens.device

    @property
    def num_step_sizes_log2(self) -> int:
        return int(math.log2(self.max_steps))

    @property
    def prob_shortcut_train(self) -> float:
        return 1.0 - 1.0 / self.num_step_sizes_log2

    def get_times_from_signal_level(self, signal_levels):
        return signal_levels.float() / self.max_steps

    @property
    def latent_shape(self) -> tuple[int, int]:
        return (self.num_latent_tokens, self.dim_latent)

    @property
    def has_actions(self) -> bool:
        return len([n for n in self.num_discrete_actions if n > 0]) > 0

    @property
    def tokens_per_frame(self) -> int:
        return (1 + self.num_spatial_tokens * self.num_video_views + self.num_register_tokens
                + int(self.has_actions) + int(self.add_reward_embed_to_agent_token)
                + self.num_agents)

    def init_cache(self, batch: int, max_time: int, dtype=None) -> DynamicsCache:
        """KV caches default to the trunk's compute dtype."""
        if dtype is None:
            dtype = self.dtype if self.dtype is not None else torch.float32
        return DynamicsCache(main=self.transformer.init_cache(
            batch, self.tokens_per_frame, max_time, dtype=dtype, device=self.device))

    # ------------------------------------------------------- token builders

    def _reward_tokens(self, rewards, time: int, reward_token_mask=None, agent_index: int = 0,
                       is_training: bool = False, generator=None):
        """(b, t') rewards -> (b, t, 1, d) shifted reward tokens, or None.
        In training the reward embedding is dropped, for the whole batch at
        once, with probability `add_reward_embed_dropout`."""
        if not self.add_reward_embed_to_agent_token or rewards is None:
            return None
        two_hot = self.reward_encoder.encode(rewards)
        table = self.reward_bin_embed.weight
        embeds = torch.einsum('...l,ld->...d', two_hot.to(table.dtype), table)
        if not (time == 1 and embeds.shape[1] == 1):
            # shift right so each agent token sees the previous reward
            pop_last = 1 if embeds.shape[1] == time else 0
            embeds = nn.functional.pad(embeds[:, :embeds.shape[1] - pop_last], (0, 0, 1, 0))
            embeds = embeds[:, :time]
        if is_training and self.add_reward_embed_dropout > 0.0:
            keep = draw('reward_keep', (), generator=generator, device=embeds.device,
                        prob=1.0 - self.add_reward_embed_dropout)
            embeds = torch.where(keep, embeds, 0.0)
        if reward_token_mask is not None:
            embeds = embeds * reward_token_mask[..., None]
        tokens = embeds + self.reward_learned_embed[agent_index]
        return tokens[:, :, None, :]

    def _action_tokens(self, discrete_actions, time: int, shift: bool, is_sequential: bool,
                       action_token_mask=None, agent_index: int = 0):
        """-> (b, t, 1, d) action tokens or None; the token paired with state
        t is the previous action."""
        if not self.has_actions or discrete_actions is None:
            return None
        tokens = self.action_embedder(discrete_actions=discrete_actions)
        tokens = tokens + self.action_learned_embed[agent_index]
        action_len = tokens.shape[1]
        if (action_len == time and shift and not is_sequential) or action_len == time - 1:
            head = tokens[:, :-1] if action_len == time else tokens
            tokens = nn.functional.pad(head, (0, 0, 1, 0))
        if action_token_mask is not None:
            tokens = tokens * action_token_mask[..., None]
        return tokens[:, :, None, :]

    # ------------------------------------------------------------ prediction

    def _predict(self, noised_latents, signal_levels, step_sizes_log2, action_tokens,
                 reward_tokens, agent_tokens, cache: DynamicsCache | None = None,
                 max_time: int | None = None):
        b, t, v = noised_latents.shape[:3]
        dim = self.dim
        s_per_view = self.num_spatial_tokens

        if self.latents_to_spatial_tokens is None:
            space_tokens = noised_latents
        else:
            space_tokens = self.latents_to_spatial_tokens(noised_latents)   # (b, t, v, s, d)
        space_tokens = space_tokens.reshape(b, t, v * s_per_view, dim)
        if self.add_action_embed_to_spatial and action_tokens is not None:
            space_tokens = space_tokens + action_tokens

        signal_emb = self.signal_levels_embed(signal_levels.long())          # (b, t, d/2)
        step_emb = self.step_size_embed(step_sizes_log2.long())              # (b, d/2)
        step_emb = step_emb[:, None].expand(b, t, dim // 2)
        parts = [torch.cat([signal_emb, step_emb], dim=-1)[:, :, None, :], space_tokens,
                 self.register_tokens.expand(b, t, self.num_register_tokens, dim)]
        if self.has_actions:
            if action_tokens is None:
                action_tokens = torch.zeros((b, t, 1, dim), device=noised_latents.device)
            parts.append(action_tokens)
        if self.add_reward_embed_to_agent_token:
            if reward_tokens is None:
                reward_tokens = (self.reward_learned_embed[0] * 0.0).expand(b, t, 1, dim)
            parts.append(reward_tokens)
        parts.append(agent_tokens)
        dt = parts[0].dtype
        for p in parts[1:]:
            dt = torch.promote_types(dt, p.dtype)
        tokens = torch.cat([p.to(dt) for p in parts], dim=2)
        assert tokens.shape[2] == self.tokens_per_frame

        tokens, interm = self.transformer(
            tokens, cache=cache.main if cache is not None else None, max_time=max_time,
            return_intermediates=True, collect_normed_inputs=False)

        space_out = tokens[:, :, 1:1 + v * s_per_view]
        agent_out = tokens[:, :, -self.num_agents:]

        h = self.latent_pred_norm(space_out.reshape(b, t, v, s_per_view, dim))
        if self.latent_pred_pool is not None:
            h = self.latent_pred_pool(h)
        pred = self.to_latent_pred(h)                                        # (b, t, v, n, dl)

        new_cache = DynamicsCache(main=interm.cache) if interm.cache is not None else None
        return (Predictions(flow=pred, proprio=None, state=None),
                Embeds(agent=agent_out, state_pred=None, actor=agent_out, critic=agent_out),
                new_cache)

    # --------------------------------------------------------------- forward

    def forward(self, *, latents, signal_levels=None, step_sizes=None, step_sizes_log2=None,
                rewards=None, terminals=None, discrete_actions=None,
                shift_action_tokens: bool = True, lens=None, action_token_mask=None,
                reward_token_mask=None, latent_has_view_dim: bool = False, agent_index: int = 0,
                cache: DynamicsCache | None = None, max_time: int | None = None,
                latent_is_noised: bool = False, return_pred_only: bool = False,
                return_intermediates: bool = False, shortcut_train: bool | None = None,
                is_training: bool = True, generator: torch.Generator | None = None):
        """Without signal levels, the training forward: draws signal levels
        (and step sizes for a shortcut step, `shortcut_train`, which the
        trainer chooses), noises the latents and returns the total loss, or
        (total loss, WorldModelLosses, Embeds) with `return_intermediates`.
        With `latent_is_noised` (or `return_pred_only`), the prediction:
        Predictions, or (Predictions, (Embeds, new_cache)). Draws come from
        `generator` through `draw`."""
        device = self.device
        b, time = latents.shape[:2]
        if latents.ndim == 4 and not latent_has_view_dim:
            latents = latents[:, :, None]
        if latents.shape[2] != self.num_video_views or latents.shape[-2:] != self.latent_shape:
            raise ValueError(f'latents of shape {tuple(latents.shape)} do not match the model')

        if rewards is not None and rewards.shape[1] == time - 1:
            rewards = nn.functional.pad(rewards, (1, 0))
        if terminals is not None and terminals.ndim == 2 and terminals.shape[1] == time - 1:
            terminals = nn.functional.pad(terminals, (1, 0))
        if discrete_actions is not None and discrete_actions.ndim == 2:
            discrete_actions = discrete_actions[..., None]

        def conform(x):
            if x is None:
                return None
            x = torch.as_tensor(x, dtype=torch.long, device=device)
            return x.expand(b) if x.ndim == 0 else x

        signal_levels = conform(signal_levels)
        if signal_levels is not None and signal_levels.ndim == 1:
            signal_levels = signal_levels[:, None].expand(b, time)
        step_sizes_log2 = conform(step_sizes_log2)
        if step_sizes is not None:
            if step_sizes_log2 is not None:
                raise ValueError('pass step_sizes or step_sizes_log2, not both')
            step_sizes_log2 = torch.round(torch.log2(conform(step_sizes).float())).long()

        is_inference = signal_levels is not None
        return_pred_only = return_pred_only or latent_is_noised
        rnd = lambda kind, shape, **kw: draw(kind, shape, generator=generator, device=device, **kw)

        # training-time signal levels (diffusion forcing)
        if not is_inference:
            if shortcut_train is None:
                raise ValueError('the training forward needs shortcut_train (the trainer draws '
                                 'it with probability prob_shortcut_train)')
            if shortcut_train:
                step_sizes_log2 = rnd('step_sizes_log2', (b,), low=1,
                                      high=self.num_step_sizes_log2)
                num_steps = (2 ** step_sizes_log2)[:, None]
                signal_levels = rnd('signal_levels', (b, time), high=self.max_steps)
                signal_levels = signal_levels // num_steps * num_steps
            else:
                step_sizes_log2 = torch.zeros((b,), dtype=torch.long, device=device)
                signal_levels = rnd('signal_levels', (b, time), high=self.max_steps)
        times = self.get_times_from_signal_level(signal_levels)

        noise = None
        if latent_is_noised:
            noised_latents = latents
        else:
            noise = rnd('noise', latents.shape)
            noised_latents = noise + (latents - noise) * times[..., None, None, None]

        agent_tokens = self.agent_learned_embed[None, None].expand(
            b, time, self.num_agents, self.dim)
        is_sequential = cache is not None and time == 1
        reward_tokens = self._reward_tokens(rewards, time, reward_token_mask=reward_token_mask,
                                            agent_index=agent_index,
                                            is_training=is_training and not is_inference,
                                            generator=generator)
        action_tokens = self._action_tokens(discrete_actions, time, shift=shift_action_tokens,
                                            is_sequential=is_sequential,
                                            action_token_mask=action_token_mask,
                                            agent_index=agent_index)

        pred, embeds, new_cache = self._predict(noised_latents, signal_levels, step_sizes_log2,
                                                action_tokens, reward_tokens, agent_tokens,
                                                cache=cache, max_time=max_time)
        if return_pred_only:
            if not return_intermediates:
                return pred
            return pred, (embeds, new_cache)

        losses = self._losses(
            latents, noised_latents, noise, pred, embeds, times, signal_levels, step_sizes_log2,
            rewards=rewards, terminals=terminals, discrete_actions=discrete_actions,
            shift_action_tokens=shift_action_tokens, lens=lens, agent_index=agent_index,
            shortcut_train=bool(shortcut_train),
            frozen_tokens=(action_tokens, reward_tokens, agent_tokens))
        w = self.loss_weights
        total_loss = (losses.flow * w['flow'] + losses.shortcut * w['shortcut']
                      + (losses.rewards * w['rewards']).sum()
                      + losses.terminals * w['terminals']
                      + (losses.discrete_actions * w['discrete_actions']).sum())
        if not return_intermediates:
            return total_loss
        return total_loss, losses, embeds

    def _losses(self, latents, noised_latents, noise, pred, embeds, times, signal_levels,
                step_sizes_log2, *, rewards, terminals, discrete_actions, shift_action_tokens,
                lens, agent_index, shortcut_train, frozen_tokens) -> WorldModelLosses:
        b, time = latents.shape[:2]
        device = latents.device
        zero = torch.zeros((), device=device)
        mtp = self.multi_token_pred_len
        flat = lambda x: x.reshape(b, time, -1)

        # flow matching, x-space or v-space
        packed_pred, noised, data = flat(pred.flow), flat(noised_latents), flat(latents)
        pred_target = data if self.pred_orig_latent else data - flat(noise)
        flow_losses = (packed_pred - pred_target).square()

        # shortcut self-consistency: two half steps of the frozen model
        # (no grad: K1 runs without its LSE there) make the target of one
        # full step
        shortcut_losses = None
        if shortcut_train:
            action_tokens, reward_tokens, agent_tokens = frozen_tokens
            half_log2 = step_sizes_log2 - 1
            half_step = 2 ** half_log2
            first_times = times[..., None]

            def run_frozen(noised_flat, sig):
                lat = noised_flat.reshape(latents.shape)
                p, _, _ = self._predict(lat, sig, half_log2, action_tokens, reward_tokens,
                                        agent_tokens)
                return flat(p.flow)

            with torch.no_grad():
                first_pred = run_frozen(noised, signal_levels)
                first_flow = ((first_pred - noised) / (1.0 - first_times)
                              if self.pred_orig_latent else first_pred)
                denoised = noised + first_flow * (half_step[:, None, None].float() / self.max_steps)
                signal_plus_half = signal_levels + half_step[:, None]
                second_pred = run_frozen(denoised, signal_plus_half)
                if self.pred_orig_latent:
                    second_times = self.get_times_from_signal_level(signal_plus_half)[..., None]
                    second_flow = (second_pred - denoised) / (1.0 - second_times)
                else:
                    second_flow = second_pred
                shortcut_target = (first_flow + second_flow) / 2.0
            shortcut_pred, shortcut_weight = packed_pred, 1.0
            if self.pred_orig_latent:
                shortcut_pred = (shortcut_pred - noised) / (1.0 - first_times)
                shortcut_weight = (1.0 - first_times).square()
            shortcut_losses = (shortcut_pred - shortcut_target).square() * shortcut_weight

        # ramp loss weighting, eq (8)
        flow_losses = flow_losses * ramp_weight(times)[..., None]

        is_var_len = lens is not None
        loss_mask = lens_to_mask(lens, time) if is_var_len else None
        mask_without_last = loss_mask[:, :-1] if is_var_len else None
        mean = ((lambda t, m: masked_mean(t, m)) if is_var_len else (lambda t, m: t.mean()))
        flow_loss = mean(flow_losses, loss_mask[..., None] if is_var_len else None)
        shortcut_loss = (mean(shortcut_losses, loss_mask[..., None] if is_var_len else None)
                         if shortcut_train else zero)

        # rewards: CE over MTP targets from the shifted agent tokens
        reward_loss = torch.zeros((mtp,), device=device)
        if rewards is not None and time > 1:
            reward_logits = self.to_reward_pred(embeds.agent.mean(dim=2)[:, :-1])
            targets, rmask = create_multi_token_prediction_targets(
                self.reward_encoder.encode(rewards)[:, 1:], mtp)     # (b, t-1, mtp, bins)
            logp = torch.log_softmax(reward_logits, dim=-1).movedim(0, 2)
            ce = torch.where(rmask, -(targets * logp).sum(dim=-1), 0.0)
            if is_var_len:
                denom = mask_without_last[..., None] & rmask
                reward_loss = (torch.where(denom, ce, 0.0).sum(dim=(0, 1))
                               / denom.sum(dim=(0, 1)).clamp_min(1.0))
            else:
                reward_loss = ce.mean(dim=(0, 1))

        # terminals: BCE with DreamerV3 label smoothing
        terminal_loss = zero
        if terminals is not None and self.predict_terminals and time > 1:
            logits = self.to_state_terminal_pred(latents[:, 1:].mean(dim=(-3, -2)))[..., 0]
            if terminals.ndim == 1:
                last = ((lens - 2) if is_var_len
                        else torch.full((b,), time - 2, device=device)).clamp_min(0)
                seq = torch.arange(time - 1, device=device)
                terminals_seq = (seq[None, :] == last[:, None]) & terminals.bool()[:, None]
            else:
                terminals_seq = terminals[:, 1:]
            eps = 1.0 - self.gae_discount_factor
            terminals_seq = terminals_seq.float().clamp(eps, 1.0 - eps)
            bce = (logits.clamp_min(0) - logits * terminals_seq
                   + torch.log1p(torch.exp(-logits.abs())))
            if self.terminal_pos_weight != 1.0:
                # upweight the (smoothed) positive frames
                bce = bce * (1.0 + (self.terminal_pos_weight - 1.0) * terminals_seq)
            terminal_loss = masked_mean(bce, mask_without_last) if is_var_len else bce.mean()

        # actions: MTP log likelihood of the next actions under the policy head
        discrete_action_loss = torch.zeros((mtp,), device=device)
        w = self.loss_weights
        has_action_loss = w['discrete_actions'] + w['continuous_actions'] > 0
        if has_action_loss and time > 1 and discrete_actions is not None:
            da = discrete_actions
            if shift_action_tokens:
                da = nn.functional.pad(da, (0, 0, 1, 0))
            pred_len = da.shape[1]
            num_targets = pred_len - 1 if shift_action_tokens else pred_len
            policy_embed = self.policy_head(embeds.actor[:, :num_targets, agent_index])
            targets, amask = create_multi_token_prediction_targets(da, mtp)
            if shift_action_tokens:
                targets, amask = targets[:, 1:], amask[:, 1:]
            targets, amask = targets.movedim(2, 0), amask.movedim(2, 0)   # (mtp, b, t, ...)
            lp = self.action_embedder.log_probs(policy_embed, discrete_targets=targets)
            nld = torch.where(amask[..., None], -lp.discrete, 0.0)
            if is_var_len:
                action_mask = mask_without_last if pred_len == time - 1 else loss_mask
                m = action_mask[None, :, :num_targets, None] & amask[..., None]
                discrete_action_loss = (torch.where(m, nld, 0.0).sum(dim=(1, 2, 3))
                                        / m.sum(dim=(1, 2, 3)).clamp_min(1.0))
            else:
                discrete_action_loss = nld.mean(dim=(1, 2, 3))

        return WorldModelLosses(
            flow=flow_loss, shortcut=shortcut_loss, rewards=reward_loss,
            terminals=terminal_loss, discrete_actions=discrete_action_loss,
            continuous_actions=torch.zeros((mtp,), device=device), state_pred=zero,
            agent_state_pred=zero, latent_ar=zero, latent_ar_sigreg=zero, lapo_action=zero,
            lapo_fdm=zero, lapo_raw_latent_fdm=zero, tem=zero, h_net=zero)
