"""DynamicsWorldModel (counterpart of `dreamer4_tpu/models/world_model.py`).

Per-frame token layout:
  [flow token][latent spatial tokens][proprio][state-pred][registers]
  [action][reward][aug][agent tokens]
with the aug and agent tokens as the trunk's special tokens. Ported: the heads,
`init_cache`, the reward and action tokens (discrete and continuous
actions), the proprioception token and its read-out (`dim_proprio`), the
state-prediction token and its Beta head (`add_state_pred_head`),
`_predict`, the inference branch of the forward (`latent_is_noised=True`
with given signal levels) and the training branch: diffusion-forcing signal
levels, noising of the latents and the proprioception, the shortcut
self-consistency pass over both, the ramp weight, var-len masks, and the
flow, shortcut, reward MTP, terminal, state-prediction and discrete and
continuous action MTP losses; the state-vector inputs of a real
environment: `state_to_latents` (`dim_state`) and `critic_state_embedder`
(`dim_critic_state`); and the RL options of the imagination recipes: the
agent's state prediction (`agent_predicts_state`, its Beta NLL off the agent
token and the next action), the latent-input policy and value heads
(`actor_critic_latent_input`, `latent_actor_inputs`) and the actor's
self-predictive rollout (`actor_spr`, whose loss `models/rl.py` adds); and
the EMA normalization of the training losses (`use_loss_normalization`);
and the other options of the counterpart: task and latent-gene embeddings
added to the agent tokens (`num_tasks`, `num_latent_genes`), actor and
critic trunks over the main trunk's output (`actor_depth`, `critic_depth`),
spatial and action pre-encoders (`spatial_pre_encoder_depth`,
`action_pre_encoder_depth`), the augmentation token with its CFG dropout
(`has_aug_conditioning`), the latent autoregressive loss on the trunk's
hiddens (`latent_ar`), LAPO (`ssl_lapo`), TEM (`ssl_tem`) and the hiddens
self-flow reads (`return_layer_hiddens`); the trunk's subsystems: the GRU
time layer (`use_time_rnn`) and MoT (`mot_temporal`) on every trunk over
the tokens, the H-Net splice on the main trunk (`h_net_*`, its ratio loss
as `losses.h_net`, weighted by `h_net_loss_weight`); and multi-view video
(`num_video_views > 1`: a learned `view_emb` per view added to its spatial
tokens, per-view state heads and losses, the latent encoders' mean over
views). Every field of the counterpart is ported.

Every random draw of the training forward goes through the module-level
`draw` (the latent AR loss's sigreg through `ops.losses.draw`), so a test
can replace it to replay the counterpart's draws.
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
from ..nn.latent_ar import LatentAutoregressiveLoss
from ..nn.loss_normalizer import LossNormalizer
from ..nn.mlp import EnsembleHead, create_mlp
from ..nn.norms import RMSNorm
from ..nn.ssl import LAPO, TEM, ActorSPR
from ..ops import dists
from ..ops.codecs import get_reward_encoder
from ..ops.mtp import create_multi_token_prediction_targets
from ..ops.utils import frac_gradient, lens_to_mask, ramp_weight
from ..parallel.distributed import batch_mean, batch_sum, local_rows
from .transformer import AxialSpaceTimeTransformer, TransformerCache


class WorldModelLosses(NamedTuple):
    """The counterpart's loss record; the losses of options that are off
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
    """The KV caches of every trunk the model has (None for the others)."""
    main: TransformerCache
    actor: TransformerCache | None = None
    critic: TransformerCache | None = None
    spatial: TransformerCache | None = None
    action: TransformerCache | None = None


# the loss normalizers' names -> the WorldModelLosses field each normalizes
_NORMALIZED_FIELDS = dict(flow='flow', shortcut='shortcut', reward='rewards',
                          terminal='terminals', discrete_actions='discrete_actions',
                          continuous_actions='continuous_actions')


def draw(kind: str, shape, *, generator: torch.Generator | None, device, low: int = 0,
         high: int = 0, prob: float = 0.0) -> torch.Tensor:
    """One random draw of the training forward.

    kind: 'step_sizes_log2', 'signal_levels' — integers in [low, high);
          'noise'         — standard normal noise of the latents;
          'proprio_noise' — standard normal noise of the proprioception;
          'reward_keep'   — Bernoulli(prob) keep of the reward embedding;
          'aug_drop'      — Bernoulli(prob) CFG dropout of each row's aug id.
    """
    if kind in ('step_sizes_log2', 'signal_levels'):
        return torch.randint(low, high, shape, generator=generator, device=device)
    if kind in ('noise', 'proprio_noise'):
        return torch.randn(shape, generator=generator, device=device)
    if kind in ('reward_keep', 'aug_drop'):
        return torch.rand(shape, generator=generator, device=device) < prob
    raise ValueError(f'unknown draw {kind}')


class DynamicsWorldModel(nn.Module):
    def __init__(self, *, dim: int, dim_latent: int, num_latent_tokens: int,
                 max_steps: int = 64, num_register_tokens: int = 8,
                 num_spatial_tokens: int = 4, num_agents: int = 1, num_tasks: int = 0,
                 num_latent_genes: int = 0, num_video_views: int = 1,
                 depth: int = 4, actor_depth: int = 0, critic_depth: int = 0,
                 spatial_pre_encoder_depth: int = 0, action_pre_encoder_depth: int = 0,
                 time_block_every: int = 4, attn_heads: int = 8,
                 attn_dim_head: int = 64, query_heads: int | None = None,
                 attn_softclamp_value: float = 50.0, pred_orig_latent: bool = True,
                 identity_latents_to_spatial: bool = False,
                 reward_encoder_type: str = 'hl_gauss',
                 reward_range: tuple[float, float] = (-20.0, 20.0), reward_num_bins: int = 255,
                 value_num_bins: int | None = None,
                 add_reward_embed_to_agent_token: bool = False,
                 add_reward_embed_dropout: float = 0.1, predict_terminals: bool = True,
                 num_discrete_actions: tuple[int, ...] = (), num_continuous_actions: int = 0,
                 continuous_norm_stats: tuple[tuple[float, float], ...] | None = None,
                 continuous_dist_type: str = 'beta',
                 continuous_target_action_range: tuple[float, float] | None = None,
                 multi_token_pred_len: int = 8, dim_proprio: int | None = None,
                 add_state_pred_head: bool = False, state_pred_loss_weight: float = 0.1,
                 eps_latent_pred: float = 1e-6, state_entropy_bonus_weight: float = 0.0,
                 add_action_embed_to_spatial: bool = False,
                 actor_critic_latent_input: bool = False, agent_predicts_state: bool = False,
                 agent_predicts_state_frac_gradient: float = 0.0,
                 agent_state_pred_loss_weight: float = 0.1, actor_spr: bool = False,
                 actor_spr_num_rollouts: int = 1, policy_head_mlp_depth: int = 3,
                 value_head_mlp_depth: int = 3, latent_flow_loss_weight: float = 1.0,
                 shortcut_loss_weight: float = 1.0, reward_loss_weight: float = 1.0,
                 terminal_loss_weight: float = 1.0, terminal_pos_weight: float = 1.0,
                 discrete_action_loss_weight: float = 1.0,
                 continuous_action_loss_weight: float = 1.0, gae_discount_factor: float = 0.997,
                 gae_lambda: float = 0.95, ppo_eps_clip: float = 0.2,
                 pmpo_pos_to_neg_weight: float = 0.5, pmpo_reverse_kl: bool = True,
                 pmpo_kl_div_loss_weight: float = 0.3, use_delight_gating: bool = True,
                 delight_temperature: float = 1.0, value_clip: float = 0.4,
                 clip_values: bool = False, policy_entropy_weight: float = 0.01,
                 agent_policy_gradient_frac: float = 1.0, agent_value_gradient_frac: float = 1.0,
                 keep_reward_ema_stats: bool = False, reward_ema_decay: float = 0.998,
                 reward_quantile_filter: tuple[float, float] = (0.05, 0.95),
                 normalize_advantages: bool | None = None, use_loss_normalization: bool = False,
                 use_flash_attention: bool = False, flash_min_scores: int = 128 * 128,
                 use_fused_small: bool | None = None, use_attn_pool: bool = True,
                 time_attention_use_pope: bool = False,
                 dim_state: int | None = None, dim_critic_state: int | None = None,
                 latent_ar: bool = False, latent_ar_layer: int | tuple[int, int] | None = None,
                 latent_ar_action_conditioned: bool = False, latent_ar_num_slices: int = 256,
                 latent_ar_loss_weight: float = 0.0, latent_ar_sigreg_loss_weight: float = 0.05,
                 has_aug_conditioning: bool = False, aug_cfg_dropout_prob: float = 0.1,
                 ssl_lapo: bool = False, lapo_pred_actions: bool = True, lapo_use_fdm: bool = True,
                 ssl_tem: bool = False, tem_first_state_as_init_hidden: bool = True,
                 tem_learn_relative_actions: bool = False, lapo_action_loss_weight: float = 1.0,
                 lapo_fdm_loss_weight: float = 1.0, lapo_raw_latent_fdm_loss_weight: float = 1.0,
                 tem_loss_weight: float = 1.0, use_time_rnn: bool = False,
                 mot_temporal: bool = False, h_net_layer: int | None = None, h_net_depth: int = 2,
                 h_net_compression_ratio: int = 4, h_net_dynamic: bool = False,
                 h_net_loss_weight: float = 1.0, dtype=None, device=None):
        # the constructor's arguments, for checkpoints (train/checkpoint.py)
        config = {k: v for k, v in locals().items()
                  if k not in ('self', '__class__', 'device')}
        super().__init__()
        self.config = config
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
                                 continuous_actions=continuous_action_loss_weight,
                                 state_pred=state_pred_loss_weight,
                                 agent_state_pred=agent_state_pred_loss_weight,
                                 latent_ar=latent_ar_loss_weight,
                                 latent_ar_sigreg=latent_ar_sigreg_loss_weight,
                                 lapo_action=lapo_action_loss_weight,
                                 lapo_fdm=lapo_fdm_loss_weight,
                                 lapo_raw_latent_fdm=lapo_raw_latent_fdm_loss_weight,
                                 tem=tem_loss_weight, h_net=h_net_loss_weight)
        self.terminal_pos_weight = terminal_pos_weight
        self.gae_discount_factor = gae_discount_factor
        # RL hyperparameters, read by models/rl.py
        self.gae_lambda = gae_lambda
        self.ppo_eps_clip = ppo_eps_clip
        self.pmpo_pos_to_neg_weight = pmpo_pos_to_neg_weight
        self.pmpo_reverse_kl = pmpo_reverse_kl
        self.pmpo_kl_div_loss_weight = pmpo_kl_div_loss_weight
        self.use_delight_gating = use_delight_gating
        self.delight_temperature = delight_temperature
        self.value_clip = value_clip
        self.clip_values = clip_values
        self.policy_entropy_weight = policy_entropy_weight
        self.agent_policy_gradient_frac = agent_policy_gradient_frac
        self.agent_value_gradient_frac = agent_value_gradient_frac
        self.keep_reward_ema_stats = keep_reward_ema_stats
        self.reward_ema_decay = reward_ema_decay
        self.reward_quantile_filter = tuple(reward_quantile_filter)
        self.normalize_advantages = normalize_advantages
        self.predict_terminals = predict_terminals
        self.num_discrete_actions = tuple(num_discrete_actions)
        self.num_continuous_actions = num_continuous_actions
        self.dim_proprio = dim_proprio
        self.add_state_pred_head = add_state_pred_head
        self.eps_latent_pred = eps_latent_pred
        self.state_entropy_bonus_weight = state_entropy_bonus_weight
        self.add_action_embed_to_spatial = add_action_embed_to_spatial
        self.actor_critic_latent_input = actor_critic_latent_input
        self.agent_predicts_state = agent_predicts_state
        self.agent_predicts_state_frac_gradient = agent_predicts_state_frac_gradient
        self.actor_spr = actor_spr
        self.multi_token_pred_len = multi_token_pred_len
        self.dim_state, self.dim_critic_state = dim_state, dim_critic_state
        self.num_tasks, self.num_latent_genes = num_tasks, num_latent_genes
        self.actor_depth, self.critic_depth = actor_depth, critic_depth
        self.spatial_pre_encoder_depth = spatial_pre_encoder_depth
        self.action_pre_encoder_depth = action_pre_encoder_depth
        self.has_aug_conditioning = has_aug_conditioning
        self.aug_cfg_dropout_prob = aug_cfg_dropout_prob
        self.latent_ar = latent_ar
        self.latent_ar_layer = (tuple(latent_ar_layer) if isinstance(latent_ar_layer, list)
                                else latent_ar_layer)
        self.latent_ar_action_conditioned = latent_ar_action_conditioned
        self.ssl_lapo, self.ssl_tem = ssl_lapo, ssl_tem
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
        # added to the agent tokens of each row's task and latent gene
        if num_tasks > 0:
            self.task_embed = nn.Embedding(num_tasks, dim, device=device)
            embed_normal_(self.task_embed.weight)
        if num_latent_genes > 0:
            self.latent_genes = param((num_latent_genes, dim), 1.0)

        self.policy_head = create_mlp(dim, dim * 4, policy_head_mlp_depth, dim * 4,
                                      device=device)
        self.action_embedder = ActionEmbedder(
            dim, num_discrete_actions=self.num_discrete_actions,
            num_continuous_actions=num_continuous_actions,
            continuous_norm_stats=continuous_norm_stats,
            continuous_dist_type=continuous_dist_type,
            continuous_target_action_range=continuous_target_action_range, can_unembed=True,
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

        if self.has_proprio:
            self.to_proprio_token = Dense(dim_proprio, dim, device=device)
            self.proprio_pred_norm = RMSNorm(dim, device=device)
            self.to_proprio_pred = Dense(dim, dim_proprio, device=device)
        if self.should_pred_state:
            self.state_pred_token = param((dim,), 1e-2)
            self.state_pred_norm = RMSNorm(dim, device=device)
            # Beta params per latent entry: (n, d_latent, 2) flattened
            self.to_state_pred = Dense(dim, num_video_views * num_latent_tokens * dim_latent * 2,
                                       device=device)

        # the main trunk, and the actor and critic trunks over its output,
        # all with the same settings; the aug token is one more special token
        trunk_kwargs = dict(
            dim=dim, attn_heads=attn_heads, attn_dim_head=attn_dim_head,
            query_heads=query_heads, attn_softclamp_value=attn_softclamp_value,
            time_block_every=time_block_every,
            num_special_tokens=num_agents + int(has_aug_conditioning),
            final_norm=False, use_flash_attention=use_flash_attention,
            flash_min_scores=flash_min_scores, use_fused_small=use_fused_small,
            time_attention_use_pope=time_attention_use_pope, use_attn_pool=use_attn_pool,
            rnn_time=use_time_rnn, mot_temporal=mot_temporal, dtype=dtype, device=device)
        # the H-Net splices into the main trunk only
        self.transformer = AxialSpaceTimeTransformer(
            depth=depth, h_net_layer=h_net_layer, h_net_depth=h_net_depth,
            h_net_compression_ratio=h_net_compression_ratio, h_net_dynamic=h_net_dynamic,
            **trunk_kwargs)
        if actor_depth > 0:
            self.actor_transformer = AxialSpaceTimeTransformer(depth=actor_depth, **trunk_kwargs)
        if critic_depth > 0:
            self.critic_transformer = AxialSpaceTimeTransformer(depth=critic_depth,
                                                                **trunk_kwargs)
        # the pre-encoders: no special tokens, no final norm and, as the
        # counterpart builds them, no flash attention; the action
        # pre-encoder attends over time in every layer
        pre_kwargs = dict(dim=dim, attn_heads=attn_heads, attn_dim_head=attn_dim_head,
                          query_heads=query_heads, attn_softclamp_value=attn_softclamp_value,
                          num_special_tokens=0, final_norm=False, dtype=dtype, device=device)
        if spatial_pre_encoder_depth > 0:
            self.spatial_pre_encoder = AxialSpaceTimeTransformer(
                depth=spatial_pre_encoder_depth, time_block_every=time_block_every,
                **pre_kwargs)
        if action_pre_encoder_depth > 0:
            if not self.has_actions:
                raise ValueError('action_pre_encoder_depth needs actions')
            self.action_pre_encoder = AxialSpaceTimeTransformer(
                depth=action_pre_encoder_depth, time_block_every=1, **pre_kwargs)
        if has_aug_conditioning:
            self.aug_cond_embedding = nn.Embedding(3, dim, device=device)
            embed_normal_(self.aug_cond_embedding.weight)
        if num_video_views > 1:
            self.view_emb = param((num_video_views, dim), 1e-2)

        if latent_ar:
            if latent_ar_layer is None:
                raise ValueError('latent_ar needs latent_ar_layer')
            self.latent_ar_module = LatentAutoregressiveLoss(
                dim, dim_in=dim * 2 if latent_ar_action_conditioned else dim,
                sigreg_num_slices=latent_ar_num_slices,
                conditioned=latent_ar_action_conditioned, device=device)
        if ssl_lapo:
            if spatial_pre_encoder_depth == 0:
                raise ValueError('LAPO requires the spatial pre-encoder')
            self.ssl_lapo_module = LAPO(
                dim, dim, num_discrete_actions=self.num_discrete_actions,
                num_continuous_actions=num_continuous_actions, dim_raw_latent=dim_latent,
                num_raw_latent_tokens=num_latent_tokens, pred_actions=lapo_pred_actions,
                use_fdm=lapo_use_fdm, device=device)
        if ssl_tem:
            if action_pre_encoder_depth == 0:
                raise ValueError('TEM requires the action pre-encoder')
            self.ssl_tem_module = TEM(
                dim, dim_latent, num_latent_tokens,
                first_state_as_init_hidden=tem_first_state_as_init_hidden,
                learn_relative_actions=tem_learn_relative_actions, device=device)

        # state-vector environments: the state as the frame's latents, and
        # the privileged critic state added to the value head's input
        if dim_state is not None:
            self.state_to_latents_proj = Dense(dim_state, num_latent_tokens * dim_latent,
                                               bias=False, device=device)
        if dim_critic_state is not None:
            self.critic_state_embedder = Dense(dim_critic_state, dim, device=device)

        # RL-owned encoders of the flattened latents, the policy and value
        # heads' inputs in place of the agent token
        if actor_critic_latent_input:
            flat = num_latent_tokens * dim_latent
            self.actor_latent_encoder = create_mlp(flat, dim, 2, dim, device=device)
            self.critic_latent_encoder = create_mlp(flat, dim, 2, dim, device=device)
        # Beta params of the next frame's latents from the agent token (and
        # the next action's token)
        if agent_predicts_state:
            dim_in = dim * 2 if self.has_actions else dim
            self.agent_state_pred_net = create_mlp(
                dim_in, dim_in, 2, num_video_views * num_latent_tokens * dim_latent * 2,
                device=device)
        if actor_spr:
            self.actor_spr_module = ActorSPR(dim * 4, num_rollouts=actor_spr_num_rollouts,
                                             dim_action_embed=dim, device=device)
        # the EMA loss normalizers, named as the counterpart's (their buffers
        # are its 'state' collection), each over the entries of its loss
        self.use_loss_normalization = use_loss_normalization
        if use_loss_normalization:
            for name, n in self.normalized_losses.items():
                setattr(self, f'{name}_loss_normalizer', LossNormalizer(n, device=device))

    # the counterpart's name of a submodule, where the port's differs (a
    # method of that name here), for convert.py
    flax_names = {'state_to_latents': 'state_to_latents_proj'}

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
        return (len([n for n in self.num_discrete_actions if n > 0]) > 0
                or self.num_continuous_actions > 0)

    @property
    def has_proprio(self) -> bool:
        return self.dim_proprio is not None

    @property
    def should_pred_state(self) -> bool:
        return self.add_state_pred_head and self.loss_weights['state_pred'] > 0.0

    @property
    def add_state_entropy_bonus(self) -> bool:
        return self.should_pred_state and self.state_entropy_bonus_weight > 0.0

    @property
    def normalized_losses(self) -> dict[str, int]:
        """The counterpart's loss normalizers: name -> the entries of its
        loss."""
        mtp = self.multi_token_pred_len
        out = dict(flow=1, shortcut=1, reward=mtp)
        if self.predict_terminals:
            out['terminal'] = 1
        return {**out, 'discrete_actions': mtp, 'continuous_actions': mtp}

    @property
    def tokens_per_frame(self) -> int:
        return (1 + self.num_spatial_tokens * self.num_video_views + int(self.has_proprio)
                + int(self.should_pred_state) + self.num_register_tokens
                + int(self.has_actions) + int(self.add_reward_embed_to_agent_token)
                + int(self.has_aug_conditioning) + self.num_agents)

    def state_to_latents(self, state):
        """(..., dim_state) -> (..., n, d_latent), the latents of a
        state-vector observation."""
        out = self.state_to_latents_proj(state)
        return out.reshape(*state.shape[:-1], self.num_latent_tokens, self.dim_latent)

    def latent_actor_inputs(self, latents):
        """(..., n, d_latent) -> (actor_in, critic_in), each (..., dim): the
        policy and value heads' inputs with `actor_critic_latent_input`,
        read from the latents (data that concurrent world-model training
        cannot shift) through the two latent encoders. A multi-view model
        takes (..., v, n, d_latent) and means the encoders' outputs over
        the views."""
        flat = latents.reshape(*latents.shape[:-2], -1)
        a, c = self.actor_latent_encoder(flat), self.critic_latent_encoder(flat)
        if self.num_video_views > 1:
            a, c = a.mean(dim=-2), c.mean(dim=-2)
        return a, c

    def init_cache(self, batch: int, max_time: int, dtype=None) -> DynamicsCache:
        """KV caches default to the trunk's compute dtype."""
        if dtype is None:
            dtype = self.dtype if self.dtype is not None else torch.float32

        def make(trunk, space_len):
            return trunk.init_cache(batch, space_len, max_time, dtype=dtype, device=self.device)

        s = self.tokens_per_frame
        return DynamicsCache(
            main=make(self.transformer, s),
            actor=make(self.actor_transformer, s) if self.actor_depth > 0 else None,
            critic=make(self.critic_transformer, s) if self.critic_depth > 0 else None,
            spatial=(make(self.spatial_pre_encoder,
                          self.num_spatial_tokens * self.num_video_views)
                     if self.spatial_pre_encoder_depth > 0 else None),
            action=(make(self.action_pre_encoder, 1)
                    if self.action_pre_encoder_depth > 0 else None))

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

    def _action_tokens(self, discrete_actions, continuous_actions, time: int, shift: bool,
                       is_sequential: bool, action_token_mask=None, agent_index: int = 0):
        """-> ((b, t, 1, d) action tokens, (b, t', d) next-action tokens), or
        (None, None); the token paired with state t is the previous action,
        the next-action token of state t the action taken from it."""
        if not self.has_actions or (discrete_actions is None and continuous_actions is None):
            return None, None
        tokens = self.action_embedder(discrete_actions=discrete_actions,
                                      continuous_actions=continuous_actions)
        tokens = next_tokens = tokens + self.action_learned_embed[agent_index]
        action_len = tokens.shape[1]
        if (action_len == time and shift and not is_sequential) or action_len == time - 1:
            head = tokens[:, :-1] if action_len == time else tokens
            tokens = nn.functional.pad(head, (0, 0, 1, 0))
        if action_token_mask is not None:
            tokens = tokens * action_token_mask[..., None]
        return tokens[:, :, None, :], next_tokens

    # ------------------------------------------------------------ prediction

    def _predict(self, noised_latents, noised_proprio, signal_levels, step_sizes_log2,
                 action_tokens, reward_tokens, aug_token, agent_tokens,
                 cache: DynamicsCache | None = None, max_time: int | None = None):
        """-> (Predictions, Embeds, aux, new cache); aux holds the main
        trunk's `layer_hiddens` and its spatial outputs `space_out`."""
        b, t, v = noised_latents.shape[:3]
        dim = self.dim
        s_per_view = self.num_spatial_tokens

        if self.latents_to_spatial_tokens is None:
            space_tokens = noised_latents
        else:
            space_tokens = self.latents_to_spatial_tokens(noised_latents)   # (b, t, v, s, d)
        if self.num_video_views > 1:
            space_tokens = space_tokens + self.view_emb[:, None, :]
        space_tokens = space_tokens.reshape(b, t, v * s_per_view, dim)
        if self.add_action_embed_to_spatial and action_tokens is not None:
            space_tokens = space_tokens + action_tokens

        def sub_trunk(trunk, x, sub_cache):
            return trunk(x, cache=sub_cache, max_time=max_time, return_intermediates=True,
                         collect_normed_inputs=False)

        spatial_interm = action_interm = None
        if self.spatial_pre_encoder_depth > 0:
            space_tokens, spatial_interm = sub_trunk(
                self.spatial_pre_encoder, space_tokens,
                cache.spatial if cache is not None else None)
        if self.action_pre_encoder_depth > 0 and action_tokens is not None:
            action_tokens, action_interm = sub_trunk(
                self.action_pre_encoder, action_tokens,
                cache.action if cache is not None else None)

        signal_emb = self.signal_levels_embed(signal_levels.long())          # (b, t, d/2)
        step_emb = self.step_size_embed(step_sizes_log2.long())              # (b, d/2)
        step_emb = step_emb[:, None].expand(b, t, dim // 2)
        parts = [torch.cat([signal_emb, step_emb], dim=-1)[:, :, None, :], space_tokens]
        if self.has_proprio:
            if noised_proprio is None:
                raise ValueError('a model with dim_proprio needs proprio')
            parts.append(self.to_proprio_token(noised_proprio)[:, :, None, :])
        if self.should_pred_state:
            parts.append(self.state_pred_token.expand(b, t, 1, dim))
        parts.append(self.register_tokens.expand(b, t, self.num_register_tokens, dim))
        if self.has_actions:
            if action_tokens is None:
                action_tokens = torch.zeros((b, t, 1, dim), device=noised_latents.device)
            parts.append(action_tokens)
        if self.add_reward_embed_to_agent_token:
            if reward_tokens is None:
                reward_tokens = (self.reward_learned_embed[0] * 0.0).expand(b, t, 1, dim)
            parts.append(reward_tokens)
        if self.has_aug_conditioning:
            if aug_token is None:
                aug_token = self.aug_cond_embedding.weight[0].expand(b, t, 1, dim)
            parts.append(aug_token)
        parts.append(agent_tokens)
        dt = parts[0].dtype
        for p in parts[1:]:
            dt = torch.promote_types(dt, p.dtype)
        tokens = torch.cat([p.to(dt) for p in parts], dim=2)
        assert tokens.shape[2] == self.tokens_per_frame

        tokens, interm = sub_trunk(self.transformer, tokens,
                                   cache.main if cache is not None else None)
        # the actor and critic trunks read the main trunk's output
        actor_interm = critic_interm = None
        agent_out = tokens[:, :, -self.num_agents:]
        actor_out = critic_out = agent_out
        if self.actor_depth > 0:
            actor_tokens, actor_interm = sub_trunk(self.actor_transformer, tokens,
                                                   cache.actor if cache is not None else None)
            actor_out = actor_tokens[:, :, -self.num_agents:]
        if self.critic_depth > 0:
            critic_tokens, critic_interm = sub_trunk(self.critic_transformer, tokens,
                                                     cache.critic if cache is not None else None)
            critic_out = critic_tokens[:, :, -self.num_agents:]

        n_space = v * s_per_view
        space_out = tokens[:, :, 1:1 + n_space]

        h = self.latent_pred_norm(space_out.reshape(b, t, v, s_per_view, dim))
        if self.latent_pred_pool is not None:
            h = self.latent_pred_pool(h)
        pred = self.to_latent_pred(h)                                        # (b, t, v, n, dl)

        # the proprio and state-prediction tokens follow the spatial ones
        idx = 1 + n_space
        pred_proprio = pred_state = state_pred_out = None
        if self.has_proprio:
            pred_proprio = self.to_proprio_pred(self.proprio_pred_norm(tokens[:, :, idx]))
            idx += 1
        if self.should_pred_state:
            state_pred_out = tokens[:, :, idx:idx + 1]
            s = self.to_state_pred(self.state_pred_norm(state_pred_out[:, :, 0]))
            pred_state = s.reshape(b, t, v, self.num_latent_tokens, self.dim_latent, 2)
            if v == 1:
                pred_state = pred_state[:, :, 0]    # single-view callers keep (b, t, n, d, 2)

        new_cache = None
        if interm.cache is not None:
            cache_of = lambda out: out.cache if out is not None else None
            new_cache = DynamicsCache(main=interm.cache, actor=cache_of(actor_interm),
                                      critic=cache_of(critic_interm),
                                      spatial=cache_of(spatial_interm),
                                      action=cache_of(action_interm))
        aux = dict(layer_hiddens=interm.layer_hiddens, space_out=space_out,
                   h_net_loss=interm.h_net_loss)
        return (Predictions(flow=pred, proprio=pred_proprio, state=pred_state),
                Embeds(agent=agent_out, state_pred=state_pred_out, actor=actor_out,
                       critic=critic_out),
                aux, new_cache)

    # --------------------------------------------------------------- forward

    def forward(self, *, latents, signal_levels=None, step_sizes=None, step_sizes_log2=None,
                rewards=None, terminals=None, discrete_actions=None, continuous_actions=None,
                shift_action_tokens: bool = True, proprio=None, tasks=None, latent_gene_ids=None,
                lens=None, action_token_mask=None, reward_token_mask=None, aug_id=None,
                cfg_dropout_aug: bool | None = None, latent_has_view_dim: bool = False,
                agent_index: int = 0, cache: DynamicsCache | None = None,
                max_time: int | None = None, latent_is_noised: bool = False,
                return_pred_only: bool = False, return_intermediates: bool = False,
                return_layer_hiddens: bool = False, shortcut_train: bool | None = None,
                is_training: bool = True, update_loss_ema: bool = True,
                generator: torch.Generator | None = None):
        """Without signal levels, the training forward: draws signal levels
        (and step sizes for a shortcut step, `shortcut_train`, which the
        trainer chooses), noises the latents and returns the total loss, or
        (total loss, WorldModelLosses, Embeds) with `return_intermediates`;
        under `use_loss_normalization` the losses of the given inputs are
        divided by their EMA's RMS, which moves with `update_loss_ema`.
        With `latent_is_noised` (or `return_pred_only`), the prediction:
        Predictions, or (Predictions, (Embeds, new_cache)). Draws come from
        `generator` through `draw`.

        `tasks` and `latent_gene_ids` (b,) ints add their embeddings to the
        agent tokens. `aug_id` (an int, a bool meaning 2 for True, or (b,)
        of either) picks the aug token; in training each row's id drops to
        0 with probability `aug_cfg_dropout_prob` (`cfg_dropout_aug`,
        default: in training). `return_layer_hiddens` appends the main
        trunk's hiddens to the training forward's output."""
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
        if continuous_actions is not None and continuous_actions.ndim == 2:
            continuous_actions = continuous_actions[..., None]

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
        # a draw of shape (b, ...) is made at the global batch under
        # data parallelism, and this rank's rows are taken
        rnd = lambda kind, shape, **kw: local_rows(
            lambda s: draw(kind, s, generator=generator, device=device, **kw), shape)

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

        noise = proprio_noise = None
        if latent_is_noised:
            noised_latents, noised_proprio = latents, proprio
        else:
            noise = rnd('noise', latents.shape)
            noised_latents = noise + (latents - noise) * times[..., None, None, None]
            noised_proprio = None
            if self.has_proprio:
                if proprio is None:
                    raise ValueError('a model with dim_proprio needs proprio')
                proprio_noise = rnd('proprio_noise', proprio.shape)
                noised_proprio = proprio_noise + (proprio - proprio_noise) * times[..., None]

        agent_tokens = self.agent_learned_embed[None].expand(b, self.num_agents, self.dim)
        if tasks is not None:
            if self.num_tasks == 0:
                raise ValueError('tasks need a model with num_tasks > 0')
            agent_tokens = agent_tokens + self.task_embed(torch.as_tensor(
                tasks, device=device).long())[:, None, :]
        if latent_gene_ids is not None:
            if self.num_latent_genes == 0:
                raise ValueError('latent_gene_ids need a model with num_latent_genes > 0')
            ids = torch.as_tensor(latent_gene_ids, device=device).long()
            agent_tokens = agent_tokens + self.latent_genes[ids][:, None, :]
        agent_tokens = agent_tokens[:, None].expand(b, time, self.num_agents, self.dim)
        is_sequential = cache is not None and time == 1
        reward_tokens = self._reward_tokens(rewards, time, reward_token_mask=reward_token_mask,
                                            agent_index=agent_index,
                                            is_training=is_training and not is_inference,
                                            generator=generator)
        action_tokens, next_action_tokens = self._action_tokens(
            discrete_actions, continuous_actions, time,
                                            shift=shift_action_tokens,
                                            is_sequential=is_sequential,
                                            action_token_mask=action_token_mask,
                                            agent_index=agent_index)

        aug_token = None
        if self.has_aug_conditioning:
            if cfg_dropout_aug is None:
                cfg_dropout_aug = is_training and not is_inference
            aug_ids = torch.as_tensor(0 if aug_id is None else aug_id, device=device)
            # a bool id means 2 for True and 1 for False
            aug_ids = aug_ids.long() + 1 if aug_ids.dtype == torch.bool else aug_ids.long()
            aug_ids = aug_ids.expand(b)
            if cfg_dropout_aug and self.aug_cfg_dropout_prob > 0.0:
                drop = rnd('aug_drop', (b,), prob=self.aug_cfg_dropout_prob)
                aug_ids = torch.where(drop, 0, aug_ids)
            aug_token = self.aug_cond_embedding(aug_ids)[:, None, None, :].expand(
                b, time, 1, self.dim)

        pred, embeds, aux, new_cache = self._predict(
            noised_latents, noised_proprio, signal_levels, step_sizes_log2, action_tokens,
            reward_tokens, aug_token, agent_tokens, cache=cache, max_time=max_time)
        if return_pred_only:
            if not return_intermediates:
                return pred
            return pred, (embeds, new_cache)

        losses = self._losses(
            latents, noised_latents, noise, pred, embeds, times, signal_levels, step_sizes_log2,
            proprio=(proprio, noised_proprio, proprio_noise), rewards=rewards,
            terminals=terminals, discrete_actions=discrete_actions,
            continuous_actions=continuous_actions, shift_action_tokens=shift_action_tokens,
            lens=lens, agent_index=agent_index, shortcut_train=bool(shortcut_train),
            frozen_tokens=(action_tokens, reward_tokens, aug_token, agent_tokens),
            next_action_tokens=next_action_tokens, aux=aux, generator=generator)
        if self.use_loss_normalization:
            given = dict(flow=True, shortcut=True, reward=rewards is not None,
                         terminal=terminals is not None,
                         discrete_actions=discrete_actions is not None,
                         continuous_actions=continuous_actions is not None)
            losses = losses._replace(**{
                _NORMALIZED_FIELDS[name]: getattr(self, f'{name}_loss_normalizer')(
                    getattr(losses, _NORMALIZED_FIELDS[name]), update_ema=update_loss_ema)
                for name in self.normalized_losses if given[name]})
        w = self.loss_weights
        total_loss = (losses.flow * w['flow'] + losses.shortcut * w['shortcut']
                      + (losses.rewards * w['rewards']).sum()
                      + losses.terminals * w['terminals']
                      + (losses.discrete_actions * w['discrete_actions']).sum()
                      + (losses.continuous_actions * w['continuous_actions']).sum()
                      + losses.state_pred * w['state_pred']
                      + losses.agent_state_pred * w['agent_state_pred']
                      + losses.latent_ar * w['latent_ar']
                      + losses.latent_ar_sigreg * w['latent_ar_sigreg']
                      + losses.lapo_action * w['lapo_action']
                      + losses.lapo_fdm * w['lapo_fdm']
                      + losses.lapo_raw_latent_fdm * w['lapo_raw_latent_fdm']
                      + losses.tem * w['tem']
                      + losses.h_net * w['h_net'])
        if not return_intermediates:
            return total_loss
        if return_layer_hiddens:
            return total_loss, losses, embeds, aux['layer_hiddens']
        return total_loss, losses, embeds

    def _losses(self, latents, noised_latents, noise, pred, embeds, times, signal_levels,
                step_sizes_log2, *, proprio, rewards, terminals, discrete_actions,
                continuous_actions, shift_action_tokens, lens, agent_index, shortcut_train,
                frozen_tokens, next_action_tokens, aux, generator) -> WorldModelLosses:
        b, time = latents.shape[:2]
        device = latents.device
        zero = torch.zeros((), device=device)
        mtp = self.multi_token_pred_len
        proprio, noised_proprio, proprio_noise = proprio

        def pack(lat, prop):
            """Latents and proprio as one vector per frame, for the flow math."""
            flat = lat.reshape(b, time, -1)
            return torch.cat([flat, prop.to(flat.dtype)], dim=-1) if self.has_proprio else flat

        # flow matching, x-space or v-space
        packed_pred = pack(pred.flow, pred.proprio)
        noised, data = pack(noised_latents, noised_proprio), pack(latents, proprio)
        pred_target = data if self.pred_orig_latent else data - pack(noise, proprio_noise)
        flow_losses = (packed_pred - pred_target).square()

        # shortcut self-consistency: two half steps of the frozen model
        # (no grad: K1 runs without its LSE there) make the target of one
        # full step
        shortcut_losses = None
        if shortcut_train:
            action_tokens, reward_tokens, aug_token, agent_tokens = frozen_tokens
            half_log2 = step_sizes_log2 - 1
            half_step = 2 ** half_log2
            first_times = times[..., None]

            lat_size = latents[0, 0].numel()

            def run_frozen(noised_flat, sig):
                lat = noised_flat[..., :lat_size].reshape(latents.shape)
                prop = noised_flat[..., lat_size:] if self.has_proprio else None
                p = self._predict(lat, prop, sig, half_log2, action_tokens, reward_tokens,
                                  aug_token, agent_tokens)[0]
                return pack(p.flow, p.proprio)

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
        # every mean over the batch is the global batch's under data
        # parallelism (`batch_mean`, `batch_sum`)
        flow_loss = batch_mean(flow_losses, loss_mask[..., None] if is_var_len else None)
        shortcut_loss = (batch_mean(shortcut_losses, loss_mask[..., None] if is_var_len else None)
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
                reward_loss = (batch_sum(torch.where(denom, ce, 0.0).sum(dim=(0, 1)))
                               / batch_sum(denom.sum(dim=(0, 1)).float()).clamp_min(1.0))
            else:
                reward_loss = batch_mean(ce, dim=(0, 1))

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
            terminal_loss = batch_mean(bce, mask_without_last)

        # state prediction: Beta NLL of the next frame's latents, mapped
        # from [-1, 1] into (0, 1)
        state_pred_loss = zero
        multi_view = self.num_video_views > 1
        if self.should_pred_state and time > 1:
            target = latents[:, 1:] if multi_view else latents[:, 1:, 0]
            target = ((target + 1.0) / 2.0).clamp(self.eps_latent_pred, 1.0 - self.eps_latent_pred)
            nll = -dists.continuous_log_prob(pred.state[:, :-1], target, 'beta')
            state_pred_loss = (
                batch_mean(nll, mask_without_last.reshape(*mask_without_last.shape,
                                                            *([1] * (nll.ndim - 2))))
                if is_var_len else batch_mean(nll))

        # the agent's state prediction: Beta NLL of the next frame's latents
        # from the agent token (only `agent_predicts_state_frac_gradient` of
        # its gradient reaches the trunk) and the next action's token
        agent_state_pred_loss = zero
        if self.agent_predicts_state and time > 1:
            agent_in = frac_gradient(embeds.agent[:, :-1].mean(dim=2),
                                     self.agent_predicts_state_frac_gradient)
            if self.has_actions:
                nat = next_action_tokens
                if nat is None:
                    nat = torch.zeros((b, time, self.dim), device=device)
                seq_len = min(agent_in.shape[1], nat.shape[1])
                agent_in = torch.cat([agent_in[:, :seq_len], nat[:, :seq_len].to(agent_in.dtype)],
                                     dim=-1)
            s = self.agent_state_pred_net(agent_in)
            seq_len = s.shape[1]
            s = s.reshape(b, seq_len, self.num_video_views, self.num_latent_tokens,
                          self.dim_latent, 2)
            target = ((latents[:, 1:1 + seq_len] + 1.0) / 2.0).clamp(
                self.eps_latent_pred, 1.0 - self.eps_latent_pred)
            nll = -dists.continuous_log_prob(s, target, 'beta')
            agent_state_pred_loss = (
                batch_mean(nll, mask_without_last[:, :seq_len, None, None, None])
                if is_var_len else batch_mean(nll))

        # actions: MTP log likelihood of the next actions under the policy head
        action_losses = {'discrete': torch.zeros((mtp,), device=device),
                         'continuous': torch.zeros((mtp,), device=device)}
        w = self.loss_weights
        has_action_loss = w['discrete_actions'] + w['continuous_actions'] > 0
        given = {k: v for k, v in (('discrete', discrete_actions),
                                   ('continuous', continuous_actions)) if v is not None}
        if has_action_loss and time > 1 and given:
            if shift_action_tokens:
                given = {k: nn.functional.pad(v, (0, 0, 1, 0)) for k, v in given.items()}
            pred_len = next(iter(given.values())).shape[1]
            num_targets = pred_len - 1 if shift_action_tokens else pred_len
            if self.actor_critic_latent_input:
                # the policy head learns from the input RL gives it: the
                # latent encoder over the clean latents
                actor_tokens, _ = self.latent_actor_inputs(
                    latents if multi_view else latents[:, :, 0])
            else:
                actor_tokens = embeds.actor[:, :, agent_index]
            policy_embed = self.policy_head(actor_tokens[:, :num_targets])
            targets, masks = {}, {}
            for kind, actions in given.items():
                tgt, amask = create_multi_token_prediction_targets(actions, mtp)
                if shift_action_tokens:
                    tgt, amask = tgt[:, 1:], amask[:, 1:]
                targets[kind], masks[kind] = tgt.movedim(2, 0), amask.movedim(2, 0)  # (mtp, b, t, ...)
            lp = self.action_embedder.log_probs(
                policy_embed, discrete_targets=targets.get('discrete'),
                continuous_targets=targets.get('continuous'), soft_validate_range=True)
            for kind, log_prob in zip(('discrete', 'continuous'), lp):
                if log_prob is None:
                    continue
                amask = masks[kind]
                nl = torch.where(amask[..., None], -log_prob, 0.0)
                if is_var_len:
                    action_mask = mask_without_last if pred_len == time - 1 else loss_mask
                    m = action_mask[None, :, :num_targets, None] & amask[..., None]
                    dims = (1, 2, 3)
                    action_losses[kind] = (batch_sum(torch.where(m, nl, 0.0).sum(dim=dims))
                                           / batch_sum(m.sum(dim=dims).float()).clamp_min(1.0))
                else:
                    action_losses[kind] = batch_mean(nl, dim=(1, 2, 3))

        def next_actions_or_zeros():
            nat = next_action_tokens
            return nat if nat is not None else torch.zeros((b, time, self.dim), device=device)

        # latent AR on the main trunk's hiddens of the spatial tokens, from
        # one layer to itself or to another, conditioned on the next action
        latent_ar_loss = latent_ar_sigreg_loss = zero
        if self.latent_ar and time > 1:
            layer = self.latent_ar_layer
            src_layer, tgt_layer = layer if isinstance(layer, tuple) else (layer, layer)
            hiddens = aux['layer_hiddens']
            n_space = self.num_spatial_tokens * self.num_video_views
            src_h = hiddens[src_layer][:, :, 1:1 + n_space]
            tgt_h = hiddens[tgt_layer][:, :, 1:1 + n_space]
            cond = None
            if self.latent_ar_action_conditioned:
                nat = next_actions_or_zeros()
                if nat.shape[1] == time - 1:
                    nat = nn.functional.pad(nat, (0, 0, 0, 1))
                cond = nat[:, :, None, :].expand(*src_h.shape[:-1], self.dim)
            latent_ar_loss, latent_ar_sigreg_loss, _ = self.latent_ar_module(
                src_h, target=None if src_layer == tgt_layer else tgt_h, mask=loss_mask,
                cond=cond, generator=generator)

        # the self-supervised losses: LAPO over the trunk's spatial outputs,
        # TEM over the next action tokens, both against the raw latents
        lapo = (zero, zero, zero)
        if self.ssl_lapo and time > 1:
            lapo = self.ssl_lapo_module(aux['space_out'], discrete_actions=discrete_actions,
                                        continuous_actions=continuous_actions,
                                        raw_latents=latents[:, :, 0])
        tem_loss = zero
        if self.ssl_tem:
            tem_loss = self.ssl_tem_module(next_actions_or_zeros(), latents[:, :, 0])

        return WorldModelLosses(
            flow=flow_loss, shortcut=shortcut_loss, rewards=reward_loss,
            terminals=terminal_loss, discrete_actions=action_losses['discrete'],
            continuous_actions=action_losses['continuous'], state_pred=state_pred_loss,
            agent_state_pred=agent_state_pred_loss, latent_ar=latent_ar_loss,
            latent_ar_sigreg=latent_ar_sigreg_loss, lapo_action=lapo[0], lapo_fdm=lapo[1],
            lapo_raw_latent_fdm=lapo[2], tem=tem_loss, h_net=aux['h_net_loss'])
