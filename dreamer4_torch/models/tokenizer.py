"""VideoTokenizer, the causal space-time transformer autoencoder
(counterpart of `dreamer4_tpu/models/tokenizer.py`).

- Encoder: linear patchify -> LayerNorm, or shifted patch tokenization
  (`use_shifted_patch_tokenization`, clean video only) -> optional causal
  depthwise conv3d (`use_causal_conv3d`) -> per-frame MAE masking (a
  per-(b, t) mask probability ~ U(lo, hi), then a Bernoulli patch mask, or
  an explicit `patch_mask`; with `latent_init_patch_size` the mask is
  repeated onto the finer patch grid too) -> learned latent tokens,
  optionally initialized by slot attention over the fine patches or the
  tokens -> optional aug-conditioning token with CFG dropout -> axial
  trunk (special tokens = aug + latents) -> optional conv3d on the spatial
  tokens -> linear bottleneck -> tanh.
- Decoder: spatial tokens from a 2-D coordinate MLP position embedding
  (plus the noised image's tokens on flow steps), optionally initialized
  by slot attention over the latents, through the pre conv3d, packed with
  the aug token and the latents, which attend only to themselves, then
  through the post conv3d and unpatchified. With `separate_flow_decoder`
  a second decoder (`flow_decoder`) takes every flow step after the first.
- Flow decoding: x-prediction over `decoder_flow_steps`; `decode` runs the
  Euler steps, the training forward one flow-noised step with the loss in
  v-space and var-len `time_lens` masking. Its flow steps are uniform,
  Beta-distributed (`decoder_flow_times_beta`) or, with the separate flow
  decoder, 0 for the main decoder and in [1, steps) for the flow decoder.
- Loss terms beside the reconstruction: LPIPS (`lpips_fn`, which the
  trainer supplies), the time and space decorrelation of the encoder
  trunk's normed attention inputs, the latent AR loss on the
  pre-bottleneck latent hiddens, the latents' orthogonality and sigreg,
  each normalized by its EMA under `use_loss_normalization`, BYOL against
  the EMA teacher's latents (`byol_target_latents`, which the trainer
  supplies), and the latent consistency of `latent_consistency_loss`,
  which the train step adds.
- Both trunks take learned rotary (PoPE) on their time and space layers
  and MOSS spatial modules after chosen layers.

Only the trunks take `dtype`: the patch projections, the convs, the
bottleneck, the position MLP, the slot attentions, `tokens_to_patch` and
`time_embed` compute in float32 around a bf16 trunk, as flax's layers
without a dtype promote to their float32 parameters. The public video
layout is (b, c, t, h, w), the internal one (b, t, h, w, c). Every random
draw goes through a module-level `draw` (this module's, `ops.losses.draw`,
`nn.lpips.draw`), so a test can replay the counterpart's draws. The
encoder's trunk takes the GRU time layer (`use_time_rnn`) and the H-Net
splice (`h_net_*`), whose ratio loss, weighted by `h_net_loss_weight`,
joins the total (the counterpart's `TokenizerLosses` has no field for it).

`encode` also streams: frame by frame (`cache=`, `max_time=`,
`return_cache=`), as an environment's frames arrive, through the
counterpart's four-part `TokenizerCache`: the shifted-patch cache (the
previous frame), the pre-conv cache (its last k - 1 normed token frames),
the encoder trunk's cache (its KV caches and its MOSS layers' conv caches)
and the post-conv cache.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from ..nn.conv import CausalDepthwiseConv3d
from ..nn.dense import Dense
from ..nn.init import embed_normal_, normal_
from ..nn.latent_ar import LatentAutoregressiveLoss
from ..nn.loss_normalizer import LossNormalizer
from ..nn.mlp import MLP, create_mlp
from ..nn.norms import LayerNorm
from ..nn.sem import SEM
from ..nn.slot_attention import SlotAttention
from ..nn.spt import ShiftedPatchTokenization
from ..ops.dists import beta_sample
from ..ops.losses import decorrelation_loss, sigreg
from ..ops.utils import frac_gradient, lens_to_mask, orthogonal_loss, smooth_l1_loss
from ..parallel.distributed import batch_gather, batch_mean, local_rows
from .transformer import AxialSpaceTimeTransformer, TransformerCache


class TokenizerLosses(NamedTuple):
    """The counterpart's loss record; a term whose option is off is zero."""
    recon: torch.Tensor
    flow_recon: torch.Tensor
    lpips: torch.Tensor
    time_decorr: torch.Tensor
    space_decorr: torch.Tensor
    latent_ortho: torch.Tensor
    latent_ar: torch.Tensor
    latent_ar_sigreg: torch.Tensor
    latent_sigreg: torch.Tensor
    byol: torch.Tensor


class TokenizerIntermediates(NamedTuple):
    losses: TokenizerLosses
    recon: torch.Tensor
    latents: torch.Tensor


class TokenizerCache(NamedTuple):
    """The streaming encode's cache, in the counterpart's four parts: the
    shifted-patch tokenizer's previous frame, the encoder's pre-conv and
    post-conv time caches (each None without its option) and the encoder
    trunk's cache (KV caches and MOSS conv caches)."""
    spt: torch.Tensor | None
    pre_conv: torch.Tensor | None
    transformer: TransformerCache
    post_conv: torch.Tensor | None


# the parameters of the encoder (the counterpart's `ENCODER_PARAM_KEYS`):
# the latent consistency loss re-encodes through them detached
ENCODER_PARAM_KEYS = (
    'patch_to_tokens', 'patch_proj', 'patch_norm', 'mask_token', 'latent_tokens',
    'encoder_transformer', 'encoded_to_latents', 'slot_attention',
    'encoder_pre_causal_conv3d', 'encoder_post_causal_conv3d',
    'latent_init_patch_proj', 'latent_init_patch_norm', 'latent_init_mask_token',
    'aug_cond_embedding',
)


def draw(kind: str, shape, *, generator: torch.Generator | None, device, low: float = 0.0,
         high: float = 0.0, prob: torch.Tensor | float | None = None,
         concentration: tuple[float, float] | None = None) -> torch.Tensor:
    """One random draw of the tokenizer.

    kind: 'mask_prob'    — uniform in [low, high), the per-frame mask probability;
          'patch_mask'   — Bernoulli(prob) per patch, True = masked;
          'aug_dropout'  — Bernoulli(prob) per batch row, True = drop the aug id;
          'time_indices' — integers in [low, high), the flow steps;
          'flow_times'   — Beta(*concentration) in [0, 1], a flow step's fraction;
          'noise'        — standard normal noise of the video.
    """
    if kind == 'mask_prob':
        return torch.rand(shape, generator=generator, device=device) * (high - low) + low
    if kind in ('patch_mask', 'aug_dropout'):
        return torch.rand(shape, generator=generator, device=device) < prob
    if kind == 'time_indices':
        return torch.randint(int(low), int(high), shape, generator=generator, device=device)
    if kind == 'flow_times':
        a, b = concentration
        return beta_sample(torch.full(shape, float(a), device=device),
                           torch.full(shape, float(b), device=device), generator=generator)
    if kind == 'noise':
        return torch.randn(shape, generator=generator, device=device)
    raise ValueError(f'unknown draw {kind}')


def video_to_internal(video: torch.Tensor) -> torch.Tensor:
    """(b, c, t, h, w) -> (b, t, h, w, c)."""
    return video.permute(0, 2, 3, 4, 1)


def video_to_external(video: torch.Tensor) -> torch.Tensor:
    """(b, t, h, w, c) -> (b, c, t, h, w)."""
    return video.permute(0, 4, 1, 2, 3)


class VideoDecoderNetwork(nn.Module):
    def __init__(self, *, dim: int, patch_size: int, channels: int, depth: int,
                 time_block_every: int, attn_dim_head: int, attn_heads: int,
                 query_heads: int | None = None, num_latent_tokens: int = 64,
                 full_spatial_attn: bool = False, pos_mlp_depth: int = 2,
                 pos_mlp_activation: str = 'silu', has_aug_conditioning: bool = False,
                 use_causal_conv3d: bool = False, causal_conv3d_kernel_size: int = 3,
                 slot_attention_initted_spatial_tokens: bool = False,
                 slot_attention_iters: int = 2, slot_attention_inverted: bool = True,
                 slot_spatial_mix: bool = False, num_spatial_tokens: int | None = None,
                 use_flash_attention: bool = False, use_fused_small: bool | None = None,
                 time_attention_use_pope: bool = False, space_attention_use_pope: bool = False,
                 moss_layers: tuple = (), image_height: int | None = None,
                 image_width: int | None = None, dtype=None, device=None):
        super().__init__()
        self.dim, self.patch_size, self.channels = dim, patch_size, channels
        self.use_causal_conv3d = use_causal_conv3d
        self.to_pos_emb = MLP(2, (dim * 2,) * pos_mlp_depth, dim,
                              activation=pos_mlp_activation, device=device)
        if slot_attention_initted_spatial_tokens:
            self.slot_attention = SlotAttention(
                dim, iters=slot_attention_iters, heads=attn_heads, dim_head=attn_dim_head,
                inverted_attention=slot_attention_inverted, num_slots=num_spatial_tokens,
                spatial_mix=slot_spatial_mix, device=device)
        if has_aug_conditioning:
            self.aug_cond_embedding = nn.Embedding(3, dim, device=device)
            embed_normal_(self.aug_cond_embedding.weight)
        if use_causal_conv3d:
            self.pre_causal_conv3d = CausalDepthwiseConv3d(dim, causal_conv3d_kernel_size,
                                                           device=device)
            self.post_causal_conv3d = CausalDepthwiseConv3d(dim, causal_conv3d_kernel_size,
                                                            device=device)
        self.transformer = AxialSpaceTimeTransformer(
            dim=dim, depth=depth, attn_dim_head=attn_dim_head, attn_heads=attn_heads,
            query_heads=query_heads, time_block_every=time_block_every,
            num_special_tokens=num_latent_tokens + int(has_aug_conditioning),
            special_attend_only_itself=True,   # latents attend only to themselves
            full_spatial_attn=full_spatial_attn, use_flash_attention=use_flash_attention,
            use_fused_small=use_fused_small, time_attention_use_pope=time_attention_use_pope,
            space_attention_use_pope=space_attention_use_pope,
            space_height=image_height // patch_size if image_height is not None else None,
            space_width=image_width // patch_size if image_width is not None else None,
            spatial_module_layers=tuple(moss_layers), dtype=dtype, device=device)
        self.tokens_to_patch = Dense(dim, channels * patch_size ** 2, device=device)

    def forward(self, latent_tokens, height: int, width: int, noised_image_tokens=None,
                aug_id=None):
        """latent_tokens (b, t, n, dim); noised_image_tokens (b, t, hp, wp,
        dim) or None; aug_id (b,) ints or None (0). -> (b, t, h, w, c)."""
        b, t = latent_tokens.shape[:2]
        p = self.patch_size
        hp, wp = height // p, width // p
        device = latent_tokens.device

        ys = torch.linspace(-1.0, 1.0, hp, device=device)
        xs = torch.linspace(-1.0, 1.0, wp, device=device)
        coords = torch.stack(torch.meshgrid(ys, xs, indexing='ij'), dim=-1)   # (hp, wp, 2)
        spatial = self.to_pos_emb(coords)[None, None].expand(b, t, hp, wp, self.dim)
        if noised_image_tokens is not None:
            spatial = spatial + noised_image_tokens
        if hasattr(self, 'slot_attention'):
            spatial = self.slot_attention(spatial.reshape(b, t, hp * wp, self.dim),
                                          latent_tokens).reshape(b, t, hp, wp, self.dim)
        if self.use_causal_conv3d:
            spatial = self.pre_causal_conv3d(spatial)
        parts = [spatial.reshape(b, t, hp * wp, self.dim)]
        if hasattr(self, 'aug_cond_embedding'):
            if aug_id is None:
                aug_id = torch.zeros(b, dtype=torch.long, device=device)
            parts.append(self.aug_cond_embedding(aug_id)[:, None, None, :].expand(
                b, t, 1, self.dim))
        parts.append(latent_tokens)

        tokens, _ = self.transformer(torch.cat(parts, dim=2))

        spatial = tokens[:, :, :hp * wp]
        if self.use_causal_conv3d:
            spatial = self.post_causal_conv3d(spatial.reshape(b, t, hp, wp, self.dim))
        patches = self.tokens_to_patch(spatial).reshape(b, t, hp, wp, p, p, self.channels)
        return patches.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, hp * p, wp * p, self.channels)


class VideoTokenizer(nn.Module):
    def __init__(self, *, dim: int, dim_latent: int, patch_size: int, image_height: int,
                 image_width: int, channels: int = 3, num_latent_tokens: int = 64,
                 encoder_depth: int = 4, decoder_depth: int = 4, time_block_every: int = 4,
                 attn_dim_head: int = 64, attn_heads: int = 8, query_heads: int | None = None,
                 attn_softclamp_value: float = 50.0, encoder_full_spatial_attn: bool = False,
                 decoder_full_spatial_attn: bool = False,
                 per_image_patch_mask_prob: tuple[float, float] = (0.0, 0.9),
                 decoder_flow_steps: int = 1, decoder_v_space_loss: bool = True,
                 pos_mlp_depth: int = 2, encode_temporal_diff: bool = False,
                 use_causal_conv3d: bool = False, causal_conv3d_kernel_size: int = 3,
                 use_shifted_patch_tokenization: bool = False, spt_temporal_shift: bool = True,
                 latent_init_patch_size: int | None = None,
                 slot_attention_initted_latents: bool = False, slot_attention_iters: int = 2,
                 encoder_slot_spatial_mix: bool = True, slot_attention_inverted: bool = True,
                 decoder_slot_attention_initted_spatial_tokens: bool = False,
                 decoder_slot_attention_iters: int = 2, decoder_slot_spatial_mix: bool = False,
                 separate_flow_decoder: bool = False, flow_decoder_train_prob: float = 0.5,
                 latent_grad_only_at_noise: bool = False,
                 decoder_flow_times_beta: tuple[float, float] = (1.0, 1.0),
                 has_aug_conditioning: bool = False, aug_cfg_dropout_prob: float = 0.1,
                 has_byol: bool = False, byol_loss_weight: float = 1.0,
                 byol_use_sem: bool = False, byol_sem_simplex_dim: int = 8,
                 byol_sem_temperature: float = 0.1, use_loss_normalization: bool = True,
                 lpips_loss_weight: float = 0.2, encoder_add_decorr_aux_loss: bool = False,
                 time_decorr_loss_weight: float = 4e-3, space_decorr_loss_weight: float = 4e-3,
                 decorr_sample_frac: float = 0.25, latent_ortho_loss_weight: float = 0.0,
                 latent_ar_loss_weight: float = 0.0, latent_ar_sigreg_loss_weight: float = 0.05,
                 latent_ar_num_slices: int = 256, latent_sigreg_loss_weight: float = 0.0,
                 latent_sigreg_num_slices: int = 256,
                 latent_consistency_loss_weight: float = 0.0, use_flash_attention: bool = False,
                 use_fused_small: bool | None = None, time_attention_use_pope: bool = False,
                 space_attention_use_pope: bool = False, encoder_moss_layers: tuple = (),
                 decoder_moss_layers: tuple = (), use_time_rnn: bool = False,
                 h_net_layer: int | None = None, h_net_depth: int = 2,
                 h_net_compression_ratio: int = 4, h_net_dynamic: bool = False,
                 h_net_loss_weight: float = 1.0, dtype=None, device=None):
        # the constructor's arguments, for checkpoints (train/checkpoint.py)
        config = {k: v for k, v in locals().items()
                  if k not in ('self', '__class__', 'device')}
        super().__init__()
        self.config = config
        if image_height % patch_size or image_width % patch_size:
            raise ValueError('image sides must be multiples of the patch size')
        if latent_init_patch_size is not None and (latent_init_patch_size > patch_size or
                                                   patch_size % latent_init_patch_size):
            raise ValueError('latent_init_patch_size must divide the patch size')
        device = resolve_device(device)

        self.dim, self.dim_latent, self.patch_size = dim, dim_latent, patch_size
        self.image_height, self.image_width, self.channels = image_height, image_width, channels
        self.num_latent_tokens = num_latent_tokens
        self.per_image_patch_mask_prob = tuple(per_image_patch_mask_prob)
        self.decoder_flow_steps = decoder_flow_steps
        self.decoder_v_space_loss = decoder_v_space_loss
        self.encode_temporal_diff = encode_temporal_diff
        self.use_causal_conv3d = use_causal_conv3d
        self.use_shifted_patch_tokenization = use_shifted_patch_tokenization
        self.latent_init_patch_size = latent_init_patch_size
        self.separate_flow_decoder = separate_flow_decoder
        self.flow_decoder_train_prob = flow_decoder_train_prob
        self.latent_grad_only_at_noise = latent_grad_only_at_noise
        self.decoder_flow_times_beta = tuple(decoder_flow_times_beta)
        self.aug_cfg_dropout_prob = aug_cfg_dropout_prob
        self.has_byol, self.byol_use_sem = has_byol, byol_use_sem
        self.use_loss_normalization = use_loss_normalization
        # the weighted terms of the total loss, in the counterpart's order
        self.loss_weights = dict(lpips=lpips_loss_weight, time_decorr=time_decorr_loss_weight,
                                 space_decorr=space_decorr_loss_weight,
                                 latent_ortho=latent_ortho_loss_weight,
                                 latent_ar=latent_ar_loss_weight,
                                 latent_ar_sigreg=latent_ar_sigreg_loss_weight,
                                 latent_sigreg=latent_sigreg_loss_weight,
                                 byol=byol_loss_weight)
        self.encoder_add_decorr_aux_loss = encoder_add_decorr_aux_loss
        self.decorr_sample_frac = decorr_sample_frac
        self.latent_sigreg_num_slices = latent_sigreg_num_slices
        self.latent_consistency_loss_weight = latent_consistency_loss_weight
        self.h_net_loss_weight = h_net_loss_weight

        enc_channels = channels * (2 if encode_temporal_diff else 1)
        if use_shifted_patch_tokenization:
            self.patch_to_tokens = ShiftedPatchTokenization(
                dim, patch_size, channels=enc_channels, temporal_shift=spt_temporal_shift,
                device=device)
        else:
            self.patch_proj = Dense(enc_channels * patch_size ** 2, dim, device=device)
            self.patch_norm = LayerNorm(dim, device=device)
        if latent_init_patch_size is not None:
            self.latent_init_patch_proj = Dense(enc_channels * latent_init_patch_size ** 2, dim,
                                                device=device)
            self.latent_init_patch_norm = LayerNorm(dim, device=device)
            self.latent_init_mask_token = nn.Parameter(torch.empty(dim, device=device))
            normal_(self.latent_init_mask_token, 1e-2)
        self.mask_token = nn.Parameter(torch.empty(dim, device=device))
        self.latent_tokens = nn.Parameter(torch.empty(num_latent_tokens, dim, device=device))
        normal_(self.mask_token, 1e-2)
        normal_(self.latent_tokens, 1e-2)
        if slot_attention_initted_latents:
            self.slot_attention = SlotAttention(
                dim, iters=slot_attention_iters, heads=attn_heads, dim_head=attn_dim_head,
                inverted_attention=slot_attention_inverted, num_slots=num_latent_tokens,
                spatial_mix=encoder_slot_spatial_mix, device=device)
        if has_aug_conditioning:
            self.aug_cond_embedding = nn.Embedding(3, dim, device=device)
            embed_normal_(self.aug_cond_embedding.weight)
        if use_causal_conv3d:
            self.encoder_pre_causal_conv3d = CausalDepthwiseConv3d(
                dim, causal_conv3d_kernel_size, device=device)
            self.encoder_post_causal_conv3d = CausalDepthwiseConv3d(
                dim, causal_conv3d_kernel_size, device=device)

        trunk = dict(dim=dim, attn_dim_head=attn_dim_head, attn_heads=attn_heads,
                     query_heads=query_heads, time_block_every=time_block_every,
                     use_flash_attention=use_flash_attention, use_fused_small=use_fused_small,
                     time_attention_use_pope=time_attention_use_pope,
                     space_attention_use_pope=space_attention_use_pope, dtype=dtype,
                     device=device)
        self.encoder_transformer = AxialSpaceTimeTransformer(
            **trunk, depth=encoder_depth, attn_softclamp_value=attn_softclamp_value,
            num_special_tokens=num_latent_tokens + int(has_aug_conditioning),
            full_spatial_attn=encoder_full_spatial_attn, final_norm=True,
            space_height=image_height // patch_size, space_width=image_width // patch_size,
            spatial_module_layers=tuple(encoder_moss_layers), rnn_time=use_time_rnn,
            h_net_layer=h_net_layer, h_net_depth=h_net_depth,
            h_net_compression_ratio=h_net_compression_ratio, h_net_dynamic=h_net_dynamic)
        self.encoded_to_latents = Dense(dim, dim_latent, bias=False, device=device)
        self.latents_to_decoder = Dense(dim_latent, dim, bias=False, device=device)
        decoder_kwargs = dict(
            **trunk, depth=decoder_depth, patch_size=patch_size, channels=channels,
            num_latent_tokens=num_latent_tokens, full_spatial_attn=decoder_full_spatial_attn,
            pos_mlp_depth=pos_mlp_depth, has_aug_conditioning=has_aug_conditioning,
            use_causal_conv3d=use_causal_conv3d,
            causal_conv3d_kernel_size=causal_conv3d_kernel_size,
            slot_attention_initted_spatial_tokens=decoder_slot_attention_initted_spatial_tokens,
            slot_attention_iters=decoder_slot_attention_iters,
            slot_attention_inverted=slot_attention_inverted,
            slot_spatial_mix=decoder_slot_spatial_mix,
            num_spatial_tokens=(image_height // patch_size) * (image_width // patch_size),
            moss_layers=tuple(decoder_moss_layers), image_height=image_height,
            image_width=image_width)
        self.decoder = VideoDecoderNetwork(**decoder_kwargs)
        if self.has_separate_flow_decoder:
            self.flow_decoder = VideoDecoderNetwork(**decoder_kwargs)

        if self.has_flow:
            self.time_embed = nn.Embedding(decoder_flow_steps, dim, device=device)
            embed_normal_(self.time_embed.weight)
            self.noised_patch_proj = Dense(channels * patch_size ** 2, dim, device=device)
            self.noised_patch_norm = LayerNorm(dim, device=device)
        if has_byol:
            self.byol_predictor = create_mlp(dim_latent, dim_latent, 3, dim_latent,
                                             device=device)
            if byol_use_sem:
                self.byol_sem = SEM(dim_latent, temperature=byol_sem_temperature,
                                    dim_simplex=byol_sem_simplex_dim, pre_layernorm=True,
                                    device=device)
        if latent_ar_loss_weight > 0.0:
            self.latent_ar = LatentAutoregressiveLoss(
                dim, use_rmsnorm=True, predict_residual=True,
                sigreg_num_slices=latent_ar_num_slices, device=device)
        # the counterpart's loss normalizers, in its order
        self.normalized_losses = []
        if use_loss_normalization:
            self.normalized_losses = (
                ['recon'] + ['flow_recon'] * self.has_separate_flow_decoder
                + ['lpips'] * (lpips_loss_weight > 0.0)
                + ['time_decorr', 'space_decorr'] * encoder_add_decorr_aux_loss
                + [name for name in ('latent_ar', 'latent_ortho', 'latent_sigreg')
                   if self.loss_weights[name] > 0.0])
        for name in self.normalized_losses:
            setattr(self, f'{name}_loss_normalizer', LossNormalizer(device=device))

    # ------------------------------------------------------------ properties

    @property
    def device(self) -> torch.device:
        return self.mask_token.device

    @property
    def has_flow(self) -> bool:
        return self.decoder_flow_steps > 0

    @property
    def has_separate_flow_decoder(self) -> bool:
        return self.separate_flow_decoder and self.has_flow

    @property
    def has_aug_conditioning(self) -> bool:
        return hasattr(self, 'aug_cond_embedding')

    @property
    def latent_shape(self) -> tuple[int, int]:
        return (self.num_latent_tokens, self.dim_latent)

    # ------------------------------------------------------------- helpers

    def _prep_aug_id(self, aug_id, batch: int, cfg_dropout: bool, generator, device):
        """Aug ids as (batch,) ints in {0: none, 1: not augmented, 2:
        augmented} from None (0), an int, a bool (True is 2) or an array
        of either, with the CFG dropout to 0 when asked."""
        if aug_id is None:
            aug_id = 0
        if isinstance(aug_id, bool):
            aug_id = int(aug_id) + 1
        aug_id = torch.as_tensor(aug_id, device=device)
        if aug_id.dtype == torch.bool:
            aug_id = aug_id.long() + 1
        aug_id = aug_id.broadcast_to((batch,)).long()
        if cfg_dropout and self.aug_cfg_dropout_prob > 0.0:
            drop = local_rows(lambda s: draw('aug_dropout', s, generator=generator, device=device,
                                             prob=self.aug_cfg_dropout_prob), (batch,))
            aug_id = torch.where(drop, 0, aug_id)
        return aug_id

    def _patchify(self, video, noised: bool = False, latent_init: bool = False):
        """The plain patch projection: (b, t, h, w, c) -> (b, t, hp, wp,
        dim), of the clean video, of the decoder's noised one (`noised`),
        or at the fine patch size of the latent init (`latent_init`)."""
        b, t, h, w, c = video.shape
        p = self.latent_init_patch_size if latent_init else self.patch_size
        x = video.reshape(b, t, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, h // p, w // p, p * p * c)
        if noised:
            return self.noised_patch_norm(self.noised_patch_proj(x))
        if latent_init:
            return self.latent_init_patch_norm(self.latent_init_patch_proj(x))
        return self.patch_norm(self.patch_proj(x))

    def _encoder_input(self, video, is_image: bool):
        if not self.encode_temporal_diff:
            return video
        if is_image:
            return torch.cat([video, torch.zeros_like(video)], dim=-1)
        diff = torch.nn.functional.pad(video[:, 1:] - video[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0))
        return torch.cat([video, diff], dim=-1)

    # -------------------------------------------------------------- encode

    def encode(self, video, mask_patches: bool = False, patch_mask=None, aug_id=None,
               cfg_dropout_aug: bool = False, generator: torch.Generator | None = None,
               cache: TokenizerCache | None = None, max_time: int | None = None,
               return_cache: bool = False, return_pre_bottleneck: bool = False):
        """video (b, c, t, h, w) or (b, c, h, w) -> latents (b, t, n,
        d_latent) (or (b, n, d_latent) for an image), in [-1, 1]. With
        `mask_patches`, patches are replaced by the mask token at a random
        per-frame rate; `patch_mask` (b, t, hp, wp) masks given patches.
        `aug_id` (None, an int, a bool or a (b,) array) conditions an
        aug-conditioned encoder; `cfg_dropout_aug` drops it to 0 at random.

        `return_pre_bottleneck=True` adds (latent hiddens (b, t, n, dim),
        the trunk's TransformerOutputs, the aug ids or None) after the
        latents. Streaming: `return_cache=True` adds the TokenizerCache, the
        four caches after these frames, the trunk's allocated for `max_time`
        frames when no `cache` is given; a later call with `cache=` encodes
        its newest frame against it (the trunk's cached path, on the plain
        attention). `max_time` counts only with `return_cache`."""
        latents, hiddens, interm, aug_ids, next_cache = self._encode(
            video, mask_patches=mask_patches, patch_mask=patch_mask, aug_id=aug_id,
            cfg_dropout_aug=cfg_dropout_aug, generator=generator, cache=cache,
            max_time=max_time if return_cache else None)
        if video.ndim == 4:
            latents = latents[:, 0]
        out = (latents,)
        if return_pre_bottleneck:
            out += (hiddens, interm, aug_ids)
        if return_cache:
            out += (next_cache,)
        return out[0] if len(out) == 1 else out

    def _encode(self, video, mask_patches: bool = False, patch_mask=None, aug_id=None,
                cfg_dropout_aug: bool = False, generator: torch.Generator | None = None,
                cache: TokenizerCache | None = None, max_time: int | None = None,
                collect_normed_inputs: bool = False):
        """The encoder: video (b, c, t, h, w) or (b, c, h, w) -> (latents
        (b, t, n, d_latent), the latent hiddens before the bottleneck, the
        encoder trunk's TransformerOutputs, the aug ids or None, the
        TokenizerCache after these frames)."""
        is_image = video.ndim == 4
        if is_image:
            video = video[:, :, None]
        video = self._encoder_input(video_to_internal(video), is_image)
        b, t = video.shape[:2]
        spt_cache, pre_conv_cache, trunk_cache, post_conv_cache = (
            cache if cache is not None else (None,) * 4)

        next_spt_cache = next_pre_conv_cache = next_post_conv_cache = None
        if self.use_shifted_patch_tokenization:
            tokens, next_spt_cache = self.patch_to_tokens(video, time_cache=spt_cache,
                                                          return_time_cache=True)
        else:
            tokens = self._patchify(video)
        hp, wp = tokens.shape[2], tokens.shape[3]
        if self.use_causal_conv3d:
            tokens, next_pre_conv_cache = self.encoder_pre_causal_conv3d(
                tokens, time_cache=pre_conv_cache, return_time_cache=True)
        init_tokens = None
        if self.latent_init_patch_size is not None:
            init_tokens = self._patchify(video, latent_init=True)
        if mask_patches or patch_mask is not None:
            if patch_mask is None:
                lo, hi = self.per_image_patch_mask_prob
                # under data parallelism both draws are made at the global
                # batch (`local_rows`), the second from every rank's first
                mask_prob = local_rows(lambda s: draw('mask_prob', s, generator=generator,
                                                      device=video.device, low=lo, high=hi),
                                       (b, t))
                global_prob = batch_gather(mask_prob)[..., None, None]
                patch_mask = local_rows(lambda s: draw('patch_mask', s, generator=generator,
                                                       device=video.device, prob=global_prob),
                                        (b, t, hp, wp))
            tokens = torch.where(patch_mask[..., None], self.mask_token, tokens)
            if init_tokens is not None:
                scale = self.patch_size // self.latent_init_patch_size
                fine_mask = patch_mask.repeat_interleave(scale, dim=2).repeat_interleave(
                    scale, dim=3)
                init_tokens = torch.where(fine_mask[..., None], self.latent_init_mask_token,
                                          init_tokens)
        tokens = tokens.reshape(b, t, hp * wp, self.dim)

        latents = self.latent_tokens.expand(b, t, *self.latent_tokens.shape)
        if hasattr(self, 'slot_attention'):
            init_src = (init_tokens.reshape(b, t, -1, self.dim) if init_tokens is not None
                        else tokens)
            latents = self.slot_attention(latents, init_src)
        parts = [tokens]
        aug_ids = None
        if self.has_aug_conditioning:
            aug_ids = self._prep_aug_id(aug_id, b, cfg_dropout_aug, generator, video.device)
            parts.append(self.aug_cond_embedding(aug_ids)[:, None, None, :].expand(
                b, t, 1, self.dim))
        parts.append(latents)
        tokens, interm = self.encoder_transformer(
            torch.cat(parts, dim=2), cache=trunk_cache, max_time=max_time,
            return_intermediates=True, collect_normed_inputs=collect_normed_inputs)
        if self.use_causal_conv3d:
            n_spatial = hp * wp
            spatial, next_post_conv_cache = self.encoder_post_causal_conv3d(
                tokens[:, :, :n_spatial].reshape(b, -1, hp, wp, self.dim),
                time_cache=post_conv_cache, return_time_cache=True)
            tokens = torch.cat([spatial.reshape(b, -1, n_spatial, self.dim),
                                tokens[:, :, n_spatial:]], dim=2)

        hiddens = tokens[:, :, -self.num_latent_tokens:]
        latents = torch.tanh(self.encoded_to_latents(hiddens))
        next_cache = TokenizerCache(next_spt_cache, next_pre_conv_cache, interm.cache,
                                    next_post_conv_cache)
        return latents, hiddens, interm, aug_ids, next_cache

    # -------------------------------------------------------------- decode

    def decode_step(self, latents, noised_video=None, time_indices=None,
                    height: int | None = None, width: int | None = None, aug_id=None,
                    use_flow_decoder: bool = False):
        """One pass of a decoder: latents (b, t, n, d_latent), the noised
        video (b, t, h, w, c) and the flow step of each batch row (b,) ->
        the predicted clean video (b, t, h, w, c). `use_flow_decoder` picks
        the separate flow decoder, where there is one."""
        height = height if height is not None else self.image_height
        width = width if width is not None else self.image_width
        b = latents.shape[0]
        latent_tokens = self.latents_to_decoder(latents)
        if self.has_flow:
            if time_indices is None:
                time_indices = torch.zeros(b, dtype=torch.long, device=latents.device)
            latent_tokens = latent_tokens + self.time_embed(time_indices)[:, None, None, :]
        image_tokens = None
        if noised_video is not None:
            image_tokens = self._patchify(noised_video, noised=True)
        aug_ids = None
        if self.has_aug_conditioning:
            aug_ids = self._prep_aug_id(aug_id, b, False, None, latents.device)
        decoder = (self.flow_decoder if use_flow_decoder and self.has_separate_flow_decoder
                   else self.decoder)
        return decoder(latent_tokens, height, width, noised_image_tokens=image_tokens,
                       aug_id=aug_ids)

    def decode(self, latents, height: int | None = None, width: int | None = None,
               aug_id=None, generator: torch.Generator | None = None,
               noise: torch.Tensor | None = None):
        """Euler flow sampling from noise: latents (b, t, n, d_latent) ->
        video (b, c, t, h, w); steps after the first run on the separate
        flow decoder, where there is one. The starting noise (b, t, h, w, c)
        is drawn from `generator`, or given as `noise` by a caller that
        draws it."""
        height = height if height is not None else self.image_height
        width = width if width is not None else self.image_width
        b, t = latents.shape[:2]
        if not self.has_flow:
            return video_to_external(self.decode_step(latents, height=height, width=width,
                                                      aug_id=aug_id))

        video = noise if noise is not None else draw(
            'noise', (b, t, height, width, self.channels), generator=generator,
            device=latents.device)
        steps = self.decoder_flow_steps
        delta = 1.0 / steps
        for i in range(steps):
            t_frac = i * delta
            time_indices = torch.full((b,), i, dtype=torch.long, device=latents.device)
            pred = self.decode_step(latents, noised_video=video, time_indices=time_indices,
                                    height=height, width=width, aug_id=aug_id,
                                    use_flow_decoder=i > 0)
            flow = (pred - video) / (1.0 - t_frac)
            video = video + flow * delta
        return video_to_external(video)

    def latent_disagreement(self, latents, clip_decoded: bool = False,
                            generator: torch.Generator | None = None):
        """Hallucination metric: decode latents (b, t, n, d_latent), clip
        the video to [0, 1] with `clip_decoded`, re-encode it, and return
        the mean squared difference per frame (b, t)."""
        recon = self.decode(latents, generator=generator)
        if clip_decoded:
            recon = recon.clamp(0.0, 1.0)
        err = (self.encode(recon) - latents).square()
        return err.mean(dim=tuple(range(2, err.ndim)))

    # ------------------------------------------------------------ training

    def forward(self, video, return_latents: bool = False, mask_patches: bool | None = None,
                patch_mask=None, time_lens=None, aug_id=None,
                cfg_dropout_aug: bool | None = None, byol_target_latents=None,
                lpips_fn: Callable | None = None, update_loss_ema: bool = True,
                return_intermediates: bool = False, train_flow_decoder: bool | None = None,
                is_training: bool = True, generator: torch.Generator | None = None):
        """The training forward: masked encode, one flow-noised decoder
        step, the reconstruction loss (in v-space by default) over the
        frames inside `time_lens`, and the loss terms the options turn on:
        `lpips_fn(recon, clean, generator, time_lens)` (the trainer's LPIPS),
        the decorrelation of the encoder trunk's normed attention inputs,
        the latent AR loss and its sigreg, the latents' orthogonality and
        sigreg, BYOL against `byol_target_latents` (the EMA teacher's
        latents, detached); each normalized by its EMA under
        `use_loss_normalization`, except the sigregs and BYOL. With the
        separate flow decoder, `train_flow_decoder` chooses the decoder this
        step trains: the flow decoder at steps [1, steps) into `flow_recon`,
        or the main one at step 0 into `recon`; the latents' gradient
        reaches the encoder only from step 0. Returns the total loss, and
        with `return_intermediates` also (TokenizerLosses, recon, latents)
        as `TokenizerIntermediates`. Draws in the counterpart's order: the
        patch mask, the aug dropout, the latent AR's and the latents' sigreg
        slices, the flow steps and noise, the LPIPS frames, the
        decorrelation rows."""
        if return_latents:
            return self.encode(video, aug_id=aug_id, generator=generator)
        if mask_patches is None:
            mask_patches = is_training
        if cfg_dropout_aug is None:
            cfg_dropout_aug = is_training

        is_image = video.ndim == 4
        if is_image:
            video = video[:, :, None]
        video_internal = video_to_internal(video)
        b, t, height, width, _ = video_internal.shape
        rnd = lambda kind, shape, **kw: local_rows(
            lambda s: draw(kind, s, generator=generator, device=video.device, **kw), shape)

        latents, hiddens, interm, aug_ids, _ = self._encode(
            video, mask_patches=mask_patches, patch_mask=patch_mask, aug_id=aug_id,
            cfg_dropout_aug=cfg_dropout_aug, generator=generator,
            collect_normed_inputs=self.encoder_add_decorr_aux_loss)
        zero = torch.zeros((), device=video.device)
        w = self.loss_weights
        losses = dict.fromkeys(TokenizerLosses._fields, zero)
        if w['latent_ar'] > 0.0 and t > 1:
            mask = lens_to_mask(time_lens, t) if time_lens is not None else None
            losses['latent_ar'], losses['latent_ar_sigreg'], _ = self.latent_ar(
                hiddens, mask=mask, generator=generator)
        if w['latent_sigreg'] > 0.0:
            losses['latent_sigreg'] = sigreg(latents[None], num_slices=self.latent_sigreg_num_slices,
                                             generator=generator, mean=batch_mean)
        clean = video_internal[..., :self.channels]

        use_flow_decoder = False
        if self.has_flow:
            steps = self.decoder_flow_steps
            if self.has_separate_flow_decoder and steps > 1:
                use_flow_decoder = bool(train_flow_decoder)
                low, high = (1, steps) if use_flow_decoder else (0, 1)
                time_indices = rnd('time_indices', (b,), low=low, high=high)
            elif self.decoder_flow_times_beta != (1.0, 1.0):
                u = rnd('flow_times', (b,), concentration=self.decoder_flow_times_beta)
                time_indices = (u * steps).long().clamp(0, steps - 1)
            else:
                time_indices = rnd('time_indices', (b,), low=0, high=steps)
            noise = rnd('noise', (b, t, height, width, self.channels))
            t_frac = (time_indices.float() / steps)[:, None, None, None, None]
            noised_video = noise + (clean - noise) * t_frac
            dec_latents = latents
            if self.latent_grad_only_at_noise or self.has_separate_flow_decoder:
                frac = (time_indices == 0).float()[:, None, None, None]
                dec_latents = frac_gradient(latents, frac)
            recon_video = self.decode_step(dec_latents, noised_video=noised_video,
                                           time_indices=time_indices, height=height,
                                           width=width, aug_id=aug_ids,
                                           use_flow_decoder=use_flow_decoder)
            if self.decoder_v_space_loss:
                target = clean - noise
                pred = (recon_video - noised_video) / (1.0 - t_frac)
            else:
                target, pred = clean, recon_video
        else:
            recon_video = self.decode_step(latents, height=height, width=width, aug_id=aug_ids)
            target, pred = clean, recon_video

        # every mean over the batch is the global batch's under data
        # parallelism (`batch_mean`), so the normalizers' EMAs agree
        recon_err = (pred - target).square()
        frames = None if time_lens is None else lens_to_mask(time_lens, t)
        recon = batch_mean(recon_err, None if frames is None else frames[:, :, None, None, None])
        losses['flow_recon' if use_flow_decoder else 'recon'] = recon

        use_lpips = lpips_fn is not None and w['lpips'] > 0.0
        if use_lpips:
            losses['lpips'] = lpips_fn(recon_video, clean, generator, time_lens)
        if self.encoder_add_decorr_aux_loss:
            for kind, normed in (('time', interm.normed_time_inputs),
                                 ('space', interm.normed_space_inputs)):
                if normed is not None:
                    # (layers, b * rows, ...): the global batch's rows
                    losses[f'{kind}_decorr'] = decorrelation_loss(
                        batch_gather(normed, dim=1), self.decorr_sample_frac,
                        generator=generator)
        if w['latent_ortho'] > 0.0:
            losses['latent_ortho'] = orthogonal_loss(latents, mean=batch_mean)
        if self.has_byol and byol_target_latents is not None:
            h = self.byol_sem(latents) if self.byol_use_sem else latents
            losses['byol'] = batch_mean(smooth_l1_loss(self.byol_predictor(h),
                                                       byol_target_latents.detach()))

        # the decoder this step did not train keeps its normalizer as it is
        skip = {'recon' if use_flow_decoder else 'flow_recon'} | (
            set() if use_lpips else {'lpips'})
        for name in self.normalized_losses:
            if name not in skip:
                losses[name] = getattr(self, f'{name}_loss_normalizer')(
                    losses[name], update_ema=update_loss_ema)
        total = losses['recon'] + losses['flow_recon']
        for name, weight in w.items():
            total = total + losses[name] * weight
        total = total + interm.h_net_loss * self.h_net_loss_weight

        if not return_intermediates:
            return total
        recon_out = recon_video[:, 0] if is_image else recon_video
        return total, TokenizerIntermediates(losses=TokenizerLosses(**losses), recon=recon_out,
                                             latents=latents)


def latent_consistency_loss(model: VideoTokenizer, recon_video, latents, time_lens=None):
    """Re-encode the reconstruction (b, t, h, w, c) through the encoder with
    its parameters detached and match the original latents, detached too
    (the counterpart's `latent_consistency_loss` over
    `freeze_encoder_params`): the gradient reaches the decoder through the
    reconstruction, and the encoder none from the re-encode."""
    frozen = {name: p.detach() for name, p in model.named_parameters()
              if name.split('.')[0] in ENCODER_PARAM_KEYS}
    recon_latents = torch.func.functional_call(
        model, frozen, (video_to_external(recon_video),), dict(return_latents=True))
    err = (recon_latents - latents.detach()).square()
    if time_lens is not None:
        return batch_mean(err, lens_to_mask(time_lens, latents.shape[1])[:, :, None, None])
    return batch_mean(err)
