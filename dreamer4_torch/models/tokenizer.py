"""VideoTokenizer, the causal space-time transformer autoencoder
(counterpart of `dreamer4_tpu/models/tokenizer.py`).

- Encoder: linear patchify -> LayerNorm, or shifted patch tokenization
  (`use_shifted_patch_tokenization`, clean video only) -> optional causal
  depthwise conv3d (`use_causal_conv3d`) -> per-frame MAE masking (a
  per-(b, t) mask probability ~ U(lo, hi), then a Bernoulli patch mask, or
  an explicit `patch_mask`) -> learned latent tokens appended on the right
  as the trunk's special tokens -> axial trunk -> optional conv3d on the
  spatial tokens -> linear bottleneck -> tanh.
- Decoder: spatial tokens from a 2-D coordinate MLP position embedding
  (plus the noised image's tokens on flow steps), through the pre conv3d,
  packed with the latents, which attend only to themselves, then through
  the post conv3d and unpatchified.
- Flow decoding: x-prediction over `decoder_flow_steps`; `decode` runs the
  Euler steps, the training forward one flow-noised step with the loss in
  v-space and var-len `time_lens` masking.
- Loss terms beside the reconstruction: LPIPS (`lpips_fn`, which the
  trainer supplies), the time and space decorrelation of the encoder
  trunk's normed attention inputs, the latents' orthogonality and sigreg,
  each normalized by its EMA under `use_loss_normalization`, and the latent
  consistency of `latent_consistency_loss`, which the train step adds.

Only the trunks take `dtype`: the patch projections, the convs, the
bottleneck, the position MLP, `tokens_to_patch` and `time_embed` compute in
float32 around a bf16 trunk, as flax's layers without a dtype promote to
their float32 parameters. The public video layout is (b, c, t, h, w), the
internal one (b, t, h, w, c). Every random draw goes through a module-level
`draw` (this module's, `ops.losses.draw`, `nn.lpips.draw`), so a test can
replay the counterpart's draws. The counterpart's fields that the port does
not have yet (`_NOT_PORTED`) are accepted at their defaults and raise at
any other value.

`encode` also streams: frame by frame (`cache=`, `max_time=`,
`return_cache=`), as an environment's frames arrive, through the
counterpart's four-part `TokenizerCache`: the shifted-patch cache (the
previous frame), the pre-conv cache (its last k - 1 normed token frames),
the encoder trunk's KV cache and the post-conv cache.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from ..nn.conv import CausalDepthwiseConv3d
from ..nn.dense import Dense
from ..nn.init import embed_normal_, normal_
from ..nn.loss_normalizer import LossNormalizer
from ..nn.mlp import MLP
from ..nn.norms import LayerNorm
from ..nn.spt import ShiftedPatchTokenization
from ..ops.losses import decorrelation_loss, sigreg
from ..ops.utils import frac_gradient, lens_to_mask, masked_mean, orthogonal_loss
from .transformer import AxialSpaceTimeTransformer, TransformerCache, check_not_ported


class TokenizerLosses(NamedTuple):
    """The counterpart's loss record; the losses of options not ported yet
    (the separate flow decoder, latent AR, BYOL) are zeros."""
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
    trunk's KV cache."""
    spt: torch.Tensor | None
    pre_conv: torch.Tensor | None
    transformer: TransformerCache
    post_conv: torch.Tensor | None


# options of the counterpart, with their defaults, that the port does not
# have yet; any other value raises
_NOT_PORTED = dict(
    latent_init_patch_size=None, slot_attention_initted_latents=False,
    slot_attention_iters=2, encoder_slot_spatial_mix=True, slot_attention_inverted=True,
    decoder_slot_attention_initted_spatial_tokens=False, decoder_slot_attention_iters=2,
    decoder_slot_spatial_mix=False, separate_flow_decoder=False, flow_decoder_train_prob=0.5,
    decoder_flow_times_beta=(1.0, 1.0), has_aug_conditioning=False, aug_cfg_dropout_prob=0.1,
    has_byol=False, byol_loss_weight=1.0, byol_use_sem=False, byol_sem_simplex_dim=8,
    byol_sem_temperature=0.1, latent_ar_loss_weight=0.0, latent_ar_sigreg_loss_weight=0.05,
    latent_ar_num_slices=256, time_attention_use_pope=False, space_attention_use_pope=False,
    encoder_moss_layers=(), decoder_moss_layers=(), use_time_rnn=False, h_net_layer=None,
    h_net_depth=2, h_net_compression_ratio=4, h_net_dynamic=False, h_net_loss_weight=1.0,
)

# the parameters of the encoder (the counterpart's `ENCODER_PARAM_KEYS`,
# those the port has): the latent consistency loss re-encodes through them
# detached
ENCODER_PARAM_KEYS = (
    'patch_to_tokens', 'patch_proj', 'patch_norm', 'mask_token', 'latent_tokens',
    'encoder_transformer', 'encoded_to_latents', 'encoder_pre_causal_conv3d',
    'encoder_post_causal_conv3d',
)


def draw(kind: str, shape, *, generator: torch.Generator | None, device, low: float = 0.0,
         high: float = 0.0, prob: torch.Tensor | None = None) -> torch.Tensor:
    """One random draw of the tokenizer.

    kind: 'mask_prob'    — uniform in [low, high), the per-frame mask probability;
          'patch_mask'   — Bernoulli(prob) per patch, True = masked;
          'time_indices' — integers in [low, high), the flow steps;
          'noise'        — standard normal noise of the video.
    """
    if kind == 'mask_prob':
        return torch.rand(shape, generator=generator, device=device) * (high - low) + low
    if kind == 'patch_mask':
        return torch.rand(shape, generator=generator, device=device) < prob
    if kind == 'time_indices':
        return torch.randint(int(low), int(high), shape, generator=generator, device=device)
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
                 pos_mlp_activation: str = 'silu', use_causal_conv3d: bool = False,
                 causal_conv3d_kernel_size: int = 3, use_flash_attention: bool = False,
                 use_fused_small: bool | None = None, dtype=None, device=None):
        super().__init__()
        self.dim, self.patch_size, self.channels = dim, patch_size, channels
        self.use_causal_conv3d = use_causal_conv3d
        self.to_pos_emb = MLP(2, (dim * 2,) * pos_mlp_depth, dim,
                              activation=pos_mlp_activation, device=device)
        if use_causal_conv3d:
            self.pre_causal_conv3d = CausalDepthwiseConv3d(dim, causal_conv3d_kernel_size,
                                                           device=device)
            self.post_causal_conv3d = CausalDepthwiseConv3d(dim, causal_conv3d_kernel_size,
                                                            device=device)
        self.transformer = AxialSpaceTimeTransformer(
            dim=dim, depth=depth, attn_dim_head=attn_dim_head, attn_heads=attn_heads,
            query_heads=query_heads, time_block_every=time_block_every,
            num_special_tokens=num_latent_tokens,
            special_attend_only_itself=True,   # latents attend only to themselves
            full_spatial_attn=full_spatial_attn, use_flash_attention=use_flash_attention,
            use_fused_small=use_fused_small, dtype=dtype, device=device)
        self.tokens_to_patch = Dense(dim, channels * patch_size ** 2, device=device)

    def forward(self, latent_tokens, height: int, width: int, noised_image_tokens=None):
        """latent_tokens (b, t, n, dim); noised_image_tokens (b, t, hp, wp,
        dim) or None. -> (b, t, h, w, c)."""
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
        if self.use_causal_conv3d:
            spatial = self.pre_causal_conv3d(spatial)
        spatial = spatial.reshape(b, t, hp * wp, self.dim)

        tokens = torch.cat([spatial, latent_tokens], dim=2)
        tokens, _ = self.transformer(tokens)

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
                 latent_grad_only_at_noise: bool = False, use_loss_normalization: bool = True,
                 lpips_loss_weight: float = 0.2, encoder_add_decorr_aux_loss: bool = False,
                 time_decorr_loss_weight: float = 4e-3, space_decorr_loss_weight: float = 4e-3,
                 decorr_sample_frac: float = 0.25, latent_ortho_loss_weight: float = 0.0,
                 latent_sigreg_loss_weight: float = 0.0, latent_sigreg_num_slices: int = 256,
                 latent_consistency_loss_weight: float = 0.0, use_flash_attention: bool = False,
                 use_fused_small: bool | None = None, dtype=None, device=None, **not_ported):
        # the constructor's arguments, for checkpoints (train/checkpoint.py)
        config = {k: v for k, v in locals().items()
                  if k not in ('self', '__class__', 'device', 'not_ported')}
        super().__init__()
        self.config = {**config, **not_ported}
        check_not_ported(not_ported, _NOT_PORTED)
        if image_height % patch_size or image_width % patch_size:
            raise ValueError('image sides must be multiples of the patch size')
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
        self.latent_grad_only_at_noise = latent_grad_only_at_noise
        self.use_loss_normalization = use_loss_normalization
        self.loss_weights = dict(lpips=lpips_loss_weight, time_decorr=time_decorr_loss_weight,
                                 space_decorr=space_decorr_loss_weight,
                                 latent_ortho=latent_ortho_loss_weight,
                                 latent_sigreg=latent_sigreg_loss_weight)
        self.encoder_add_decorr_aux_loss = encoder_add_decorr_aux_loss
        self.decorr_sample_frac = decorr_sample_frac
        self.latent_sigreg_num_slices = latent_sigreg_num_slices
        self.latent_consistency_loss_weight = latent_consistency_loss_weight

        enc_channels = channels * (2 if encode_temporal_diff else 1)
        if use_shifted_patch_tokenization:
            self.patch_to_tokens = ShiftedPatchTokenization(
                dim, patch_size, channels=enc_channels, temporal_shift=spt_temporal_shift,
                device=device)
        else:
            self.patch_proj = Dense(enc_channels * patch_size ** 2, dim, device=device)
            self.patch_norm = LayerNorm(dim, device=device)
        self.mask_token = nn.Parameter(torch.empty(dim, device=device))
        self.latent_tokens = nn.Parameter(torch.empty(num_latent_tokens, dim, device=device))
        normal_(self.mask_token, 1e-2)
        normal_(self.latent_tokens, 1e-2)
        if use_causal_conv3d:
            self.encoder_pre_causal_conv3d = CausalDepthwiseConv3d(
                dim, causal_conv3d_kernel_size, device=device)
            self.encoder_post_causal_conv3d = CausalDepthwiseConv3d(
                dim, causal_conv3d_kernel_size, device=device)

        trunk = dict(dim=dim, attn_dim_head=attn_dim_head, attn_heads=attn_heads,
                     query_heads=query_heads, time_block_every=time_block_every,
                     use_flash_attention=use_flash_attention, use_fused_small=use_fused_small,
                     dtype=dtype, device=device)
        self.encoder_transformer = AxialSpaceTimeTransformer(
            **trunk, depth=encoder_depth, attn_softclamp_value=attn_softclamp_value,
            num_special_tokens=num_latent_tokens, full_spatial_attn=encoder_full_spatial_attn,
            final_norm=True)
        self.encoded_to_latents = Dense(dim, dim_latent, bias=False, device=device)
        self.latents_to_decoder = Dense(dim_latent, dim, bias=False, device=device)
        self.decoder = VideoDecoderNetwork(
            **trunk, depth=decoder_depth, patch_size=patch_size, channels=channels,
            num_latent_tokens=num_latent_tokens, full_spatial_attn=decoder_full_spatial_attn,
            pos_mlp_depth=pos_mlp_depth, use_causal_conv3d=use_causal_conv3d,
            causal_conv3d_kernel_size=causal_conv3d_kernel_size)

        if self.has_flow:
            self.time_embed = nn.Embedding(decoder_flow_steps, dim, device=device)
            embed_normal_(self.time_embed.weight)
            self.noised_patch_proj = Dense(channels * patch_size ** 2, dim, device=device)
            self.noised_patch_norm = LayerNorm(dim, device=device)
        # the counterpart's loss normalizers, in its order
        self.normalized_losses = []
        if use_loss_normalization:
            self.normalized_losses = ['recon'] + ['lpips'] * (lpips_loss_weight > 0.0) + (
                ['time_decorr', 'space_decorr'] * encoder_add_decorr_aux_loss) + [
                name for name in ('latent_ortho', 'latent_sigreg') if self.loss_weights[name] > 0.0]
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
    def latent_shape(self) -> tuple[int, int]:
        return (self.num_latent_tokens, self.dim_latent)

    # ------------------------------------------------------------- helpers

    def _patchify(self, video, noised: bool = False):
        """The plain patch projection: (b, t, h, w, c) -> (b, t, hp, wp,
        dim), of the clean video or (`noised`) of the decoder's noised one."""
        b, t, h, w, c = video.shape
        p = self.patch_size
        x = video.reshape(b, t, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, h // p, w // p, p * p * c)
        if noised:
            return self.noised_patch_norm(self.noised_patch_proj(x))
        return self.patch_norm(self.patch_proj(x))

    def _encoder_input(self, video, is_image: bool):
        if not self.encode_temporal_diff:
            return video
        if is_image:
            return torch.cat([video, torch.zeros_like(video)], dim=-1)
        diff = torch.nn.functional.pad(video[:, 1:] - video[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0))
        return torch.cat([video, diff], dim=-1)

    # -------------------------------------------------------------- encode

    def encode(self, video, mask_patches: bool = False, patch_mask=None,
               generator: torch.Generator | None = None, cache: TokenizerCache | None = None,
               max_time: int | None = None, return_cache: bool = False, **unported):
        """video (b, c, t, h, w) or (b, c, h, w) -> latents (b, t, n,
        d_latent) (or (b, n, d_latent) for an image), in [-1, 1]. With
        `mask_patches`, patches are replaced by the mask token at a random
        per-frame rate; `patch_mask` (b, t, hp, wp) masks given patches.

        Streaming: `return_cache=True` returns (latents, TokenizerCache),
        the four caches after these frames, the trunk's allocated for
        `max_time` frames when no `cache` is given; a later call with
        `cache=` encodes its newest frame against it (the trunk's cached
        path, on the plain attention). `max_time` counts only with
        `return_cache`. Aug conditioning and `return_pre_bottleneck` are
        not ported."""
        for name, value in unported.items():
            if value is not None and value is not False:
                raise NotImplementedError(f'encode({name}=...) is not ported to dreamer4_torch yet')
        latents, _, next_cache = self._encode(
            video, mask_patches=mask_patches, patch_mask=patch_mask, generator=generator,
            cache=cache, max_time=max_time if return_cache else None)
        if video.ndim == 4:
            latents = latents[:, 0]
        if return_cache:
            return latents, next_cache
        return latents

    def _encode(self, video, mask_patches: bool = False, patch_mask=None,
                generator: torch.Generator | None = None, cache: TokenizerCache | None = None,
                max_time: int | None = None, collect_normed_inputs: bool = False):
        """The encoder: video (b, c, t, h, w) or (b, c, h, w) -> (latents
        (b, t, n, d_latent), the encoder trunk's TransformerOutputs, the
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
        if mask_patches or patch_mask is not None:
            if patch_mask is None:
                lo, hi = self.per_image_patch_mask_prob
                mask_prob = draw('mask_prob', (b, t), generator=generator, device=video.device,
                                 low=lo, high=hi)
                patch_mask = draw('patch_mask', (b, t, hp, wp), generator=generator,
                                  device=video.device, prob=mask_prob[..., None, None])
            tokens = torch.where(patch_mask[..., None], self.mask_token, tokens)
        tokens = tokens.reshape(b, t, hp * wp, self.dim)

        latents = self.latent_tokens.expand(b, t, *self.latent_tokens.shape)
        tokens, interm = self.encoder_transformer(
            torch.cat([tokens, latents], dim=2), cache=trunk_cache, max_time=max_time,
            return_intermediates=True, collect_normed_inputs=collect_normed_inputs)
        if self.use_causal_conv3d:
            n_spatial = hp * wp
            spatial, next_post_conv_cache = self.encoder_post_causal_conv3d(
                tokens[:, :, :n_spatial].reshape(b, -1, hp, wp, self.dim),
                time_cache=post_conv_cache, return_time_cache=True)
            tokens = torch.cat([spatial.reshape(b, -1, n_spatial, self.dim),
                                tokens[:, :, n_spatial:]], dim=2)

        latents = torch.tanh(self.encoded_to_latents(tokens[:, :, -self.num_latent_tokens:]))
        next_cache = TokenizerCache(next_spt_cache, next_pre_conv_cache, interm.cache,
                                    next_post_conv_cache)
        return latents, interm, next_cache

    # -------------------------------------------------------------- decode

    def decode_step(self, latents, noised_video=None, time_indices=None,
                    height: int | None = None, width: int | None = None):
        """One pass of the decoder: latents (b, t, n, d_latent), the noised
        video (b, t, h, w, c) and the flow step of each batch row (b,) ->
        the predicted clean video (b, t, h, w, c)."""
        height = height if height is not None else self.image_height
        width = width if width is not None else self.image_width
        latent_tokens = self.latents_to_decoder(latents)
        if self.has_flow:
            if time_indices is None:
                time_indices = torch.zeros(latents.shape[0], dtype=torch.long,
                                           device=latents.device)
            latent_tokens = latent_tokens + self.time_embed(time_indices)[:, None, None, :]
        image_tokens = None
        if noised_video is not None:
            image_tokens = self._patchify(noised_video, noised=True)
        return self.decoder(latent_tokens, height, width, noised_image_tokens=image_tokens)

    def decode(self, latents, height: int | None = None, width: int | None = None,
               generator: torch.Generator | None = None, noise: torch.Tensor | None = None):
        """Euler flow sampling from noise: latents (b, t, n, d_latent) ->
        video (b, c, t, h, w). The starting noise (b, t, h, w, c) is drawn
        from `generator`, or given as `noise` by a caller that draws it."""
        height = height if height is not None else self.image_height
        width = width if width is not None else self.image_width
        b, t = latents.shape[:2]
        if not self.has_flow:
            return video_to_external(self.decode_step(latents, height=height, width=width))

        video = noise if noise is not None else draw(
            'noise', (b, t, height, width, self.channels), generator=generator,
            device=latents.device)
        steps = self.decoder_flow_steps
        delta = 1.0 / steps
        for i in range(steps):
            t_frac = i * delta
            time_indices = torch.full((b,), i, dtype=torch.long, device=latents.device)
            pred = self.decode_step(latents, noised_video=video, time_indices=time_indices,
                                    height=height, width=width)
            flow = (pred - video) / (1.0 - t_frac)
            video = video + flow * delta
        return video_to_external(video)

    # ------------------------------------------------------------ training

    def forward(self, video, return_latents: bool = False, mask_patches: bool | None = None,
                patch_mask=None, time_lens=None, lpips_fn: Callable | None = None,
                update_loss_ema: bool = True, return_intermediates: bool = False,
                is_training: bool = True, generator: torch.Generator | None = None,
                **unported):
        """The training forward: masked encode, one flow-noised decoder
        step, the reconstruction loss (in v-space by default) over the
        frames inside `time_lens`, and the loss terms the options turn on:
        `lpips_fn(recon, clean, generator, time_lens)` (the trainer's LPIPS),
        the decorrelation of the encoder trunk's normed attention inputs,
        the latents' orthogonality and sigreg; each normalized by its EMA
        under `use_loss_normalization`. Returns the total loss, and with
        `return_intermediates` also (TokenizerLosses, recon, latents) as
        `TokenizerIntermediates`. Draws in the counterpart's order: the
        patch mask, the sigreg slices, the flow steps and noise, the LPIPS
        frames, the decorrelation rows. Aug ids, BYOL targets and the
        flow-decoder switch are not ported."""
        for name, value in unported.items():
            if value is not None and value is not False:
                raise NotImplementedError(f'{name} is not ported to dreamer4_torch yet')
        if return_latents:
            return self.encode(video, generator=generator)
        if mask_patches is None:
            mask_patches = is_training

        is_image = video.ndim == 4
        if is_image:
            video = video[:, :, None]
        video_internal = video_to_internal(video)
        b, t, height, width, _ = video_internal.shape
        rnd = lambda kind, shape, **kw: draw(kind, shape, generator=generator,
                                             device=video.device, **kw)

        latents, interm, _ = self._encode(video, mask_patches=mask_patches,
                                          patch_mask=patch_mask, generator=generator,
                                          collect_normed_inputs=self.encoder_add_decorr_aux_loss)
        zero = torch.zeros((), device=video.device)
        w = self.loss_weights
        losses = dict.fromkeys(TokenizerLosses._fields, zero)
        if w['latent_sigreg'] > 0.0:
            losses['latent_sigreg'] = sigreg(latents[None], num_slices=self.latent_sigreg_num_slices,
                                             generator=generator)
        clean = video_internal[..., :self.channels]

        if self.has_flow:
            steps = self.decoder_flow_steps
            time_indices = rnd('time_indices', (b,), low=0, high=steps)
            noise = rnd('noise', (b, t, height, width, self.channels))
            t_frac = (time_indices.float() / steps)[:, None, None, None, None]
            noised_video = noise + (clean - noise) * t_frac
            dec_latents = latents
            if self.latent_grad_only_at_noise:
                frac = (time_indices == 0).float()[:, None, None, None]
                dec_latents = frac_gradient(latents, frac)
            recon_video = self.decode_step(dec_latents, noised_video=noised_video,
                                           time_indices=time_indices, height=height,
                                           width=width)
            if self.decoder_v_space_loss:
                target = clean - noise
                pred = (recon_video - noised_video) / (1.0 - t_frac)
            else:
                target, pred = clean, recon_video
        else:
            recon_video = self.decode_step(latents, height=height, width=width)
            target, pred = clean, recon_video

        recon_err = (pred - target).square()
        if time_lens is not None:
            losses['recon'] = masked_mean(recon_err,
                                          lens_to_mask(time_lens, t)[:, :, None, None, None])
        else:
            losses['recon'] = recon_err.mean()

        use_lpips = lpips_fn is not None and w['lpips'] > 0.0
        if use_lpips:
            losses['lpips'] = lpips_fn(recon_video, clean, generator, time_lens)
        if self.encoder_add_decorr_aux_loss:
            for kind, normed in (('time', interm.normed_time_inputs),
                                 ('space', interm.normed_space_inputs)):
                if normed is not None:
                    losses[f'{kind}_decorr'] = decorrelation_loss(
                        normed, self.decorr_sample_frac, generator=generator)
        if w['latent_ortho'] > 0.0:
            losses['latent_ortho'] = orthogonal_loss(latents)

        for name in self.normalized_losses:
            if name != 'lpips' or use_lpips:
                losses[name] = getattr(self, f'{name}_loss_normalizer')(
                    losses[name], update_ema=update_loss_ema)
        total = losses['recon'] + losses['flow_recon']
        for name, weight in w.items():
            total = total + losses[name] * weight

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
        return masked_mean(err, lens_to_mask(time_lens, latents.shape[1])[:, :, None, None])
    return err.mean()
