"""VideoTokenizer, the causal space-time transformer autoencoder
(counterpart of `dreamer4_tpu/models/tokenizer.py`).

- Encoder: linear patchify -> LayerNorm -> per-frame MAE masking (a
  per-(b, t) mask probability ~ U(lo, hi), then a Bernoulli patch mask, or
  an explicit `patch_mask`) -> learned latent tokens appended on the right
  as the trunk's special tokens -> axial trunk -> linear bottleneck -> tanh.
- Decoder: spatial tokens from a 2-D coordinate MLP position embedding
  (plus the noised image's tokens on flow steps), packed with the latents,
  which attend only to themselves, then unpatchified.
- Flow decoding: x-prediction over `decoder_flow_steps`; `decode` runs the
  Euler steps, the training forward one flow-noised step with the loss in
  v-space, var-len `time_lens` masking and the EMA loss normalizer.

Only the trunks take `dtype`: the patch projections, the bottleneck, the
position MLP, `tokens_to_patch` and `time_embed` compute in float32 around
a bf16 trunk, as flax's layers without a dtype promote to their float32
parameters. The public video layout is (b, c, t, h, w), the internal one
(b, t, h, w, c). Every random draw goes through the module-level `draw`,
so a test can replay the counterpart's draws. The counterpart's fields
that the port does not have yet (`_NOT_PORTED`) are accepted at their
defaults and raise at any other value; LPIPS waits for VGG16 weights in the
repository.

`encode` also streams: frame by frame over the encoder trunk's KV cache
(`cache=`, `max_time=`, `return_cache=`), as an environment's frames
arrive. Its `TokenizerCache` carries the trunk's cache only; the
shifted-patch and causal-conv caches of the counterpart belong to options
the port does not have, and stay None.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from ..nn.dense import Dense
from ..nn.init import embed_normal_, normal_
from ..nn.loss_normalizer import LossNormalizer
from ..nn.mlp import MLP
from ..nn.norms import LayerNorm
from ..ops.utils import frac_gradient, lens_to_mask, masked_mean
from .transformer import AxialSpaceTimeTransformer, TransformerCache, check_not_ported


class TokenizerLosses(NamedTuple):
    """The counterpart's loss record; the losses of options not ported yet
    are zeros."""
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
    encoder trunk's KV cache, and the shifted-patch and causal-conv caches,
    None here (options not ported)."""
    spt: torch.Tensor | None
    pre_conv: torch.Tensor | None
    transformer: TransformerCache
    post_conv: torch.Tensor | None


# options of the counterpart, with their defaults, that the port does not
# have yet; any other value raises
_NOT_PORTED = dict(
    use_causal_conv3d=False, causal_conv3d_kernel_size=3, use_shifted_patch_tokenization=False,
    spt_temporal_shift=True, latent_init_patch_size=None, slot_attention_initted_latents=False,
    slot_attention_iters=2, encoder_slot_spatial_mix=True, slot_attention_inverted=True,
    decoder_slot_attention_initted_spatial_tokens=False, decoder_slot_attention_iters=2,
    decoder_slot_spatial_mix=False, separate_flow_decoder=False, flow_decoder_train_prob=0.5,
    decoder_flow_times_beta=(1.0, 1.0), has_aug_conditioning=False, aug_cfg_dropout_prob=0.1,
    has_byol=False, byol_loss_weight=1.0, byol_use_sem=False, byol_sem_simplex_dim=8,
    byol_sem_temperature=0.1, encoder_add_decorr_aux_loss=False, time_decorr_loss_weight=0.004,
    space_decorr_loss_weight=0.004, decorr_sample_frac=0.25, latent_ortho_loss_weight=0.0,
    latent_ar_loss_weight=0.0, latent_ar_sigreg_loss_weight=0.05, latent_ar_num_slices=256,
    latent_sigreg_loss_weight=0.0, latent_sigreg_num_slices=256,
    latent_consistency_loss_weight=0.0, time_attention_use_pope=False,
    space_attention_use_pope=False, encoder_moss_layers=(), decoder_moss_layers=(),
    use_time_rnn=False, h_net_layer=None, h_net_depth=2, h_net_compression_ratio=4,
    h_net_dynamic=False, h_net_loss_weight=1.0,
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
                 pos_mlp_activation: str = 'silu', use_flash_attention: bool = False,
                 use_fused_small: bool | None = None, dtype=None, device=None):
        super().__init__()
        self.dim, self.patch_size, self.channels = dim, patch_size, channels
        self.to_pos_emb = MLP(2, (dim * 2,) * pos_mlp_depth, dim,
                              activation=pos_mlp_activation, device=device)
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
        spatial = spatial.reshape(b, t, hp * wp, self.dim)

        tokens = torch.cat([spatial, latent_tokens], dim=2)
        tokens, _ = self.transformer(tokens)

        patches = self.tokens_to_patch(tokens[:, :, :hp * wp])    # (b, t, hp*wp, p*p*c)
        patches = patches.reshape(b, t, hp, wp, p, p, self.channels)
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
                 latent_grad_only_at_noise: bool = False, use_loss_normalization: bool = True,
                 lpips_loss_weight: float = 0.2, use_flash_attention: bool = False,
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
        self.latent_grad_only_at_noise = latent_grad_only_at_noise
        self.use_loss_normalization = use_loss_normalization

        enc_channels = channels * (2 if encode_temporal_diff else 1)
        self.patch_proj = Dense(enc_channels * patch_size ** 2, dim, device=device)
        self.patch_norm = LayerNorm(dim, device=device)
        self.mask_token = nn.Parameter(torch.empty(dim, device=device))
        self.latent_tokens = nn.Parameter(torch.empty(num_latent_tokens, dim, device=device))
        normal_(self.mask_token, 1e-2)
        normal_(self.latent_tokens, 1e-2)

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
            pos_mlp_depth=pos_mlp_depth)

        if self.has_flow:
            self.time_embed = nn.Embedding(decoder_flow_steps, dim, device=device)
            embed_normal_(self.time_embed.weight)
            self.noised_patch_proj = Dense(channels * patch_size ** 2, dim, device=device)
            self.noised_patch_norm = LayerNorm(dim, device=device)
        if use_loss_normalization:
            self.recon_loss_normalizer = LossNormalizer(device=device)

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
        """(b, t, h, w, c) -> (b, t, hp, wp, dim)."""
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
        the encoder trunk's KV cache holding these frames, allocated for
        `max_time` frames when no `cache` is given; a later call with
        `cache=` encodes its newest frame against it (the trunk's cached
        path, on the plain attention). `max_time` counts only with
        `return_cache`. Aug conditioning is not ported."""
        for name, value in unported.items():
            if value is not None and value is not False:
                raise NotImplementedError(f'encode({name}=...) is not ported to dreamer4_torch yet')
        is_image = video.ndim == 4
        if is_image:
            video = video[:, :, None]
        video = self._encoder_input(video_to_internal(video), is_image)
        b, t = video.shape[:2]

        tokens = self._patchify(video)
        hp, wp = tokens.shape[2], tokens.shape[3]
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
        tokens, trunk_cache = self.encoder_transformer(
            torch.cat([tokens, latents], dim=2),
            cache=cache.transformer if cache is not None else None,
            max_time=max_time if return_cache else None)

        latents = torch.tanh(self.encoded_to_latents(tokens[:, :, -self.num_latent_tokens:]))
        if is_image:
            latents = latents[:, 0]
        if return_cache:
            return latents, TokenizerCache(None, None, trunk_cache, None)
        return latents

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
                patch_mask=None, time_lens=None, update_loss_ema: bool = True,
                return_intermediates: bool = False, is_training: bool = True,
                generator: torch.Generator | None = None, **unported):
        """The training forward: masked encode, one flow-noised decoder
        step, the reconstruction loss (in v-space by default) over the
        frames inside `time_lens`, normalized by its EMA. Returns the total
        loss, and with `return_intermediates` also (TokenizerLosses, recon,
        latents) as `TokenizerIntermediates`. Aug ids, BYOL targets, an
        LPIPS function and the flow-decoder switch are not ported."""
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

        latents = self.encode(video, mask_patches=mask_patches, patch_mask=patch_mask,
                              generator=generator)
        zero = torch.zeros((), device=video.device)
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
            recon_loss = masked_mean(recon_err, lens_to_mask(time_lens, t)[:, :, None, None, None])
        else:
            recon_loss = recon_err.mean()
        if self.use_loss_normalization:
            recon_loss = self.recon_loss_normalizer(recon_loss, update_ema=update_loss_ema)

        if not return_intermediates:
            return recon_loss
        losses = TokenizerLosses(recon_loss, *([zero] * (len(TokenizerLosses._fields) - 1)))
        recon_out = recon_video[:, 0] if is_image else recon_video
        return recon_loss, TokenizerIntermediates(losses=losses, recon=recon_out, latents=latents)
