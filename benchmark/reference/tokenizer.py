"""The video tokenizer's training loss plainly.

Encoder: the frames cut into p x p patches, each projected and LayerNormed;
masked patches replaced by the mask token; the learned latent tokens appended
as the trunk's special tokens; the trunk's latent outputs mapped to the latent
width through tanh. Decoder: the latents mapped back to the model width plus
the flow step's embedding, beside spatial tokens made of a coordinate MLP's
position embedding plus the projected, LayerNormed patches of the noised
video; a trunk in which the latents attend only to each other; each spatial
token mapped back to its patch. The loss is the squared error in velocity
space, divided by the root of the EMA of its square taken before this step
folds it in (the state starts at 1 and moves by 5% a step).
"""
from __future__ import annotations

import torch

from .ops import Precision, layernorm, linear, silu_mlp
from .trunk import Trunk


class Tokenizer:
    def __init__(self, P: dict, cfg: dict, prec: Precision):
        self.P, self.prec = P, prec
        k = cfg['kwargs']
        self.dim, self.patch = k['dim'], k['patch_size']
        self.height, self.width = k['image_height'], k['image_width']
        self.n_latent = k['num_latent_tokens']
        self.flow_steps = k.get('decoder_flow_steps', 1)
        common = dict(heads=k.get('attn_heads', 8), time_every=k['time_block_every'],
                      num_special=self.n_latent, final_norm=True, prec=prec)
        self.encoder = Trunk(P, 'encoder_transformer.', depth=k['encoder_depth'], **common)
        self.decoder = Trunk(P, 'decoder.transformer.', depth=k['decoder_depth'],
                             special_only_itself=True, **common)

    def patchify(self, x):
        """(b, t, h, w, c) -> (b, t, hp, wp, p*p*c)."""
        b, t, h, w, c = x.shape
        p = self.patch
        x = x.reshape(b, t, h // p, p, w // p, p, c).permute(0, 1, 2, 4, 3, 5, 6)
        return x.reshape(b, t, h // p, w // p, p * p * c)

    def loss(self, video, draws: dict, norm_state: torch.Tensor):
        """video (b, c, t, h, w) in [0, 1]; draws: 'patch_mask' (b, t, hp,
        wp) bool, 'time_indices' (b,), 'noise' (b, t, h, w, c); norm_state
        the loss normalizer's EMA of the squared loss. -> (total loss, the
        next state)."""
        P, prec = self.P, self.prec
        clean = video.permute(0, 2, 3, 4, 1)
        b, t, h, w, c = clean.shape
        d, p = self.dim, self.patch
        hp, wp = h // p, w // p

        tok = layernorm(linear(prec, self.patchify(clean), P['patch_proj.weight'],
                               P['patch_proj.bias']), P['patch_norm.scale'])
        tok = torch.where(draws['patch_mask'][..., None], P['mask_token'], tok)
        tokens = torch.cat([tok.reshape(b, t, hp * wp, d),
                            P['latent_tokens'].expand(b, t, self.n_latent, d)], dim=2)
        hidden = self.encoder(tokens)[:, :, -self.n_latent:]
        latents = torch.tanh(linear(prec, hidden, P['encoded_to_latents.weight']))

        steps = draws['time_indices']
        frac = (steps.float() / self.flow_steps)[:, None, None, None, None]
        noise = draws['noise']
        noised = noise + (clean - noise) * frac
        lat_tok = linear(prec, latents, P['latents_to_decoder.weight'])
        lat_tok = lat_tok + P['time_embed.weight'][steps][:, None, None, :]
        ys = torch.linspace(-1.0, 1.0, hp, device=video.device)
        xs = torch.linspace(-1.0, 1.0, wp, device=video.device)
        coords = torch.stack(torch.meshgrid(ys, xs, indexing='ij'), dim=-1)
        pos = silu_mlp(prec, P, 'decoder.to_pos_emb.', coords, 3, rmsnorm_in=False)
        img = layernorm(linear(prec, self.patchify(noised), P['noised_patch_proj.weight'],
                               P['noised_patch_proj.bias']), P['noised_patch_norm.scale'])
        spatial = (pos + img).reshape(b, t, hp * wp, d)
        out = self.decoder(torch.cat([spatial, lat_tok], dim=2))[:, :, :hp * wp]
        patches = linear(prec, out, P['decoder.tokens_to_patch.weight'],
                         P['decoder.tokens_to_patch.bias'])
        recon = patches.reshape(b, t, hp, wp, p, p, c).permute(0, 1, 2, 4, 3, 5, 6)
        recon = recon.reshape(b, t, h, w, c)

        loss = (((recon - noised) / (1.0 - frac) - (clean - noise)).square()).mean()
        next_state = norm_state + 0.05 * (loss.detach().square() - norm_state)
        return loss / norm_state.sqrt().clamp_min(1e-6), next_state
