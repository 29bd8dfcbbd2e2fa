"""Self-supervised auxiliary modules (counterpart of `dreamer4_tpu/nn/ssl.py`):
`LAPO` (latent actions from inverse dynamics, with forward-dynamics losses),
`TEM` (path integration of actions into structural codes that read the
latents back through an implicit attention memory) and `ActorSPR`
(self-predictive rollout of the policy embedding).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..ops.attention import naive_attend
from ..ops.losses import sigreg
from ..ops.masks import causal_mask
from ..ops.utils import l2norm, smooth_l1_loss
from ..parallel.distributed import batch_mean
from .dense import Dense
from .gru import GRUCell
from .init import normal_
from .mlp import MLP
from .norms import RMSNorm
from .sem import SEM


def _detach_tree(x):
    """Detach every tensor of a nest of tuples (an unembedding's output)."""
    if isinstance(x, (tuple, list)):
        return type(x)(_detach_tree(v) for v in x)
    return x.detach() if isinstance(x, torch.Tensor) else x


class LAPO(nn.Module):
    """Latent action pretraining over the mean-pooled spatial tokens: an
    inverse-dynamics MLP maps (state, next state) through a SEM bottleneck
    to a latent action, which (with `pred_actions`) reads out the actions
    taken (cross-entropy per discrete type, squared error of the
    continuous ones, averaged over the types given), and (with `use_fdm`)
    predicts the next state from the state, in the normed projected space
    and, given the raw latents' shape, in the raw latent space; both
    targets carry no gradient. -> (action_loss, fdm_loss,
    raw_latent_fdm_loss)."""

    def __init__(self, dim_embed: int, dim_latent_action: int,
                 num_discrete_actions: tuple[int, ...] = (), num_continuous_actions: int = 0,
                 dim_raw_latent: int | None = None, num_raw_latent_tokens: int | None = None,
                 pred_actions: bool = True, use_fdm: bool = True, device=None):
        super().__init__()
        self.num_discrete_actions = tuple(num_discrete_actions)
        self.num_continuous_actions = num_continuous_actions
        self.pred_actions, self.use_fdm = pred_actions, use_fdm
        self.has_raw_latent_fdm = (use_fdm and dim_raw_latent is not None
                                   and num_raw_latent_tokens is not None)
        d, da = dim_embed, dim_latent_action
        hidden = 4 * d
        self.state_norm = RMSNorm(d, device=device)
        self.state_norm_next = RMSNorm(d, device=device)
        self.to_latent_action = MLP(2 * d, (hidden,), da, device=device)
        self.sem = SEM(da, temperature=0.1, dim_simplex=4, device=device)
        if pred_actions:
            for i, n in enumerate(self.num_discrete_actions):
                if n > 0:
                    setattr(self, f'action_readout_d{i}', Dense(da, n, device=device))
            if num_continuous_actions > 0:
                self.action_readout_c = Dense(da, num_continuous_actions, device=device)
        if use_fdm:
            self.to_pred_next_state = MLP(d + da, (hidden,), d, device=device)
        if self.has_raw_latent_fdm:
            self.to_pred_raw_latent = MLP(d + da, (hidden, hidden),
                                          dim_raw_latent * num_raw_latent_tokens, device=device)

    def forward(self, space_tokens, discrete_actions=None, continuous_actions=None,
                raw_latents=None):
        """space_tokens (b, t, s, d); discrete_actions (b, t', na) ints;
        continuous_actions (b, t', nc); raw_latents (b, t, n, dl)."""
        zero = torch.zeros((), device=space_tokens.device)
        state_embed = space_tokens.mean(dim=2)
        state = self.state_norm(state_embed[:, :-1])
        next_state = self.state_norm_next(state_embed[:, 1:])
        latent_action = self.sem(self.to_latent_action(torch.cat([state, next_state], dim=-1)))
        seq = latent_action.shape[1]

        action_loss = zero
        if self.pred_actions:
            terms = []
            if discrete_actions is not None:
                for i, n in enumerate(self.num_discrete_actions):
                    if n <= 0:
                        continue
                    logp = torch.log_softmax(getattr(self, f'action_readout_d{i}')(latent_action),
                                             dim=-1)
                    tgt = discrete_actions[:, :seq, i].long()
                    terms.append(batch_mean(-logp.gather(-1, tgt[..., None])))
            if self.num_continuous_actions > 0 and continuous_actions is not None:
                pred_c = self.action_readout_c(latent_action)
                terms.append(batch_mean((pred_c - continuous_actions[:, :seq]).square()))
            if terms:
                action_loss = sum(terms) / len(terms)

        fdm_loss = raw_fdm_loss = zero
        fdm_in = torch.cat([state, latent_action], dim=-1)
        if self.use_fdm:
            pred_next = self.to_pred_next_state(fdm_in)
            fdm_loss = batch_mean((l2norm(pred_next) - l2norm(next_state).detach()).square())
        if self.has_raw_latent_fdm and raw_latents is not None:
            b, t = raw_latents.shape[:2]
            target = raw_latents.reshape(b, t, -1)[:, 1:]
            raw_fdm_loss = batch_mean((self.to_pred_raw_latent(fdm_in) - target.detach()).square())
        return action_loss, fdm_loss, raw_fdm_loss


class TEM(nn.Module):
    """Tolman-Eichenbaum-style structure learning: a GRU integrates the
    action embeddings from an initial hidden state (read from the first
    frame's encoded latents, or learned) into structural codes; two causal
    attentions over keys and values shifted one step behind dummy first
    entries (so no position sees itself) read the encoded latents back,
    with talking heads and a SiLU between them and per-head sigmoid gates
    after; a decoder predicts each frame's raw latents, held by a squared
    error from the second frame on against targets without gradient. The
    attentions are plain attention. -> the loss, and with `return_preds`
    the predicted latents (b, t, n, dl)."""

    def __init__(self, dim_action_embed: int, dim_raw_latent: int, num_raw_latent_tokens: int,
                 heads: int = 8, dim_head: int = 64, first_state_as_init_hidden: bool = True,
                 learn_relative_actions: bool = False, device=None):
        super().__init__()
        # the structural codes are as wide as the action embeddings
        ds = da = dim_action_embed
        self.heads, self.dim_head = heads, dim_head
        self.dim_raw_latent, self.num_raw_latent_tokens = dim_raw_latent, num_raw_latent_tokens
        self.first_state_as_init_hidden = first_state_as_init_hidden
        self.learn_relative_actions = learn_relative_actions
        inner = heads * dim_head

        def param(shape, std):
            p = nn.Parameter(torch.empty(shape, device=device))
            normal_(p, std)
            return p

        self.sensory_encoder = MLP(dim_raw_latent, (ds,), ds, device=device)
        if first_state_as_init_hidden:
            self.to_init_hiddens = MLP(ds, (ds,), ds, device=device)
        else:
            self.init_hiddens = param((ds,), 1e-2)
        if learn_relative_actions:
            self.learned_relative_encode = MLP(2 * da, (2 * da,), da, device=device)
        self.GRUCell_0 = GRUCell(da, ds, device=device)
        self.structural_norm = RMSNorm(ds, device=device)
        self.sensory_norm = RMSNorm(ds, device=device)
        for name in ('to_q', 'to_k1', 'to_v1', 'to_k2', 'to_v2'):
            setattr(self, name, Dense(ds, inner, bias=False, device=device))
        for name in ('k1', 'v1', 'k2', 'v2'):
            setattr(self, f'dummy_{name}', param((inner,), 1e-2))
        self.talking_heads = nn.Parameter(torch.eye(heads, device=device))
        self.to_gates = Dense(ds, heads, bias=False, device=device)
        self.to_out = Dense(inner, ds, bias=False, device=device)
        self.sensory_decoder = MLP(ds, (ds,), dim_raw_latent * num_raw_latent_tokens,
                                   device=device)

    def forward(self, next_action_tokens, raw_latents, return_preds: bool = False):
        """next_action_tokens (b, t', d) or (b, t', 1, d); raw_latents
        (b, t, n, dl)."""
        b, t = raw_latents.shape[:2]
        pooled = raw_latents.reshape(b, t, -1, raw_latents.shape[-1]).mean(dim=2)
        encoded_sensory = self.sensory_encoder(pooled)
        if self.first_state_as_init_hidden:
            init_hidden = self.to_init_hiddens(encoded_sensory[:, 0])
        else:
            init_hidden = self.init_hiddens.expand(b, -1)

        actions = next_action_tokens
        if actions.ndim == 4:
            actions = actions[:, :, 0]
        actions = actions[:, :t - 1].to(init_hidden.dtype)
        if actions.shape[1] > 0:
            if self.learn_relative_actions:
                past = nn.functional.pad(actions[:, :-1], (0, 0, 1, 0))
                actions = self.learned_relative_encode(torch.cat([actions, past], dim=-1))
            gru_out = self.GRUCell_0.scan(init_hidden, actions)
            structural = torch.cat([init_hidden[:, None], gru_out], dim=1)
        else:
            structural = init_hidden[:, None]
        structural = self.structural_norm(structural)
        encoded_sensory = self.sensory_norm(encoded_sensory)

        h, dh = self.heads, self.dim_head
        split = lambda x: x.reshape(b, -1, h, dh).transpose(1, 2)

        def shift(x, name):
            dummy = getattr(self, f'dummy_{name}').expand(b, 1, -1)
            return split(torch.cat([dummy.to(x.dtype), x[:, :-1]], dim=1))

        q = split(self.to_q(structural))
        k1, v1 = shift(self.to_k1(structural), 'k1'), shift(self.to_v1(encoded_sensory), 'v1')
        k2, v2 = shift(self.to_k2(encoded_sensory), 'k2'), shift(self.to_v2(encoded_sensory), 'v2')
        mask = causal_mask(q.shape[2], k1.shape[2], device=q.device)
        out = naive_attend(q, k1, v1, mask=mask)
        out = torch.einsum('bhtd,hg->bgtd', out, self.talking_heads.to(out.dtype))
        out = naive_attend(nn.functional.silu(out), k2, v2, mask=mask)
        gates = torch.sigmoid(self.to_gates(structural))                 # (b, n, h)
        out = out * gates.transpose(1, 2)[..., None]
        out = self.to_out(out.transpose(1, 2).reshape(b, -1, h * dh))
        pred_raw = self.sensory_decoder(out)

        loss = torch.zeros((), device=raw_latents.device)
        if t > 1:
            target = raw_latents.reshape(b, t, -1)[:, 1:]
            loss = batch_mean((pred_raw[:, 1:] - target.detach()).square())
        if not return_preds:
            return loss
        return loss, pred_raw.reshape(b, t, self.num_raw_latent_tokens, self.dim_raw_latent)


class ActorSPR(nn.Module):
    """Self-predictive rollout of the policy embedding: an MLP dynamics
    model rolls the (normed) embedding `num_rollouts` steps forward under
    the actions taken, each step held by a smooth-L1 loss against the
    embedding that many steps later, and by the KL between the policies the
    frozen unembedding reads from the two. The action embedder enters as
    the injected `unembed_fn` / `kl_fn`, so the module holds none of its
    parameters.

    `dim` is the policy embedding's width (dim * 4 in the world model),
    `dim_action_embed` the action embedding's (the world model's dim). A
    nonzero `sigreg_loss_weight` adds `sigreg` over the normed embeddings
    inside `mask` (256 slices, drawn through `ops.losses.draw` from
    `generator`); the world model builds the module with 0."""

    def __init__(self, dim: int, num_rollouts: int = 1, spr_loss_weight: float = 1.0,
                 kl_loss_weight: float = 1.0, sigreg_loss_weight: float = 0.0,
                 dynamics_num_layers: int = 3, dim_action_embed: int | None = None,
                 device=None):
        super().__init__()
        self.num_rollouts = num_rollouts
        self.spr_loss_weight = spr_loss_weight
        self.kl_loss_weight = kl_loss_weight
        self.sigreg_loss_weight = sigreg_loss_weight
        da = dim_action_embed if dim_action_embed is not None else dim
        self.norm = RMSNorm(dim, device=device)
        self.dynamics_mlp = MLP(dim + da, (dim,) * dynamics_num_layers, dim, use_rmsnorm=True,
                                device=device)

    def forward(self, policy_embed, action_embeds, unembed_fn: Callable | None = None,
                kl_fn: Callable | None = None, mask=None,
                generator: torch.Generator | None = None):
        """policy_embed: (b, t, dim); action_embeds: (b, t, da), the action
        taken at each position; mask: (b, t) bool, the positions that count
        as targets. unembed_fn(embeds) -> (discrete logits, continuous
        params); kl_fn(src, tgt) -> (discrete KL, continuous KL).
        -> (total, (spr, kl, sigreg))."""
        zero = torch.zeros((), device=policy_embed.device)
        b, seq = policy_embed.shape[:2]
        R = self.num_rollouts
        if seq <= R:
            raise ValueError(f'ActorSPR needs more than num_rollouts={R} time steps, got {seq}')
        policy_embed = self.norm(policy_embed)
        if mask is None:
            mask = torch.ones((b, seq), dtype=torch.bool, device=policy_embed.device)

        # the K-step rollout: step k from position i takes the action taken
        # at i + k (zero past the end)
        actions = action_embeds.detach()
        preds, pred = [], policy_embed[:, :-1]
        for step in range(R):
            a = nn.functional.pad(actions[:, step:], (0, 0, 0, step))[:, :seq - 1]
            pred = pred + self.dynamics_mlp(torch.cat([pred, a.to(pred.dtype)], dim=-1))
            preds.append(pred)
        preds = torch.stack(preds)                                   # (R, b, seq-1, dim)

        # targets: the embedding step + 1 positions later, padded with zeros
        # that the padded mask leaves out
        targets = torch.stack([nn.functional.pad(policy_embed[:, 1 + k:], (0, 0, 0, k))
                               for k in range(R)])
        target_masks = torch.stack([nn.functional.pad(mask[:, 1 + k:], (0, k))
                                    for k in range(R)])
        weight = 1.0 / R

        spr_loss = zero
        if self.spr_loss_weight > 0.0:
            l1 = smooth_l1_loss(preds, targets.detach()) * weight
            spr_loss = batch_mean(l1, target_masks[..., None], dim=(1, 2, 3)).sum()

        kl_loss = zero
        if self.kl_loss_weight > 0.0 and unembed_fn is not None and kl_fn is not None:
            target_unembeds = _detach_tree(unembed_fn(targets.detach()))
            d_kl, c_kl = kl_fn(target_unembeds, unembed_fn(preds))
            step_kl = sum(kl for kl in (d_kl, c_kl) if kl is not None) * weight
            kl_loss = batch_mean(step_kl, target_masks, dim=(1, 2)).sum()

        sigreg_loss = zero
        if self.sigreg_loss_weight > 0.0:
            sigreg_loss = sigreg(policy_embed[None], mask=mask[None], num_slices=256,
                                 generator=generator, mean=batch_mean)

        total = (spr_loss * self.spr_loss_weight + kl_loss * self.kl_loss_weight
                 + sigreg_loss * self.sigreg_loss_weight)
        return total, (spr_loss, kl_loss, sigreg_loss)
