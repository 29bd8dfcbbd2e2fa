"""Latent autoregressive loss with signature regularization (counterpart of
`dreamer4_tpu/nn/latent_ar.py`): an MLP predicts each next time step's
latent from the current one, held by a smooth-L1 or cosine loss, plus
`sigreg` on the targets. Its sigreg draws go through `ops.losses.draw`."""
from __future__ import annotations

import torch
from torch import nn

from ..ops.losses import sigreg
from ..ops.utils import l2norm, masked_mean, smooth_l1_loss
from .dense import Dense
from .mlp import MLP
from .norms import RMSNorm


class LatentAutoregressiveLoss(nn.Module):
    """x (b, t, ..., d) predicts x (or `target`, another layer's hidden of
    the same shape) one step later.

    `dim_in` is the width of the predictor's input: x's, or x's and the
    condition's together when `conditioned` (the world model's next action
    tokens). A `project_in` Dense to `dim` precedes the MLP when that width
    differs from `dim` or a condition comes in, as in the counterpart.
    With `sigreg_num_subspaces` k > 1 the targets are projected on k fixed
    orthogonal sub-spaces (`subspace_projs`, no gradient) for sigreg."""

    def __init__(self, dim: int, dim_in: int | None = None, use_rmsnorm: bool = False,
                 loss_type: str = 'smooth_l1', detach_target: bool = True,
                 predict_residual: bool = False, sigreg_num_slices: int = 256,
                 sigreg_num_subspaces: int | None = None, conditioned: bool = False,
                 device=None):
        super().__init__()
        if loss_type not in ('smooth_l1', 'cosine'):
            raise ValueError(loss_type)
        dim_in = dim_in if dim_in is not None else dim
        self.loss_type, self.detach_target = loss_type, detach_target
        self.predict_residual = predict_residual
        self.sigreg_num_slices = sigreg_num_slices
        self.conditioned = conditioned
        self.project_in = (Dense(dim_in, dim, device=device)
                           if dim_in != dim or conditioned else None)
        self.norm = RMSNorm(dim, device=device) if use_rmsnorm else None
        self.net = MLP(dim, (dim * 4,), dim, use_rmsnorm=True, device=device)
        self.subspace_projs = None
        k = sigreg_num_subspaces
        if k is not None and k > 1:
            # sigreg reads the targets, of the prediction's width
            if dim % k != 0:
                raise ValueError(f'dim {dim} must be a multiple of {k} sub-spaces')
            projs = torch.empty((k, dim // k, dim), device=device)
            for p in projs:
                nn.init.orthogonal_(p)
            self.subspace_projs = nn.Parameter(projs)

    def forward(self, x, target=None, mask=None, cond=None,
                generator: torch.Generator | None = None):
        """x (b, t, ..., d); target like x or None (x itself); mask (b, t)
        bool; cond (b, t, ..., dc) with `conditioned`. -> (loss,
        sigreg_loss, pred)."""
        if (cond is not None) != self.conditioned:
            raise ValueError('pass cond exactly when the module is conditioned')
        is_same_layer = target is None
        if target is None:
            target = x
        latents_input, target_output = x[:, :-1], target[:, 1:]
        h = latents_input
        if cond is not None:
            h = torch.cat([h, cond[:, :-1].to(h.dtype)], dim=-1)
        if self.project_in is not None:
            h = self.project_in(h)
        if self.norm is not None:
            h = self.norm(h)
        pred = self.net(h)
        if self.predict_residual:
            pred = pred + latents_input

        target_loss = target_output.detach() if self.detach_target else target_output
        if self.loss_type == 'smooth_l1':
            losses = smooth_l1_loss(pred, target_loss)
        else:
            losses = (l2norm(pred) - l2norm(target_loss)).square()

        loss_mask = mask[:, 1:] if mask is not None else None
        if loss_mask is not None:
            bmask = loss_mask.reshape(*loss_mask.shape, *(1,) * (losses.ndim - loss_mask.ndim))
            loss = masked_mean(losses, bmask)
        else:
            loss = losses.mean()

        # sigreg on the targets (and, across layers, on the inputs too)
        if is_same_layer:
            sig_input, sig_mask = target_output, loss_mask
        else:
            sig_input = torch.cat([x[:, :-1], target_output], dim=0)
            sig_mask = torch.cat([loss_mask, loss_mask]) if loss_mask is not None else None
        if self.subspace_projs is not None:
            k = self.subspace_projs.shape[0]
            sig_input = torch.einsum('...d,ksd->k...s', sig_input,
                                     self.subspace_projs.detach().to(sig_input.dtype))
            if sig_mask is not None:
                sig_mask = sig_mask[None].expand(k, *sig_mask.shape)
        else:
            sig_input = sig_input[None]
            if sig_mask is not None:
                sig_mask = sig_mask[None]
        if sig_mask is not None:
            extra = sig_input.ndim - 1 - sig_mask.ndim
            sig_mask = sig_mask.reshape(*sig_mask.shape, *(1,) * extra)
            sig_mask = sig_mask.expand(sig_input.shape[:-1])
        sig_loss = sigreg(sig_input, num_slices=self.sigreg_num_slices, mask=sig_mask,
                          generator=generator)
        return loss, sig_loss, pred
