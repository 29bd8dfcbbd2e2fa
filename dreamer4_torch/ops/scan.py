"""Generalized advantage estimation as a log-depth scan (counterpart of
`dreamer4_tpu/ops/scan.py`).

The counterpart is `jax.lax.associative_scan`, which XLA lowers. Here the
first-order linear recurrence h_t = gate_t * h_{t-1} + value_t (or h_{t+1}
in reverse) is a doubling scan: after step k each element holds the
composition of the 2^k elements that end at it, so ceil(log2 T) steps of a
few elementwise ops over the whole tensor solve it (8 steps at T = 192),
with no loop over time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def linear_recurrence_scan(gates: torch.Tensor, values: torch.Tensor, reverse: bool = False,
                           dim: int = -1) -> torch.Tensor:
    """Solve h_t = gate_t * h_{t-1 (or t+1 if reverse)} + values_t, with
    h = 0 before the first element, along `dim`."""
    a = gates.movedim(dim, -1)
    b = values.movedim(dim, -1)
    n = a.shape[-1]
    # the element d steps back (forward) or ahead (reverse); past the edge
    # it is the identity (gate 1, value 0)
    pad = (0, 1) if reverse else (1, 0)
    d = 1
    while d < n:
        if reverse:
            a_prev, b_prev = a[..., d:], b[..., d:]
        else:
            a_prev, b_prev = a[..., :n - d], b[..., :n - d]
        a_prev = F.pad(a_prev, (pad[0] * d, pad[1] * d), value=1.0)
        b_prev = F.pad(b_prev, (pad[0] * d, pad[1] * d), value=0.0)
        a, b = a * a_prev, b + a * b_prev
        d *= 2
    return b.movedim(-1, dim)


def calc_gae(rewards: torch.Tensor,                   # (b, t)
             values: torch.Tensor,                    # (b, t)
             masks: torch.Tensor | None = None,       # (b, t) continuation
             learn_masks: torch.Tensor | None = None,  # (b, t) zero delta outside
             gamma: float = 0.99, lam: float = 0.95) -> torch.Tensor:
    """Returns `returns = gae + values`; no gradient flows to the rewards or
    the values."""
    rewards = rewards.detach()
    values = values.detach()
    if masks is None:
        masks = torch.ones_like(values)
    masks = masks.to(values.dtype)
    values_next = F.pad(values[..., 1:], (0, 1))
    delta = rewards + gamma * values_next * masks - values
    if learn_masks is not None:
        delta = torch.where(learn_masks, delta, 0.0)
    gae = linear_recurrence_scan(gamma * lam * masks, delta, reverse=True, dim=-1)
    return gae + values
