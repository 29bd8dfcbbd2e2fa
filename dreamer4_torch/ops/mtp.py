"""Multi-token-prediction targets (counterpart of `dreamer4_tpu/ops/mtp.py`):
for each position t gather the next `steps_future` targets t .. t+K-1, with
a validity mask for positions past the sequence end.
"""
from __future__ import annotations

import torch


def create_multi_token_prediction_targets(t: torch.Tensor, steps_future: int):
    """t: (b, seq, ...) -> targets (b, seq, steps, ...), mask (b, seq, steps)."""
    batch, seq_len = t.shape[:2]
    seq = torch.arange(seq_len, device=t.device)
    steps = torch.arange(steps_future, device=t.device)
    indices = seq[:, None] + steps[None, :]                # (seq, steps)
    mask = indices < seq_len
    out = t[:, torch.where(mask, indices, 0)]             # (b, seq, steps, ...)
    return out, mask[None].expand(batch, seq_len, steps_future)
