"""Attention mask builders (counterpart of `dreamer4_tpu/ops/masks.py`).

Dense boolean tensors, True = may attend. On the flash path the same
predicates are evaluated inside the kernel instead. Static configurations
give a constant mask, built on the requested device.
"""
from __future__ import annotations

import torch


def causal_mask(q_len: int, k_len: int, block_size: int = 1, offset: int = 0,
                device=None) -> torch.Tensor:
    """Block-causal mask; query i sits at absolute position offset + i."""
    q_pos = torch.div(torch.arange(q_len, device=device) + offset, block_size,
                      rounding_mode='floor')
    k_pos = torch.div(torch.arange(k_len, device=device), block_size, rounding_mode='floor')
    return q_pos[:, None] >= k_pos[None, :]


def special_token_mask(q_len: int, k_len: int, seq_len: int, num_special: int,
                       special_attend_only_itself: bool = False, device=None) -> torch.Tensor:
    """Special tokens sit on the right of each `seq_len` block. Default:
    modality tokens cannot attend to special tokens; with
    `special_attend_only_itself` special tokens attend only among
    themselves."""
    q_pos = torch.arange(q_len, device=device) % seq_len
    k_pos = torch.arange(k_len, device=device) % seq_len
    special_start = seq_len - num_special
    q_sp = q_pos >= special_start
    k_sp = k_pos >= special_start
    if special_attend_only_itself:
        return ~(q_sp[:, None] & ~k_sp[None, :])
    return ~(~q_sp[:, None] & k_sp[None, :])


def build_attend_mask(q_len: int, k_len: int, causal: bool = False, causal_block_size: int = 1,
                      causal_offset: int = 0, num_special: int = 0,
                      block_size_per_special: int | None = None,
                      special_attend_only_itself: bool = False, device=None):
    """Compose causal and special-token masks; None when unmasked."""
    mask = None
    if causal:
        mask = causal_mask(q_len, k_len, block_size=causal_block_size, offset=causal_offset,
                           device=device)
    if num_special > 0:
        seq_len = block_size_per_special if block_size_per_special is not None else k_len
        sp = special_token_mask(q_len, k_len, seq_len, num_special,
                                special_attend_only_itself, device=device)
        mask = sp if mask is None else (mask & sp)
    return mask
