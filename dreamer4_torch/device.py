"""Device choice for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU by name. With no
card and no explicit `'cpu'` they raise: the port never falls back to the
CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'dreamer4_torch runs on CUDA by default and no CUDA device is '
                "available; pass device='cpu' to run on the CPU")
        return torch.device('cuda', torch.cuda.current_device())
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} requested but CUDA is not available')
    if device.type == 'cuda' and device.index is None:
        # 'cuda' names the current card, as the device of a tensor made there does
        device = torch.device('cuda', torch.cuda.current_device())
    return device
