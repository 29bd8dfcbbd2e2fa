"""Tiny configurations of the benchmark's models for the CPU tests: the
configuration files with their widths cut, float32 and the kernels off."""
from __future__ import annotations

import torch

from benchmark import harness

WM = dict(dim=64, depth=4, attn_heads=2, attn_dim_head=32, num_latent_tokens=4,
          num_spatial_tokens=4, dim_latent=8, num_register_tokens=2, use_flash_attention=False,
          multi_token_pred_len=3)
TOK = dict(dim=64, dim_latent=8, patch_size=4, image_height=16, image_width=16,
           num_latent_tokens=4, attn_heads=2, attn_dim_head=32, use_fused_small=False)


def tiny_config(name: str, cuts: dict) -> dict:
    cfg = harness.config_file(name)
    cfg['kwargs'].update(cuts)
    cfg['dtype'] = 'float32'
    return cfg


def tiny_workload(cell: str) -> dict:
    wl = harness.workload_file(cell)
    wl.update({'wm_train_long': dict(batch=2, frames=6), 'wm_train_short': dict(batch=4, frames=3),
               'tok_train': dict(batch=4, frames=4),
               'wm_imagine': dict(batch=6, prompt_frames=3, time_steps=7, check_rows=4)}[cell],
              trace_calls=2)
    return wl


def tiny_cell_config(cell: str) -> dict:
    return (tiny_config('dreamer4-tok-512', TOK) if cell == 'tok_train'
            else tiny_config('dreamer4-wm-512', WM))


def weights_of(kind: str, seed: int) -> dict:
    if kind == 'wm':
        from dreamer4_torch.models.world_model import DynamicsWorldModel
        model = DynamicsWorldModel(**tiny_config('dreamer4-wm-512', WM)['kwargs'], device='cpu')
    else:
        from dreamer4_torch.models.tokenizer import VideoTokenizer
        model = VideoTokenizer(**tiny_config('dreamer4-tok-512', TOK)['kwargs'], device='cpu')
    return harness.make_weights(model.named_parameters(), seed, torch.device('cpu'))


def tiny_world_model():
    return tiny_config('dreamer4-wm-512', WM), weights_of('wm', 0)


def tiny_tokenizer():
    return tiny_config('dreamer4-tok-512', TOK), weights_of('tok', 0)
