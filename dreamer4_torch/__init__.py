"""dreamer4_torch — the PyTorch / CUDA port of dreamer4_tpu for NVIDIA Hopper.

The JAX package `dreamer4_tpu` is the reference; this package mirrors its
layout (`ops/`, `nn/`, `models/`, `data/`) module for module, so each
counterpart is found under the same name. It imports torch only: never jax,
flax or anything of `dreamer4_tpu`.

Ported so far: the imagination rollout (`models.generate.generate`) of
`DynamicsWorldModel`, its training (`train.trainers.BehaviorCloneTrainer`,
over latents or over video through a tokenizer), and the video tokenizer
(`models.tokenizer.VideoTokenizer`: encode, flow decode, the training
forward) with `train.trainers.TokenizerTrainer`. The flash-attention
forward and backward (`csrc/flash_attn_fwd.cu`, `csrc/flash_attn_bwd_dq.cu`,
`csrc/flash_attn_bwd_dkv.cu`) and the small-attention forward and backward
(`csrc/small_attn_fwd.cu`, `csrc/small_attn_bwd.cu`, behind
`use_fused_small`) are hand-written CUDA kernels. Entry points run on CUDA
unless the caller passes `device='cpu'`.
"""

__version__ = '0.1.0'

from .data.experience import Experience
from .models.generate import generate
from .models.tokenizer import VideoTokenizer
from .models.transformer import AxialSpaceTimeTransformer
from .models.world_model import DynamicsWorldModel
from .train.trainers import BehaviorCloneTrainer, TokenizerTrainer

__all__ = [
    'AxialSpaceTimeTransformer',
    'BehaviorCloneTrainer',
    'DynamicsWorldModel',
    'Experience',
    'TokenizerTrainer',
    'VideoTokenizer',
    'generate',
]
