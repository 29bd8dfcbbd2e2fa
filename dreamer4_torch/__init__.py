"""dreamer4_torch — the PyTorch / CUDA port of dreamer4_tpu for NVIDIA Hopper.

The JAX package `dreamer4_tpu` is the reference; this package mirrors its
layout (`ops/`, `nn/`, `models/`, `data/`) module for module, so each
counterpart is found under the same name. It imports torch only: never jax,
flax or anything of `dreamer4_tpu`.

Ported so far: the imagination rollout (`models.generate.generate`) of
`DynamicsWorldModel` and its training (`train.trainers.BehaviorCloneTrainer`
over latents), with the flash-attention forward and backward as hand-written
CUDA kernels (`csrc/flash_attn_fwd.cu`, `csrc/flash_attn_bwd_dq.cu`,
`csrc/flash_attn_bwd_dkv.cu`). Entry points run on CUDA unless the caller
passes `device='cpu'`.
"""

__version__ = '0.1.0'

from .data.experience import Experience
from .models.generate import generate
from .models.transformer import AxialSpaceTimeTransformer
from .models.world_model import DynamicsWorldModel
from .train.trainers import BehaviorCloneTrainer

__all__ = [
    'AxialSpaceTimeTransformer',
    'BehaviorCloneTrainer',
    'DynamicsWorldModel',
    'Experience',
    'generate',
]
