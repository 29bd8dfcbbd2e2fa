"""dreamer4_torch — the PyTorch / CUDA port of dreamer4_tpu for NVIDIA Hopper.

The JAX package `dreamer4_tpu` is the reference; this package mirrors its
layout (`ops/`, `nn/`, `models/`, `data/`) module for module, so each
counterpart is found under the same name. It imports torch only: never jax,
flax or anything of `dreamer4_tpu`.

Ported so far: the imagination rollout (`models.generate.generate`) of
`DynamicsWorldModel`, its training (`train.trainers.BehaviorCloneTrainer`,
over latents or over video through a tokenizer), and the video tokenizer
(`models.tokenizer.VideoTokenizer`: encode, flow decode, the training
forward) with `train.trainers.TokenizerTrainer`, and RL in imagination:
`models.rl.rl_losses` (PPO, PMPO, SPO; heads-only or full-model) with
`train.trainers.DreamTrainer`, and RL against an environment: the actor
loop `envs.interact.EnvInteractor` (`interact_with_env` for one rollout)
over state-vector observations (`state_to_latents`, a critic state) or
pixels (the tokenizer's streaming, cached `encode`), and
`train.trainers.SimTrainer` (rollouts, interleaved dynamics training, RL
epochs), and the data plane, the CLI and serving: the memmapped
`data.replay_buffer.ReplayBuffer`, the video datasets, the native prefetch
library (`native/prefetch.cpp`), Snake and the record wrappers,
`envs.world_model_env.DynamicsWorldModelWrapper`, the HTTP servers
(`serve.server`) and `python -m dreamer4_torch.cli` with its four commands,
and FIRE and latent-gene evolution (`ops.fire`), and parallelism
(`parallel`): the process group and its (data, model) mesh over
`torch.distributed` (NCCL on cards, gloo on the CPU), data-parallel
training in every trainer (`mesh=`), weights sharded over `model` as
DTensors, and ring attention over time (`time_ring_axis`). The port now
covers every module of the JAX package, and `examples` holds the
counterparts of the ten recipes in `examples/` (`python -m
dreamer4_torch.examples.<name>`). The flash-attention
forward and backward (`csrc/flash_attn_fwd.cu`, `csrc/flash_attn_bwd_dq.cu`,
`csrc/flash_attn_bwd_dkv.cu`) and the small-attention forward and backward
(`csrc/small_attn_fwd.cu`, `csrc/small_attn_bwd.cu`, behind
`use_fused_small`) are hand-written CUDA kernels. Entry points run on CUDA
unless the caller passes `device='cpu'`.
"""

__version__ = '0.1.0'

from .data.experience import Experience, combine_experiences
from .data.replay_buffer import ReplayBuffer
from .envs.interact import EnvInteractor, interact_with_env
from .envs.world_model_env import DynamicsWorldModelWrapper
from .models.generate import generate
from .models.tokenizer import VideoTokenizer
from .models.transformer import AxialSpaceTimeTransformer
from .models.world_model import DynamicsWorldModel
from .models.rl import ReturnStats, rl_losses
from .train.trainers import BehaviorCloneTrainer, DreamTrainer, SimTrainer, TokenizerTrainer

__all__ = [
    'AxialSpaceTimeTransformer',
    'BehaviorCloneTrainer',
    'DreamTrainer',
    'DynamicsWorldModel',
    'DynamicsWorldModelWrapper',
    'EnvInteractor',
    'Experience',
    'ReplayBuffer',
    'ReturnStats',
    'SimTrainer',
    'TokenizerTrainer',
    'VideoTokenizer',
    'combine_experiences',
    'generate',
    'interact_with_env',
    'rl_losses',
]
