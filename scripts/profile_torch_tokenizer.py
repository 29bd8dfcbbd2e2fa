"""Where the time of the tokenizer's train step, and of the world model's
b8 x T32 step on the small-attention path, goes on one CUDA card.

    python3 scripts/profile_torch_tokenizer.py

Builds the bench tokenizer as chip_smoke.py's tokenizer phase does (dim 512,
64 x 64, patch 8, 16 latents, depth 4 + 4, float32 master weights, bf16
compute, `use_fused_small`) with a `TokenizerTrainer` and b8 x T16 video,
then the bench world model with `use_fused_small` at b8 x T32 with a
`BehaviorCloneTrainer`. For each, with the small-attention kernels K4/K5
and with the plain attention (every attention's `use_fused_small` off),
it prints, under torch.profiler, one whole step after a warm one: wall
time, device busy time and idle share, the CUDA kernels launched, each port
kernel's launches and device time, each span's host, device and idle time (the
step's parts and the attention calls by path), and the leading CUDA kernels
and host ops (`scripts/profile_torch_train.py`'s report). Imports torch,
numpy, the port and the benchmark's span reduction only.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import (BENCH_MODEL, BENCH_TOKENIZER, TOK_VIDEO, WM_FUSED,  # noqa: E402
                        gpu_name_and_power_limit, set_attention)
from dreamer4_torch import (BehaviorCloneTrainer, DynamicsWorldModel,  # noqa: E402
                            TokenizerTrainer, VideoTokenizer)
from dreamer4_torch.train.trainers import make_world_model_train_step  # noqa: E402
from profile_torch_train import profile_step  # noqa: E402


def run(model, step, label):
    for fused in (True, False):
        set_attention(model, 'Attention', 'use_fused_small', fused)
        step()
        profile_step(step, f'{label}, {"K4/K5" if fused else "plain attention"}')


def main() -> int:
    if not torch.cuda.is_available():
        print('profile_torch_tokenizer: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(gpu_name_and_power_limit(), flush=True)

    torch.manual_seed(0)
    tok = VideoTokenizer(**BENCH_TOKENIZER, dtype=torch.bfloat16)
    trainer = TokenizerTrainer(tok, learning_rate=3e-4, clip_grad_norm=1.0, seed=0)
    b, t = TOK_VIDEO['batch_size'], TOK_VIDEO['time_steps']
    video = torch.rand((b, 3, t, 64, 64), generator=torch.Generator(device='cuda').manual_seed(1),
                       device='cuda')
    run(tok, lambda: trainer.train_on_batch(video), f'tokenizer train step b{b} x T{t}')
    del tok, trainer, video

    model = DynamicsWorldModel(**BENCH_MODEL, use_fused_small=True, dtype=torch.bfloat16)
    trainer = BehaviorCloneTrainer(model, learning_rate=3e-4, clip_grad_norm=1.0, seed=0)
    b, t = WM_FUSED['batch_size'], WM_FUSED['time_steps']
    g = torch.Generator(device='cuda').manual_seed(2)
    batch = dict(latents=torch.randn((b, t, 16, 32), generator=g, device='cuda') * 0.5,
                 rewards=torch.zeros((b, t), device='cuda'),
                 discrete_actions=torch.zeros((b, t, 1), dtype=torch.long, device='cuda'))
    step_fn = make_world_model_train_step(model, trainer.optimizer, ema_decay=0.999)

    def step():
        trainer.ts = step_fn(trainer.ts, batch, shortcut_train=False,
                             generator=trainer.generator)[0]
    run(model, step, f'world model plain step b{b} x T{t}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
