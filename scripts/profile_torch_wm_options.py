"""Where the time of the options world model's train step goes, on one CUDA card.

    python3 scripts/profile_torch_wm_options.py

Builds chip_smoke.py's wm-options model (the bench world model with every
world-model option: tasks and latent genes, actor and critic trunks, the
pre-encoders, the aug token, LAPO, TEM, the latent AR loss; float32 master
weights, bf16 compute) and, for the attribution, the same model without the
critic trunk, without TEM, and the bench model without any option. For each
it prints the wall time of the parts of a plain b1 x T1024 step (forward,
backward, optimizer, EMA; mean of 3 after a warm step), and for the options
model one step under torch.profiler: the device's busy time and idle share,
the port's kernels, and the CUDA kernels and host ops that take the most
time (`scripts/profile_torch_train.py`'s report).
Imports torch, numpy and the port only.
"""
from __future__ import annotations

import gc
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import (BENCH_MODEL, TRAIN, WMOPT_MODEL, gpu_name_and_power_limit,  # noqa: E402
                        wmopt_batch)
from dreamer4_torch import BehaviorCloneTrainer, DynamicsWorldModel  # noqa: E402
from dreamer4_torch.train.trainers import make_world_model_train_step  # noqa: E402
from profile_torch_train import part_times_ms, profile_step  # noqa: E402

VARIANTS = {'options': WMOPT_MODEL,
            'options without the critic trunk': dict(WMOPT_MODEL, critic_depth=0),
            'options without TEM': dict(WMOPT_MODEL, ssl_tem=False),
            'bench, no option': BENCH_MODEL}


def main() -> int:
    if not torch.cuda.is_available():
        print('profile_torch_wm_options: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(gpu_name_and_power_limit(), flush=True)
    label = f'b{TRAIN["batch_size"]} x T{TRAIN["time_steps"]}'
    for name, cfg in VARIANTS.items():
        torch.manual_seed(0)
        model = DynamicsWorldModel(**cfg, dtype=torch.bfloat16)
        trainer = BehaviorCloneTrainer(model, learning_rate=3e-4, clip_grad_norm=1.0,
                                       with_ema=True, seed=0)
        step_fn = make_world_model_train_step(model, trainer.optimizer, ema_decay=0.999)
        batch = wmopt_batch(model.device, 2)
        if not cfg.get('num_tasks'):
            batch.pop('tasks')

        def step():
            trainer.ts = step_fn(trainer.ts, batch, shortcut_train=False,
                                 generator=trainer.generator)[0]
        step()
        parts = part_times_ms(lambda: model(**batch, shortcut_train=False,
                                            generator=trainer.generator), trainer)
        print(f'{name}: plain step {label}: '
              + ', '.join(f'{k} {v:.1f} ms' for k, v in parts.items())
              + f' (sum {sum(parts.values()):.1f} ms; wall, mean of 3)', flush=True)
        if name == 'options':
            profile_step(step, f'{name}: plain step {label}')
        del model, trainer, step_fn, batch
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
