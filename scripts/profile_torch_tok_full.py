"""Where the time of the all-options tokenizer's train step goes, on one CUDA card.

    python3 scripts/profile_torch_tok_full.py

Builds chip_smoke.py's tok-full tokenizer (the bench tokenizer with the
latent init patch, slot attention in the encoder and the decoder, the
separate flow decoder, the aug token, BYOL through SEM, the latent AR loss,
time and space PoPE and MOSS; float32 master weights, bf16 trunks) and, for
the attribution, the same tokenizer without each group of options in turn,
and the bench tokenizer without any. For each it prints the wall ms of a
main-decoder `TokenizerTrainer` step at b8 x T16 (the step function, the
EMA teacher's encode included; mean of 5 after a warm step), and then, as
the profiler can leave a cost on every later launch of the process, one
step of the all-options tokenizer under torch.profiler: the device's busy
time and idle share, the port's kernels, and the CUDA kernels and host ops
that take the most time (`scripts/profile_torch_train.py`'s report).
Imports torch, numpy and the port only.
"""
from __future__ import annotations

import gc
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import (BENCH_TOKENIZER, TOK_FULL, TOK_VIDEO,  # noqa: E402
                        gpu_name_and_power_limit)
from dreamer4_torch import TokenizerTrainer, VideoTokenizer  # noqa: E402
from dreamer4_torch.train.trainers import make_tokenizer_train_step  # noqa: E402
from profile_torch_train import profile_step  # noqa: E402

OFF = {'slot attention and the latent init': dict(
           latent_init_patch_size=None, slot_attention_initted_latents=False,
           decoder_slot_attention_initted_spatial_tokens=False),
       'BYOL (and its EMA teacher encode)': dict(has_byol=False, byol_use_sem=False),
       'the latent AR loss': dict(latent_ar_loss_weight=0.0),
       'PoPE': dict(time_attention_use_pope=False, space_attention_use_pope=False),
       'MOSS': dict(encoder_moss_layers=(), decoder_moss_layers=()),
       'the aug token': dict(has_aug_conditioning=False),
       'the separate flow decoder': dict(separate_flow_decoder=False)}
VARIANTS = {'all options': TOK_FULL,
            **{f'without {name}': dict(TOK_FULL, **off) for name, off in OFF.items()},
            'bench, no option': BENCH_TOKENIZER}


def main() -> int:
    if not torch.cuda.is_available():
        print('profile_torch_tok_full: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(gpu_name_and_power_limit(), flush=True)
    b, t = TOK_VIDEO['batch_size'], TOK_VIDEO['time_steps']
    video = torch.rand((b, 3, t, 64, 64), generator=torch.Generator(device='cuda').manual_seed(1),
                       device='cuda')
    for name, cfg in [*VARIANTS.items(), ('all options', TOK_FULL)]:
        torch.manual_seed(0)
        tok = VideoTokenizer(**cfg, dtype=torch.bfloat16)
        trainer = TokenizerTrainer(tok, learning_rate=3e-4, clip_grad_norm=1.0, with_ema=True,
                                   seed=0)
        step_fn = make_tokenizer_train_step(tok, trainer.optimizer, ema_decay=0.999)

        def step():
            trainer.ts = step_fn(trainer.ts, video, generator=trainer.generator)[0]
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 5
        print(f'{name}: main-decoder step b{b} x T{t}: {ms:.1f} ms (wall, mean of 5 after a '
              f'warm step)', flush=True)
        del tok, trainer, step_fn
        gc.collect()
        torch.cuda.empty_cache()
    torch.manual_seed(0)
    tok = VideoTokenizer(**TOK_FULL, dtype=torch.bfloat16)
    trainer = TokenizerTrainer(tok, learning_rate=3e-4, clip_grad_norm=1.0, with_ema=True, seed=0)
    step_fn = make_tokenizer_train_step(tok, trainer.optimizer, ema_decay=0.999)

    def step():
        trainer.ts = step_fn(trainer.ts, video, generator=trainer.generator)[0]
    step()
    profile_step(step, f'all options: main-decoder step b{b} x T{t}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
