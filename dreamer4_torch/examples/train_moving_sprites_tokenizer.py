"""Moving-sprites tokenizer training (counterpart of
`examples/train_moving_sprites_tokenizer.py`; reference
`train_moving_mnist_tokenizer.py`).

Streams (JAX -> here): the initial weights, `PRNGKey(seed)` -> the global
generator seeded with `--seed` inside `common.seeded_init`; the trainer's
key chain -> `TokenizerTrainer(seed=--seed)`'s generator; the dataset's
and the batches' numpy generators as in the JAX recipe. As there, the first
batch is drawn for the init and not trained on, so both take the same
batches from one seed.

Usage:
  python -m dreamer4_torch.examples.dataset_moving_sprites ./data/moving_sprites
  python -m dreamer4_torch.examples.train_moving_sprites_tokenizer --data ./data/moving_sprites
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..data.datasets import VideoTrajectoryDataset, batch_iterator
from ..device import resolve_device
from ..models.tokenizer import VideoTokenizer
from ..train.checkpoint import save_model
from ..train.trainers import TokenizerTrainer
from .common import seeded_init


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--data', type=str, default='./data/moving_sprites')
    p.add_argument('--output', type=str, default='./checkpoints/sprites_tokenizer')
    p.add_argument('--num-steps', type=int, default=20_000)
    p.add_argument('--batch-size', type=int, default=8)
    p.add_argument('--num-frames', type=int, default=8)
    p.add_argument('--dim', type=int, default=128)
    p.add_argument('--log-every', type=int, default=100)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', type=str, default=None,
                   help='torch device (default: the CUDA card; "cpu" runs on the CPU)')
    return p.parse_args(argv)


def build_model(args, device, **overrides) -> VideoTokenizer:
    """The recipe's tokenizer (examples/train_moving_sprites_tokenizer.py:
    42-46), its weights from `args.seed`."""
    kwargs = dict(
        dim=args.dim, dim_latent=16, patch_size=8,
        image_height=32, image_width=32, channels=1,
        num_latent_tokens=8, encoder_depth=2, decoder_depth=2, time_block_every=2,
        attn_dim_head=32, attn_heads=4)
    with seeded_init(args.seed, device):
        return VideoTokenizer(**{**kwargs, **overrides}, device=device)


def train(args, device) -> TokenizerTrainer:
    """`--num-steps` steps, then the weights saved to `--output`."""
    ds = VideoTrajectoryDataset(args.data, num_frames=args.num_frames, seed=args.seed)
    it = batch_iterator(ds, args.batch_size, rng=np.random.default_rng(args.seed))
    model = build_model(args, device)
    next(it)   # the JAX recipe's init batch
    trainer = TokenizerTrainer(model, seed=args.seed, device=device)

    t0 = time.time()
    for step in range(args.num_steps):
        batch = next(it)
        loss, _ = trainer.train_on_batch(
            torch.as_tensor(batch['video'], dtype=torch.float32, device=device),
            time_lens=torch.as_tensor(batch['lens'], dtype=torch.long, device=device))
        if step % args.log_every == 0:
            print(f'step {step}: loss {float(loss):.4f} [{time.time()-t0:.0f}s]', flush=True)

    save_model(args.output, model)
    print(f'saved to {args.output}')
    return trainer


def main(argv=None):
    args = parse_args(argv)
    train(args, resolve_device(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
