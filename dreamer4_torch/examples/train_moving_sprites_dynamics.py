"""Moving-sprites action-conditioned dynamics training (counterpart of
`examples/train_moving_sprites_dynamics.py`; reference
`train_moving_mnist_dynamics.py`): behavior-clone the world model on
velocity-conditioned sprite trajectories, then sample velocity-controlled
generations on a 3x3 grid of actions.

Streams (JAX -> here): the initial weights, `PRNGKey(seed)` -> the global
generator seeded with `--seed` inside `common.seeded_init`; the trainer's
key chain -> `BehaviorCloneTrainer(seed=--seed)`; a sample at step s,
`generate` from `PRNGKey(s)` and `decode` from `PRNGKey(1)` -> generators
seeded with s and 1. The jitted tokenize is a plain `encode` under
`torch.no_grad()`.

Usage: python -m dreamer4_torch.examples.train_moving_sprites_dynamics --data ./data/moving_sprites
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..data.datasets import VideoTrajectoryDataset, batch_iterator
from ..data.video_io import save_gif, video_grid
from ..device import resolve_device
from ..models.generate import generate
from ..models.tokenizer import VideoTokenizer
from ..models.world_model import DynamicsWorldModel
from ..train.checkpoint import load_model, save_model
from ..train.trainers import BehaviorCloneTrainer
from .common import seeded_init


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--data', type=str, default='./data/moving_sprites')
    p.add_argument('--tokenizer-checkpoint', type=str, default='./checkpoints/sprites_tokenizer')
    p.add_argument('--output', type=str, default='./checkpoints/sprites_dynamics')
    p.add_argument('--num-steps', type=int, default=20_000)
    p.add_argument('--batch-size', type=int, default=8)
    p.add_argument('--num-frames', type=int, default=8)
    p.add_argument('--dim', type=int, default=128)
    p.add_argument('--depth', type=int, default=4)
    p.add_argument('--log-every', type=int, default=100)
    p.add_argument('--sample-every', type=int, default=5000)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', type=str, default=None,
                   help='torch device (default: the CUDA card; "cpu" runs on the CPU)')
    return p.parse_args(argv)


def build_model(args, tokenizer: VideoTokenizer, device, **overrides) -> DynamicsWorldModel:
    """The recipe's world model (examples/train_moving_sprites_dynamics.py:
    48-62), its weights from `args.seed`."""
    kwargs = dict(
        dim=args.dim,
        dim_latent=tokenizer.dim_latent,
        num_latent_tokens=tokenizer.num_latent_tokens,
        num_spatial_tokens=tokenizer.num_latent_tokens,
        max_steps=16,
        depth=args.depth,
        time_block_every=2,
        attn_heads=4,
        attn_dim_head=32,
        num_discrete_actions=(9,),  # 3x3 velocity grid
        multi_token_pred_len=4,
        predict_terminals=False,
    )
    with seeded_init(args.seed, device):
        return DynamicsWorldModel(**{**kwargs, **overrides}, device=device)


def sample(args, model, tokenizer, step: int, device) -> Path:
    """One dream per velocity id from sticky prompt actions, decoded into a
    3 x 3 grid GIF beside `--output`."""
    actions = torch.arange(9, device=device)[:, None, None]  # (9, t=1, na=1)
    with torch.no_grad():
        exp = generate(model, torch.Generator(device=device).manual_seed(step),
                       time_steps=args.num_frames, num_steps=4, batch_size=9,
                       prompt_discrete_actions=actions.expand(9, args.num_frames - 1, 1))
        video = tokenizer.decode(exp.latents,
                                 generator=torch.Generator(device=device).manual_seed(1))
    path = Path(args.output).parent / f'sample_{step}.gif'
    save_gif(path, video_grid(video.float().cpu().numpy(), columns=3))
    return path


def train(args, device) -> BehaviorCloneTrainer:
    """`--num-steps` steps with a sample every `--sample-every`, then the
    weights saved to `--output`."""
    tokenizer = load_model(args.tokenizer_checkpoint, VideoTokenizer, device=device)
    ds = VideoTrajectoryDataset(args.data, num_frames=args.num_frames, seed=args.seed)
    it = batch_iterator(ds, args.batch_size, rng=np.random.default_rng(args.seed))
    model = build_model(args, tokenizer, device)

    def prep(batch):
        video = torch.as_tensor(batch['video'], dtype=torch.float32, device=device)
        with torch.no_grad():
            out = dict(latents=tokenizer.encode(video),
                       lens=torch.as_tensor(batch['lens'], dtype=torch.long, device=device))
        if 'actions' in batch:
            out['discrete_actions'] = torch.as_tensor(batch['actions'], dtype=torch.long,
                                                      device=device)[..., None]
        return out

    prep(next(it))   # the JAX recipe's init batch
    trainer = BehaviorCloneTrainer(model, tokenizer=tokenizer, seed=args.seed, device=device)

    t0 = time.time()
    for step in range(args.num_steps):
        loss, _ = trainer.train_on_batch(prep(next(it)))
        if step % args.log_every == 0:
            print(f'step {step}: loss {float(loss):.4f} [{time.time()-t0:.0f}s]', flush=True)
        if step > 0 and step % args.sample_every == 0:
            sample(args, model, tokenizer, step, device)

    save_model(args.output, model)
    print(f'saved to {args.output}')
    return trainer


def main(argv=None):
    args = parse_args(argv)
    train(args, resolve_device(args.device))
    return 0


if __name__ == '__main__':
    sys.exit(main())
