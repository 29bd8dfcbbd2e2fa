"""Command-line interface (counterpart of `dreamer4_tpu/cli.py`).

The same four commands with the same flags and defaults, on argparse:

  python -m dreamer4_torch.cli train-video-tokenizer --dataset <folder|buffer> ...
  python -m dreamer4_torch.cli train-dynamics --tokenizer-checkpoint <dir> ...
  python -m dreamer4_torch.cli serve-world-model --checkpoint <dir> ...
  python -m dreamer4_torch.cli inspect-replay-buffer --buffer <dir>

Each command also takes `--device` (default: the CUDA card; `--device cpu`
runs on the CPU). Seeds build `torch.Generator`s where the counterpart
builds PRNG keys, and models are saved and loaded through the port's
`train/checkpoint.py` (the counterpart's orbax checkpoints are not read).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from .data.datasets import (VideoDataset, VideoDatasetFromReplayBuffer,
                            VideoTrajectoryDataset, batch_iterator, prefetch_batches,
                            randomly_apply_aug)
from .data.replay_buffer import ReplayBuffer
from .device import resolve_device
from .envs.snake import SnakeEnv
from .envs.world_model_env import DynamicsWorldModelWrapper
from .models.generate import generate
from .models.tokenizer import VideoTokenizer
from .models.world_model import DynamicsWorldModel
from .serve.server import InspectReplayBufferServer, WebEnvServer
from .train.checkpoint import load_model
from .train.logging import MetricLogger
from .train.trainers import BehaviorCloneTrainer, TokenizerTrainer


def _add_device_arg(p):
    p.add_argument('--device', type=str, default=None,
                   help='torch device (default: the CUDA card; "cpu" runs on the CPU)')


def _add_tokenizer_model_args(p):
    p.add_argument('--dim', type=int, default=512)
    p.add_argument('--dim-latent', type=int, default=32)
    p.add_argument('--patch-size', type=int, default=8)
    p.add_argument('--image-size', type=int, default=64)
    p.add_argument('--num-latent-tokens', type=int, default=16)
    p.add_argument('--encoder-depth', type=int, default=4)
    p.add_argument('--decoder-depth', type=int, default=4)
    p.add_argument('--time-block-every', type=int, default=4)
    p.add_argument('--channels', type=int, default=3)


def _build_tokenizer(args, device):
    return VideoTokenizer(
        dim=args.dim,
        dim_latent=args.dim_latent,
        patch_size=args.patch_size,
        image_height=args.image_size,
        image_width=args.image_size,
        channels=args.channels,
        num_latent_tokens=args.num_latent_tokens,
        encoder_depth=args.encoder_depth,
        decoder_depth=args.decoder_depth,
        time_block_every=args.time_block_every,
        device=device,
    )


def _resolve_video_dataset(spec: str, image_size, num_frames, seed: int,
                           with_trajectories: bool = False):
    """Dataset resolution (reference `cli.py:65-96`): `spec` is a replay
    buffer directory (contains buffer_meta.json), a folder of .gif/.npy
    videos (with optional `<stem>.<key>.npy` trajectory sidecars), or a glob
    pattern."""
    path = Path(spec)
    if path.is_dir() and (path / 'buffer_meta.json').exists():
        buf = ReplayBuffer.open(path)
        return VideoDatasetFromReplayBuffer(buf, num_frames=num_frames, seed=seed)
    cls = VideoTrajectoryDataset if with_trajectories else VideoDataset
    return cls(spec, image_size=image_size, num_frames=num_frames, seed=seed)


def _batch_video(batch, device):
    """collated 'video' is already (b, c, t, h, w) float in [0, 1]."""
    return torch.as_tensor(np.asarray(batch['video'], np.float32), device=device)


def _resolve_model_checkpoint(path: str, prefer_ema: bool = True) -> Path:
    """Resolve a checkpoint dir that may be a trainer output dir with a
    floating `latest` and optional `ema/` subcheckpoint (reference EMA
    checkpoint resolution, `cli.py:207-211`)."""
    p = Path(path)
    if (p / 'latest').exists():
        p = (p / 'latest').resolve()
    if prefer_ema and (p / 'ema' / 'config.json').exists():
        p = p / 'ema'
    return p


def cmd_train_video_tokenizer(argv):
    p = argparse.ArgumentParser(prog='train-video-tokenizer')
    p.add_argument('--dataset', '--replay-buffer', dest='dataset', type=str,
                   required=True,
                   help='replay-buffer dir | folder of gif/npy videos | glob')
    p.add_argument('--output', type=str, default='./checkpoints/tokenizer')
    p.add_argument('--num-steps', type=int, default=100_000)
    p.add_argument('--batch-size', type=int, default=8)
    p.add_argument('--grad-accum', type=int, default=8,
                   help='micro-batches per optimizer step (reference default)')
    p.add_argument('--seq-len', type=int, default=8)
    p.add_argument('--learning-rate', type=float, default=3e-4)
    p.add_argument('--checkpoint-every', type=int, default=1000)
    p.add_argument('--log-every', type=int, default=50)
    p.add_argument('--sample-every', type=int, default=1000,
                   help='write original|recon sample gifs every N steps')
    p.add_argument('--aug-prob', type=float, default=0.0,
                   help='pixel-shift augmentation probability')
    p.add_argument('--no-resume', action='store_true')
    p.add_argument('--seed', type=int, default=0)
    _add_tokenizer_model_args(p)
    _add_device_arg(p)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    dataset = _resolve_video_dataset(args.dataset, (args.image_size, args.image_size),
                                     args.seq_len, args.seed)
    batches = prefetch_batches(batch_iterator(dataset, args.batch_size,
                                              rng=np.random.default_rng(args.seed)))
    torch.manual_seed(args.seed)
    model = _build_tokenizer(args, device)
    logger = MetricLogger(Path(args.output) / 'logs')

    # the counterpart's init reads the first batch for its shapes; it is
    # drawn here too, so both take the same batches from one seed
    next(batches)
    trainer = TokenizerTrainer(model, learning_rate=args.learning_rate,
                               grad_accum=args.grad_accum, seed=args.seed, device=device)

    start_step = 0
    if not args.no_resume and (Path(args.output) / 'latest').exists():
        trainer.restore(args.output)
        start_step = int(trainer.ts.step)
        print(f'resumed from {args.output} at step {start_step}', flush=True)

    aug_rng = np.random.default_rng(args.seed + 23)

    @torch.no_grad()
    def reconstruct(video):
        latents = model.encode(video)
        return model.decode(latents, generator=torch.Generator(device=device).manual_seed(1))

    step = start_step
    while step < args.num_steps:
        for _ in range(args.grad_accum):
            batch = next(batches)
            video = np.asarray(batch['video'], np.float32)
            if args.aug_prob > 0.0:
                video, _aug_id = randomly_apply_aug(aug_rng, video, prob=args.aug_prob)
            loss, _ = trainer.train_on_batch(
                torch.as_tensor(video, device=device),
                time_lens=torch.as_tensor(np.asarray(batch['lens']), device=device))
        step = int(trainer.ts.step)
        if step % args.log_every == 0:
            logger.log(step, loss=float(loss))
            print(f'step {step}: loss {float(loss):.4f}', flush=True)
        if step % args.sample_every == 0:
            clean = _batch_video(batch, device)[:4]
            recon = reconstruct(clean).float().clamp(0, 1)
            side = torch.cat([clean, recon], dim=-1)   # widthwise original|recon
            logger.log_video(step, 'recon', side.cpu().numpy())
        if step % args.checkpoint_every == 0:
            trainer.save_checkpoint(args.output)
    trainer.save_checkpoint(args.output)
    logger.close()
    print(f'saved tokenizer to {args.output}')


def cmd_train_dynamics(argv):
    p = argparse.ArgumentParser(prog='train-dynamics')
    p.add_argument('--dataset', '--replay-buffer', dest='dataset', type=str,
                   required=True,
                   help='replay-buffer dir | folder of videos+sidecars | glob')
    p.add_argument('--tokenizer-checkpoint', type=str, required=True)
    p.add_argument('--output', type=str, default='./checkpoints/dynamics')
    p.add_argument('--num-steps', type=int, default=100_000)
    p.add_argument('--batch-size', type=int, default=8)
    p.add_argument('--grad-accum', type=int, default=1)
    p.add_argument('--seq-len', type=int, default=8)
    p.add_argument('--dim', type=int, default=512)
    p.add_argument('--depth', type=int, default=8)
    p.add_argument('--num-spatial-tokens', type=int, default=16)
    p.add_argument('--num-discrete-actions', type=int, default=0)
    p.add_argument('--num-continuous-actions', type=int, default=0)
    p.add_argument('--learning-rate', type=float, default=3e-4)
    p.add_argument('--checkpoint-every', type=int, default=1000)
    p.add_argument('--log-every', type=int, default=50)
    p.add_argument('--sample-every', type=int, default=0,
                   help='write prompted-dream gifs every N steps (0 = off)')
    p.add_argument('--no-resume', action='store_true')
    p.add_argument('--seed', type=int, default=0)
    _add_device_arg(p)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    tokenizer = load_model(_resolve_model_checkpoint(args.tokenizer_checkpoint),
                           VideoTokenizer, device=device)
    dataset = _resolve_video_dataset(
        args.dataset, (tokenizer.image_height, tokenizer.image_width),
        args.seq_len, args.seed, with_trajectories=True)
    batches = prefetch_batches(batch_iterator(dataset, args.batch_size,
                                              rng=np.random.default_rng(args.seed)))
    logger = MetricLogger(Path(args.output) / 'logs')

    torch.manual_seed(args.seed)
    model = DynamicsWorldModel(
        dim=args.dim,
        dim_latent=tokenizer.dim_latent,
        num_latent_tokens=tokenizer.num_latent_tokens,
        num_spatial_tokens=args.num_spatial_tokens,
        depth=args.depth,
        num_discrete_actions=(args.num_discrete_actions,) if args.num_discrete_actions else (),
        num_continuous_actions=args.num_continuous_actions,
        device=device,
    )

    def prep(batch):
        as_t = lambda x, dtype: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        with torch.no_grad():
            out = dict(latents=tokenizer.encode(_batch_video(batch, device)))
        if 'rewards' in batch:
            out['rewards'] = as_t(batch['rewards'], torch.float32)
        if 'terminated' in batch:
            out['terminals'] = as_t(batch['terminated'], torch.bool)
        actions = batch.get('actions')
        if actions is not None and np.issubdtype(np.asarray(actions).dtype, np.integer):
            da = as_t(actions, torch.long)
            out['discrete_actions'] = da if da.ndim == 3 else da[..., None]
        elif actions is not None:
            out['continuous_actions'] = as_t(actions, torch.float32)
        if 'continuous_actions' in batch:
            out['continuous_actions'] = as_t(batch['continuous_actions'], torch.float32)
        out['lens'] = as_t(batch['lens'], torch.long)
        return out

    # the counterpart's init reads the first batch for its shapes; it is
    # drawn here too, so both take the same batches from one seed
    prep(next(batches))
    trainer = BehaviorCloneTrainer(model, tokenizer=tokenizer, grad_accum=args.grad_accum,
                                   learning_rate=args.learning_rate, seed=args.seed,
                                   device=device)

    start_step = 0
    if not args.no_resume and (Path(args.output) / 'latest').exists():
        trainer.restore(args.output)
        start_step = int(trainer.ts.step)
        print(f'resumed from {args.output} at step {start_step}', flush=True)

    step = start_step
    while step < args.num_steps:
        for _ in range(args.grad_accum):
            batch = prep(next(batches))
            loss, _ = trainer.train_on_batch(batch)
        step = int(trainer.ts.step)
        if step % args.log_every == 0:
            logger.log(step, loss=float(loss))
            print(f'step {step}: loss {float(loss):.4f}', flush=True)
        if args.sample_every and step % args.sample_every == 0:
            # prompted dream continuation gif (reference sampling,
            # `trainers.py:1104-1185`): first half of the batch sequence
            # prompts the rollout, the dreamed second half is decoded
            prompt_t = max(1, batch['latents'].shape[1] // 2)
            gen_kwargs = dict(prompt_latents=batch['latents'][:4, :prompt_t])
            if 'discrete_actions' in batch:
                gen_kwargs['prompt_discrete_actions'] = batch['discrete_actions'][:4, :prompt_t]
            if 'continuous_actions' in batch:
                gen_kwargs['prompt_continuous_actions'] = batch['continuous_actions'][:4, :prompt_t]
            exp = generate(model, torch.Generator(device=device).manual_seed(step),
                           time_steps=batch['latents'].shape[1],
                           num_steps=4, batch_size=min(4, batch['latents'].shape[0]),
                           **gen_kwargs)
            with torch.no_grad():
                dreamed = tokenizer.decode(
                    exp.latents, generator=torch.Generator(device=device).manual_seed(1))
            logger.log_video(step, 'dream', dreamed.float().clamp(0, 1).cpu().numpy())
        if step % args.checkpoint_every == 0:
            trainer.save_checkpoint(args.output)
    trainer.save_checkpoint(args.output)
    logger.close()
    print(f'saved dynamics model to {args.output}')


def world_model_env(checkpoint: str | None, tokenizer_checkpoint: str | None = None,
                    grid_size: int = 4, device=None):
    """The environment `serve-world-model` serves: Snake without a
    checkpoint, else the world model (EMA weights where the checkpoint has
    them) as a `DynamicsWorldModelWrapper`, decoding frames through the
    tokenizer when one is given."""
    if checkpoint is None:
        return SnakeEnv(grid_size=grid_size)
    device = resolve_device(device)
    model = load_model(_resolve_model_checkpoint(checkpoint), DynamicsWorldModel, device=device)
    tokenizer = None
    if tokenizer_checkpoint:
        tokenizer = load_model(_resolve_model_checkpoint(tokenizer_checkpoint), VideoTokenizer,
                               device=device)
    return DynamicsWorldModelWrapper(model, tokenizer=tokenizer, device=device)


def cmd_serve_world_model(argv):
    p = argparse.ArgumentParser(prog='serve-world-model')
    p.add_argument('--checkpoint', type=str, default=None,
                   help='dynamics checkpoint; omit for ground-truth Snake')
    p.add_argument('--tokenizer-checkpoint', type=str, default=None)
    p.add_argument('--port', type=int, default=8000)
    p.add_argument('--grid-size', type=int, default=4)
    _add_device_arg(p)
    args = p.parse_args(argv)

    env = world_model_env(args.checkpoint, args.tokenizer_checkpoint,
                          grid_size=args.grid_size, device=args.device)
    WebEnvServer(env, port=args.port).serve_forever()


def cmd_inspect_replay_buffer(argv):
    p = argparse.ArgumentParser(prog='inspect-replay-buffer')
    p.add_argument('--buffer', type=str, required=True)
    p.add_argument('--serve', action='store_true', help='start the web inspector')
    p.add_argument('--port', type=int, default=8001)
    _add_device_arg(p)   # accepted like every command's; the inspector runs no model
    args = p.parse_args(argv)

    buf = ReplayBuffer.open(args.buffer)

    if args.serve:
        InspectReplayBufferServer(buf, port=args.port).serve_forever()
        return
    lengths = [buf.episode_length(i) for i in range(buf.num_episodes)]
    print(json.dumps(dict(
        folder=str(args.buffer),
        num_episodes=buf.num_episodes,
        max_episodes=buf.max_episodes,
        max_timesteps=buf.max_timesteps,
        fields={k: [str(np.dtype(d)), list(s)] for k, (d, s) in buf.fields.items()},
        mean_episode_length=float(np.mean(lengths)) if lengths else 0.0,
    ), indent=2))


COMMANDS = {
    'train-video-tokenizer': cmd_train_video_tokenizer,
    'train-dynamics': cmd_train_dynamics,
    'serve-world-model': cmd_serve_world_model,
    'inspect-replay-buffer': cmd_inspect_replay_buffer,
}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ('-h', '--help'):
        print('usage: python -m dreamer4_torch.cli <command> [args]\ncommands:',
              *('  ' + c for c in COMMANDS), sep='\n')
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f'unknown command {cmd!r}; available: {list(COMMANDS)}', file=sys.stderr)
        return 1
    return COMMANDS[cmd](argv[1:])


if __name__ == '__main__':
    sys.exit(main() or 0)
