"""Continuous-action + proprioception dynamics (counterpart of
`examples/train_reacher_proprio_dynamics.py`).

A procedural 2-joint "reacher" arm renders 32x32 videos; actions are 6-dim
continuous in [-1, 1] (dims 0-1 drive the joint velocities, dims 2-5 are
nuisance channels the model must learn to ignore); proprio is the 4-dim
(sin/cos of both joint angles). Trajectories are written as
`<stem>.video.npy` + `.actions.npy` + `.rewards.npy` + `.proprio.npy`
sidecars, loaded back with `VideoTrajectoryDataset`, a tokenizer is
trained on them (`train_tokenizer`), and a DynamicsWorldModel with
`num_continuous_actions=6` + `dim_proprio=4` is behavior-cloned on its
latents (`train_dynamics`), then dreamed with forced constant actions to
verify the rollout responds to continuous control (`forced_dreams`,
PASS when the +0.9 and -0.9 dreams' latents differ by 1% of their scale).

Streams (JAX -> here): the tokenizer's and the world model's initial
weights, `PRNGKey(seed)` and `PRNGKey(seed + 2)` -> the global generator
seeded with `--seed` and seed + 2 inside `common.seeded_init`; the
trainers' key chains -> `TokenizerTrainer(seed=--seed)`,
`BehaviorCloneTrainer(seed=--seed)`; the forced dreams' shared
`PRNGKey(42)` -> a fresh generator seeded with 42 for each dream. The
dataset, the batches and the trajectories draw from numpy generators as
in the JAX recipe. The jitted tokenize and dreams are plain calls under
`torch.no_grad()` on `--device`.

Usage: python -m dreamer4_torch.examples.train_reacher_proprio_dynamics --steps 300
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..data.datasets import VideoTrajectoryDataset, batch_iterator
from ..device import resolve_device
from ..models.generate import generate
from ..models.tokenizer import VideoTokenizer
from ..models.world_model import DynamicsWorldModel
from ..train.trainers import BehaviorCloneTrainer, TokenizerTrainer
from .common import seeded_init

IMAGE = 32
T = 24


def render_arm(theta1: float, theta2: float) -> np.ndarray:
    """2-link arm on a 32x32x3 canvas, drawn with anti-aliased line stamps."""
    img = np.zeros((IMAGE, IMAGE, 3), np.float32)
    cx, cy = IMAGE / 2, IMAGE / 2
    l1, l2 = IMAGE * 0.28, IMAGE * 0.22
    x1, y1 = cx + l1 * np.cos(theta1), cy + l1 * np.sin(theta1)
    x2, y2 = x1 + l2 * np.cos(theta1 + theta2), y1 + l2 * np.sin(theta1 + theta2)

    def stamp_line(x0, y0, x1, y1, channel, width=1.1):
        n = 24
        xs = np.linspace(x0, x1, n)
        ys = np.linspace(y0, y1, n)
        yy, xx = np.mgrid[0:IMAGE, 0:IMAGE]
        for px, py in zip(xs, ys):
            d2 = (xx - px) ** 2 + (yy - py) ** 2
            img[..., channel] += np.exp(-d2 / (2 * width ** 2))

    stamp_line(cx, cy, x1, y1, 0)
    stamp_line(x1, y1, x2, y2, 1)
    img[..., 2] += np.exp(-(((np.mgrid[0:IMAGE, 0:IMAGE][1] - x2) ** 2
                             + (np.mgrid[0:IMAGE, 0:IMAGE][0] - y2) ** 2)
                            / (2 * 1.5 ** 2)))
    return np.clip(img, 0.0, 1.0)


def make_dataset(folder: Path, num_trajs: int, seed: int):
    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)
    for i in range(num_trajs):
        theta = rng.uniform(-np.pi, np.pi, size=2)
        frames, acts, proprio = [], [], []
        for t in range(T):
            frames.append(render_arm(*theta))
            proprio.append(np.concatenate([np.sin(theta), np.cos(theta)]))
            a = rng.uniform(-1.0, 1.0, size=6).astype(np.float32)
            if t < T - 1:
                acts.append(a)
            theta = theta + 0.35 * a[:2]  # dims 2-5 do nothing
        video = np.stack(frames).transpose(3, 0, 1, 2)  # (c, t, h, w)
        stem = folder / f'traj_{i:03d}'
        np.save(f'{stem}.video.npy', video.astype(np.float32))
        np.save(f'{stem}.actions.npy', np.stack(acts))
        np.save(f'{stem}.rewards.npy', np.zeros((T,), np.float32))
        np.save(f'{stem}.proprio.npy', np.stack(proprio).astype(np.float32))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--data', type=str, default='/tmp/reacher_trajs')
    p.add_argument('--num-trajs', type=int, default=24)
    p.add_argument('--steps', type=int, default=300)
    p.add_argument('--tokenizer-steps', type=int, default=200)
    p.add_argument('--batch-size', type=int, default=8)
    p.add_argument('--seq-len', type=int, default=8)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', type=str, default=None,
                   help='torch device (default: the CUDA card; "cpu" runs on the CPU)')
    return p.parse_args(argv)


def build_tokenizer(args, device, **overrides) -> VideoTokenizer:
    """The recipe's tokenizer (examples/train_reacher_proprio_dynamics.py:
    112-114), its weights from `args.seed`."""
    kwargs = dict(
        dim=64, dim_latent=16, patch_size=8, image_height=IMAGE, image_width=IMAGE,
        num_latent_tokens=8, encoder_depth=2, decoder_depth=2, time_block_every=2)
    with seeded_init(args.seed, device):
        return VideoTokenizer(**{**kwargs, **overrides}, device=device)


def build_model(args, device, **overrides) -> DynamicsWorldModel:
    """The recipe's world model (examples/train_reacher_proprio_dynamics.py:
    130-136), its weights from `args.seed + 2`."""
    kwargs = dict(
        dim=64, dim_latent=16, num_latent_tokens=8, num_spatial_tokens=8,
        max_steps=16, depth=2, time_block_every=2, attn_heads=4, attn_dim_head=16,
        num_continuous_actions=6, continuous_dist_type='beta',
        continuous_target_action_range=(-1.0, 1.0),
        dim_proprio=4, multi_token_pred_len=4, num_register_tokens=4,
        predict_terminals=False, add_action_embed_to_spatial=True)
    with seeded_init(args.seed + 2, device):
        return DynamicsWorldModel(**{**kwargs, **overrides}, device=device)


def load_data(args):
    """-> (dataset, endless batches), the trajectories written first where
    `--data` holds none."""
    data_dir = Path(args.data)
    if not any(data_dir.glob('*.video.npy')):
        print('generating procedural reacher trajectories...', flush=True)
        make_dataset(data_dir, args.num_trajs, args.seed)
    ds = VideoTrajectoryDataset(args.data, image_size=(IMAGE, IMAGE),
                                num_frames=args.seq_len, seed=args.seed)
    return ds, batch_iterator(ds, args.batch_size, rng=np.random.default_rng(args.seed))


def train_tokenizer(args, batches, device) -> VideoTokenizer:
    tokenizer = build_tokenizer(args, device)
    next(batches)   # the JAX recipe's init batch
    tok_trainer = TokenizerTrainer(tokenizer, seed=args.seed, device=device)
    t0 = time.time()
    for step in range(args.tokenizer_steps):
        batch = next(batches)
        loss, _ = tok_trainer.train_on_batch(
            torch.as_tensor(batch['video'], dtype=torch.float32, device=device),
            time_lens=torch.as_tensor(batch['lens'], dtype=torch.long, device=device))
        if step % 50 == 0:
            print(f'tokenizer step {step}: loss {float(loss):.4f} [{time.time()-t0:.0f}s]',
                  flush=True)
    return tokenizer


def train_dynamics(args, tokenizer, batches, device) -> DynamicsWorldModel:
    """Behaviour cloning on the tokenizer's latents with the continuous
    actions, proprio and rewards."""
    model = build_model(args, device)
    bc = BehaviorCloneTrainer(model, tokenizer=tokenizer, seed=args.seed, device=device)
    as_f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    t0 = time.time()
    for step in range(args.steps):
        batch = next(batches)
        loss, _ = bc.train_on_batch(dict(
            video=as_f32(batch['video']),
            continuous_actions=as_f32(batch['actions']),
            rewards=as_f32(batch['rewards']),
            proprio=as_f32(batch['proprio']),
            lens=torch.as_tensor(batch['lens'], dtype=torch.long, device=device)))
        if step % 50 == 0:
            print(f'dynamics step {step}: loss {float(loss):.4f} [{time.time()-t0:.0f}s]',
                  flush=True)
    return model


def divergence(pos: dict, neg: dict) -> tuple[float, float, float]:
    """The forced dreams' (latent divergence, latent scale, proprio
    divergence) after the 3 prompt frames, from each dream's `latents` and
    `proprio` arrays."""
    lat_div = float(np.abs(pos['latents'] - neg['latents'])[:, 3:].mean())
    lat_scale = float(np.abs(pos['latents'])[:, 3:].mean())
    prop_div = float(np.abs(pos['proprio'] - neg['proprio'])[:, 3:].mean())
    return lat_div, lat_scale, prop_div


def forced_dreams(model, tokenizer, ds, device) -> bool:
    """Constant +torque vs -torque dreams from one real 3-frame prompt must
    diverge; -> whether they do (PASS)."""
    item = ds[0]
    as_f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    outs = {}
    with torch.no_grad():
        p_lat = tokenizer.encode(as_f32(item['video'][None, :, :3]))
        # P prompt frames need P actions: actions[i] is taken FROM frame i,
        # and the first generated frame (i=P) conditions on actions[P-1]
        p_act = as_f32(item['actions'][None, :3])
        p_prop = as_f32(item['proprio'][None, :3])
        for name, val in (('pos', 0.9), ('neg', -0.9)):
            exp = generate(model, torch.Generator(device=device).manual_seed(42),
                           time_steps=10, num_steps=4, batch_size=1,
                           prompt_latents=p_lat, prompt_continuous_actions=p_act,
                           prompt_proprio=p_prop,
                           forced_continuous_actions=torch.full((1, 10, 6), val,
                                                                device=device))
            outs[name] = dict(latents=exp.latents.cpu().numpy(),
                              proprio=exp.proprio.cpu().numpy())
    lat_div, lat_scale, prop_div = divergence(outs['pos'], outs['neg'])
    print(f'forced-action dream divergence: latents {lat_div:.4f} '
          f'(scale {lat_scale:.4f}), proprio {prop_div:.4f}', flush=True)
    ok = lat_div > 0.01 * max(lat_scale, 1e-6)
    print('PASS' if ok else 'WEAK', flush=True)
    return ok


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    ds, batches = load_data(args)
    tokenizer = train_tokenizer(args, batches, device)
    model = train_dynamics(args, tokenizer, batches, device)
    return 0 if forced_dreams(model, tokenizer, ds, device) else 1


if __name__ == '__main__':
    sys.exit(main())
