"""Synthetic moving-sprites dataset with velocity actions (counterpart of
`examples/dataset_moving_sprites.py`, numpy only).

The reference's `dataset_moving_mnist.py` is MovingMNIST with velocity-grid
actions. MNIST cannot be downloaded here, so sprites are procedurally
generated digit-like blobs — the dynamics (straight-line motion with wall
bounces, velocity as the action) are the same, which is what the world
model learns. The episodes come from numpy `default_rng(seed)`, as in the
JAX recipe, so both write the same files.

Usage: python -m dreamer4_torch.examples.dataset_moving_sprites ./data/moving_sprites
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

VELOCITIES = [-2, 0, 2]  # 3x3 velocity grid -> 9 discrete actions


def make_sprite(rng: np.random.Generator, size: int = 10) -> np.ndarray:
    """A random connected blob, vaguely digit-like."""
    sprite = np.zeros((size, size), np.float32)
    y, x = size // 2, size // 2
    for _ in range(size * 3):
        sprite[y, x] = 1.0
        dy, dx = rng.integers(-1, 2, 2)
        y = int(np.clip(y + dy, 0, size - 1))
        x = int(np.clip(x + dx, 0, size - 1))
    return sprite


def generate_episode(
    rng: np.random.Generator,
    num_frames: int = 16,
    image_size: int = 32,
    sprite_size: int = 10,
    action_conditioned: bool = True,
):
    """-> (video (c, t, h, w), actions (t-1,)) — action = velocity id applied
    between frame i and i+1."""
    sprite = make_sprite(rng, sprite_size)
    pos = rng.integers(0, image_size - sprite_size, 2).astype(np.int64)

    frames = []
    actions = []
    vel_id = int(rng.integers(0, 9))

    for t in range(num_frames):
        frame = np.zeros((image_size, image_size), np.float32)
        y, x = pos
        frame[y:y + sprite_size, x:x + sprite_size] = sprite
        frames.append(frame)

        if t == num_frames - 1:
            break

        if action_conditioned and rng.random() < 0.2:
            vel_id = int(rng.integers(0, 9))
        actions.append(vel_id)

        vy, vx = VELOCITIES[vel_id // 3], VELOCITIES[vel_id % 3]
        pos = pos + np.array([vy, vx])
        # bounce off walls
        for d in range(2):
            hi = image_size - sprite_size
            if pos[d] < 0 or pos[d] > hi:
                pos[d] = int(np.clip(pos[d], 0, hi))

    video = np.stack(frames)[None]  # (1, t, h, w) single channel
    return video, np.asarray(actions, np.int64)


def write_dataset(folder: str, num_episodes: int = 200, seed: int = 0, **kwargs):
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(num_episodes):
        video, actions = generate_episode(rng, **kwargs)
        np.save(folder / f'ep{i:05d}.video.npy', video)
        np.save(folder / f'ep{i:05d}.actions.npy', actions)
    print(f'wrote {num_episodes} episodes to {folder}')


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    write_dataset(argv[0] if argv else './data/moving_sprites')
    return 0


if __name__ == '__main__':
    sys.exit(main())
