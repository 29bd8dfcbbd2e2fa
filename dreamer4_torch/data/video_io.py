"""Host-side video IO and logging helpers (a copy of
`dreamer4_tpu/data/video_io.py`).

Equivalent of the reference's cv2/PIL video+gif utilities
(`trainers.py:119-199`). mp4/avi decode+encode run through cv2 when it is
installed (as the reference does); GIF and .npy paths need only PIL/numpy,
so every format degrades gracefully per-environment.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

VIDEO_SUFFIXES = ('.mp4', '.avi', '.mov', '.webm', '.mkv')


def _require_cv2():
    try:
        import cv2
        return cv2
    except ImportError as e:
        raise RuntimeError(
            'mp4/avi video IO needs cv2 (opencv), which is not available in '
            'this environment; convert to .gif or .npy') from e


def load_video(path: str | Path, image_size: tuple[int, int] | None = None) -> np.ndarray:
    """-> (c, t, h, w) float32 in [0, 1]."""
    path = Path(path)
    if path.suffix.lower() in VIDEO_SUFFIXES:
        cv2 = _require_cv2()
        cap = cv2.VideoCapture(str(path))
        if not cap.isOpened():
            raise RuntimeError(f'cv2 could not open {path}')
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if image_size is not None:
                frame = cv2.resize(frame, (image_size[1], image_size[0]),
                                   interpolation=cv2.INTER_AREA)
            frames.append(frame)
        cap.release()
        if not frames:
            raise RuntimeError(f'no frames decoded from {path}')
        video = np.stack(frames).astype(np.float32) / 255.0  # (t, h, w, c)
        return np.transpose(video, (3, 0, 1, 2))             # (c, t, h, w)

    if path.suffix.lower() == '.npy':
        arr = np.load(path)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        return arr.astype(np.float32)

    from PIL import Image, ImageSequence

    img = Image.open(path)
    frames = []
    for frame in ImageSequence.Iterator(img):
        frame = frame.convert('RGB')
        if image_size is not None:
            frame = frame.resize((image_size[1], image_size[0]))
        frames.append(np.asarray(frame, np.float32) / 255.0)
    video = np.stack(frames)                   # (t, h, w, c)
    return np.transpose(video, (3, 0, 1, 2))   # (c, t, h, w)


def save_video(path: str | Path, video: np.ndarray, fps: int = 8):
    """video: (c, t, h, w) float in [0,1] -> .mp4 (mp4v) / .avi (MJPG) file
    via cv2, matching the reference's mp4 episode recording
    (`env.py:243-277`)."""
    cv2 = _require_cv2()
    path = Path(path)
    codec = 'MJPG' if path.suffix.lower() == '.avi' else 'mp4v'
    frames = np.clip(np.transpose(video, (1, 2, 3, 0)), 0, 1)  # (t, h, w, c)
    frames = (frames * 255).astype(np.uint8)
    if frames.shape[-1] == 1:
        frames = np.repeat(frames, 3, axis=-1)
    t, h, w, _ = frames.shape
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*codec), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f'cv2 could not open a video writer for {path}')
    for frame in frames:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()


def save_gif(path: str | Path, video: np.ndarray, fps: int = 8):
    """video: (c, t, h, w) float in [0,1] -> animated gif."""
    from PIL import Image

    video = np.clip(np.transpose(video, (1, 2, 3, 0)), 0, 1)  # (t, h, w, c)
    frames = [(f * 255).astype(np.uint8) for f in video]
    if frames[0].shape[-1] == 1:
        frames = [np.repeat(f, 3, axis=-1) for f in frames]
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)


def video_grid(videos: np.ndarray, columns: int | None = None) -> np.ndarray:
    """(b, c, t, h, w) -> (c, t, H, W) grid for logging gifs."""
    b, c, t, h, w = videos.shape
    columns = columns if columns is not None else int(np.ceil(np.sqrt(b)))
    rows = int(np.ceil(b / columns))
    grid = np.zeros((c, t, rows * h, columns * w), videos.dtype)
    for i in range(b):
        r, col = divmod(i, columns)
        grid[:, :, r * h:(r + 1) * h, col * w:(col + 1) * w] = videos[i]
    return grid
