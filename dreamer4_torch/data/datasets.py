"""Host-side datasets and batch assembly (a copy of
`dreamer4_tpu/data/datasets.py`).

Equivalents of the reference's data plane (`trainers.py:80-415`):
- VideoDataset: glob gif/npy videos -> (c, t, h, w), frame crop/pad
- VideoTrajectoryDataset: + sibling <stem>.<key>.npy arrays
  (actions / rewards / terminated)
- VideoDatasetFromReplayBuffer
- collate_videos: pad to max time with time_lens
- sample_video_and_actions: random frame window keeping obs/action alignment
- pixel_shift_aug / randomly_apply_aug: CFG-style aug conditioning inputs

Everything numpy on host; devices receive padded arrays.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .video_io import load_video


def crop_or_pad_frames(video: np.ndarray, num_frames: int, rng=None) -> tuple[np.ndarray, int]:
    """(c, t, h, w) -> exactly num_frames frames; returns (video, valid_len)."""
    t = video.shape[1]
    if t > num_frames:
        start = int(rng.integers(0, t - num_frames + 1)) if rng is not None else 0
        return video[:, start:start + num_frames], num_frames
    if t < num_frames:
        pad = np.zeros((video.shape[0], num_frames - t, *video.shape[2:]), video.dtype)
        return np.concatenate([video, pad], axis=1), t
    return video, t


class VideoDataset:
    """Glob a folder of .gif/.npy/.mp4/.avi videos (reference `VideoDataset`,
    `trainers.py:156-253`)."""

    EXTENSIONS = ('*.gif', '*.npy', '*.mp4', '*.avi')

    SIDECAR_SUFFIXES = ('.actions.npy', '.rewards.npy', '.terminated.npy',
                        '.proprio.npy')

    def __init__(self, folder: str | Path, image_size: tuple[int, int] | None = None,
                 num_frames: int | None = None, seed: int = 0):
        """`folder` is a directory of videos OR a glob pattern like
        `data/*.gif` (reference dataset resolution, `cli.py:65-96`)."""
        self.folder = Path(folder)
        if self.folder.is_dir():
            candidates = (p for ext in self.EXTENSIONS for p in self.folder.glob(ext))
        else:  # glob pattern, anchored at the first wildcard-free parent
            if not any(ch in str(self.folder) for ch in '*?['):
                # a plain path that is not a directory — fail clearly
                # instead of letting anchor.glob('.') raise a cryptic
                # ValueError below
                raise FileNotFoundError(
                    f'video folder does not exist: {self.folder}')
            anchor = self.folder
            while any(ch in anchor.name for ch in '*?['):
                anchor = anchor.parent
            pattern = str(self.folder.relative_to(anchor))
            candidates = (p for p in anchor.glob(pattern)
                          if p.suffix in ('.gif', '.npy', '.mp4', '.avi'))
        self.paths = sorted(
            p for p in candidates
            if not any(str(p).endswith(s) for s in self.SIDECAR_SUFFIXES))
        assert len(self.paths) > 0, f'no videos found in {folder}'
        self.image_size = image_size
        self.num_frames = num_frames
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx) -> dict:
        video = load_video(self.paths[idx], image_size=self.image_size)
        lens = video.shape[1]
        if self.num_frames is not None:
            video, lens = crop_or_pad_frames(video, self.num_frames, self.rng)
        return {'video': video, 'lens': lens}


class VideoTrajectoryDataset(VideoDataset):
    """Adds sibling `<stem>.<key>.npy` arrays aligned with the video frames
    (reference `VideoTrajectoryDataset`, `trainers.py:255-340`)."""

    KEYS = ('actions', 'rewards', 'terminated', 'proprio')

    def __getitem__(self, idx) -> dict:
        path = self.paths[idx]
        video = load_video(path, image_size=self.image_size)

        stem = str(path)
        for suffix in ('.video.npy', '.gif', '.npy', '.mp4', '.avi'):
            if stem.endswith(suffix):
                stem = stem[: -len(suffix)]
                break

        arrays = {}
        for key in self.KEYS:
            sibling = Path(f'{stem}.{key}.npy')
            if sibling.exists():
                arrays[key] = np.load(sibling)

        t = video.shape[1]
        if self.num_frames is not None:
            out = sample_video_and_actions(
                dict(video=video, **arrays), self.num_frames, self.rng)
        else:
            out = dict(video=video, lens=t, **arrays)
        return out


def sample_video_and_actions(item: dict, num_frames: int, rng) -> dict:
    """Random frame window keeping obs/action alignment: the action stored at
    index i is the one taken FROM frame i, so a window [s, s+T) takes actions
    [s, s+T-1) (reference `sample_video_and_actions`, `trainers.py:203-253`)."""
    video = item['video']
    t = video.shape[1]
    take = min(t, num_frames)
    start = int(rng.integers(0, t - take + 1)) if t > take else 0

    out = {}
    video_w = video[:, start:start + take]
    if take < num_frames:
        pad = np.zeros((video.shape[0], num_frames - take, *video.shape[2:]), video.dtype)
        video_w = np.concatenate([video_w, pad], axis=1)
    out['video'] = video_w
    out['lens'] = take

    for key in ('actions', 'rewards', 'terminated', 'proprio'):
        if key not in item:
            continue
        arr = item[key]
        # proprio is per-frame (like rewards); actions span frame transitions
        span = take - 1 if key == 'actions' else take
        window = arr[start:start + span]
        full = num_frames - 1 if key == 'actions' else num_frames
        if window.shape[0] < full:
            pad = np.zeros((full - window.shape[0], *window.shape[1:]), window.dtype)
            window = np.concatenate([window, pad], axis=0)
        out[key] = window
    return out


class VideoDatasetFromReplayBuffer:
    """(reference `VideoDatasetFromReplayBuffer`, `trainers.py:342-415`)."""

    def __init__(self, buffer, num_frames: int | None = None, seed: int = 0):
        self.buffer = buffer
        self.num_frames = num_frames
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.buffer.num_episodes

    def __getitem__(self, idx) -> dict:
        ep = self.buffer.get_episode(idx)
        video = ep.get('video')
        if video is not None:
            if video.dtype == np.uint8:
                video = video.astype(np.float32) / 255.0
            video = np.transpose(video, (1, 0, 2, 3))  # (t,c,h,w) -> (c,t,h,w)

        item = {'video': video}
        for src, dst in (('rewards', 'rewards'), ('terminated', 'terminated'),
                         ('discrete_actions', 'actions'), ('continuous_actions', 'continuous_actions')):
            if src in ep:
                item[dst] = ep[src]

        if self.num_frames is not None:
            return sample_video_and_actions(item, self.num_frames, self.rng)
        item['lens'] = video.shape[1]
        return item


def collate(items: list[dict]) -> dict:
    """Pad every array to max time and stack; scalar 'lens' stacks to (b,)
    (reference `video_tensor_collate_fn`)."""
    keys = items[0].keys()
    out = {}
    for k in keys:
        vals = [item[k] for item in items]
        if np.isscalar(vals[0]) or np.asarray(vals[0]).ndim == 0:
            out[k] = np.asarray(vals)
            continue
        time_axis = 1 if k == 'video' else 0
        max_t = max(v.shape[time_axis] for v in vals)
        padded = []
        for v in vals:
            pad = max_t - v.shape[time_axis]
            if pad > 0:
                widths = [(0, 0)] * v.ndim
                widths[time_axis] = (0, pad)
                v = np.pad(v, widths)
            padded.append(v)
        out[k] = np.stack(padded)
    return out


def batch_iterator(dataset, batch_size: int, rng=None, shuffle: bool = True):
    """Endless iterator over collated batches (the reference's cycled
    dataloader, `trainers.py:649-653`)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    n = len(dataset)
    while True:
        idxs = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n - batch_size + 1, batch_size):
            yield collate([dataset[int(i)] for i in idxs[start:start + batch_size]])


def prefetch_batches(batches, depth: int = 2):
    """Pull `batches` ahead on a background thread so host-side assembly
    (video decode, collation, augmentation in the source iterator) overlaps
    device steps — the role of the reference's DataLoader worker processes
    (`trainers.py:649-653`). numpy/cv2 release the GIL for the heavy copies;
    replay-buffer streams can use the fully native
    `data.prefetch.PrefetchSampler` instead."""
    import queue
    import threading

    q: 'queue.Queue' = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    done = object()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not put(b):
                    return
            put(done)
        except BaseException as e:  # noqa: BLE001 — surfaced to the consumer
            put(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


# ------------------------------------------------------------- augmentation

def pixel_shift_aug(rng, video: np.ndarray, max_shift: int = 4) -> np.ndarray:
    """Reflect-padded random translation (reference `pixel_shift_aug`,
    `trainers.py:98-117`). video: (b, c, t, h, w)."""
    b = video.shape[0]
    out = np.empty_like(video)
    for i in range(b):
        dy, dx = rng.integers(-max_shift, max_shift + 1, size=2)
        padded = np.pad(video[i], ((0, 0), (0, 0),
                                   (max_shift, max_shift), (max_shift, max_shift)),
                        mode='reflect')
        h, w = video.shape[-2:]
        out[i] = padded[:, :, max_shift + dy:max_shift + dy + h,
                        max_shift + dx:max_shift + dx + w]
    return out


def randomly_apply_aug(rng, video: np.ndarray, aug_fn=pixel_shift_aug, prob: float = 0.5):
    """-> (video, aug_id) where aug_id in {1: unaugmented, 2: augmented} for
    CFG-style conditioning (reference `randomly_apply_aug`,
    `trainers.py:80-96`)."""
    if rng.random() < prob:
        return aug_fn(rng, video), 2
    return video, 1
