from .datasets import (VideoDataset, VideoDatasetFromReplayBuffer,
                       VideoTrajectoryDataset, batch_iterator, collate,
                       prefetch_batches)
from .experience import Experience, combine_experiences, index_experience
from .prefetch import CopyEngine, PrefetchSampler
from .replay_buffer import ReplayBuffer

__all__ = [
    'VideoDataset', 'VideoDatasetFromReplayBuffer', 'VideoTrajectoryDataset',
    'batch_iterator', 'collate', 'prefetch_batches',
    'Experience', 'combine_experiences', 'index_experience',
    'CopyEngine', 'PrefetchSampler', 'ReplayBuffer',
]
