"""Perceptual (LPIPS-style) loss (counterpart of `dreamer4_tpu/nn/lpips.py`).

The MSE between VGG16 features of randomly sampled frames of the prediction
and of the target. Pretrained VGG16 weights are not in the repository and
are not downloaded: `init_lpips` loads a local torchvision-layout npz
(`features.{i}.weight` / `.bias`) when given one, and otherwise keeps the
trunk's seeded random initialization, which works as a perceptual loss too.
The trunk is frozen and computes in float32. It is not a submodule of the
tokenizer: the trainer holds it, so the optimizer, the EMA, checkpoints and
the converter never see it. The frame draws go through the module-level
`draw`, so a test can replay the counterpart's.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .init import lecun_normal_

# VGG16's conv plan: (out_channels, convs) per stage
VGG16_PLAN = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def draw(kind: str, shape, *, generator: torch.Generator | None, device, low: int = 0,
         high: int = 0) -> torch.Tensor:
    """One random draw of `lpips_loss`.

    kind: 'frame_batch'     — integers in [low, high), the batch rows;
          'frame_time'      — integers in [low, high), the frames;
          'frame_time_frac' — uniform in [0, 1), the frames' fractions of
                              their rows' lengths (with `time_lens`).
    """
    if kind in ('frame_batch', 'frame_time'):
        return torch.randint(low, high, shape, generator=generator, device=device)
    if kind == 'frame_time_frac':
        return torch.rand(shape, generator=generator, device=device)
    raise ValueError(f'unknown draw {kind}')


class VGG16Features(nn.Module):
    """VGG16's convolution trunk, 3 x 3 'same' convolutions with ReLU and a
    2 x 2 max pool between stages; returns each stage's features (the
    counterpart also pools the last stage's, and reads nothing of it). The
    convolutions are named `conv_{i}` as the counterpart's
    flax `nn.Conv`s, whose HWIO kernels the converter turns to OIHW."""

    def __init__(self, device=None, generator: torch.Generator | None = None):
        super().__init__()
        dim_in, i = 3, 0
        for out_ch, n_convs in VGG16_PLAN:
            for _ in range(n_convs):
                conv = nn.Conv2d(dim_in, out_ch, 3, padding=1, device=device)
                lecun_normal_(conv.weight, 9 * dim_in, generator=generator)
                nn.init.zeros_(conv.bias)
                setattr(self, f'conv_{i}', conv)
                dim_in, i = out_ch, i + 1
        self.register_buffer('mean', torch.tensor(IMAGENET_MEAN, device=device),
                             persistent=False)
        self.register_buffer('std', torch.tensor(IMAGENET_STD, device=device),
                             persistent=False)

    def forward(self, x) -> list[torch.Tensor]:
        """x (b, h, w, 3) in [0, 1] -> the five stages' features (b, c, h', w')."""
        x = ((x - self.mean) / self.std).permute(0, 3, 1, 2)
        feats, i = [], 0
        for stage, (_, n_convs) in enumerate(VGG16_PLAN):
            if stage:
                x = F.max_pool2d(x, 2, 2)
            for _ in range(n_convs):
                x = F.relu(getattr(self, f'conv_{i}')(x))
                i += 1
            feats.append(x)
        return feats


def load_vgg16_npz(path) -> dict[str, torch.Tensor]:
    """A torchvision-layout VGG16 npz (features.N.weight, OIHW) as a
    state_dict of `VGG16Features`."""
    raw = np.load(path)
    state, conv_idx, torch_layer = {}, 0, 0
    for _, n_convs in VGG16_PLAN:
        for _ in range(n_convs):
            for leaf in ('weight', 'bias'):
                state[f'conv_{conv_idx}.{leaf}'] = torch.from_numpy(
                    np.array(raw[f'features.{torch_layer}.{leaf}'], np.float32))
            conv_idx += 1
            torch_layer += 2   # conv + relu
        torch_layer += 1       # max pool
    return state


def init_lpips(seed: int = 0, weights_path=None, device=None) -> VGG16Features:
    """The frozen float32 trunk: the weights of a local npz when
    `weights_path` is given, else a random initialization from `seed`."""
    generator = torch.Generator().manual_seed(seed)
    module = VGG16Features(generator=generator)
    if weights_path is not None:
        module.load_state_dict(load_vgg16_npz(weights_path))
    module.requires_grad_(False)
    return module.eval().to(device)


def lpips_loss(module: VGG16Features, pred, target, generator: torch.Generator | None = None,
               sampled_frames: int = 1, time_lens=None,
               feature_layers: Sequence[int] = (1, 2, 3)) -> torch.Tensor:
    """pred, target (b, t, h, w, c) video: the mean over `feature_layers`
    of the MSE between the features of `sampled_frames` random frames per
    row (drawn inside each row's `time_lens`). The gradient reaches `pred`
    only."""
    b, t = pred.shape[:2]
    num = b * sampled_frames
    device = pred.device
    batch_idx = draw('frame_batch', (num,), generator=generator, device=device, low=0, high=b)
    if time_lens is not None:
        lens = time_lens[batch_idx].long().clamp_min(1)
        u = draw('frame_time_frac', (num,), generator=generator, device=device)
        time_idx = torch.minimum((u * lens).long(), lens - 1)
    else:
        time_idx = draw('frame_time', (num,), generator=generator, device=device, low=0, high=t)

    pred_frames = pred[batch_idx, time_idx].float()
    target_frames = target[batch_idx, time_idx].detach().float()
    if pred_frames.shape[-1] == 1:
        pred_frames = pred_frames.repeat(1, 1, 1, 3)
        target_frames = target_frames.repeat(1, 1, 1, 3)
    pred_feats, target_feats = module(pred_frames), module(target_frames)
    loss = sum((pred_feats[i] - target_feats[i]).square().mean() for i in feature_layers)
    return loss / len(feature_layers)
