"""Trainers (counterpart of `dreamer4_tpu/train/trainers.py`): the train
steps and `TokenizerTrainer` and `BehaviorCloneTrainer`.

The counterpart's train steps are pure jitted functions of an immutable
TrainState. Here a step runs eagerly and updates the model's parameters
and buffers (the loss normalizers), the optimizer state and the EMA
weights in place; the returned TrainState carries the new step count. With
`grad_accum > 1` the optimizer is `MultiSteps` (`optax.MultiSteps`): the
gradients are averaged over that many micro-steps, and the optimizer, the
EMA and the step move only on the last of them, while a loss normalizer
moves on every one. The world model's shortcut branch is a host-side draw
from a numpy `default_rng(seed)`, as in the counterpart, so both packages
choose the same sequence of plain and shortcut steps from one seed; the
training forward's own draws come from a `torch.Generator` seeded the same
way.
"""
from __future__ import annotations

import shutil
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.tokenizer import TokenizerLosses, VideoTokenizer
from ..models.world_model import DynamicsWorldModel, WorldModelLosses
from .checkpoint import load_train_state, save_model, save_train_state
from .ema import init_ema, update_ema
from .optim import MuonAdamAtan2, with_grad_accum

# batch entries of the counterpart's train step that the port does not take yet
_NOT_PORTED_BATCH = ('continuous_actions', 'proprio', 'tasks')


class TrainState(NamedTuple):
    """The counterpart's TrainState: `model` holds the parameters and the
    loss normalizers' state (its `params` and `state`), `optimizer` their
    optimizer state (`opt_state`)."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: dict | None
    step: int


def create_train_state(model, optimizer, with_ema: bool = False) -> TrainState:
    ema = init_ema(dict(model.named_parameters())) if with_ema else None
    return TrainState(model=model, optimizer=optimizer, ema_params=ema, step=0)


def _apply_update(ts: TrainState, ema_decay: float) -> TrainState:
    """The optimizer step after a backward, then the EMA and the step count
    when the optimizer applied an update (every step, or the last micro-step
    under `MultiSteps`; the counterpart's `_applied_update`)."""
    ts.optimizer.step()
    if getattr(ts.optimizer, 'mini_step', 0) != 0:
        return ts
    if ts.ema_params is not None:
        update_ema(ts.ema_params, dict(ts.model.named_parameters()), ema_decay)
    return ts._replace(step=ts.step + 1)


def make_tokenizer_train_step(model: VideoTokenizer, optimizer, ema_decay: float = 0.999):
    """-> train_step(ts, video, time_lens=None, generator=None) returning
    (ts, loss, losses): the training forward on `video` (b, c, t, h, w),
    its gradients, one optimizer update and one EMA update."""

    def train_step(ts: TrainState, video, time_lens=None,
                   generator: torch.Generator | None = None):
        optimizer.zero_grad(set_to_none=True)
        loss, interm = model(video, time_lens=time_lens, return_intermediates=True,
                             generator=generator)
        loss.backward()
        ts = _apply_update(ts, ema_decay)
        return ts, loss.detach(), TokenizerLosses(*(l.detach() for l in interm.losses))

    return train_step


def make_world_model_train_step(model: DynamicsWorldModel, optimizer: MuonAdamAtan2,
                                ema_decay: float = 0.999):
    """-> train_step(ts, batch, shortcut_train, generator=None) returning
    (ts, loss, losses): the training forward on `batch` (latents, rewards,
    terminals, discrete_actions, lens), its gradients, one optimizer update
    and one EMA update."""

    def train_step(ts: TrainState, batch: dict, shortcut_train: bool,
                   generator: torch.Generator | None = None):
        for name in _NOT_PORTED_BATCH:
            if batch.get(name) is not None:
                raise NotImplementedError(f'batch entry {name} is not ported yet')
        kwargs = {k: batch.get(k) for k in ('rewards', 'terminals', 'discrete_actions', 'lens')}
        optimizer.zero_grad(set_to_none=True)
        loss, losses, _ = model(latents=batch['latents'], **kwargs,
                                shortcut_train=shortcut_train, return_intermediates=True,
                                generator=generator)
        loss.backward()
        ts = _apply_update(ts, ema_decay)
        return ts, loss.detach(), WorldModelLosses(*(l.detach() for l in losses))

    return train_step


class _CheckpointableTrainer:
    """Save/resume: the whole TrainState plus the model config, as
    step-tagged directories with a `latest` link, and the host RNG states
    (the numpy branch draws, the torch generator of the forward's draws),
    so that a resumed run continues bit for bit."""

    model = None  # type: ignore[assignment]
    ts: TrainState
    rng: np.random.Generator
    generator: torch.Generator

    def save_checkpoint(self, path, extra: dict | None = None, tag_step: bool = True) -> Path:
        path = Path(path)
        step = self.ts.step
        target = path / f'ckpt-{step}' if tag_step else path
        extra = dict(extra or {})
        extra['_np_rng'] = self.rng.bit_generator.state
        extra['_torch_generator'] = self.generator.get_state().tolist()
        save_model(target, self.model, extra=dict(step=step, **extra))
        if self.ts.ema_params is not None:
            # EMA weights, with the model's buffers, as a standalone loadable
            # model checkpoint
            save_model(target / 'ema', self.model,
                       state_dict={**self.model.state_dict(), **self.ts.ema_params},
                       extra=dict(step=step, ema=True))
        save_train_state(target, self.ts, extra=extra)
        if tag_step:
            latest, latest_tmp = path / 'latest', path / '.latest.tmp'
            if latest_tmp.is_symlink() or latest_tmp.exists():
                latest_tmp.unlink()
            latest_tmp.symlink_to(target.name)
            if latest.exists() and not latest.is_symlink():
                shutil.rmtree(latest)   # a copied tree dereferenced the link
            latest_tmp.replace(latest)
        return target

    def restore(self, path) -> dict:
        """Restore the TrainState in place from a checkpoint directory (or
        a directory holding `latest`). Returns the checkpoint's extra
        metadata."""
        path = Path(path)
        if (path / 'latest').exists():
            path = (path / 'latest').resolve()
        self.ts, extra = load_train_state(path, self.ts)
        if '_np_rng' in extra:
            self.rng.bit_generator.state = extra.pop('_np_rng')
        if '_torch_generator' in extra:
            self.generator.set_state(
                torch.tensor(extra.pop('_torch_generator'), dtype=torch.uint8))
        return extra


def _check_device(model, device) -> torch.device:
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f'the model is on {model.device}, the trainer on {device}')
    return device


class TokenizerTrainer(_CheckpointableTrainer):
    """Tokenizer training: one train step per batch of video. Runs on CUDA
    unless `device='cpu'` is given, and the model must live there. The
    counterpart's host draw chooses between the decoders only with a
    separate flow decoder, which the port does not have; LPIPS
    (`use_lpips`) waits for VGG16 weights in the repository and is
    refused."""

    def __init__(self, model: VideoTokenizer, *, learning_rate: float = 3e-4,
                 clip_grad_norm: float = 1.0, grad_accum: int = 1, with_ema: bool = True,
                 ema_decay: float = 0.999, seed: int = 0, use_lpips: bool = False,
                 lpips_weights_path: str | None = None, device=None):
        if use_lpips or lpips_weights_path is not None:
            raise NotImplementedError('LPIPS is not ported to dreamer4_torch yet: it needs '
                                      'VGG16 weights in the repository')
        device = _check_device(model, device)
        self.model = model
        self.optimizer = with_grad_accum(
            MuonAdamAtan2(model, learning_rate=learning_rate, clip_grad_norm=clip_grad_norm),
            grad_accum)
        self.ts = create_train_state(model, self.optimizer, with_ema=with_ema)
        self._train_step = make_tokenizer_train_step(model, self.optimizer, ema_decay)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def train_on_batch(self, video, time_lens=None):
        """video (b, c, t, h, w) on the trainer's device; time_lens (b,)
        or None. -> (loss, losses)."""
        self.ts, loss, losses = self._train_step(self.ts, video, time_lens,
                                                 generator=self.generator)
        return loss, losses


class BehaviorCloneTrainer(_CheckpointableTrainer):
    """World-model training over offline batches: per batch, video is
    tokenized to latents by `tokenizer.encode` when the batch has no
    latents, a host-side Bernoulli draw chooses the shortcut step
    (probability `model.prob_shortcut_train`), then one train step. Runs on
    CUDA unless `device='cpu'` is given, and the models must live there.

    Not ported yet, and refused when set: `aux_image_encoder_fn` and
    `use_self_flow`."""

    def __init__(self, model: DynamicsWorldModel, *, tokenizer: VideoTokenizer | None = None,
                 aux_image_encoder_fn=None, learning_rate: float = 3e-4,
                 clip_grad_norm: float = 1.0, grad_accum: int = 1, with_ema: bool = True,
                 ema_decay: float = 0.999, seed: int = 0, use_self_flow: bool = False,
                 device=None):
        for name, value in (('aux_image_encoder_fn', aux_image_encoder_fn),
                            ('use_self_flow', use_self_flow)):
            if value:
                raise NotImplementedError(f'{name} is not ported to dreamer4_torch yet')
        device = _check_device(model, device)
        if tokenizer is not None and tokenizer.device != device:
            raise ValueError(f'the tokenizer is on {tokenizer.device}, the trainer on {device}')
        self.model = model
        self.tokenizer = tokenizer
        self.optimizer = with_grad_accum(
            MuonAdamAtan2(model, learning_rate=learning_rate, clip_grad_norm=clip_grad_norm),
            grad_accum)
        self.ts = create_train_state(model, self.optimizer, with_ema=with_ema)
        self._train_step = make_world_model_train_step(model, self.optimizer, ema_decay)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def train_on_batch(self, batch: dict):
        """batch: latents (b, t, n, d), or video (b, c, t, h, w) with a
        tokenizer, and optional rewards, terminals, discrete_actions, lens,
        on the trainer's device. -> (loss, losses)."""
        batch = dict(batch)
        if 'latents' not in batch:
            if self.tokenizer is None or 'video' not in batch:
                raise ValueError('a batch without latents needs video and a tokenizer')
            with torch.no_grad():
                batch['latents'] = self.tokenizer.encode(batch['video'])
        batch.pop('video', None)
        shortcut = bool(self.rng.random() < self.model.prob_shortcut_train)
        self.ts, loss, losses = self._train_step(self.ts, batch, shortcut_train=shortcut,
                                                 generator=self.generator)
        return loss, losses
