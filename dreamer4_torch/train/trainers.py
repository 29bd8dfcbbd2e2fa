"""World-model training (counterpart of `dreamer4_tpu/train/trainers.py`,
the dynamics part): the train step and `BehaviorCloneTrainer`.

The counterpart's train step is a pure jitted function of an immutable
TrainState. Here the step runs eagerly and updates the model's parameters,
the optimizer state and the EMA weights in place; the returned TrainState
carries the new step count. The shortcut branch is a host-side draw from a
numpy `default_rng(seed)`, as in the counterpart, so both packages choose
the same sequence of plain and shortcut steps from one seed; the training
forward's own draws come from a `torch.Generator` seeded the same way.
"""
from __future__ import annotations

import shutil
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.world_model import DynamicsWorldModel, WorldModelLosses
from .checkpoint import load_train_state, save_model, save_train_state
from .ema import init_ema, update_ema
from .optim import MuonAdamAtan2

# batch entries of the counterpart's train step that the port does not take yet
_NOT_PORTED_BATCH = ('continuous_actions', 'proprio', 'tasks')


class TrainState(NamedTuple):
    """The counterpart's TrainState: `model` holds the parameters (its
    `params`), `optimizer` their optimizer state (`opt_state`)."""
    model: DynamicsWorldModel
    optimizer: MuonAdamAtan2
    ema_params: dict | None
    step: int


def create_train_state(model, optimizer, with_ema: bool = False) -> TrainState:
    ema = init_ema(dict(model.named_parameters())) if with_ema else None
    return TrainState(model=model, optimizer=optimizer, ema_params=ema, step=0)


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
        optimizer.step()
        if ts.ema_params is not None:
            update_ema(ts.ema_params, dict(model.named_parameters()), ema_decay)
        losses = WorldModelLosses(*(l.detach() for l in losses))
        return ts._replace(step=ts.step + 1), loss.detach(), losses

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
            # EMA weights as a standalone loadable model checkpoint
            save_model(target / 'ema', self.model, state_dict=self.ts.ema_params,
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


class BehaviorCloneTrainer(_CheckpointableTrainer):
    """World-model training over offline batches of latents: per batch, a
    host-side Bernoulli draw chooses the shortcut step (probability
    `model.prob_shortcut_train`), then one train step. Runs on CUDA unless
    `device='cpu'` is given, and the model must live there.

    Not ported yet, and refused when set: tokenizing video (`tokenizer`,
    `aux_image_encoder_fn`), `use_self_flow` and `grad_accum > 1`."""

    def __init__(self, model: DynamicsWorldModel, *, tokenizer=None, aux_image_encoder_fn=None,
                 learning_rate: float = 3e-4, clip_grad_norm: float = 1.0, grad_accum: int = 1,
                 with_ema: bool = True, ema_decay: float = 0.999, seed: int = 0,
                 use_self_flow: bool = False, device=None):
        for name, value in (('tokenizer', tokenizer), ('aux_image_encoder_fn', aux_image_encoder_fn),
                            ('use_self_flow', use_self_flow)):
            if value:
                raise NotImplementedError(f'{name} is not ported to dreamer4_torch yet')
        if grad_accum > 1:
            raise NotImplementedError('grad_accum > 1 is not ported to dreamer4_torch yet')
        device = resolve_device(device)
        if model.device != device:
            raise ValueError(f'the model is on {model.device}, the trainer on {device}')
        self.model = model
        self.optimizer = MuonAdamAtan2(model, learning_rate=learning_rate,
                                       clip_grad_norm=clip_grad_norm)
        self.ts = create_train_state(model, self.optimizer, with_ema=with_ema)
        self._train_step = make_world_model_train_step(model, self.optimizer, ema_decay)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def train_on_batch(self, batch: dict):
        """batch: latents (b, t, n, d) and optional rewards, terminals,
        discrete_actions, lens, on the trainer's device. -> (loss, losses)."""
        if 'latents' not in batch:
            raise NotImplementedError('tokenizing video is not ported yet: pass latents')
        shortcut = bool(self.rng.random() < self.model.prob_shortcut_train)
        self.ts, loss, losses = self._train_step(self.ts, batch, shortcut_train=shortcut,
                                                 generator=self.generator)
        return loss, losses
