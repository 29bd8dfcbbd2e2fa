"""What the port's recipes share: seeded streams, model construction from a
seed, time padding, prompt windows cut from real experience, and the
world-model optimizer that leaves the policy and value heads frozen."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..train.optim import MuonAdamAtan2
from ..train.trainers import TrainState, make_world_model_train_step, rl_param_labels


def stream(seed: int, *path: int, device) -> torch.Generator:
    """The generator of the stream a JAX recipe derives as
    `fold_in(PRNGKey(seed), *path)` (or `PRNGKey(seed)` alone): seeded from
    (seed, *path) through numpy's `SeedSequence`, so each path has a
    stream of its own."""
    state = np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state >> np.uint64(1)))


@contextlib.contextmanager
def seeded_init(seed: int, device: torch.device | str):
    """The port's constructors draw their initial weights from the global
    generator: build inside this block to take them from `seed` (the JAX
    recipe's `PRNGKey(seed)` for 'params') and leave the global state as
    it was."""
    device = torch.device(device)
    devices = [device.index] if device.type == 'cuda' else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        yield


def pad_time(x: np.ndarray, length: int, axis: int = 1) -> np.ndarray:
    """`x` cut or zero-padded to `length` frames along `axis`."""
    pad = length - x.shape[axis]
    if pad <= 0:
        return np.asarray(x)[tuple(slice(None) if a != axis else slice(length)
                                   for a in range(x.ndim))]
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(np.asarray(x), widths)


def experience_item(exp, length: int) -> dict:
    """An `Experience` of a rollout as the recipes keep it in replay: numpy
    arrays, padded to `length` frames."""
    host = lambda t: t.detach().cpu().numpy()
    return dict(latents=pad_time(host(exp.latents), length),
                rewards=pad_time(host(exp.rewards), length),
                terminals=host(exp.terminals),
                discrete_actions=pad_time(host(exp.actions.discrete), length),
                lens=host(exp.lens))


_DTYPES = dict(latents=torch.float32, rewards=torch.float32, terminals=torch.bool,
               discrete_actions=torch.long, lens=torch.long)


def to_batch(item: dict, device, lens_key: str = 'lens') -> dict:
    """A replay item as a world-model batch on `device` (`lens_key` names
    the lens the world model trains on)."""
    batch = {k: torch.as_tensor(np.asarray(item[k]), dtype=_DTYPES[k], device=device)
             for k in ('latents', 'rewards', 'terminals', 'discrete_actions')}
    batch['lens'] = torch.as_tensor(np.asarray(item[lens_key]), dtype=torch.long, device=device)
    return batch


def prompt_window(item: dict, batch: int, prompt_len: int, rng: np.random.Generator,
                  device) -> dict:
    """`batch` prompts of `prompt_len` real frames from one replay item:
    only rows long enough for a fully real window (clamping a short episode
    upward would prompt from zero padding), at uniform starts."""
    ok = np.nonzero(item['lens'] >= prompt_len + 1)[0]
    if len(ok) == 0:
        ok = np.arange(item['latents'].shape[0])
    rows = ok[rng.integers(0, len(ok), size=batch)]
    lens = item['lens'][rows]
    starts = (rng.random(batch) * np.maximum(lens - prompt_len - 1, 1)).astype(int)
    idx_t = starts[:, None] + np.arange(prompt_len)[None]
    take = lambda k, dtype: torch.as_tensor(item[k][rows[:, None], idx_t], dtype=dtype,
                                            device=device)
    return dict(prompt_latents=take('latents', torch.float32),
                prompt_discrete_actions=take('discrete_actions', torch.long),
                prompt_rewards=take('rewards', torch.float32))


class WorldModelUpdates:
    """The JAX recipes' world-model training beside dream RL: `MuonAdamAtan2`
    (gradients clipped at norm 1) over the parameters `rl_param_labels`
    calls 'frozen', the policy and value heads in no group (the
    counterpart's `optax.multi_transform` with `optax.set_to_zero()` on
    'policy' and 'value'), one train step per call. The JAX recipes split
    their key once per step; here the steps draw from one generator in
    turn. The shortcut flag is the recipe's host draw from `rng`, made
    before `sample_batch()` draws the batch, as in the JAX recipes."""

    def __init__(self, model, learning_rate: float, generator: torch.Generator,
                 rng: np.random.Generator):
        labels = rl_param_labels(model)
        self.model = model
        self.optimizer = MuonAdamAtan2(model, learning_rate=learning_rate, clip_grad_norm=1.0,
                                       only={n for n, label in labels.items()
                                             if label == 'frozen'})
        self.ts = TrainState(model=model, optimizer=self.optimizer, ema_params=None, step=0)
        self._step = make_world_model_train_step(model, self.optimizer)
        self.generator = generator
        self.rng = rng

    def __call__(self, sample_batch) -> torch.Tensor:
        shortcut = bool(self.rng.random() < self.model.prob_shortcut_train)
        self.ts, loss, _ = self._step(self.ts, sample_batch(), shortcut_train=shortcut,
                                      generator=self.generator)
        return loss
