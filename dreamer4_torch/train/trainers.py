"""Trainers (counterpart of `dreamer4_tpu/train/trainers.py`): the train
steps, `TokenizerTrainer` and `BehaviorCloneTrainer`, RL in imagination (the
RL optimizer and update step and `DreamTrainer`) and RL against an
environment (`SimTrainer`).

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

Data parallelism: each train step, trainer and update step takes a `mesh`
(`parallel.mesh`), and each rank then passes its rows of the batch (or a
batch of DTensors, `parallel.distributed.host_local_batch_to_global`). The
forward and backward run inside `parallel.mesh.data_parallel`: every
reduction over the batch in the losses is the global batch's (the
`parallel.distributed.batch_*` helpers), so a loss normalizer's EMA moves
alike on every rank, every draw is made at the global batch and cut to the
rank's rows, and the gradients are averaged
over `data` before the optimizer steps, so the step equals one process's on
the global batch (the counterpart's GSPMD step). A model sharded over
`model` (`parallel.mesh.shard_params`) computes with its weights gathered
whole and updates its shards. The RL trainers dream or roll out on each
rank from its own draws (the counterpart's per-host actor fleet) and take
data-parallel updates; their weights stay whole on every rank.
"""
from __future__ import annotations

import shutil
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..data.experience import (Experience, combine_experiences, index_experience,
                               pad_experience_time)
from ..device import resolve_device
from ..envs.interact import EnvInteractor
from ..models.generate import generate
from ..models.rl import ReturnStats, RLLossOutputs, rl_losses
from ..models.self_flow import SelfFlowHead, self_flow_loss
from ..models.tokenizer import TokenizerLosses, VideoTokenizer, latent_consistency_loss
from ..models.world_model import DynamicsWorldModel, WorldModelLosses
from ..nn.lpips import init_lpips, lpips_loss
from ..parallel.distributed import is_main_process, mean_over_data
from ..parallel.mesh import data_parallel, local_batch, model_axis_size, whole
from ..tracing import span
from .checkpoint import load_train_state, save_model, save_train_state
from .ema import init_ema, update_ema
from .optim import MuonAdamAtan2, named_train_parameters, with_grad_accum

# the self-flow head's key in the counterpart's parameter tree, and the
# prefix of its parameters' names here
SELF_FLOW_HEAD = 'self_flow_head'


class TrainState(NamedTuple):
    """The counterpart's TrainState: `model` holds the parameters and the
    loss normalizers' state (its `params` and `state`), `optimizer` their
    optimizer state (`opt_state`). A world-model trainer with self-flow
    also trains `self_flow_head`, whose parameters the counterpart keeps
    under `params['self_flow_head']`: here they are named
    `self_flow_head.<name>` in the optimizer and the EMA weights."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer | None
    ema_params: dict | None
    step: int
    self_flow_head: torch.nn.Module | None = None

    def modules(self) -> dict[str, torch.nn.Module]:
        """The trained modules, by the prefix of their parameters' names:
        the model's carry none."""
        if self.self_flow_head is None:
            return {'': self.model}
        return {'': self.model, SELF_FLOW_HEAD: self.self_flow_head}

    def named_parameters(self) -> dict[str, torch.Tensor]:
        """Every trained parameter: the model's, then the head's."""
        return dict(named_train_parameters(self.modules()))

    def model_ema(self) -> dict[str, torch.Tensor] | None:
        """The model's own EMA weights (without the head's), by the model's
        parameter names."""
        if self.ema_params is None:
            return None
        return {k: whole(v) for k, v in self.ema_params.items()
                if not k.startswith(SELF_FLOW_HEAD + '.')}


def create_train_state(model, optimizer, with_ema: bool = False,
                       self_flow_head: torch.nn.Module | None = None) -> TrainState:
    ts = TrainState(model=model, optimizer=optimizer, ema_params=None, step=0,
                    self_flow_head=self_flow_head)
    return ts._replace(ema_params=init_ema(ts.named_parameters()) if with_ema else None)


def _apply_update(ts: TrainState, ema_decay: float) -> TrainState:
    """The optimizer step after a backward, then the EMA and the step count
    when the optimizer applied an update (every step, or the last micro-step
    under `MultiSteps`; the counterpart's `_applied_update`)."""
    with span('dreamer4.optimizer'):
        ts.optimizer.step()
    if getattr(ts.optimizer, 'mini_step', 0) != 0:
        return ts
    if ts.ema_params is not None:
        with span('dreamer4.ema'):
            update_ema(ts.ema_params, ts.named_parameters(), ema_decay)
    return ts._replace(step=ts.step + 1)


def make_tokenizer_train_step(model: VideoTokenizer, optimizer, ema_decay: float = 0.999,
                              lpips_fn=None, mesh=None):
    """-> train_step(ts, video, time_lens=None, generator=None,
    train_flow_decoder=False) returning (ts, loss, losses): the training
    forward on `video` (b, c, t, h, w) with `lpips_fn(recon, clean,
    generator, time_lens)` as its LPIPS term, plus the latent consistency
    loss when the model weights it, their gradients, one optimizer update
    and one EMA update. With BYOL and EMA weights, the teacher's latents
    are the EMA weights' encode of the clean video, without gradient.
    `train_flow_decoder` picks the decoder a model with a separate flow
    decoder trains. With a `mesh`, data parallel (see the module
    docstring)."""

    def train_step(ts: TrainState, video, time_lens=None,
                   generator: torch.Generator | None = None, train_flow_decoder: bool = False):
        with span('dreamer4.train_step'):
            video, time_lens = local_batch((video, time_lens))
            optimizer.zero_grad(set_to_none=True)
            with data_parallel(ts.modules(), mesh):
                with span('dreamer4.forward'):
                    byol_targets = None
                    if model.has_byol and ts.ema_params is not None:
                        with torch.no_grad():
                            byol_targets = torch.func.functional_call(
                                model, ts.model_ema(), (video,), dict(return_latents=True))
                    loss, interm = model(video, time_lens=time_lens, return_intermediates=True,
                                         byol_target_latents=byol_targets, lpips_fn=lpips_fn,
                                         train_flow_decoder=train_flow_decoder,
                                         generator=generator)
                    if model.latent_consistency_loss_weight > 0.0:
                        loss = loss + model.latent_consistency_loss_weight * (
                            latent_consistency_loss(model, interm.recon, interm.latents,
                                                    time_lens=time_lens))
                with span('dreamer4.backward'):
                    loss.backward()
            ts = _apply_update(ts, ema_decay)
            return ts, mean_over_data(loss.detach(), mesh), TokenizerLosses(
                *(mean_over_data(l.detach(), mesh) for l in interm.losses))

    return train_step


def make_world_model_train_step(model: DynamicsWorldModel, optimizer: MuonAdamAtan2,
                                ema_decay: float = 0.999, self_flow_cfg: dict | None = None,
                                mesh=None):
    """-> train_step(ts, batch, shortcut_train, generator=None) returning
    (ts, loss, losses): the training forward on `batch` (latents, rewards,
    terminals, discrete_actions, continuous_actions, proprio, lens, tasks),
    its gradients, one optimizer update and one EMA update.

    `self_flow_cfg`: dict(head=SelfFlowHead, weight, student_layer,
    teacher_layer) adds `weight` times the self-flow loss, whose teacher
    runs on the EMA weights, so it needs `ts.ema_params` and a `generator`:
    its forwards take the draws that follow the training forward's. With a
    `mesh`, data parallel (see the module docstring)."""

    def train_step(ts: TrainState, batch: dict, shortcut_train: bool,
                   generator: torch.Generator | None = None):
        with span('dreamer4.train_step'):
            batch = local_batch(batch)
            if self_flow_cfg is not None and (generator is None or ts.ema_params is None):
                raise ValueError('the self-flow loss needs a generator, so that the teacher '
                                 'replays the student\'s draws, and EMA weights for the teacher')
            kwargs = {k: batch.get(k) for k in ('rewards', 'terminals', 'discrete_actions',
                                                'continuous_actions', 'proprio', 'lens', 'tasks')}
            kwargs = dict(latents=batch['latents'], **kwargs, shortcut_train=shortcut_train)
            optimizer.zero_grad(set_to_none=True)
            with data_parallel(ts.modules(), mesh):
                with span('dreamer4.forward'):
                    loss, losses, _ = model(**kwargs, return_intermediates=True,
                                            generator=generator)
                    if self_flow_cfg is not None:
                        sf = self_flow_loss(
                            model, self_flow_cfg['head'], ts.model_ema(), kwargs, generator,
                            student_layer=self_flow_cfg.get('student_layer', -3),
                            teacher_layer=self_flow_cfg.get('teacher_layer', -1),
                            lens=batch.get('lens'))
                        loss = loss + sf * self_flow_cfg.get('weight', 1.0)
                with span('dreamer4.backward'):
                    loss.backward()
            ts = _apply_update(ts, ema_decay)
            return ts, mean_over_data(loss.detach(), mesh), WorldModelLosses(
                *(mean_over_data(l.detach(), mesh) for l in losses))

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
            # the model's EMA weights, with its buffers, as a standalone
            # loadable model checkpoint
            save_model(target / 'ema', self.model,
                       state_dict={**self.model.state_dict(), **self.ts.model_ema()},
                       extra=dict(step=step, ema=True))
        save_train_state(target, self.ts, extra=extra)
        if tag_step and is_main_process():
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


def _data_rank(mesh) -> int:
    """This rank's index on the mesh's `data` axis (0 without a mesh)."""
    if mesh is None:
        return 0
    return mesh.get_local_rank('data') if mesh.ndim > 1 else mesh.get_local_rank()


def _check_device(model, device) -> torch.device:
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f'the model is on {model.device}, the trainer on {device}')
    return device


class TokenizerTrainer(_CheckpointableTrainer):
    """Tokenizer training: one train step per batch of video. Runs on CUDA
    unless `device='cpu'` is given, and the model must live there. With a
    separate flow decoder, a host draw from the numpy `default_rng(seed)`
    chooses the decoder each step trains (the flow decoder with
    probability `model.flow_decoder_train_prob`), as in the counterpart,
    which draws only for such a model.

    `use_lpips` (with a nonzero `model.lpips_loss_weight`) adds the LPIPS
    term on a frozen float32 VGG16 trunk that the trainer holds, outside
    the model: the weights of the torchvision-layout npz at
    `lpips_weights_path`, or seeded random features (seed + 7, the
    counterpart's key)."""

    def __init__(self, model: VideoTokenizer, *, learning_rate: float = 3e-4,
                 clip_grad_norm: float = 1.0, grad_accum: int = 1, with_ema: bool = True,
                 ema_decay: float = 0.999, seed: int = 0, use_lpips: bool = False,
                 lpips_weights_path: str | None = None, mesh=None, device=None):
        device = _check_device(model, device)
        self.model = model
        self.mesh = mesh
        self.optimizer = with_grad_accum(
            MuonAdamAtan2(model, learning_rate=learning_rate, clip_grad_norm=clip_grad_norm),
            grad_accum)
        self.ts = create_train_state(model, self.optimizer, with_ema=with_ema)
        self.lpips = lpips_fn = None
        if use_lpips and model.loss_weights['lpips'] > 0.0:
            self.lpips = init_lpips(seed + 7, weights_path=lpips_weights_path, device=device)
            lpips_fn = lambda recon, clean, gen, lens: lpips_loss(
                self.lpips, recon, clean, generator=gen, time_lens=lens)
        self._train_step = make_tokenizer_train_step(model, self.optimizer, ema_decay,
                                                     lpips_fn=lpips_fn, mesh=mesh)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def train_on_batch(self, video, time_lens=None):
        """video (b, c, t, h, w) on the trainer's device; time_lens (b,)
        or None. -> (loss, losses)."""
        train_flow = (self.model.has_separate_flow_decoder
                      and bool(self.rng.random() < self.model.flow_decoder_train_prob))
        self.ts, loss, losses = self._train_step(self.ts, video, time_lens,
                                                 generator=self.generator,
                                                 train_flow_decoder=train_flow)
        return loss, losses


class BehaviorCloneTrainer(_CheckpointableTrainer):
    """World-model training over offline batches: per batch, video is
    tokenized to latents by `tokenizer.encode` when the batch has no
    latents, a host-side Bernoulli draw chooses the shortcut step
    (probability `model.prob_shortcut_train`), then one train step. Runs on
    CUDA unless `device='cpu'` is given, and the models must live there.

    `use_self_flow` adds the self-flow loss (`self_flow_weight`, the
    student's and the teacher's layers): the trainer holds a
    `SelfFlowHead` (`self.self_flow_head`), trained with the model under
    one optimizer and one EMA, and keeps the EMA on whatever `with_ema`
    says, as the counterpart does.

    `aux_image_encoder_fn(video) -> (b, t, n_aux, d_latent)` adds tokens of
    its own to a video batch's latents, after the tokenizer's along the
    token axis (build the model with `num_latent_tokens` = the tokenizer's
    + n_aux); without a tokenizer its tokens are the latents."""

    def __init__(self, model: DynamicsWorldModel, *, tokenizer: VideoTokenizer | None = None,
                 aux_image_encoder_fn=None, learning_rate: float = 3e-4,
                 clip_grad_norm: float = 1.0, grad_accum: int = 1, with_ema: bool = True,
                 ema_decay: float = 0.999, seed: int = 0, use_self_flow: bool = False,
                 self_flow_weight: float = 1.0, self_flow_student_layer: int = -3,
                 self_flow_teacher_layer: int = -1, mesh=None, device=None):
        device = _check_device(model, device)
        if tokenizer is not None and tokenizer.device != device:
            raise ValueError(f'the tokenizer is on {tokenizer.device}, the trainer on {device}')
        self.model = model
        self.mesh = mesh
        self.tokenizer = tokenizer
        self.aux_image_encoder_fn = aux_image_encoder_fn
        self.self_flow_head = SelfFlowHead(model.dim, device=device) if use_self_flow else None
        self_flow_cfg = None
        if use_self_flow:
            self_flow_cfg = dict(head=self.self_flow_head, weight=self_flow_weight,
                                 student_layer=self_flow_student_layer,
                                 teacher_layer=self_flow_teacher_layer)
        ts = create_train_state(model, None, with_ema=with_ema or use_self_flow,
                                self_flow_head=self.self_flow_head)
        self.optimizer = with_grad_accum(
            MuonAdamAtan2(ts.modules(), learning_rate=learning_rate,
                          clip_grad_norm=clip_grad_norm), grad_accum)
        self.ts = ts._replace(optimizer=self.optimizer)
        self._train_step = make_world_model_train_step(model, self.optimizer, ema_decay,
                                                       self_flow_cfg=self_flow_cfg, mesh=mesh)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def train_on_batch(self, batch: dict):
        """batch: latents (b, t, n, d), or video (b, c, t, h, w) with a
        tokenizer or an aux image encoder, and optional rewards, terminals,
        discrete_actions, continuous_actions, proprio, lens, tasks, on the
        trainer's device; with a mesh, the rank's rows (or DTensors).
        -> (loss, losses)."""
        batch = dict(local_batch(batch))
        if 'latents' not in batch:
            if (self.tokenizer is None and self.aux_image_encoder_fn is None) \
                    or 'video' not in batch:
                raise ValueError('a batch without latents needs video and a tokenizer or an '
                                 'aux image encoder')
            with torch.no_grad():
                parts = []
                if self.tokenizer is not None:
                    parts.append(self.tokenizer.encode(batch['video']))
                if self.aux_image_encoder_fn is not None:
                    parts.append(self.aux_image_encoder_fn(batch['video']))
                batch['latents'] = torch.cat(parts, dim=-2)
        batch.pop('video', None)
        shortcut = bool(self.rng.random() < self.model.prob_shortcut_train)
        self.ts, loss, losses = self._train_step(self.ts, batch, shortcut_train=shortcut,
                                                 generator=self.generator)
        return loss, losses


# ---------------------------------------------------------------------- RL

def rl_param_labels(model: DynamicsWorldModel, full_model: bool = False) -> dict[str, str]:
    """Parameter name -> 'policy' (the policy head, the actor's latent
    encoder and the action unembedding), 'value' (the value head, the
    critic's latent encoder and the critic state's embedding), or the rest:
    'frozen' in heads-only RL, 'trunk' when fine-tuning the whole model. As
    in the counterpart, the rest includes `actor_spr_module`: its loss
    reaches it, but heads-only RL leaves it where it is."""
    rest = 'trunk' if full_model else 'frozen'

    def label(name: str) -> str:
        top, _, sub = name.partition('.')
        if top in ('policy_head', 'actor_latent_encoder'):
            return 'policy'
        if top in ('value_head', 'critic_latent_encoder', 'critic_state_embedder'):
            return 'value'
        if top == 'action_embedder' and 'unembed' in sub.partition('.')[0]:
            return 'policy'
        return rest

    return {name: label(name) for name, _ in model.named_parameters()}


# optax.adamw's defaults
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def make_rl_optimizer(model: DynamicsWorldModel, policy_lr: float = 1e-4,
                      value_lr: float = 1e-4, trunk_lr: float | None = None
                      ) -> torch.optim.AdamW:
    """AdamW over the labelled groups of `rl_param_labels`, each group at
    its own rate. trunk_lr=None: heads-only RL, the frozen parameters are in
    no group, so they neither move nor decay; a float fine-tunes the whole
    model at that rate (pair it with
    `make_rl_update_step(only_learn_policy_value_heads=False)`)."""
    labels = rl_param_labels(model, full_model=trunk_lr is not None)
    lrs = {'policy': policy_lr, 'value': value_lr, 'trunk': trunk_lr}
    groups = []
    for group, lr in lrs.items():
        params = [p for name, p in model.named_parameters() if labels[name] == group]
        if params and lr is not None:
            groups.append(dict(params=params, lr=lr, name=group))
    return torch.optim.AdamW(groups, **ADAMW)


class RLState(NamedTuple):
    """The counterpart's RLState: `model` holds the parameters, `optimizer`
    their optimizer state."""
    model: DynamicsWorldModel
    optimizer: torch.optim.Optimizer
    return_stats: ReturnStats
    step: int


def create_rl_state(model: DynamicsWorldModel, optimizer: torch.optim.Optimizer) -> RLState:
    return RLState(model=model, optimizer=optimizer,
                   return_stats=ReturnStats.create(device=model.device), step=0)


def make_rl_update_step(model: DynamicsWorldModel, optimizer: torch.optim.Optimizer,
                        objective: str = 'ppo', only_learn_policy_value_heads: bool = True,
                        mesh=None, **rl_loss_kwargs):
    """-> update_step(rl_state, experience) returning (rl_state, outputs):
    the RL losses, their gradients and one optimizer update. Pass
    `only_learn_policy_value_heads=False`, with an optimizer built with
    `trunk_lr`, for full-model RL: the loss then re-forwards the trunk with
    gradients. With a `mesh` (whose `model` axis is 1: the RL weights stay
    whole), data parallel over the ranks' experience (see the module
    docstring): the returns' quantiles, the EMA return statistics and every
    mean are the global batch's."""
    if model_axis_size(mesh) > 1:
        raise NotImplementedError('RL updates keep the weights whole on every rank: '
                                  'pass a mesh whose model axis is 1')
    trained = [p for group in optimizer.param_groups for p in group['params']]

    def update_step(rl_state: RLState, experience: Experience):
        experience = local_batch(experience)
        optimizer.zero_grad(set_to_none=True)
        with data_parallel(model, mesh, trained=trained):
            out = rl_losses(model, experience, objective=objective,
                            only_learn_policy_value_heads=only_learn_policy_value_heads,
                            return_stats=rl_state.return_stats, **rl_loss_kwargs)
            (out.policy_loss + out.value_loss).backward()
        # a parameter the loss does not reach has a zero gradient in the
        # counterpart and still decays; AdamW would skip it at None
        for p in trained:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        out = RLLossOutputs(mean_over_data(out.policy_loss.detach(), mesh),
                            mean_over_data(out.value_loss.detach(), mesh), out.stats,
                            ReturnStats(*(x.detach() for x in out.return_stats)))
        return RLState(model, optimizer, out.return_stats, rl_state.step + 1), out

    return update_step


class DreamTrainer:
    """RL purely in imagination: per step, `generate` dreams a batch of
    experience from the model, then `update_epochs` heads-only updates learn
    from it (the importance ratio of the objective handles the drift of
    reused dreams). Runs on CUDA unless `device='cpu'` is given, and the
    model must live there.

    `prompt_fn(generator)` returns a dict of `prompt_*` tensors (fixed
    shapes) to start the dreams from real experience; `generate_kwargs`
    pass through to `generate` (e.g. `terminal_logit_offset`,
    `min_dream_length`) and `rl_loss_kwargs` to `rl_losses` (e.g.
    `soft_continuation`). The dreams' draws come from a `torch.Generator`
    seeded with `seed`. With a `mesh`, each data rank dreams `batch_size`
    rows of its own (the generator seeded with `seed` plus its index on
    `data`), and the updates are data parallel over them."""

    def __init__(self, model: DynamicsWorldModel, *, time_steps: int = 16, num_steps: int = 4,
                 batch_size: int = 8, objective: str = 'ppo', policy_lr: float = 1e-4,
                 value_lr: float = 1e-4, update_epochs: int = 1, prompt_fn=None,
                 generate_kwargs: dict | None = None, rl_loss_kwargs: dict | None = None,
                 seed: int = 0, mesh=None, device=None):
        device = _check_device(model, device)
        self.model = model
        self.time_steps = time_steps
        self.num_steps = num_steps
        self.batch_size = batch_size
        self.objective = objective
        self.update_epochs = update_epochs
        self.prompt_fn = prompt_fn
        self.generate_kwargs = dict(generate_kwargs or {})
        self.optimizer = make_rl_optimizer(model, policy_lr, value_lr)
        self.rl_state = create_rl_state(model, self.optimizer)
        self._update = make_rl_update_step(model, self.optimizer, objective, mesh=mesh,
                                           **(rl_loss_kwargs or {}))
        self.generator = torch.Generator(device=device).manual_seed(seed + _data_rank(mesh))

    def dream(self) -> Experience:
        prompt = self.prompt_fn(self.generator) if self.prompt_fn is not None else {}
        return generate(self.model, self.generator, time_steps=self.time_steps,
                        num_steps=self.num_steps, batch_size=self.batch_size, **prompt,
                        **self.generate_kwargs)

    def step(self) -> tuple[Experience, RLLossOutputs]:
        experience = self.dream()
        for _ in range(self.update_epochs):
            self.rl_state, out = self._update(self.rl_state, experience)
        return experience, out

    def __call__(self, num_steps: int) -> list[dict[str, float]]:
        """`num_steps` steps; one dict of float stats per step."""
        logs = []
        for _ in range(num_steps):
            _, out = self.step()
            logs.append({k: float(v) for k, v in out.stats.items()})
        return logs


class SimTrainer:
    """Online RL against a real environment: per step, rollouts through an
    `EnvInteractor`, combined and padded to `max_timesteps + 1` frames (one
    shape, whatever the longest episode), then (with `train_dynamics`) the
    world model's training on them, and `update_epochs` epochs of RL
    updates, each over the whole batch or over minibatches of a fresh
    permutation (a tail short of a minibatch is dropped). Runs on CUDA
    unless `device='cpu'` is given, and the models must live there.

    The RL updates are heads-only, or full-model with `rl_trunk_lr` (the
    policy and value losses re-forward the trunk, which a third optimizer
    group fine-tunes at that rate); `rl_loss_kwargs` pass through to
    `rl_losses` (e.g. `latent_input_full_model_ok` for full-model RL of a
    latent-input model). The dynamics training keeps its own
    `MuonAdamAtan2` (`dynamics_lr`, gradients clipped at norm 1) over all
    parameters; only the parameters it moves are shared with the RL
    optimizer. As in the counterpart, the shortcut flag of a dynamics step
    and the minibatch permutations come from one numpy `default_rng(seed)`;
    the rollouts' draws come from a `torch.Generator` seeded with `seed`,
    the training forward's from one seeded with `seed + 13`. With a `mesh`,
    each data rank steps its own `env` (its rollout generator seeded with
    `seed` plus its index on `data`); the dynamics steps and RL updates are
    data parallel over the ranks' experience, and every rank takes the same
    shortcut draws and minibatch positions of its rows."""

    def __init__(self, model: DynamicsWorldModel, env, *, tokenizer: VideoTokenizer | None = None,
                 objective: str = 'ppo', policy_lr: float = 1e-4, value_lr: float = 1e-4,
                 rl_trunk_lr: float | None = None, num_steps: int = 4, max_timesteps: int = 16,
                 num_rollouts_per_step: int = 1, update_epochs: int = 2,
                 minibatch_size: int | None = None, train_dynamics: bool = True,
                 dynamics_lr: float = 3e-4, dynamics_epochs: int = 1,
                 rl_loss_kwargs: dict | None = None, seed: int = 0, mesh=None, device=None):
        device = _check_device(model, device)
        self.model = model
        self.env = env
        self.num_steps = num_steps
        self.max_timesteps = max_timesteps
        self.num_rollouts_per_step = num_rollouts_per_step
        self.update_epochs = update_epochs
        self.minibatch_size = minibatch_size
        self.optimizer = make_rl_optimizer(model, policy_lr, value_lr, trunk_lr=rl_trunk_lr)
        self.rl_state = create_rl_state(model, self.optimizer)
        self.interactor = EnvInteractor(model, tokenizer=tokenizer, device=device)
        self._update = make_rl_update_step(model, self.optimizer, objective,
                                           only_learn_policy_value_heads=rl_trunk_lr is None,
                                           mesh=mesh, **(rl_loss_kwargs or {}))
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=device).manual_seed(seed + _data_rank(mesh))
        self.train_dynamics = train_dynamics
        self.dynamics_epochs = dynamics_epochs
        if train_dynamics:
            self.wm_optimizer = MuonAdamAtan2(model, learning_rate=dynamics_lr,
                                              clip_grad_norm=1.0)
            self._wm_step = make_world_model_train_step(model, self.wm_optimizer, mesh=mesh)
            self.wm_generator = torch.Generator(device=device).manual_seed(seed + 13)

    def rollout(self) -> Experience:
        """The step's rollouts, combined and padded to `max_timesteps + 1`
        frames (the `+ 1` holds the bootstrap frame)."""
        exps = [self.interactor(self.env, self.generator, num_steps=self.num_steps,
                                max_timesteps=self.max_timesteps)
                for _ in range(self.num_rollouts_per_step)]
        experience = combine_experiences(exps) if len(exps) > 1 else exps[0]
        return pad_experience_time(experience, self.max_timesteps + 1)

    def train_dynamics_on(self, experience: Experience):
        """The world model's training on the experience; -> the last loss,
        or None where there is nothing to train on. The step takes the RL
        state's step count, and only the parameters it moves come back."""
        if not self.train_dynamics or experience.time_steps <= 1:
            return None
        batch = dict(latents=experience.latents, rewards=experience.rewards,
                     terminals=experience.terminals, lens=experience.lens)
        if experience.actions is not None:
            if experience.actions.discrete is not None:
                batch['discrete_actions'] = experience.actions.discrete
            if experience.actions.continuous is not None:
                batch['continuous_actions'] = experience.actions.continuous
        ts = TrainState(model=self.model, optimizer=self.wm_optimizer, ema_params=None,
                        step=self.rl_state.step)
        loss = None
        for _ in range(self.dynamics_epochs):
            shortcut = bool(self.rng.random() < self.model.prob_shortcut_train)
            ts, loss, _ = self._wm_step(ts, batch, shortcut_train=shortcut,
                                        generator=self.wm_generator)
        return loss

    def update(self, experience: Experience) -> list[RLLossOutputs]:
        """`update_epochs` epochs of RL updates; -> the outputs of each."""
        b = experience.batch_size
        mb = min(max(self.minibatch_size or b, 1), b)
        outs = []
        for _ in range(self.update_epochs):
            if mb == b:
                self.rl_state, out = self._update(self.rl_state, experience)
                outs.append(out)
                continue
            perm = self.rng.permutation(b)
            for s in range(0, b - mb + 1, mb):
                idx = torch.as_tensor(perm[s:s + mb], device=self.model.device)
                self.rl_state, out = self._update(self.rl_state,
                                                  index_experience(experience, idx))
                outs.append(out)
        return outs

    def step(self) -> tuple[Experience, list[RLLossOutputs]]:
        experience = self.rollout()
        self.train_dynamics_on(experience)
        return experience, self.update(experience)

    def __call__(self, num_steps: int) -> list[float]:
        """`num_steps` steps; the mean episode return of each."""
        returns = []
        for _ in range(num_steps):
            experience, _ = self.step()
            returns.append(float(np.mean(experience.episode_return.cpu().numpy())))
        return returns
