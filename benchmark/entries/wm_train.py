"""Driver of `BehaviorCloneTrainer.train_on_batch`: world-model training on
batches of latents, discrete actions and rewards.

Set-up builds the model from the configuration, loads the benchmark's
weights, builds the trainer (its own seeded Bernoulli picks the shortcut
steps) and drives it through the first `check_steps` steps on distinct
batches, with the training forward's draws made by the benchmark
(`harness.DrawTape`). Those steps are the readings the reference is held to,
and they compile and warm both kinds of step. The window then continues the
same trainer over the cell's pool of batches.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import flops, harness


class Cell:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        import dreamer4_torch.models.world_model as world_model
        from dreamer4_torch.train.trainers import BehaviorCloneTrainer

        self.config, self.workload, self.device = config, workload, device
        kw = dict(config['kwargs'])
        self.kw = kw
        b, t = workload['batch'], workload['frames']
        self.b, self.t = b, t
        self.model = world_model.DynamicsWorldModel(**kw, dtype=harness.DTYPES[config['dtype']],
                                                    device=device)
        self.weights = harness.make_weights(self.model.named_parameters(), seed, device)
        harness.load_weights(self.model, self.weights)
        tr = config['trainer']
        self.trainer = BehaviorCloneTrainer(
            self.model, learning_rate=tr['learning_rate'], clip_grad_norm=tr['clip_grad_norm'],
            with_ema=tr['with_ema'], ema_decay=tr['ema_decay'], seed=workload['trainer_seed'],
            device=device)

        g = harness.generator(seed, 'batches', device)
        pool = workload['batch_pool']
        n, dl = kw['num_latent_tokens'], kw['dim_latent']
        self.latents = torch.tanh(torch.randn((pool, b, t, n, dl), generator=g, device=device))
        self.actions = torch.randint(0, kw['num_discrete_actions'][0], (pool, b, t),
                                     generator=g, device=device)
        self.rewards = torch.randn((pool, b, t), generator=g, device=device)

        # the trainer's shortcut choices, mirrored: its numpy generator draws
        # once per step, as the trainer documents
        self.prob_shortcut = 1.0 - 1.0 / math.log2(kw['max_steps'])
        self.mirror = np.random.default_rng(workload['trainer_seed'])
        self.calls = 0
        self.losses = []
        self._step_flops = {s: flops.wm_train_step_flops(kw, b, t, s) for s in (False, True)}
        # the least time of one K1, K2 and K3 call at the time attention's
        # shape, for `flash_roofline` (K1 without its LSE's bytes, the lower)
        fb = flops.flash_bounds_s(B=b * flops.wm_tokens_per_frame(kw), heads=kw['attn_heads'],
                                  n=t, dim_head=kw['attn_dim_head'], dtype=config['dtype'])
        self.bounds_s = {'flash_fwd': fb['k1'], 'bwd_dq': fb['k2'], 'bwd_dkv': fb['k3']}

        # the checked steps, with the benchmark's draws
        tape = harness.DrawTape(seed, device, b)
        original = world_model.draw
        world_model.draw = tape
        try:
            losses, flows = [], []
            for i in range(workload['check_steps']):
                tape.new_step()
                rec = self.step()
                losses.append(rec['loss'])
                flows.append(rec['flow'])
                if i == 0:
                    grads = harness.first_gradients(self.trainer.optimizer)
                    self.grad_norms = harness.leaf_norms(grads)
                    del grads
        finally:
            world_model.draw = original
        self.draws = tape.steps
        params = dict(self.model.named_parameters())
        self.change_norms = harness.leaf_norms({n: params[n] - self.weights[n] for n in params})
        self.check_losses = [float(x) for x in torch.stack(losses).tolist()]
        self.check_flows = [float(x) for x in torch.stack(flows).tolist()]
        self.losses = []

    def batch(self, i: int) -> dict:
        return {'latents': self.latents[i], 'discrete_actions': self.actions[i][..., None],
                'rewards': self.rewards[i]}

    def step(self) -> dict:
        i = self.calls % self.workload['batch_pool']
        self.calls += 1
        shortcut = bool(self.mirror.random() < self.prob_shortcut)
        loss, terms = self.trainer.train_on_batch(self.batch(i))
        self.losses.append(loss)
        return {'work': self.b * self.t, 'flops': self._step_flops[shortcut], 'loss': loss,
                'flow': terms.flow}

    def end_window(self) -> tuple[int, int]:
        """(steps attempted, steps whose loss is not finite)."""
        finite = torch.isfinite(torch.stack(self.losses)) if self.losses else None
        return len(self.losses), (0 if finite is None else int((~finite).sum()))

    def program_readings(self) -> dict:
        return {'losses': self.check_losses, 'terms': {'flow': self.check_flows},
                'grad_norms': self.grad_norms, 'change_norms': self.change_norms}

    def release_program(self):
        self.checked = [self.batch(i) for i in range(self.workload['check_steps'])]
        del self.trainer, self.model, self.losses, self.latents, self.actions, self.rewards
        harness.free_device_memory()

    def reference_readings(self, precision: str = 'float32') -> dict:
        from benchmark.reference.ops import Precision
        from benchmark.reference.world_model import WorldModel

        def loss_fn(params, i):
            model = WorldModel(params, self.config, Precision(precision))
            bt = self.checked[i]
            d = self.draws[i]
            return model.loss(bt['latents'].float(), bt['discrete_actions'][..., 0],
                              bt['rewards'].float(), d, shortcut='step_sizes_log2' in d)

        tr = self.config['trainer']
        return harness.reference_training(self.weights, loss_fn, self.workload['check_steps'],
                                          clip=tr['clip_grad_norm'], lr=tr['learning_rate'])

    def control_readings(self) -> dict:
        """The control in the program's place: the reference in fp8."""
        return self.reference_readings('fp8')

    gaps = staticmethod(harness.training_gaps)


def _half_batch():
    from dreamer4_torch.train.trainers import BehaviorCloneTrainer

    def make(original):
        def train_on_batch(self, batch):
            half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return original(self, half)
        return train_on_batch
    return harness.patched(BehaviorCloneTrainer, 'train_on_batch', make)


def _altered_prediction():
    from dreamer4_torch.models.world_model import DynamicsWorldModel

    def make(original):
        def _predict(self, *args, **kwargs):
            pred, *rest = original(self, *args, **kwargs)
            flow = pred.flow.clone()
            flow[..., 0, :] = flow[..., 0, :] + 1.0
            return (pred._replace(flow=flow), *rest)
        return _predict
    return harness.patched(DynamicsWorldModel, '_predict', make)


# faults planted under the timed path, each of which the comparison has to
# catch: the optimizer's step leaves the state unchanged; half of each batch
# is left out, the loss the mean over the rest; the first latent token's
# prediction is altered, in every frame, where the model produces it
FAULTS = {'frozen_state': harness.frozen_optimizer, 'half_batch': _half_batch,
          'altered_output': _altered_prediction}
