"""Driver of `TokenizerTrainer.train_on_batch`: video tokenizer training on
batches of clips.

Set-up builds the tokenizer, loads the benchmark's weights, builds the
trainer and drives it through the first `check_steps` steps on distinct
batches with the benchmark's draws (patch masks, flow steps, noise), which
the reference is held to; the window continues the same trainer over the
cell's pool of batches.
"""
from __future__ import annotations

import torch

from benchmark import flops, harness


class Cell:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        import dreamer4_torch.models.tokenizer as tokenizer
        from dreamer4_torch.train.trainers import TokenizerTrainer

        self.config, self.workload, self.device = config, workload, device
        kw = dict(config['kwargs'])
        self.kw = kw
        b, t = workload['batch'], workload['frames']
        self.b, self.t = b, t
        self.model = tokenizer.VideoTokenizer(**kw, dtype=harness.DTYPES[config['dtype']],
                                              device=device)
        self.weights = harness.make_weights(self.model.named_parameters(), seed, device)
        harness.load_weights(self.model, self.weights)
        tr = config['trainer']
        self.trainer = TokenizerTrainer(
            self.model, learning_rate=tr['learning_rate'], clip_grad_norm=tr['clip_grad_norm'],
            with_ema=tr['with_ema'], ema_decay=tr['ema_decay'], seed=workload['trainer_seed'],
            device=device)

        g = harness.generator(seed, 'batches', device)
        c = kw.get('channels', 3)
        self.video = torch.rand((workload['batch_pool'], b, c, t, kw['image_height'],
                                 kw['image_width']), generator=g, device=device)
        self.calls = 0
        self.losses = []
        self._step_flops = flops.tok_train_step_flops(kw, b, t)
        # the least time of one K4 and K5 call at the time attention's shape
        # (every patch and latent token of every clip), for `small_roofline`
        n = kw['patch_size']
        s = (kw['image_height'] // n) * (kw['image_width'] // n) + kw['num_latent_tokens']
        sb = flops.small_bounds_s(B=b * s, n=t, heads=kw.get('attn_heads', 8),
                                  dim_head=kw.get('attn_dim_head', 64), dtype=config['dtype'],
                                  allowed_pairs=flops.causal_pairs(t))
        self.bounds_s = {'small_fwd': sb['k4'], 'small_bwd': sb['k5']}

        tape = harness.DrawTape(seed, device, b)
        original = tokenizer.draw
        tokenizer.draw = tape
        try:
            losses = []
            for i in range(workload['check_steps']):
                tape.new_step()
                losses.append(self.step()['loss'])
                if i == 0:
                    grads = harness.first_gradients(self.trainer.optimizer)
                    self.grad_norms = harness.leaf_norms(grads)
                    del grads
        finally:
            tokenizer.draw = original
        self.draws = tape.steps
        params = dict(self.model.named_parameters())
        self.change_norms = harness.leaf_norms({n: params[n] - self.weights[n] for n in params})
        self.check_losses = [float(x) for x in torch.stack(losses).tolist()]
        self.losses = []

    def step(self) -> dict:
        i = self.calls % self.workload['batch_pool']
        self.calls += 1
        loss, _ = self.trainer.train_on_batch(self.video[i])
        self.losses.append(loss)
        return {'work': self.b * self.t, 'flops': self._step_flops, 'loss': loss}

    def end_window(self) -> tuple[int, int]:
        finite = torch.isfinite(torch.stack(self.losses)) if self.losses else None
        return len(self.losses), (0 if finite is None else int((~finite).sum()))

    def program_readings(self) -> dict:
        return {'losses': self.check_losses, 'grad_norms': self.grad_norms,
                'change_norms': self.change_norms}

    def release_program(self):
        self.checked = self.video[:self.workload['check_steps']].clone()
        del self.trainer, self.model, self.losses, self.video
        harness.free_device_memory()

    def reference_readings(self, precision: str = 'float32') -> dict:
        from benchmark.reference.ops import Precision
        from benchmark.reference.tokenizer import Tokenizer

        video = self.checked
        state = [torch.ones((), device=video.device)]

        def loss_fn(params, i):
            model = Tokenizer(params, self.config, Precision(precision))
            d = self.draws[i]
            loss, state[0] = model.loss(video[i], d, state[0])
            return loss, {}

        tr = self.config['trainer']
        return harness.reference_training(self.weights, loss_fn, self.workload['check_steps'],
                                          clip=tr['clip_grad_norm'], lr=tr['learning_rate'])

    def control_readings(self) -> dict:
        """The control in the program's place: the reference in fp8."""
        return self.reference_readings('fp8')

    gaps = staticmethod(harness.training_gaps)


def _half_batch():
    from dreamer4_torch.train.trainers import TokenizerTrainer

    def make(original):
        def train_on_batch(self, video, time_lens=None):
            return original(self, video[:video.shape[0] // 2], time_lens)
        return train_on_batch
    return harness.patched(TokenizerTrainer, 'train_on_batch', make)


def _altered_reconstruction():
    from dreamer4_torch.models.tokenizer import VideoTokenizer

    def make(original):
        def decode_step(self, *args, **kwargs):
            recon = original(self, *args, **kwargs).clone()
            p = self.patch_size
            recon[:, :, :p, :p] = 0.0
            return recon
        return decode_step
    return harness.patched(VideoTokenizer, 'decode_step', make)


# faults planted under the timed path, each of which the comparison has to
# catch: the optimizer's step leaves the state unchanged; half of each batch
# is left out, the loss the mean over the rest; the first patch of every
# frame's reconstruction is left at zero where the decoder produces it
FAULTS = {'frozen_state': harness.frozen_optimizer, 'half_batch': _half_batch,
          'altered_output': _altered_reconstruction}
