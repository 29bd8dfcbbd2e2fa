"""Driver of `models/generate.py` `generate`: imagination rollouts of the
world model from prompts, as an agent's learner asks for them.

Set-up builds the model, loads the benchmark's weights, makes the prompts
(latents in the tokenizer's tanh range and the actions that led to them)
and runs one rollout, which compiles and warms every shape. Each call of the
window is one rollout of every row: the prompt pass into the KV caches, then
per dreamed frame the denoising steps, the clean pass and the sampled action.
The rollout's draws come from a generator the benchmark seeds and passes in;
the draws of the latest rollout are kept by reference for the check.
"""
from __future__ import annotations

import contextlib

import torch

from benchmark import flops, harness


class _Recorder:
    """The rollout's `draw`, passed through, with the latest rollout's draws
    kept by reference (no copy inside the window)."""

    def __init__(self, original):
        self.original = original
        self.draws = {}

    def __call__(self, kind, frame, shape, **kw):
        t = self.original(kind, frame, shape, **kw)
        self.draws[(kind, frame, kw.get('part', 0))] = t
        return t


class Cell:
    def __init__(self, config: dict, workload: dict, seed: int, device):
        import dreamer4_torch.models.generate as gen_module
        from dreamer4_torch.models.world_model import DynamicsWorldModel

        self.config, self.workload, self.device, self.seed = config, workload, device, seed
        kw = dict(config['kwargs'])
        self.kw = kw
        self.b, self.P, self.T = workload['batch'], workload['prompt_frames'], workload['time_steps']
        self.num_steps = workload['num_steps']
        self.model = DynamicsWorldModel(**kw, dtype=harness.DTYPES[config['dtype']], device=device)
        self.weights = harness.make_weights(self.model.named_parameters(), seed, device)
        harness.load_weights(self.model, self.weights)
        g = harness.generator(seed, 'prompts', device)
        n, dl = kw['num_latent_tokens'], kw['dim_latent']
        self.prompt_latents = torch.tanh(torch.randn((self.b, self.P, n, dl), generator=g,
                                                     device=device))
        self.prompt_actions = torch.randint(0, kw['num_discrete_actions'][0],
                                            (self.b, self.P, 1), generator=g, device=device)
        self.gen = harness.generator(seed, 'rollouts', device)
        self.generate = gen_module.generate
        self.recorder = _Recorder(gen_module.draw)
        self.gen_module = gen_module
        self._flops = flops.wm_rollout_flops(kw, self.b, self.P, self.T, self.num_steps)
        self.rollouts = 0
        self.last = None
        self.step()

    def step(self) -> dict:
        self.recorder.draws = {}
        original = self.gen_module.draw
        self.gen_module.draw = self.recorder
        try:
            self.last = self.generate(
                self.model, self.gen, time_steps=self.T, num_steps=self.num_steps,
                batch_size=self.b, prompt_latents=self.prompt_latents,
                prompt_discrete_actions=self.prompt_actions)
        finally:
            self.gen_module.draw = original
        self.rollouts += 1
        frames = self.T - self.P
        return {'work': frames * self.b, 'frames': frames, 'flops': self._flops}

    def end_window(self) -> tuple[int, int]:
        """(rollouts attempted less the set-up's, rollouts with a non-finite
        dreamed latent: checked on the latest)."""
        bad = int(not bool(torch.isfinite(self.last.latents).all()))
        return self.rollouts - 1, bad

    def program_readings(self) -> dict:
        """The sampled rows of the latest rollout, and its draws for them."""
        g = harness.generator(self.seed, 'check_rows', 'cpu')
        rows = torch.randperm(self.b, generator=g)[:self.workload['check_rows']].to(self.device)
        d = self.recorder.draws
        F = self.T - self.P
        exp = self.last
        self._readings = {
            'rows': rows,
            'prompt_latents': self.prompt_latents[rows].float(),
            'prompt_actions': self.prompt_actions[rows, :, 0],
            'context_noise': d[('context_noise', 0, 0)][rows, :, 0],
            'frame_noise': torch.stack([d[('noise', self.P + f, 0)][rows, 0, 0]
                                        for f in range(F)], dim=1),
            'gumbels': torch.stack([d[('action', self.P + f, 0)][rows] for f in range(F)], dim=1),
            'latents': exp.latents[rows].float(),
            'logits': exp.old_action_unembeds[0][0][rows, self.P:].float(),
            'actions': exp.actions.discrete[rows, :, 0],
        }
        return self._readings

    def release_program(self):
        del self.model, self.last, self.prompt_latents, self.prompt_actions
        self.recorder.draws = {}
        harness.free_device_memory()

    def reference_readings(self, precision: str = 'float32') -> dict:
        """The reference's reading of the served rows: its denoised frames
        and policy logits, teacher-forced on what the program served."""
        from benchmark.reference.ops import Precision, float32_matmuls
        from benchmark.reference.world_model import WorldModel

        prog = self._readings
        model = WorldModel(self.weights, self.config, Precision(precision))
        with torch.no_grad(), float32_matmuls():
            denoised, logits = model.rollout_readings(
                prog['prompt_latents'], prog['prompt_actions'], prog['context_noise'],
                prog['frame_noise'], prog['latents'], prog['actions'], self.num_steps)
        return {'latents': denoised.clamp(-1.0, 1.0), 'logits': logits}

    def control_readings(self) -> dict:
        """The control in the program's place: the reference in fp8, its
        frames, its logits and its own choice of each action under the same
        noise, on the same served history."""
        ref = self.reference_readings('fp8')
        prog = self._readings
        P = self.P
        actions = prog['actions'].clone()
        actions[:, P:] = (ref['logits'] + prog['gumbels']).argmax(dim=-1)
        latents = prog['latents'].clone()
        latents[:, P:] = ref['latents']
        return {**prog, 'latents': latents, 'logits': ref['logits'], 'actions': actions}

    def gaps(self, prog: dict, ref: dict) -> dict:
        """- latent_err: over the sampled rows' dreamed frames, the worst
          relative L2 distance between a served frame and the reference's;
        - logit_err: the distance between the served policy logits (the
          first prediction head, as the rollout samples from it) of every
          sampled row and dreamed frame and the reference's, relative (L2);
        - action_gap: the widest gap by which a served action's logit, with
          the rollout's Gumbel noise added, lies below the best served logit
          so perturbed: the sampling rule itself, exact (0 when every
          action is the Gumbel-max choice of the served logits)."""
        P = self.P
        served = prog['latents'][:, P:]
        diff = (served - ref['latents']).flatten(2).norm(dim=-1)
        latent_err = (diff / ref['latents'].flatten(2).norm(dim=-1).clamp_min(1e-12)).max()
        logit_err = (prog['logits'] - ref['logits']).norm() / ref['logits'].norm()
        perturbed = prog['logits'] + prog['gumbels']
        chosen = perturbed.gather(-1, prog['actions'][:, P:, None])[..., 0]
        action_gap = (perturbed.max(dim=-1).values - chosen).max()
        return {'latent_err': float(latent_err), 'logit_err': float(logit_err),
                'action_gap': float(action_gap)}


@contextlib.contextmanager
def _frozen_denoise():
    """Every denoising step returns its state unchanged: the prediction of a
    cached noised frame is the frame itself, so the Euler step moves
    nothing."""
    from dreamer4_torch.models.world_model import DynamicsWorldModel

    def make(original):
        def forward(self, *args, **kwargs):
            out = original(self, *args, **kwargs)
            sig = kwargs.get('signal_levels')
            if (kwargs.get('cache') is not None and not kwargs.get('return_intermediates')
                    and torch.is_tensor(sig) and int(sig.max()) < self.max_steps - 1):
                return out._replace(flow=kwargs['latents'].to(out.flow.dtype))
            return out
        return forward
    with harness.patched(DynamicsWorldModel, 'forward', make):
        yield


@contextlib.contextmanager
def _altered_action():
    """Every sampled action is replaced by the next one where the action
    embedder produces it."""
    from dreamer4_torch.nn.action_embedder import ActionEmbedder

    def make(original):
        def sample(self, *args, **kwargs):
            d, c = original(self, *args, **kwargs)
            return (d + 1) % self.discrete_sizes[0], c
        return sample
    with harness.patched(ActionEmbedder, 'sample', make):
        yield


# faults planted under the timed path, each of which the comparison has to
# catch: a denoising step returns its state unchanged; a sampled action is
# altered where it is produced
FAULTS = {'frozen_state': _frozen_denoise, 'altered_output': _altered_action}
