"""The world model exposed as a gym-style environment (counterpart of
`dreamer4_tpu/envs/world_model_env.py`).

Equivalent of the reference `DynamicsWorldModelWrapper` (`env.py:353-552`):
`reset()` dreams frame 0 with a fresh KV cache; `step(action)` conditions on
the action and dreams the next frame, returning
(obs, reward, terminated, truncated, info). Each frame is `num_steps`
single-frame denoise passes over the static cache, then one pass at the
last signal level that commits the frame to the cache and gives the agent
embedding, as in `models.generate`.

Every random draw goes through the module-level `draw`, so a test can
replace it to replay the counterpart's draws.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.world_model import DynamicsWorldModel


def draw(kind: str, frame: int, shape, *, generator: torch.Generator, device) -> torch.Tensor:
    """One random draw of the wrapper.

    kind: 'noise'    — normal start of frame `frame`'s denoising;
          'terminal' — uniform draw of the frame's terminal Bernoulli;
          'decode'   — normal start of the tokenizer's flow decode of the
                       frame, (b, 1, h, w, c).
    """
    if kind in ('noise', 'decode'):
        return torch.randn(shape, generator=generator, device=device)
    if kind == 'terminal':
        return torch.rand(shape, generator=generator, device=device)
    raise ValueError(f'unknown draw {kind}')


class DynamicsWorldModelWrapper:
    """Serves `model` (and `tokenizer`, whose `decode` turns each dreamed
    frame into pixels) as an environment. Runs on CUDA unless
    `device='cpu'` is given, and the models must live there. Observations
    are pixels (b, c, h, w) with a tokenizer, else latents (b, n, d); with
    `batch_size` 1, step returns a float reward and bool flags. An action is
    the discrete actions per batch row, or the continuous ones for a model
    with continuous actions only, or a (discrete, continuous) pair.

    A model with `dim_proprio` is refused: the counterpart's dream step
    never passes proprio to the model, whose forward then fails
    (`dreamer4_tpu/envs/world_model_env.py`, `dream_frame`), so there is no
    behaviour to port."""

    def __init__(self, model: DynamicsWorldModel, tokenizer=None, *, batch_size: int = 1,
                 num_steps: int = 4, max_timesteps: int = 64,
                 return_latents_obs: bool | None = None, seed: int = 0, device=None):
        if model.has_proprio:
            raise NotImplementedError(
                'DynamicsWorldModelWrapper does not take a model with dim_proprio: the '
                'counterpart\'s dream_frame (dreamer4_tpu/envs/world_model_env.py) never passes '
                'proprio to the model, whose forward asserts it')
        device = resolve_device(device)
        for name, m in (('model', model), ('tokenizer', tokenizer)):
            if m is not None and m.device != device:
                raise ValueError(f'the {name} is on {m.device}, the wrapper on {device}')
        K = model.max_steps
        if num_steps <= 0 or K % num_steps != 0:
            raise ValueError(f'num_steps {num_steps} must divide max_steps {K}')
        self.model = model
        self.tokenizer = tokenizer
        self.device = device
        self.batch_size = batch_size
        self.num_steps = num_steps
        self.max_timesteps = max_timesteps
        self.return_latents_obs = (return_latents_obs if return_latents_obs is not None
                                   else tokenizer is None)
        self.step_size = K // num_steps
        self.na_d = len([n for n in model.num_discrete_actions if n > 0])
        self.na_c = model.num_continuous_actions
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def _draw(self, kind: str, shape) -> torch.Tensor:
        return draw(kind, self._t, shape, generator=self.generator, device=self.device)

    def _dream_frame(self, prev_disc, prev_cont, prev_reward, first: bool):
        """One dreamed frame over the cache -> (latents (b, 1, n, d) in
        [-1, 1], reward (b,), terminated (b,)); commits it to the cache."""
        model, b, device = self.model, self.batch_size, self.device
        K, step_size = model.max_steps, self.step_size
        n, d_lat = model.latent_shape
        noised = self._draw('noise', (b, 1, n, d_lat))

        valid = torch.full((b, 1), 0.0 if first else 1.0, device=device)
        cond = {}
        if self.na_d > 0:
            cond['discrete_actions'] = prev_disc
        if self.na_c > 0:
            cond['continuous_actions'] = prev_cont
        if model.has_actions:
            cond['action_token_mask'] = valid
        if model.add_reward_embed_to_agent_token:
            cond['rewards'] = prev_reward
            cond['reward_token_mask'] = valid
        common = dict(cache=self.cache, latent_is_noised=True, is_training=False,
                      step_sizes=torch.full((b,), step_size, dtype=torch.long, device=device),
                      **cond)
        level = lambda v: torch.full((b, 1), v, dtype=torch.long, device=device)

        for s in range(self.num_steps):
            signal_val = s * step_size
            pred = model(latents=noised, signal_levels=level(signal_val), **common)
            flow_pred = pred.flow[:, :, 0]
            flow = ((flow_pred - noised) / (1.0 - signal_val / K) if model.pred_orig_latent
                    else flow_pred)
            noised = noised + flow * (step_size / K)
        denoised = noised.clamp(-1.0, 1.0)

        # the pass at the last signal level commits the frame to the cache
        _, (embeds, self.cache) = model(latents=denoised, signal_levels=level(K - 1),
                                        return_intermediates=True, **common)
        agent_embed = embeds.agent[:, 0, 0]
        reward = model.reward_encoder.decode(model.to_reward_pred(agent_embed)[0])
        if model.predict_terminals:
            term_logits = model.to_state_terminal_pred(denoised[:, 0].mean(dim=-2))[..., 0]
            terminated = self._draw('terminal', (b,)) < torch.sigmoid(term_logits)
        else:
            terminated = torch.zeros((b,), dtype=torch.bool, device=device)
        return denoised, reward, terminated

    def _obs(self, latents) -> np.ndarray:
        if self.return_latents_obs:
            return latents[:, 0].float().cpu().numpy()
        tok = self.tokenizer
        noise = self._draw('decode', (self.batch_size, 1, tok.image_height, tok.image_width,
                                      tok.channels))
        video = tok.decode(latents, noise=noise)            # (b, c, 1, h, w)
        return video[:, :, 0].float().cpu().numpy()

    @torch.no_grad()
    def reset(self, seed: int | None = None):
        if seed is not None:
            self.generator.manual_seed(seed)
        b = self.batch_size
        self.cache = self.model.init_cache(b, self.max_timesteps + 1)
        self._t = 0
        zero_d = torch.zeros((b, 1, max(self.na_d, 1)), dtype=torch.long, device=self.device)
        zero_c = torch.zeros((b, 1, max(self.na_c, 1)), device=self.device)
        zero_r = torch.zeros((b, 1), device=self.device)
        latents, reward, _ = self._dream_frame(zero_d, zero_c, zero_r, first=True)
        self._last_reward = reward
        return self._obs(latents), {}

    @torch.no_grad()
    def step(self, action):
        b = self.batch_size
        self._t += 1
        as_t = lambda a, dtype: torch.as_tensor(np.asarray(a).reshape(b, 1, -1), dtype=dtype,
                                                device=self.device)
        disc = torch.zeros((b, 1, max(self.na_d, 1)), dtype=torch.long, device=self.device)
        cont = torch.zeros((b, 1, max(self.na_c, 1)), device=self.device)
        if isinstance(action, tuple):
            disc, cont = as_t(action[0], torch.long), as_t(action[1], torch.float32)
        elif self.na_d > 0:
            disc = as_t(action, torch.long)
        else:
            cont = as_t(action, torch.float32)
        latents, reward, terminated = self._dream_frame(disc, cont, self._last_reward[:, None],
                                                        first=False)
        self._last_reward = reward

        obs = self._obs(latents)
        truncated = np.full((b,), self._t >= self.max_timesteps)
        reward_np = reward.float().cpu().numpy()
        terminated_np = terminated.cpu().numpy()
        if b == 1:
            return obs, float(reward_np[0]), bool(terminated_np[0]), bool(truncated[0]), {}
        return obs, reward_np, terminated_np, truncated, {}
