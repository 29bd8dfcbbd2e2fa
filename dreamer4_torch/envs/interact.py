"""Real-environment rollout (counterpart of `dreamer4_tpu/envs/interact.py`):
the host-side actor loop.

The environment steps on the host. Per frame, the observation crosses to the
device once (as float32 tensors) and the sampled action once back; on the
device, one eager step tokenizes the frame (the tokenizer's streaming encode,
or `state_to_latents` for a state vector), runs the world model over its KV
cache, and reads the value, the policy sample and its log probs off the
agent token. Continuous actions are stored in the distribution's native
range and sent to the environment rescaled to its range. With a state
prediction head and `state_entropy_bonus_weight`, the mean entropy of the
predicted Beta state is added to the environment's reward. Everything the
experience keeps per frame (latents, values, embeddings, actions, log
probs) is written in place into buffers on the device; only the
environment's rewards and episode flags live on the host.

Every random draw goes through the module-level `draw`, so a test can
replace it to replay the counterpart's draws.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np
import torch

from ..data.experience import Experience
from ..device import resolve_device
from ..models.world_model import DynamicsWorldModel
from ..nn.action_embedder import Actions
from ..ops import dists


def draw(kind: str, step: int, shape, *, generator: torch.Generator, device,
         part: int = 0, concentration=None) -> torch.Tensor:
    """One random draw of the rollout.

    kind: 'action'            — Gumbel noise of discrete action type `part`
                                at frame `step`;
          'continuous_action' — standard normal noise of the Gaussian
                                actions, or Beta draws where `concentration`
                                gives (alpha, beta).
    """
    if kind == 'action':
        return dists.gumbel(shape, generator=generator, device=device)
    if kind == 'continuous_action':
        if concentration is not None:
            return dists.beta_sample(*concentration, generator=generator)
        return torch.randn(shape, generator=generator, device=device)
    raise ValueError(f'unknown draw {kind}')


def _parse_step_out(env_step_out, batch):
    """Parse a 2- to 5-tuple `env.step` return: (obs, reward, terminated,
    truncated), the missing ones 0 / False."""
    n = len(env_step_out)
    obs = env_step_out[0]
    reward = env_step_out[1] if n >= 2 else 0.0
    terminated = env_step_out[2] if n >= 3 else np.zeros((batch,), bool)
    truncated = env_step_out[3] if n >= 4 else np.zeros((batch,), bool)
    return obs, reward, terminated, truncated


def _normalize_obs(obs):
    """An observation (or a gym `(obs, info)` pair) as a dict: an array of
    three or more dimensions is an 'image', else a 'state'."""
    if isinstance(obs, tuple):
        obs = obs[0]
    if not isinstance(obs, dict):
        obs = np.asarray(obs, np.float32)
        obs = {'image': obs} if obs.ndim >= 3 else {'state': obs}
    return obs


class EnvInteractor:
    """Rolls a (world model, tokenizer) pair out in a real environment.
    Runs on CUDA unless `device='cpu'` is given, and the models must live
    there.

    `obs_to_latents_fn(obs, tok_cache)` replaces the tokenizer: it gets the
    observation as a dict of float32 tensors on the device and returns
    (latents (b, 1, n, d), its cache). `aux_image_encoder_fn(frame)` maps
    the frame (b, c, 1, h, w) to extra latent tokens, concatenated after the
    tokenizer's (size them into the model's `num_latent_tokens`).

    A model with `dim_proprio` is refused: the counterpart's per-frame step
    never passes the observation's proprio to the model, whose forward then
    fails (`dreamer4_tpu/envs/interact.py`, `policy_step`), so there is no
    behaviour to port."""

    def __init__(self, model: DynamicsWorldModel, tokenizer=None,
                 obs_to_latents_fn: Callable | None = None,
                 aux_image_encoder_fn: Callable | None = None, device=None):
        if model.has_proprio:
            raise NotImplementedError(
                'EnvInteractor does not take a model with dim_proprio: the counterpart\'s '
                'policy_step (dreamer4_tpu/envs/interact.py) never passes proprio to the model, '
                'whose forward asserts it')
        device = resolve_device(device)
        for name, m in (('model', model), ('tokenizer', tokenizer)):
            if m is not None and m.device != device:
                raise ValueError(f'the {name} is on {m.device}, the interactor on {device}')
        self.model = model
        self.tokenizer = tokenizer
        self.obs_to_latents_fn = obs_to_latents_fn
        self.aux_image_encoder_fn = aux_image_encoder_fn
        self.device = device
        self.na_d = len(model.action_embedder.discrete_sizes)
        self.na_c = model.num_continuous_actions

    # ------------------------------------------------------------ per frame

    def obs_to_latents(self, obs: dict, tok_cache, max_time: int):
        """obs: a dict of float32 tensors on the device. -> (latents (b, 1,
        n, d), the tokenizer's cache)."""
        if self.obs_to_latents_fn is not None:
            return self.obs_to_latents_fn(obs, tok_cache)
        if 'image' in obs:
            if self.tokenizer is None and self.aux_image_encoder_fn is None:
                raise ValueError('image observations need a tokenizer or an aux image encoder')
            frame = obs['image'][:, :, None]                       # (b, c, 1, h, w)
            latents, new_cache = None, tok_cache
            if self.tokenizer is not None:
                latents, new_cache = self.tokenizer.encode(
                    frame, cache=tok_cache, max_time=max_time if tok_cache is None else None,
                    return_cache=True)
            if self.aux_image_encoder_fn is not None:
                aux = self.aux_image_encoder_fn(frame)
                latents = aux if latents is None else torch.cat([latents, aux], dim=-2)
            return latents, new_cache
        if self.model.dim_state is None:
            raise ValueError('state observations need a model with dim_state')
        return self.model.state_to_latents(obs['state'])[:, None], tok_cache

    def policy_step(self, latents, prev_disc, prev_cont, prev_reward, critic_state, cache,
                    step: int, *, first: bool, num_steps: int, agent_index: int,
                    generator: torch.Generator, sample: bool = True) -> dict:
        """One frame: the world model over its cache at the clean signal
        level, then the value (with the critic state's embedding), the state
        entropy bonus where the model has one and, with `sample`, actions
        drawn from the policy, their log probs and the continuous ones in
        the environment's range."""
        model = self.model
        b = latents.shape[0]
        device = latents.device
        valid = torch.full((b, 1), 0.0 if first else 1.0, device=device)
        kwargs = {}
        if self.na_d > 0:
            kwargs['discrete_actions'] = prev_disc
        if self.na_c > 0:
            kwargs['continuous_actions'] = prev_cont
        if model.has_actions:
            kwargs['action_token_mask'] = valid
        if model.add_reward_embed_to_agent_token:
            kwargs.update(rewards=prev_reward, reward_token_mask=valid)
        pred, (embeds, new_cache) = model(
            latents=latents, signal_levels=model.max_steps - 1,
            step_sizes=model.max_steps // num_steps, cache=cache, latent_is_noised=True,
            is_training=False, return_pred_only=True, return_intermediates=True,
            agent_index=agent_index, **kwargs)
        agent_embed = embeds.agent[:, -1, agent_index]                      # (b, dim)

        state_entropy = None
        if model.add_state_entropy_bonus and pred.state is not None:
            ent = dists.continuous_entropy(pred.state[:, -1], 'beta')
            state_entropy = ent.reshape(b, -1).mean(dim=-1)                 # (b,)

        actor_src = value_embed = agent_embed
        if model.actor_critic_latent_input:
            actor_src, value_embed = model.latent_actor_inputs(latents[:, -1])
        if model.dim_critic_state is not None and critic_state is not None:
            value_embed = value_embed + model.critic_state_embedder(critic_state)
        value = model.value_encoder.decode(model.value_head(value_embed))
        policy_embed = model.policy_head(actor_src)

        sampled_d = sampled_c = env_cont = log_probs = None
        if sample and model.has_actions:
            embedder = model.action_embedder
            rnd = lambda kind, shape, **kw: draw(kind, step, shape, generator=generator,
                                                 device=device, **kw)
            gumbels = [rnd('action', (b, size), part=j)
                       for j, size in enumerate(embedder.discrete_sizes)]
            noise = (embedder.continuous_noise(partial(rnd, 'continuous_action'), (b, self.na_c))
                     if self.na_c > 0 else None)
            sampled_d, sampled_c = embedder.sample(policy_embed, gumbels, noise)
            log_probs = embedder.log_probs(policy_embed, discrete_targets=sampled_d,
                                           continuous_targets=sampled_c, pred_head_index=0)
            if self.na_c > 0:
                env_cont = (embedder.rescale_for_env(sampled_c)
                            if embedder.target_action_range is not None else sampled_c)
        return dict(value=value, agent_embed=agent_embed, policy_embed=policy_embed,
                    sampled_d=sampled_d, sampled_c=sampled_c, env_cont=env_cont,
                    log_probs=log_probs, state_entropy=state_entropy, cache=new_cache)

    # ------------------------------------------------------------------ run

    @torch.no_grad()
    def __call__(self, env, generator: torch.Generator, seed: int | None = None,
                 num_steps: int = 4, max_timesteps: int = 16,
                 env_is_vectorized: bool | None = None, agent_index: int = 0,
                 store_agent_embed: bool = True,
                 store_old_action_unembeds: bool = True) -> Experience:
        """One rollout of up to `max_timesteps` frames, until every episode
        of the batch has ended. An episode truncated (not terminated) gets
        one more frame, the bootstrap, whose value the returns start from.
        Actions are drawn from `generator`, on the interactor's device.
        Returns an `Experience` on the device, cut to the frames run."""
        model, device = self.model, self.device
        T = max_timesteps
        if num_steps <= 0 or model.max_steps % num_steps != 0:
            raise ValueError(f'num_steps {num_steps} must divide max_steps {model.max_steps}')

        init_obs = _normalize_obs(env.reset(seed=seed) if seed is not None else env.reset())
        if env_is_vectorized is None:
            probe = init_obs.get('image', init_obs.get('state'))
            env_is_vectorized = (probe.ndim == 4) if 'image' in init_obs else (probe.ndim == 2)

        def to_device(obs):
            """The observation as float32 tensors on the device, batched:
            the one host-to-device crossing of a frame."""
            out = {}
            for k, v in obs.items():
                v = np.asarray(v, np.float32)
                out[k] = torch.tensor(v if env_is_vectorized else v[None], device=device)
            return out

        obs = to_device(init_obs)
        b = next(iter(obs.values())).shape[0]

        n, d_lat = model.latent_shape
        na, na_c = max(self.na_d, 1), max(self.na_c, 1)
        f32 = dict(dtype=torch.float32, device=device)
        latents_buf = torch.zeros((b, T + 1, n, d_lat), **f32)
        values_buf = torch.zeros((b, T + 1), **f32)
        disc_buf = torch.zeros((b, T + 1, na), dtype=torch.long, device=device)
        d_lp_buf = torch.zeros((b, T + 1, na), **f32)
        cont_buf = torch.zeros((b, T + 1, na_c), **f32)
        c_lp_buf = torch.zeros((b, T + 1, na_c), **f32)
        agent_embed_buf = torch.zeros((b, T + 1, model.dim), **f32)
        policy_embed_buf = torch.zeros((b, T + 1, model.dim * 4), **f32)
        critic_state_buf = (torch.zeros((b, T + 1, model.dim_critic_state), **f32)
                            if model.dim_critic_state is not None else None)
        video_frames = []
        # the environment's side, on the host
        rewards_buf = np.zeros((b, T + 1), np.float32)
        is_terminated = np.zeros((b,), bool)
        is_truncated = np.zeros((b,), bool)
        done = np.zeros((b,), bool)
        episode_lens = np.zeros((b,), np.int64)

        cache = model.init_cache(b, T + 1)
        tok_cache = None
        prev_disc = torch.zeros((b, 1, na), dtype=torch.long, device=device)
        prev_cont = torch.zeros((b, 1, na_c), **f32)
        prev_reward = torch.zeros((b, 1), **f32)

        def record_obs(i, obs, latents):
            latents_buf[:, i] = latents[:, 0]
            if critic_state_buf is not None and 'state' in obs:
                critic_state_buf[:, i] = obs['state']

        def critic_state_of(obs):
            return obs['state'] if 'state' in obs and model.dim_critic_state is not None else None

        step_kw = dict(num_steps=num_steps, agent_index=agent_index, generator=generator)
        step_idx = 0
        while not done.all() and step_idx < T:
            latents, tok_cache = self.obs_to_latents(obs, tok_cache, max_time=T + 1)
            record_obs(step_idx, obs, latents)
            if 'image' in obs:
                video_frames.append(obs['image'])

            out = self.policy_step(latents, prev_disc, prev_cont, prev_reward,
                                   critic_state_of(obs), cache, step_idx, first=step_idx == 0,
                                   **step_kw)
            cache = out['cache']
            values_buf[:, step_idx] = out['value']
            agent_embed_buf[:, step_idx] = out['agent_embed']
            policy_embed_buf[:, step_idx] = out['policy_embed']

            # the device-to-host crossing: the sampled actions, a
            # (discrete, continuous) pair where the model has both
            env_action = None
            if self.na_d > 0:
                disc_buf[:, step_idx] = out['sampled_d']
                d_lp_buf[:, step_idx] = out['log_probs'].discrete
                env_action = out['sampled_d'].cpu().numpy()
            if self.na_c > 0:
                cont_buf[:, step_idx] = out['sampled_c']
                c_lp_buf[:, step_idx] = out['log_probs'].continuous
                env_cont = out['env_cont'].cpu().numpy()
                env_action = env_cont if env_action is None else (env_action, env_cont)
            if not env_is_vectorized and env_action is not None:
                env_action = (tuple(a[0] for a in env_action) if isinstance(env_action, tuple)
                              else env_action[0])
                if self.na_d == 1 and self.na_c == 0:
                    env_action = int(env_action.reshape(-1)[0])

            next_obs, reward, terminated, truncated = _parse_step_out(env.step(env_action), b)
            reward = np.asarray(reward, np.float32).reshape(b)
            if out['state_entropy'] is not None:
                reward = reward + (out['state_entropy'].cpu().numpy().reshape(b)
                                   * model.state_entropy_bonus_weight)
            terminated = np.asarray(terminated).reshape(b).astype(bool)
            truncated = np.asarray(truncated).reshape(b).astype(bool)

            episode_lens = np.where(done, episode_lens, episode_lens + 1)
            is_terminated |= terminated & ~done
            is_truncated |= truncated & ~done
            if step_idx + 1 >= max_timesteps:
                is_truncated |= ~is_terminated
            done |= is_terminated | is_truncated
            rewards_buf[:, step_idx] = reward

            if model.add_reward_embed_to_agent_token:
                prev_reward = torch.tensor(rewards_buf[:, step_idx:step_idx + 1], device=device)
            if self.na_d > 0:
                prev_disc = disc_buf[:, step_idx:step_idx + 1]
            if self.na_c > 0:
                prev_cont = cont_buf[:, step_idx:step_idx + 1]
            obs = to_device(_normalize_obs(next_obs))
            step_idx += 1

        # the bootstrap frame of truncated, not terminated, episodes: its
        # value only (its action is never taken, so none is drawn)
        need_bootstrap = is_truncated & ~is_terminated
        time_dim = step_idx
        if need_bootstrap.any():
            latents, tok_cache = self.obs_to_latents(obs, tok_cache, max_time=T + 1)
            out = self.policy_step(latents, prev_disc, prev_cont, prev_reward,
                                   critic_state_of(obs), cache, step_idx, first=False,
                                   sample=False, **step_kw)
            record_obs(step_idx, obs, latents)
            values_buf[:, step_idx] = out['value']
            agent_embed_buf[:, step_idx] = out['agent_embed']
            policy_embed_buf[:, step_idx] = out['policy_embed']
            episode_lens = np.where(need_bootstrap, episode_lens + 1, episode_lens)
            time_dim = step_idx + 1

        step_mask = np.arange(time_dim)[None, :] < episode_lens[:, None]
        episode_return = (rewards_buf[:, :time_dim] * step_mask).sum(axis=1)

        def cut(x):
            return None if x is None else x[:, :time_dim]

        old_action_unembeds = None
        if store_old_action_unembeds and model.has_actions:
            old_action_unembeds = model.action_embedder.unembed(cut(policy_embed_buf),
                                                                pred_head_index=0)
        video = torch.stack(video_frames, dim=2)[:, :, :time_dim] if video_frames else None
        host = lambda x: torch.tensor(x, device=device)
        pick = lambda d, c: Actions(cut(d) if self.na_d > 0 else None,
                                    cut(c) if self.na_c > 0 else None)
        return Experience(
            latents=cut(latents_buf),
            video=video,
            critic_state=cut(critic_state_buf),
            rewards=host(rewards_buf[:, :time_dim]),
            actions=pick(disc_buf, cont_buf),
            log_probs=pick(d_lp_buf, c_lp_buf),
            values=cut(values_buf),
            agent_embed=cut(agent_embed_buf) if store_agent_embed else None,
            old_action_unembeds=old_action_unembeds,
            step_size=model.max_steps // num_steps,
            agent_index=agent_index,
            is_truncated=host(is_truncated),
            terminals=host(is_terminated),
            lens=host(episode_lens),
            is_from_world_model=False,
            episode_return=host(episode_return),
        )


def interact_with_env(model: DynamicsWorldModel, env, generator: torch.Generator,
                      tokenizer=None, device=None, **kwargs) -> Experience:
    """One rollout through a fresh `EnvInteractor` (hold one for repeated
    rollouts)."""
    return EnvInteractor(model, tokenizer=tokenizer, device=device)(env, generator, **kwargs)
