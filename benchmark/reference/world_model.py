"""The dynamics world model plainly: its per-frame tokens, the prediction of
a frame's clean latents, and the training loss of one batch.

A frame is 1 flow token (the signal level's and the step size's embeddings
side by side), the spatial tokens (one linear map of each latent token), the
register tokens, the action token (the previous action's embedding plus a
learned one; zeros before the first action) and the agent token, the special
token. The trunk's spatial outputs, RMS-normed, map back to the latents.

The loss (diffusion forcing with shortcut flow): the latents are noised to
per-frame signal levels; the flow loss is the ramp-weighted squared error of
the predicted clean latents. A shortcut step (step size 2^k, k >= 1) also
fits the prediction to the mean of two half steps of the model itself taken
without gradient, in velocity space weighted by (1 - t)^2. The agent token
predicts the next `mtp` rewards (cross-entropy against an HL-Gauss histogram,
one RMS-normed linear head each) and, through the policy MLP and the action
unembedding, the next `mtp` actions (negative log likelihood). Each mean runs
over every position, the ones past the sequence's end counting as zeros.
"""
from __future__ import annotations

import math

import torch

from .ops import Precision, linear, rmsnorm, silu_mlp
from .trunk import Trunk


class WorldModel:
    def __init__(self, P: dict, cfg: dict, prec: Precision):
        self.P, self.prec = P, prec
        k = cfg['kwargs']
        self.dim, self.dim_latent = k['dim'], k['dim_latent']
        self.n_latent, self.n_spatial = k['num_latent_tokens'], k['num_spatial_tokens']
        if self.n_latent != self.n_spatial:
            raise ValueError('the reference maps each latent token to one spatial token')
        self.n_registers = k['num_register_tokens']
        self.max_steps = k['max_steps']
        self.mtp = k['multi_token_pred_len']
        self.num_actions = k['num_discrete_actions']
        if len(self.num_actions) != 1:
            raise ValueError('the reference takes one discrete action type')
        self.trunk = Trunk(P, 'transformer.', depth=k['depth'], heads=k['attn_heads'],
                           time_every=k['time_block_every'], num_special=1, final_norm=False,
                           prec=prec)
        self.reward_range = (-20.0, 20.0)
        self.reward_bins = 255

    # ----------------------------------------------------------- pieces

    def action_tokens(self, prev_actions, valid):
        """prev_actions (b, t) ints, the action taken before each frame;
        valid (b, t) 0 where a frame has none -> (b, t, dim)."""
        P = self.P
        emb = P['action_embedder.discrete_action_embed.weight'][prev_actions]
        return (emb + P['action_learned_embed'][0]) * valid[..., None]

    def predict(self, noised, signal, step_log2, action_tok):
        """noised (b, t, n, dl), signal (b, t) and step_log2 (b,) ints,
        action_tok (b, t, dim) -> (predicted clean latents (b, t, n, dl),
        trunk output (b, t, s, dim))."""
        P, prec = self.P, self.prec
        b, t = noised.shape[:2]
        d = self.dim
        space = linear(prec, noised, P['latents_to_spatial_tokens.weight'],
                       P['latents_to_spatial_tokens.bias'])
        flow_tok = torch.cat([P['signal_levels_embed.weight'][signal],
                              P['step_size_embed.weight'][step_log2][:, None].expand(b, t, d // 2)],
                             dim=-1)
        tokens = torch.cat([
            flow_tok[:, :, None], space,
            P['register_tokens'].expand(b, t, self.n_registers, d),
            action_tok[:, :, None],
            P['agent_learned_embed'].expand(b, t, 1, d)], dim=2)
        out = self.trunk(tokens)
        h = rmsnorm(out[:, :, 1:1 + self.n_spatial], P['latent_pred_norm.scale'])
        return linear(prec, h, P['to_latent_pred.weight']), out

    def reward_logits(self, agent):
        """agent (..., dim) -> (mtp, ..., bins)."""
        P = self.P
        x = agent * torch.rsqrt(agent.square().mean(dim=-1, keepdim=True) + 1e-6)
        x = x[None] * P['to_reward_pred.norm_scale'].reshape(self.mtp, *(1,) * (agent.ndim - 1), -1)
        lead = x.shape[1:-1]
        out = self.prec.mm(x.reshape(self.mtp, -1, self.dim), P['to_reward_pred.kernel'])
        return out.reshape(self.mtp, *lead, -1)

    def policy_logits(self, agent):
        """agent (..., dim) -> (mtp, ..., num_actions)."""
        e = silu_mlp(self.prec, self.P, 'policy_head.', agent, 4, rmsnorm_in=True)
        w = self.P['action_embedder.discrete_action_unembed']       # (na, mtp, 4 dim)
        out = self.prec.mm(e.reshape(-1, e.shape[-1]), w.reshape(w.shape[0] * self.mtp, -1).t())
        out = out.reshape(*e.shape[:-1], w.shape[0], self.mtp)
        return out.movedim(-1, 0)

    def hl_gauss(self, values):
        lo, hi = self.reward_range
        support = torch.linspace(lo, hi, self.reward_bins + 1, device=values.device)
        sigma = 2.0 * (hi - lo) / self.reward_bins
        cdf = 0.5 * (1.0 + torch.erf((support - values.clamp(lo, hi)[..., None])
                                     / sigma / math.sqrt(2.0)))
        z = (cdf[..., -1] - cdf[..., 0]).clamp_min(1e-10)
        return (cdf[..., 1:] - cdf[..., :-1]) / z[..., None]

    # ------------------------------------------------------------ loss

    def loss(self, latents, actions, rewards, draws: dict, shortcut: bool):
        """latents (b, t, n, dl), actions (b, t) ints, rewards (b, t); draws:
        'signal_levels' (b, t), 'noise' like latents and, for a shortcut
        step, 'step_sizes_log2' (b,). -> (the total loss, {'flow': the flow
        term})."""
        b, t = latents.shape[:2]
        K = self.max_steps
        signal = draws['signal_levels']
        if shortcut:
            step_log2 = draws['step_sizes_log2']
            steps = (2 ** step_log2)[:, None]
            signal = signal // steps * steps
        else:
            step_log2 = torch.zeros(b, dtype=torch.long, device=latents.device)
        times = signal.float() / K
        noise = draws['noise'].reshape(latents.shape)
        noised = noise + (latents - noise) * times[..., None, None]

        prev = torch.cat([torch.zeros_like(actions[:, :1]), actions[:, :-1]], dim=1)
        valid = torch.ones((b, t), device=latents.device)
        valid[:, 0] = 0.0
        action_tok = self.action_tokens(prev, valid)

        pred, out = self.predict(noised, signal, step_log2, action_tok)
        flow = ((pred - latents).square().reshape(b, t, -1)
                * (0.9 * times + 0.1)[..., None]).mean()
        total = flow

        if shortcut:
            half_log2 = step_log2 - 1
            half = (2 ** half_log2).float()
            t1 = times[..., None, None]
            with torch.no_grad():
                p1, _ = self.predict(noised, signal, half_log2, action_tok)
                f1 = (p1 - noised) / (1.0 - t1)
                mid = noised + f1 * (half[:, None, None, None] / K)
                signal2 = signal + (2 ** half_log2)[:, None]
                p2, _ = self.predict(mid, signal2, half_log2, action_tok)
                f2 = (p2 - mid) / (1.0 - (signal2.float() / K)[..., None, None])
                target = (f1 + f2) / 2.0
            v = (pred - noised) / (1.0 - t1)
            total = total + ((v - target).square() * (1.0 - t1).square()).mean()

        agent = out[:, :, -1]                                               # (b, t, dim)
        # rewards: position i predicts the rewards of frames i+1 .. i+mtp
        logp = torch.log_softmax(self.reward_logits(agent[:, :-1]), dim=-1)
        enc = self.hl_gauss(rewards[:, 1:])
        for k in range(self.mtp):
            n_valid = t - 1 - k
            if n_valid <= 0:
                continue
            ce = -(enc[:, k:] * logp[k, :, :n_valid]).sum(dim=-1)
            total = total + ce.sum() / (b * (t - 1))
        # actions: position i predicts the actions taken at i .. i+mtp-1
        logp = torch.log_softmax(self.policy_logits(agent), dim=-1)   # (mtp, b, t, na)
        for k in range(self.mtp):
            n_valid = t - k
            if n_valid <= 0:
                continue
            lp = logp[k, :, :n_valid].gather(-1, actions[:, k:, None])[..., 0]
            total = total - lp.sum() / (b * t)
        return total, {'flow': flow}

    # -------------------------------------------------------- imagination

    def rollout_readings(self, prompt_latents, prompt_actions, context_noise, frame_noise,
                         served_latents, served_actions, num_steps: int,
                         context_signal_noise: float = 0.1):
        """The reference's reading of served rollouts, teacher-forced on what
        was served: for each dreamed frame i, the frames before it (the
        prompt noised by `context_noise`, then the served frames, all at the
        clean signal level, each with the action before it), the frame's own
        Euler denoising from `frame_noise[i]` over `num_steps` steps, and the
        clean pass over the served frame i, whose agent token gives the
        policy's logits (its first prediction head).

        prompt_latents (S, P, n, dl), prompt_actions (S, P), context_noise
        like prompt_latents, frame_noise (S, F, n, dl) for the F dreamed
        frames, served_latents (S, P + F, n, dl), served_actions (S, P + F)
        -> (denoised latents (S, F, n, dl), logits (S, F, num_actions))."""
        S, P = prompt_latents.shape[:2]
        F = frame_noise.shape[1]
        K = self.max_steps
        step = K // num_steps
        step_log2 = torch.full((S,), int(round(math.log2(step))), device=prompt_latents.device)
        noised_prompt = prompt_latents + (context_noise - prompt_latents) * context_signal_noise
        history = torch.cat([noised_prompt, served_latents[:, P:]], dim=1)
        prev = torch.cat([torch.zeros_like(served_actions[:, :1]), served_actions[:, :-1]], dim=1)
        valid = torch.ones(prev.shape, device=prev.device)
        valid[:, 0] = 0.0
        action_tok = self.action_tokens(prev, valid)
        clean = torch.full((S, P + F), K - 1, dtype=torch.long, device=prev.device)
        denoised, logits = [], []
        for f in range(F):
            i = P + f
            x = frame_noise[:, f:f + 1]
            for s in range(num_steps):
                sig = clean[:, :i + 1].clone()
                sig[:, i] = s * step
                pred, _ = self.predict(torch.cat([history[:, :i], x], dim=1), sig, step_log2,
                                       action_tok[:, :i + 1])
                x = x + (pred[:, i:] - x) / (1.0 - s * step / K) * (step / K)
            denoised.append(x[:, 0])
            _, out = self.predict(history[:, :i + 1], clean[:, :i + 1], step_log2,
                                  action_tok[:, :i + 1])
            logits.append(self.policy_logits(out[:, i, -1])[0])
        return torch.stack(denoised, dim=1), torch.stack(logits, dim=1)
