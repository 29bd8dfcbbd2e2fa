"""CartPole learned PURELY IN IMAGINATION — the Dreamer loop (counterpart of
`examples/train_cartpole_dream_rl.py`).

The policy is never updated on real experience: real CartPole rollouts (with
the current policy) only feed world-model training; all policy/value-head
updates come from PPO on dreamed rollouts (`generate` -> heads-only RL
updates through `DreamTrainer`). Real-env returns are the *evaluation*,
not a training signal. The terminal-head calibration
(`--terminal-logit-offset`, `--min-dream-length`) passes through to
`generate`.

The world-model optimizer trains everything EXCEPT the policy/value heads
(`common.WorldModelUpdates`: those are in no optimizer group, so neither
decay nor Muon nor an EMA moves them) — they belong to dream RL alone,
otherwise the WM's behavior-cloning action loss drags the policy back
toward the replayed behavior every iteration. The model is one module,
shared by the world-model updates, `DreamTrainer` and the interactor, so
no weights are copied between them.

Success bar: the dream-trained policy measurably beats the random-policy
baseline (~20-25 return) on real CartPole; the reference online-RL gate is
70.

Streams (JAX -> here): the initial weights, `PRNGKey(seed)` -> the global
generator seeded with `--seed` inside `common.seeded_init`; iteration
`it`'s rollout, `fold_in(PRNGKey(seed), it)` -> `stream(seed, it)`; the
dream updates' `fold_in(fold_in(key, it), 1000 + u)` -> `DreamTrainer(
seed=--seed)`'s generator in turn; the world-model steps' split chain of
`PRNGKey(seed + 7)` -> one generator `stream(seed + 7)` in turn; the
probe's `fold_in(key, 999_000 + it)`, shared by its three forced dreams ->
`stream(seed, 999_000 + it)`, fresh for each; the replay, prompt and
shortcut draws from numpy `default_rng(seed)` as in the JAX recipe.
`--cpu` becomes `--device`.

Usage: python -m dreamer4_torch.examples.train_cartpole_dream_rl --target-return 70
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..envs.interact import EnvInteractor
from ..models.generate import generate
from ..models.world_model import DynamicsWorldModel
from ..train.checkpoint import save_model
from ..train.logging import MetricLogger
from ..train.trainers import DreamTrainer
from .common import (WorldModelUpdates, experience_item, prompt_window, seeded_init, stream,
                     to_batch)
from .train_cartpole_with_dynamics_rl import GymnasiumVectorAdapter


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--target-return', type=float, default=70.0)
    p.add_argument('--max-timesteps', type=int, default=150)
    p.add_argument('--max-iterations', type=int, default=200)
    p.add_argument('--objective', choices=('ppo', 'pmpo', 'spo'), default='ppo')
    p.add_argument('--dim', type=int, default=64)
    p.add_argument('--depth', type=int, default=2)
    p.add_argument('--n-envs', type=int, default=16)
    p.add_argument('--wm-lr', type=float, default=3e-4)
    p.add_argument('--policy-lr', type=float, default=3e-4)
    p.add_argument('--value-lr', type=float, default=3e-4)
    p.add_argument('--wm-updates-per-iter', type=int, default=8)
    p.add_argument('--dream-updates-per-iter', type=int, default=4)
    p.add_argument('--freeze-wm-after', type=int, default=0,
                   help='if >0, stop world-model training after this many '
                        'iterations and multiply dream updates by '
                        '--frozen-dream-mult: pure dream-RL against a FIXED '
                        'world model (removes the moving-representation '
                        'problem of heads-only RL under a trunk that keeps '
                        'training)')
    p.add_argument('--frozen-dream-mult', type=int, default=4)
    p.add_argument('--wm-refresh-every', type=int, default=0,
                   help='during the frozen phase, every K iterations run a '
                        'burst of WM updates on fresh replay (and re-sync '
                        'the dream model) — the iterated Dyna scheme: the '
                        'policy improves against a fixed WM, then the WM '
                        'catches up to the states the better policy reaches')
    p.add_argument('--wm-refresh-updates', type=int, default=32)
    p.add_argument('--warmup-iters', type=int, default=5,
                   help='iterations of WM-only training before dream RL starts')
    p.add_argument('--dream-batch', type=int, default=32)
    p.add_argument('--dream-timesteps', type=int, default=17,
                   help='16 learnable + 1 bootstrap frame (reference DreamTrainer)')
    p.add_argument('--num-denoise-steps', type=int, default=4)
    p.add_argument('--prompt-len', type=int, default=3)
    p.add_argument('--hard-terminals', action='store_true',
                   help='Bernoulli-cut dreams at sampled terminals instead of '
                        'soft continuation discounting (DreamerV3-style, the '
                        'default: dreams run full length, GAE discount is '
                        'scaled by 1 - p_terminal each frame)')
    p.add_argument('--terminal-logit-offset', type=float, default=0.0)
    p.add_argument('--min-dream-length', type=int, default=0)
    p.add_argument('--entropy-weight', type=float, default=0.01)
    p.add_argument('--ppo-epochs', type=int, default=2,
                   help='PPO updates per dream (generate dominates cost; the '
                        'clip objective handles the off-policy drift)')
    p.add_argument('--diag-every', type=int, default=25,
                   help='every N iters, probe WM action-sensitivity: dream '
                        'with forced constant-left/right vs alternating '
                        'actions from one prompt and compare mean p_term — '
                        'if these match, the WM carries no action signal and '
                        'policy learning cannot work')
    p.add_argument('--replay-iters', type=int, default=20,
                   help='how many recent collection iterations stay in replay')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--window', type=int, default=20)
    p.add_argument('--no-state-pred', action='store_true',
                   help='disable the action-conditioned next-latent '
                        'prediction heads. These matter: the flow loss alone '
                        'lets the WM average over actions (measured: flow '
                        'action-sensitivity collapses 0.045->0.009 in 250 '
                        'steps), and an action-blind WM gives dream-RL a '
                        'pure-noise policy gradient')
    p.add_argument('--state-pred-frac-grad', type=float, default=0.5)
    p.add_argument('--no-action-inject', action='store_true',
                   help='disable add_action_embed_to_spatial (measured 10x '
                        'stronger flow action-sensitivity through early '
                        'training when on)')
    p.add_argument('--latent-actor', action='store_true',
                   help='actor_critic_latent_input: policy/value read the '
                        '(stable) latents through RL-owned encoders instead '
                        'of the trunk agent embeds — immune to the '
                        'representation drift that reset the policy every '
                        'time the WM trained (runs v3/v5)')
    p.add_argument('--log-dir', type=str, default='',
                   help='if set, write metrics.jsonl (+TB) learning curves '
                        'via MetricLogger')
    p.add_argument('--save-dir', type=str, default='',
                   help='if set, save the final WM+policy checkpoint there')
    p.add_argument('--device', type=str, default=None,
                   help='torch device (default: the CUDA card; "cpu" runs on the CPU)')
    return p.parse_args(argv)


def build_model(args, env, device, **overrides) -> DynamicsWorldModel:
    """The recipe's world model (examples/train_cartpole_dream_rl.py:136-159),
    its weights from `args.seed`."""
    kwargs = dict(
        dim=args.dim,
        dim_latent=16,
        num_latent_tokens=4,
        num_spatial_tokens=4,
        max_steps=16,
        depth=args.depth,
        time_block_every=2,
        attn_heads=4,
        attn_dim_head=16,
        num_discrete_actions=(env.num_actions,),
        multi_token_pred_len=4,
        num_register_tokens=4,
        dim_state=env.dim_state,
        actor_critic_latent_input=args.latent_actor,
        add_action_embed_to_spatial=not args.no_action_inject,
        add_state_pred_head=not args.no_state_pred,
        agent_predicts_state=not args.no_state_pred,
        agent_predicts_state_frac_gradient=args.state_pred_frac_grad,
        predict_terminals=True,
        policy_entropy_weight=args.entropy_weight,
        keep_reward_ema_stats=True,
        reward_range=(-args.max_timesteps * 1.2, args.max_timesteps * 1.2),
    )
    with seeded_init(args.seed, device):
        return DynamicsWorldModel(**{**kwargs, **overrides}, device=device)


def train(args, env, device) -> int:
    """The Dreamer loop until the gate or `--max-iterations`; 0 when the
    window average of real returns reaches `--target-return`, else 1."""
    model = build_model(args, env, device)
    rng = np.random.default_rng(args.seed)
    wm_updates = WorldModelUpdates(model, args.wm_lr, stream(args.seed + 7, device=device), rng)

    # --- replay of real experience (host side, one padded shape)
    replay: list[dict] = []
    T_fixed = args.max_timesteps + 1

    def add_to_replay(exp):
        replay.append(experience_item(exp, T_fixed))
        if len(replay) > args.replay_iters:
            replay.pop(0)

    def sample_wm_batch():
        return to_batch(replay[rng.integers(len(replay))], device)

    # prompts: random real-latent windows anchor the dreams in-distribution
    prompt_len = args.prompt_len

    def prompt_fn(generator):
        return prompt_window(replay[rng.integers(len(replay))], args.dream_batch,
                             prompt_len, rng, device)

    dream_trainer = DreamTrainer(
        model,
        time_steps=args.dream_timesteps,
        num_steps=args.num_denoise_steps,
        batch_size=args.dream_batch,
        objective=args.objective,
        policy_lr=args.policy_lr, value_lr=args.value_lr,
        update_epochs=args.ppo_epochs,
        prompt_fn=prompt_fn,
        generate_kwargs=dict(
            hard_terminals=args.hard_terminals,
            terminal_logit_offset=args.terminal_logit_offset,
            min_dream_length=args.min_dream_length,
        ),
        seed=args.seed, device=device)

    interactor = EnvInteractor(model, device=device)

    # --- WM action-sensitivity probe: same prompt + draws, three forced
    # action policies; if mean p_term does not separate, dreams carry no
    # action->outcome signal and the policy gradient is pure noise
    def action_sensitivity(path: int) -> dict:
        prompt = prompt_fn(None)
        b, T = args.dream_batch, args.dream_timesteps
        t_idx = np.broadcast_to(np.arange(T)[None, :, None], (b, T, 1))
        out, exps = {}, {}
        for name, acts in (('L', np.zeros((b, T, 1))), ('R', np.ones((b, T, 1))),
                           ('alt', t_idx % 2)):
            with torch.no_grad():
                exp = generate(model, stream(args.seed, path, device=device),
                               time_steps=T, num_steps=args.num_denoise_steps,
                               batch_size=b, **prompt,
                               forced_discrete_actions=torch.as_tensor(
                                   acts, dtype=torch.long, device=device),
                               hard_terminals=False)
            exps[name] = dict(latents=exp.latents[:, prompt_len:].cpu().numpy(),
                              terminal_probs=exp.terminal_probs.cpu().numpy())
            out[name] = float(exps[name]['terminal_probs'][:, prompt_len:].mean())
        lat_L, lat_R = exps['L']['latents'], exps['R']['latents']
        # where in the chain does the action signal die? latent divergence
        # (dreamed trajectories L vs R) vs the terminal-prob divergence
        out['lat_div'] = float(np.abs(lat_L - lat_R).mean())
        out['lat_scale'] = float(np.abs(lat_L).mean())
        out['tp_last'] = (float(exps['L']['terminal_probs'][:, -1].mean()),
                          float(exps['R']['terminal_probs'][:, -1].mean()))
        return out

    def run_wm_updates(n):
        return [float(wm_updates(sample_wm_batch)) for _ in range(n)]

    returns: list[float] = []
    logger = MetricLogger(args.log_dir) if args.log_dir else None
    t0 = time.time()

    for it in range(args.max_iterations):
        # ---- 1. collect real experience with the CURRENT policy (eval only)
        exp = interactor(env, stream(args.seed, it, device=device),
                         num_steps=args.num_denoise_steps,
                         max_timesteps=args.max_timesteps)
        add_to_replay(exp)
        batch_returns = exp.episode_return.cpu().tolist()
        returns.extend(batch_returns)

        # ---- 2. world-model training on replayed real experience
        wm_frozen = args.freeze_wm_after > 0 and it >= args.freeze_wm_after
        wm_losses: list[float] = []
        if (wm_frozen and args.wm_refresh_every > 0
                and (it - args.freeze_wm_after) % args.wm_refresh_every == 0
                and it > args.freeze_wm_after):
            wm_losses = run_wm_updates(args.wm_refresh_updates)
            print(f'  [wm refresh at iter {it}: loss '
                  f'{np.mean(wm_losses):.3f}]', flush=True)
        elif not wm_frozen:
            wm_losses = run_wm_updates(args.wm_updates_per_iter)

        # ---- 3. policy/value updates purely from dreams
        dream_lens = []
        dream_rewards = []
        rl_stats: dict[str, list[float]] = {}
        dream_updates = args.dream_updates_per_iter * (
            args.frozen_dream_mult if wm_frozen else 1)
        if it >= args.warmup_iters:
            for _ in range(dream_updates):
                dream, out = dream_trainer.step()
                dream_lens.append(float(dream.lens.float().mean()))
                dream_rewards.append(float(dream.rewards.mean()))
                for k, v in out.stats.items():
                    rl_stats.setdefault(k, []).append(float(v))

        window = returns[-args.window:]
        avg = float(np.mean(window))
        extra = ''
        if (args.diag_every and it >= args.warmup_iters
                and (it - args.warmup_iters) % args.diag_every == 0):
            sens = action_sensitivity(999_000 + it)
            extra += (f" | diag p_term L {sens['L']:.3f} R {sens['R']:.3f}"
                      f" alt {sens['alt']:.3f}"
                      f" lat_div {sens['lat_div']:.4f}/{sens['lat_scale']:.3f}"
                      f" tp_last L {sens['tp_last'][0]:.3f} R {sens['tp_last'][1]:.3f}")
        if rl_stats:
            extra += (f" V {np.mean(rl_stats['mean_value']):.1f}"
                      f" adv_std {np.mean(rl_stats['adv_std']):.2f}"
                      f" H {np.mean(rl_stats['entropy']):.2f}")
            if 'mean_terminal_prob' in rl_stats:
                extra += (f" p_term {np.mean(rl_stats['mean_terminal_prob']):.3f}"
                          f" alive {np.mean(rl_stats['mean_alive']):.2f}")
        wm_loss_str = f'{np.mean(wm_losses):.3f}' if wm_losses else 'frozen'
        print(f'iter {it}: real return {np.mean(batch_returns):.1f} '
              f'(window avg {avg:.1f}) wm_loss {wm_loss_str} '
              f'dream_len {np.mean(dream_lens) if dream_lens else 0:.1f} '
              f'dream_r {np.mean(dream_rewards) if dream_rewards else 0:.2f}'
              f'{extra} [{time.time() - t0:.0f}s]', flush=True)
        if logger is not None:
            scalars = dict(real_return=float(np.mean(batch_returns)),
                           window_avg=avg)
            if wm_losses:  # omit while frozen — NaN is not valid strict JSON
                scalars['wm_loss'] = float(np.mean(wm_losses))
            if rl_stats:
                scalars.update(entropy=float(np.mean(rl_stats['entropy'])),
                               value=float(np.mean(rl_stats['mean_value'])))
            logger.log(it, **scalars)

        if len(window) >= args.window and avg >= args.target_return:
            print(f'SOLVED IN IMAGINATION at iteration {it}: '
                  f'avg real return {avg:.1f} >= {args.target_return}')
            _maybe_save(args, model)
            return 0

    print(f'final window avg {float(np.mean(returns[-args.window:])):.1f} '
          f'(random baseline ~22)')
    _maybe_save(args, model)
    return 1


def _maybe_save(args, model):
    if not args.save_dir:
        return
    save_model(args.save_dir, model)
    print(f'saved WM+policy checkpoint to {args.save_dir}', flush=True)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    env = GymnasiumVectorAdapter(n_envs=args.n_envs,
                                 max_timesteps=args.max_timesteps, seed=args.seed)
    return train(args, env, device)


if __name__ == '__main__':
    sys.exit(main())
