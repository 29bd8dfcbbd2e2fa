"""CartPole policy learned PURELY IN IMAGINATION from OFFLINE data
(counterpart of `examples/train_cartpole_offline_dream_rl.py`).

The Dreamer-4 paper's headline setting ("Training Agents Inside of Scalable
World Models"): learn a world model from a FIXED offline dataset, then train
the policy entirely inside it — zero real-environment policy updates.

Four phases:
  1. ONLINE expert (`train_expert`): the proven SimTrainer recipe runs
     until the reference gate (avg return >= --expert-target) to obtain an
     expert policy (this phase only exists to MAKE the offline dataset, as
     the paper uses human/VPT data).
  2. DATASET (`collect_dataset`): mixed expert + random rollouts are
     collected once. Both use the same (untrained, frozen)
     `state_to_latents` projection, so the latents live in one space.
  3. OFFLINE WM (`train_offline_world_model`): a world model is trained
     from init on that fixed dataset (policy/value heads frozen).
  4. DREAM RL (`dream_rl`): the fresh policy/value heads are optimized with
     PPO on imagination rollouts of the frozen WM only. The real env is
     used strictly for EVALUATION.

Success = eval return >= --target-return with zero real-env policy updates
after phase 1's dataset collection. `--expert-checkpoint` and
`--dataset-cache` reload the port's own checkpoint and `.npz` (no JAX
checkpoint is read).

Streams (JAX -> here): both models' initial weights, `PRNGKey(seed)` ->
the global generator seeded with `--seed` inside `common.seeded_init`;
the expert's `fold_in(PRNGKey(seed), it)` -> `SimTrainer(seed=--seed)`;
the collectors' `fold_in(PRNGKey(seed + 100 | 200), b)` -> `stream(seed +
100 | 200, b)`; the world-model steps' split chain of `PRNGKey(seed + 7)`
-> `stream(seed + 7)` in turn; dream update u's `fold_in(PRNGKey(seed +
31), u)` -> `DreamTrainer(seed=seed + 31)` in turn and its evaluation's
`fold_in(., 10_000_000 + u)` -> `stream(seed + 31, 10_000_000 + u)`; the
replay, prompt and shortcut draws from numpy `default_rng(seed)` as in the
JAX recipe. `--cpu` becomes `--device`.

Usage: python -m dreamer4_torch.examples.train_cartpole_offline_dream_rl
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

from ..device import resolve_device
from ..envs.interact import EnvInteractor
from ..models.world_model import DynamicsWorldModel
from ..train.checkpoint import load_model, save_model
from ..train.trainers import DreamTrainer, SimTrainer
from .common import (WorldModelUpdates, experience_item, prompt_window, seeded_init, stream,
                     to_batch)
from .train_cartpole_with_dynamics_rl import GymnasiumVectorAdapter

REPLAY_KEYS = ('latents', 'rewards', 'terminals', 'discrete_actions', 'lens')


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--target-return', type=float, default=70.0)
    p.add_argument('--max-timesteps', type=int, default=150)
    p.add_argument('--n-envs', type=int, default=16)
    p.add_argument('--expert-iterations', type=int, default=60)
    p.add_argument('--expert-target', type=float, default=80.0)
    p.add_argument('--dataset-batches-expert', type=int, default=40)
    p.add_argument('--dataset-batches-random', type=int, default=40)
    p.add_argument('--wm-steps', type=int, default=4000)
    p.add_argument('--wm-lr', type=float, default=3e-4)
    p.add_argument('--wm-batch', type=int, default=16)
    p.add_argument('--dream-updates', type=int, default=3000)
    p.add_argument('--dream-batch', type=int, default=128)
    p.add_argument('--dream-timesteps', type=int, default=25)
    p.add_argument('--num-denoise-steps', type=int, default=4)
    p.add_argument('--prompt-len', type=int, default=3)
    p.add_argument('--ppo-epochs', type=int, default=2)
    p.add_argument('--policy-lr', type=float, default=6e-4)
    p.add_argument('--value-lr', type=float, default=6e-4)
    p.add_argument('--entropy-weight', type=float, default=0.001)
    p.add_argument('--eval-every', type=int, default=25,
                   help='dream updates between real-env evaluations')
    p.add_argument('--window', type=int, default=3,
                   help='eval rounds averaged for the success check '
                        '(each round is n_envs episodes)')
    p.add_argument('--expert-checkpoint', type=str, default='',
                   help='save the phase-1 expert here / reuse it on restart')
    p.add_argument('--dataset-cache', type=str, default='',
                   help='save the collected offline dataset here (.npz) / '
                        'reuse it on restart')
    p.add_argument('--collect-only', action='store_true',
                   help='run phases 1-2 (expert + dataset), write the caches, '
                        'and exit')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', type=str, default=None,
                   help='torch device (default: the CUDA card; "cpu" runs on the CPU)')
    return p.parse_args(argv)


def build_model(args, env, device, entropy_weight: float, action_inject: bool,
                **overrides) -> DynamicsWorldModel:
    """The recipe's world model (examples/train_cartpole_offline_dream_rl.py:
    106-115), its weights from `args.seed`: the ONLINE expert uses the proven
    round-1 recipe exactly (no action injection — it changes what the agent
    embeds encode and measurably slows online policy learning); the OFFLINE
    WM turns injection on for action-sensitive dreams."""
    kwargs = dict(
        dim=64, dim_latent=16, num_latent_tokens=4, num_spatial_tokens=4,
        max_steps=16, depth=2, time_block_every=2, attn_heads=4,
        attn_dim_head=16, num_discrete_actions=(env.num_actions,),
        multi_token_pred_len=4, num_register_tokens=4,
        dim_state=env.dim_state, dim_critic_state=env.dim_state,
        predict_terminals=True, add_action_embed_to_spatial=action_inject,
        policy_entropy_weight=entropy_weight, keep_reward_ema_stats=True,
        reward_range=(-args.max_timesteps * 1.2, args.max_timesteps * 1.2))
    with seeded_init(args.seed, device):
        return DynamicsWorldModel(**{**kwargs, **overrides}, device=device)


def train_expert(args, env, device, t0: float) -> DynamicsWorldModel:
    """Phase 1: the online recipe until `--expert-target` or
    `--expert-iterations`."""
    expert_model = build_model(args, env, device, 0.01, action_inject=False)
    sim = SimTrainer(expert_model, env, policy_lr=3e-4, value_lr=3e-4,
                     num_steps=args.num_denoise_steps, max_timesteps=args.max_timesteps,
                     update_epochs=4, dynamics_lr=1e-4,  # the proven online-recipe settings
                     seed=args.seed, device=device)
    returns: list[float] = []
    for it in range(args.expert_iterations):
        experience, _ = sim.step()
        returns.extend(experience.episode_return.cpu().tolist())
        window = returns[-20:]
        avg = float(np.mean(window))
        if it % 5 == 0:
            print(f'[expert] iter {it}: avg return {avg:.1f} '
                  f'[{time.time()-t0:.0f}s]', flush=True)
        if len(window) >= 20 and avg >= args.expert_target:
            print(f'[expert] reached {avg:.1f} at iter {it}', flush=True)
            break
    return expert_model


def collect_dataset(args, env, expert_model, model, device, t0: float) -> list[dict]:
    """Phase 2: `--dataset-batches-expert` batches through the EXPERT
    MODEL's forward (running its weights through the injection-enabled
    fresh model perturbs the trunk and degrades the policy, measured: return
    46 -> 26), then `--dataset-batches-random` through the fresh model."""
    replay: list[dict] = []

    def collect(actor, n_batches, tag, seed):
        eps_returns = []
        for b in range(n_batches):
            exp = actor(env, stream(seed, b, device=device),
                        num_steps=args.num_denoise_steps,
                        max_timesteps=args.max_timesteps)
            replay.append(experience_item(exp, args.max_timesteps + 1))
            eps_returns.extend(exp.episode_return.cpu().tolist())
        print(f'[dataset] {tag}: {n_batches * args.n_envs} episodes, '
              f'avg return {np.mean(eps_returns):.1f} [{time.time()-t0:.0f}s]',
              flush=True)

    collect(EnvInteractor(expert_model, device=device), args.dataset_batches_expert,
            'expert', args.seed + 100)
    collect(EnvInteractor(model, device=device), args.dataset_batches_random,
            'random', args.seed + 200)
    return replay


def train_offline_world_model(args, model, replay, rng, device, t0: float):
    """Phase 3: `--wm-steps` steps on one replayed 16-episode batch each,
    the policy and value heads frozen."""
    updates = WorldModelUpdates(model, args.wm_lr, stream(args.seed + 7, device=device), rng)
    for step in range(args.wm_steps):
        wm_loss = updates(lambda: to_batch(replay[rng.integers(len(replay))], device))
        if step % 500 == 0:
            print(f'[wm] step {step}: loss {float(wm_loss):.3f} '
                  f'[{time.time()-t0:.0f}s]', flush=True)


def dream_rl(args, env, model, replay, rng, device, t0: float) -> int:
    """Phase 4: heads-only PPO on dreams of the frozen world model, an
    evaluation on the real env every `--eval-every` updates; 0 when the
    window of evaluations reaches `--target-return`, else 1."""
    dream_trainer = DreamTrainer(
        model,
        time_steps=args.dream_timesteps, num_steps=args.num_denoise_steps,
        batch_size=args.dream_batch, objective='ppo',
        policy_lr=args.policy_lr, value_lr=args.value_lr,
        update_epochs=args.ppo_epochs,
        prompt_fn=lambda generator: prompt_window(replay[rng.integers(len(replay))],
                                                  args.dream_batch, args.prompt_len, rng,
                                                  device),
        generate_kwargs=dict(hard_terminals=False), seed=args.seed + 31, device=device)
    interactor = EnvInteractor(model, device=device)

    eval_history: list[float] = []
    for u in range(args.dream_updates):
        _, out = dream_trainer.step()
        if (u + 1) % args.eval_every == 0:
            exp = interactor(env, stream(args.seed + 31, 10_000_000 + u, device=device),
                             num_steps=args.num_denoise_steps,
                             max_timesteps=args.max_timesteps)
            ret = float(exp.episode_return.float().mean())
            eval_history.append(ret)
            window = eval_history[-args.window:]
            avg = float(np.mean(window))
            print(f'[dream] update {u+1}: eval return {ret:.1f} '
                  f'(window {avg:.1f}) H {float(out.stats["entropy"]):.2f} '
                  f'V {float(out.stats["mean_value"]):.1f} '
                  f'[{time.time()-t0:.0f}s]', flush=True)
            if len(window) >= args.window and avg >= args.target_return:
                print(f'SOLVED OFFLINE IN IMAGINATION after {u+1} dream '
                      f'updates: eval return {avg:.1f} >= {args.target_return} '
                      f'(zero real-env policy updates)', flush=True)
                return 0

    final = float(np.mean(eval_history[-args.window:])) if eval_history else 0.0
    print(f'final offline-dream eval avg {final:.1f} (random baseline ~22)')
    return 1


def run(args, env, device) -> int:
    """The four phases, with the expert and dataset caches."""
    t0 = time.time()
    ckpt_dir = Path(args.expert_checkpoint) if args.expert_checkpoint else None
    if ckpt_dir is not None and (ckpt_dir / 'config.json').exists():
        expert_model = load_model(ckpt_dir, DynamicsWorldModel, device=device)
        print(f'[expert] loaded checkpoint from {ckpt_dir}', flush=True)
    else:
        expert_model = train_expert(args, env, device, t0)
        if ckpt_dir is not None:
            save_model(ckpt_dir, expert_model)
            print(f'[expert] saved checkpoint to {ckpt_dir}', flush=True)

    # fresh model, SAME init seed, and the expert's (untrained, frozen)
    # state->latents projection grafted in, so every collector writes
    # latents in the SAME space — the projection receives no gradients
    # anywhere (observations are encoded host-side; latents enter training
    # as data)
    model = build_model(args, env, device, args.entropy_weight, action_inject=True)
    model.state_to_latents_proj.load_state_dict(expert_model.state_to_latents_proj.state_dict())

    cache = Path(args.dataset_cache) if args.dataset_cache else None
    if cache is not None and cache.exists():
        blob = np.load(cache)
        n_items = int(blob['n_items'])
        replay = [{k: blob[f'{k}_{i}'] for k in REPLAY_KEYS} for i in range(n_items)]
        print(f'[dataset] loaded {n_items} batches from {cache}', flush=True)
    else:
        replay = collect_dataset(args, env, expert_model, model, device, t0)
        if cache is not None:
            np.savez_compressed(
                cache, n_items=len(replay),
                **{f'{k}_{i}': item[k] for i, item in enumerate(replay) for k in item})
            print(f'[dataset] cached to {cache}', flush=True)

    if args.collect_only:
        print('[collect-only] expert + dataset cached; exiting', flush=True)
        return 0

    rng = np.random.default_rng(args.seed)
    train_offline_world_model(args, model, replay, rng, device, t0)
    return dream_rl(args, env, model, replay, rng, device, t0)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    env = GymnasiumVectorAdapter(n_envs=args.n_envs,
                                 max_timesteps=args.max_timesteps, seed=args.seed)
    return run(args, env, device)


if __name__ == '__main__':
    sys.exit(main())
