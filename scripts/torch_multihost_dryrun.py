"""Multi-process training dryrun of the port on the CPU (the counterpart of
scripts/multihost_dryrun.py, with its roles, widths, batch and seeds).

  --role single               : one process, the full global batch
  --role worker --process-id i: one of N processes over gloo, its rows of
                                the batch, gradients averaged over `data`
  --role rl-single / rl-worker: the RL fan-out: each host collects its own
                                rollouts (EnvInteractor on MockStateEnv) and
                                one data-parallel update learns from all

Each prints `loss=<x> checksum=<y>` after ONE step. If data parallelism is
exact, every worker's loss and post-update parameter checksum equal the
single process's on the global batch. The ranks meet through a FileStore:

  python scripts/torch_multihost_dryrun.py --role single
  python scripts/torch_multihost_dryrun.py --role worker --process-id 0 --store /tmp/s &
  python scripts/torch_multihost_dryrun.py --role worker --process-id 1 --store /tmp/s

`--inputs file.npz` replaces the seeded initial weights (`w/<name>`) and
the draws: the training forward's (`draw/<i>/<kind>`, global shapes, in
order) or each host's rollout (`exp<h>/<field>`). `--normalize` turns on
loss normalization and gives the batch rows unequal lengths (the ranks
unequal masks). Imports torch and numpy only.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dreamer4_torch.data.experience import (Experience, combine_experiences,  # noqa: E402
                                            pad_experience_time)
from dreamer4_torch.envs.interact import EnvInteractor  # noqa: E402
from dreamer4_torch.envs.mocks import MockStateEnv  # noqa: E402
from dreamer4_torch.models import world_model as world_model_module  # noqa: E402
from dreamer4_torch.models.world_model import DynamicsWorldModel  # noqa: E402
from dreamer4_torch.nn.action_embedder import Actions  # noqa: E402
from dreamer4_torch.parallel import distributed as dist  # noqa: E402
from dreamer4_torch.train.optim import MuonAdamAtan2  # noqa: E402
from dreamer4_torch.train.trainers import (create_rl_state, create_train_state,  # noqa: E402
                                           make_rl_optimizer, make_rl_update_step,
                                           make_world_model_train_step)

LOCAL_DEVICES = 4     # each host's env batch in the RL fan-out
GLOBAL_BATCH = 8
MAX_TIMESTEPS = 6
COMMON = dict(dim=16, dim_latent=8, num_latent_tokens=4, max_steps=8, depth=1,
              time_block_every=1, num_spatial_tokens=4, num_discrete_actions=(3,),
              attn_dim_head=8, attn_heads=2, multi_token_pred_len=2, num_register_tokens=2)
# unequal rows per rank under --normalize (lengths of the 3 frames)
NORMALIZE_LENS = (3, 3, 2, 3, 1, 2, 2, 1)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--role', choices=('single', 'worker', 'rl-single', 'rl-worker'),
                   required=True)
    p.add_argument('--process-id', type=int, default=0)
    p.add_argument('--num-processes', type=int, default=2)
    p.add_argument('--store', help='FileStore path for the workers\' rendezvous')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--inputs', help='npz of weights and draws to replay')
    p.add_argument('--normalize', action='store_true')
    return p.parse_args(argv)


def load_weights(model, inputs):
    if inputs is not None:
        model.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in inputs.items()
                               if k.startswith('w/')})
    return model


def checksum(params) -> float:
    return float(sum(p.detach().double().abs().sum() for p in params))


def replay_draws(inputs):
    """A `world_model.draw` handing out the recorded draws in order."""
    records = sorted((int(k.split('/')[1]), k.split('/')[2], v) for k, v in inputs.items()
                     if k.startswith('draw/'))

    def draw(kind, shape, *, generator, device, low=0, high=0, prob=0.0):
        _, recorded_kind, x = records.pop(0)
        if recorded_kind != kind or x.shape != tuple(shape):
            raise ValueError(f'draw {kind} {tuple(shape)}: recorded {recorded_kind} {x.shape}')
        out = torch.from_numpy(np.array(x))
        return out.long() if kind in ('signal_levels', 'step_sizes_log2') else out

    return draw


def run_world_model(args, mesh, inputs):
    torch.manual_seed(args.seed)
    model = DynamicsWorldModel(**COMMON, use_loss_normalization=args.normalize, device='cpu')
    load_weights(model, inputs)
    rng = np.random.default_rng(args.seed)
    batch = dict(
        latents=rng.standard_normal((GLOBAL_BATCH, 3, 1, 4, 8)).astype(np.float32) * 0.5,
        rewards=rng.standard_normal((GLOBAL_BATCH, 3)).astype(np.float32),
        terminals=np.zeros((GLOBAL_BATCH, 3), bool),
        discrete_actions=rng.integers(0, 3, (GLOBAL_BATCH, 3, 1)).astype(np.int64))
    if args.normalize:
        batch['lens'] = np.asarray(NORMALIZE_LENS, np.int64)

    optimizer = MuonAdamAtan2(model, learning_rate=1e-3, clip_grad_norm=1.0)
    ts = create_train_state(model, optimizer)
    train_step = make_world_model_train_step(model, optimizer, mesh=mesh)
    generator = torch.Generator().manual_seed(args.seed + 2)
    if inputs is not None and any(k.startswith('draw/') for k in inputs):
        world_model_module.draw = replay_draws(inputs)

    if args.role == 'worker':
        per = GLOBAL_BATCH // args.num_processes
        local = {k: v[args.process_id * per:(args.process_id + 1) * per]
                 for k, v in batch.items()}
        batch = dist.host_local_batch_to_global(mesh, ('data',), local)
    else:
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ts, loss, _ = train_step(ts, batch, shortcut_train=False, generator=generator)
    return float(loss), checksum(model.parameters())


def experience_from_npz(inputs, host: int) -> Experience:
    """A host's rollout, handed in as arrays."""
    prefix = f'exp{host}/'
    get = lambda name: (torch.from_numpy(np.array(inputs[prefix + name]))
                        if prefix + name in inputs else None)
    unembeds = sorted(k for k in inputs if k.startswith(prefix + 'unembed/'))
    return Experience(
        latents=get('latents'), agent_embed=get('agent_embed'), rewards=get('rewards'),
        terminals=get('terminals'), terminal_probs=get('terminal_probs'),
        actions=Actions(get('actions').long(), None), log_probs=Actions(get('log_probs'), None),
        old_action_unembeds=((tuple(torch.from_numpy(inputs[k]) for k in unembeds), None)
                             if unembeds else None),
        values=get('values'), step_size=int(inputs[prefix + 'step_size']),
        lens=get('lens').long(), is_truncated=get('is_truncated'),
        critic_state=get('critic_state'), episode_return=get('episode_return'))


def run_rl_fanout(args, mesh, inputs):
    torch.manual_seed(args.seed)
    model = DynamicsWorldModel(**COMMON, dim_state=4, predict_terminals=True,
                               use_loss_normalization=False, device='cpu')
    load_weights(model, inputs)
    interactor = EnvInteractor(model, device='cpu')

    def collect(host: int) -> Experience:
        if inputs is not None:
            exp = experience_from_npz(inputs, host)
        else:
            env = MockStateEnv(dim_state=4, num_actions=3, batch=LOCAL_DEVICES,
                               max_steps=MAX_TIMESTEPS, seed=500 + host)
            exp = interactor(env, torch.Generator().manual_seed(900 + host), num_steps=2,
                             max_timesteps=MAX_TIMESTEPS)
        # one time length on every host, as the global batch needs
        return pad_experience_time(exp, MAX_TIMESTEPS + 1)

    optimizer = make_rl_optimizer(model, policy_lr=1e-3, value_lr=1e-3)
    rl_state = create_rl_state(model, optimizer)
    update = make_rl_update_step(model, optimizer, mesh=mesh)
    if args.role == 'rl-worker':
        experience = dist.host_local_batch_to_global(mesh, ('data',), collect(args.process_id))
    else:
        experience = combine_experiences([collect(i) for i in range(args.num_processes)])
    rl_state, out = update(rl_state, experience)
    heads = [p for name, p in model.named_parameters()
             if name.split('.')[0] in ('policy_head', 'value_head')]
    return float(out.policy_loss) + float(out.value_loss), checksum(heads)


def main(argv=None):
    args = parse_args(argv)
    torch.set_num_threads(1)
    inputs = dict(np.load(args.inputs)) if args.inputs else None
    mesh = None
    if args.role in ('worker', 'rl-worker'):
        if args.store is None:
            raise SystemExit('workers need --store')
        dist.initialize(store=torch.distributed.FileStore(args.store, args.num_processes),
                        num_processes=args.num_processes, process_id=args.process_id,
                        device='cpu', timeout=120)
        mesh = dist.create_global_mesh(data=-1, model=1)
    try:
        run = run_rl_fanout if args.role.startswith('rl') else run_world_model
        loss, total = run(args, mesh, inputs)
        print(f'loss={loss:.6f} checksum={total:.6f}', flush=True)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
