"""Data-parallel training of the port over gloo on the CPU, against one
process on the global batch and against the JAX package.

`scripts/torch_multihost_dryrun.py` (torch and numpy only) runs the roles;
this test computes the JAX side in its own process (the JAX script's
`single` and `rl-single` roles, in process) and hands the converted weights
and the JAX draws (or each host's JAX rollout) to the torch script as an
.npz. Tolerances: loss 1e-4 absolute, checksum 1e-5 relative, those of
tests/test_multihost.py. Also: the differentiable batch sum's gradient
scale, the sharded steps over a 2x2 (data, model) mesh, and checkpoints
saved from 2 ranks with `model` sharding and loaded at 1 and at 2.
"""
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_worker import ROOT, JOIN_TIMEOUT_S, run_workers

from dreamer4_tpu.data.experience import combine_experiences as jcombine
from dreamer4_tpu.envs.interact import EnvInteractor as JEnvInteractor
from dreamer4_tpu.envs.mocks import MockStateEnv as JMockStateEnv
from dreamer4_tpu.models.world_model import DynamicsWorldModel as JWorldModel
from dreamer4_tpu.train.optim import muon_adam_atan2
from dreamer4_tpu.train.trainers import (RLState, ReturnStats, TrainState, make_rl_optimizer,
                                         make_rl_update_step, make_world_model_train_step)
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.models.tokenizer import VideoTokenizer
from dreamer4_torch.models.world_model import DynamicsWorldModel

SCRIPT = ROOT / 'scripts' / 'torch_multihost_dryrun.py'
sys.path.insert(0, str(SCRIPT.parent))
import torch_multihost_dryrun as dryrun  # noqa: E402

torch.set_num_threads(1)
# the JAX draws of the training forward, as the port's draw kinds
PORT_KIND = {'randint': 'signal_levels', 'normal': 'noise', 'bernoulli': 'reward_keep'}


def checksum(tree) -> float:
    return float(sum(np.abs(np.asarray(x, np.float64)).sum() for x in jax.tree.leaves(tree)))


def run_roles(tmp_path, single_role, inputs, extra=()):
    """The torch script's single role and two workers, side by side; ->
    [(loss, checksum)] of single, worker 0, worker 1."""
    np.savez(tmp_path / 'inputs.npz', **inputs)
    base = [sys.executable, str(SCRIPT), '--inputs', str(tmp_path / 'inputs.npz'), *extra]
    worker = single_role.replace('single', 'worker')
    cmds = [base + ['--role', single_role]]
    cmds += [base + ['--role', worker, '--process-id', str(i), '--store',
                     str(tmp_path / 'store')] for i in range(2)]
    env = {'OMP_NUM_THREADS': '1', 'PATH': '/usr/bin:/bin'}
    import os
    env = {**os.environ, **env}
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for c in cmds]
    results = []
    try:
        for p in procs:
            out = p.communicate(timeout=JOIN_TIMEOUT_S)[0]
            assert p.returncode == 0, out[-3000:]
            m = re.search(r'loss=([-\d.]+) checksum=([-\d.]+)', out)
            assert m, out[-3000:]
            results.append((float(m.group(1)), float(m.group(2))))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def assert_matches(results, ref):
    loss_s, sum_s = ref
    for loss, total in results:
        assert abs(loss - loss_s) < 1e-4, (loss, loss_s)
        assert abs(total - sum_s) / max(abs(sum_s), 1.0) < 1e-5, (total, sum_s)


def jax_world_model_step(normalize: bool, seed: int = 0):
    """The JAX script's `single` role (its model, batch, seeds and
    optimizer), with loss normalization and the rows' unequal lengths under
    `normalize`: -> (loss, checksum), the inputs for the torch script."""
    model = JWorldModel(**dryrun.COMMON, use_loss_normalization=normalize)
    rng = np.random.default_rng(seed)
    batch = dict(
        latents=rng.standard_normal((8, 3, 1, 4, 8)).astype(np.float32) * 0.5,
        rewards=rng.standard_normal((8, 3)).astype(np.float32),
        terminals=np.zeros((8, 3), bool),
        discrete_actions=rng.integers(0, 3, (8, 3, 1)).astype(np.int32))
    if normalize:
        batch['lens'] = np.asarray(dryrun.NORMALIZE_LENS, np.int32)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.jit(lambda b: model.init({'params': jax.random.PRNGKey(seed),
                                              'sample': jax.random.PRNGKey(seed + 1)},
                                             shortcut_train=False, **b))(batch)
    key = jax.random.PRNGKey(seed + 2)

    # the training forward's draws, recorded in call order
    names, real = [], {n: getattr(jax.random, n) for n in PORT_KIND}

    def forward_draws(variables, batch, key):
        values = []

        def recording(name):
            def fn(*args, **kwargs):
                out = real[name](*args, **kwargs)
                names.append(name)
                values.append(out)
                return out
            return fn

        with pytest.MonkeyPatch.context() as mp:
            for name in PORT_KIND:
                mp.setattr(jax.random, name, recording(name))
            model.apply(variables, **batch, shortcut_train=False, rngs={'sample': key},
                        mutable=['state'])
        return values

    draws = jax.jit(forward_draws)(variables, batch, key)

    tx = muon_adam_atan2(learning_rate=1e-3, clip_grad_norm=1.0)
    ts = TrainState(params=variables['params'], state=variables.get('state', {}),
                    opt_state=tx.init(variables['params']), ema_params=None,
                    step=jnp.zeros((), jnp.int32))
    ts, loss, _ = make_world_model_train_step(model, tx)(ts, batch, key, shortcut_train=False)

    tm = DynamicsWorldModel(**dryrun.COMMON, use_loss_normalization=normalize, device='cpu')
    state = jax.tree.map(np.asarray, variables['state']) if 'state' in variables else None
    weights = flax_params_to_torch(jax.tree.map(np.asarray, variables['params']), tm,
                                   state=state)
    inputs = {f'w/{k}': v.numpy() for k, v in {**tm.state_dict(), **weights}.items()}
    inputs.update({f'draw/{i}/{PORT_KIND[n]}': np.asarray(v)
                   for i, (n, v) in enumerate(zip(names, draws))})
    return (float(loss), checksum(ts.params)), inputs


@pytest.mark.parametrize('normalize', [False, True])
def test_torch_dryrun_world_model_matches_one_process_and_jax(normalize, tmp_path):
    """Two gloo workers, each with half the batch, against the single role
    and the JAX script's single role: the loss and the post-update
    checksum of every weight. `normalize`: loss normalization on and the
    rows' lengths unequal, so the ranks' masks differ."""
    ref, inputs = jax_world_model_step(normalize)
    results = run_roles(tmp_path, 'single', inputs,
                        extra=['--normalize'] if normalize else [])
    assert_matches(results[1:], results[0])
    assert_matches(results, ref)


def jax_rl_fanout(num_hosts: int = 2, seed: int = 0):
    """The JAX script's `rl-single` role: each host's rollout, one update
    over all of them; -> (loss, checksum of the heads), the inputs."""
    model = JWorldModel(**dryrun.COMMON, dim_state=4, predict_terminals=True,
                        use_loss_normalization=False)
    variables = jax.jit(lambda: model.init(
        {'params': jax.random.PRNGKey(seed), 'sample': jax.random.PRNGKey(seed + 1)},
        latents=jnp.zeros((1, 3, 4, 8)), shortcut_train=False, rewards=jnp.zeros((1, 3)),
        terminals=jnp.zeros((1,), bool), discrete_actions=jnp.zeros((1, 2, 1), jnp.int32)))()
    interactor = JEnvInteractor(model)
    exps = []
    for host in range(num_hosts):
        env = JMockStateEnv(dim_state=4, num_actions=3, batch=dryrun.LOCAL_DEVICES,
                            max_steps=dryrun.MAX_TIMESTEPS, seed=500 + host)
        exps.append(interactor(variables, env, jax.random.PRNGKey(900 + host), num_steps=2,
                               max_timesteps=dryrun.MAX_TIMESTEPS))
    tx = make_rl_optimizer(model, policy_lr=1e-3, value_lr=1e-3)(variables['params'])
    state = RLState(params=variables['params'], opt_state=tx.init(variables['params']),
                    return_stats=ReturnStats.create(), step=jnp.zeros((), jnp.int32))
    state, out = make_rl_update_step(model, tx)(state, jcombine(exps))
    heads = {k: state.params[k] for k in ('policy_head', 'value_head')}

    tm = DynamicsWorldModel(**dryrun.COMMON, dim_state=4, predict_terminals=True,
                            use_loss_normalization=False, device='cpu')
    weights = flax_params_to_torch(jax.tree.map(np.asarray, variables['params']), tm)
    inputs = {f'w/{k}': v.numpy() for k, v in {**tm.state_dict(), **weights}.items()}
    for h, e in enumerate(exps):
        fields = dict(latents=e.latents, agent_embed=e.agent_embed, rewards=e.rewards,
                      terminals=e.terminals, terminal_probs=e.terminal_probs,
                      actions=e.actions.discrete, log_probs=e.log_probs.discrete,
                      values=e.values, step_size=e.step_size, lens=e.lens,
                      is_truncated=e.is_truncated, critic_state=e.critic_state,
                      episode_return=e.episode_return)
        if e.old_action_unembeds is not None:
            fields.update({f'unembed/{i}': u for i, u in enumerate(e.old_action_unembeds[0])})
        inputs.update({f'exp{h}/{k}': np.asarray(v) for k, v in fields.items()
                       if v is not None})
    return (float(out.policy_loss) + float(out.value_loss), checksum(heads)), inputs


def test_torch_dryrun_rl_fanout_matches_one_process_and_jax(tmp_path):
    """The RL fan-out: each worker learns from its own host's rollout (the
    JAX rollouts, handed over), one data-parallel update; against the
    single role over every host's rollout and the JAX script's rl-single
    role: the losses and the heads' checksum."""
    ref, inputs = jax_rl_fanout()
    results = run_roles(tmp_path, 'rl-single', inputs)
    assert_matches(results[1:], results[0])
    assert_matches(results, ref)


def test_batch_sum_gradient_scale(tmp_path):
    """A loss that reads the global sum of the ranks' rows (through
    `batch_sum`) plus a term of the weights alone: each rank's loss is the
    global one, its gradient before averaging holds the global term P times
    for its rows (the all-reduce's backward sums the ranks' gradients) and
    the local term once, and the average over the ranks is one process's
    gradient on all rows. Also the process queries, and `replicate`, which
    holds the first rank's value on every rank."""
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal((8, 5)), rng.standard_normal((5, 3))
    outs = run_workers('batch_sum', 2, tmp_path, dict(x=x, w=w))
    wt = torch.from_numpy(w).requires_grad_()
    loss = (torch.from_numpy(x) @ wt).square().sum().sqrt() + wt.square().sum()
    loss.backward()
    total = np.sqrt(((x @ w) ** 2).sum())
    for r, out in enumerate(outs):
        assert (int(out['count']), int(out['index']), bool(out['main'])) == (2, r, r == 0)
        np.testing.assert_array_equal(out['replicated'], [0.0, 0.0])   # the first rank's
        np.testing.assert_allclose(out['loss'], loss.item(), rtol=1e-12)
        rows = x[4 * r:4 * (r + 1)]
        own = 2 * (rows.T @ (rows @ w)) / (2 * total) * 2 + 2 * w
        np.testing.assert_allclose(out['grad'], own, rtol=1e-10)
        np.testing.assert_allclose(out['averaged'], wt.grad.numpy(), rtol=1e-10)


def test_every_batch_reduction_of_the_losses_is_global(tmp_path):
    """A tokenizer and a world model with every loss term that reduces over
    the batch (torch_parallel_worker.loss_terms), on rows of unequal
    lengths, two forwards and backwards with the weights held: over 2 gloo
    ranks, each with half the rows, against one process on all of them.
    Each loss term and each loss normalizer's buffer after each pass equal
    one process's to float32 summation order (rtol 1e-5); so do the
    gradients, averaged over the ranks (1e-4 of each weight's gradient
    norm, plus 1e-7 for the H-Net score bias, whose gradient under the
    softmax is zero but for rounding); a weight without a gradient in one
    process gets zeros. The second pass reads the normalizers' EMAs that
    the first moved: a mean that stayed the rank's would part the ranks'
    EMAs, and their gradients, from one process's."""
    import torch_parallel_worker as worker
    outs = run_workers('loss_terms', 2, tmp_path)
    ref = worker.loss_terms()
    assert any('/buffer/' in name for name in ref)
    for out in outs:
        assert set(ref) <= set(out)
        for name in set(out) - set(ref):
            assert '/grad/' in name and not out[name].any(), name
        for name, want in ref.items():
            if '/grad/' in name:
                err = np.linalg.norm(out[name] - want)
                assert err <= 1e-4 * np.linalg.norm(want) + 1e-7, (name, err)
            else:
                np.testing.assert_allclose(out[name], want, rtol=1e-5, err_msg=name)


def run_sharded(tmp_path, image_size):
    """The 2 x 2 mesh's tokenizer step and dynamics loss and dream against
    one process (`torch_parallel_worker` computes both sides)."""
    import torch_parallel_worker as worker
    outs = run_workers('sharded', 4, tmp_path, dict(image_size=image_size))
    tok_losses, weights, grads, buffers = worker.sharded_tokenizer_step(image_size)
    torch.manual_seed(0)
    before = dict(VideoTokenizer(**worker.tokenizer_config(image_size),
                                 device='cpu').named_parameters())
    dyn_loss, _ = worker.sharded_dynamics_loss_and_dream()
    for out in outs:
        assert np.isfinite(out['tok_losses']).all() and np.isfinite(out['dream']).all()
        np.testing.assert_allclose(out['dyn_loss'], dyn_loss, rtol=1e-5)
        # both steps' losses and recon normalizer buffers as one process's;
        # the ranks' buffers equal, bit for bit
        np.testing.assert_allclose(out['tok_losses'], tok_losses, rtol=1e-5)
        np.testing.assert_allclose(out['tok_buffers'], buffers.numpy(), rtol=1e-5)
        np.testing.assert_array_equal(out['tok_buffers'], outs[0]['tok_buffers'])
        # the first step's gradients as one process's up to float32
        # summation order; each weight's first update within 5% of its
        # size: Muon orthogonalizes
        # in bf16 over 5 Newton-Schulz steps, which carry a gradient one
        # float32 rounding apart to several bf16 steps of some entries
        for name, w in weights.items():
            g = grads[name].numpy()
            assert np.linalg.norm(out[f'g/{name}'] - g) <= 1e-4 * np.linalg.norm(g), name
            update = float((w - before[name]).norm())
            assert np.linalg.norm(out[f'w/{name}'] - w.numpy()) <= 5e-2 * update, name


def test_sharded_steps_on_a_2x2_mesh(tmp_path):
    """tests/test_sharded_bigmodel.py over a (data 2, model 2) gloo mesh at
    64 x 64 frames: two of the tokenizer's train steps (the weights split
    by the rule, the video over `data`, its loss normalization on and the
    rows' lengths unequal, so the ranks' masks differ) and the dynamics
    model's shortcut loss and prompted dream. The losses are finite and
    equal one process's on the whole batch, as do both steps' loss
    normalizer buffers, which the ranks hold alike; the tokenizer's first
    gradients equal one process's and its first weight updates agree with
    them to 5% of their size."""
    run_sharded(tmp_path, 64)


@pytest.mark.slow
def test_sharded_steps_on_a_2x2_mesh_at_256(tmp_path):
    """As above with the 256 x 256 frames of BASELINE.json's fifth
    configuration (256 spatial tokens per frame)."""
    run_sharded(tmp_path, 256)


def test_checkpoint_saved_from_two_sharded_ranks_loads_at_one_and_two(tmp_path):
    """A world model split over `model` on 2 ranks takes a step and saves;
    the first rank writes whole tensors. Loaded at 2 ranks (sharded again)
    and at 1 (this process) the weights equal those saved; a fresh trainer
    restores the sharded optimizer state and steps as the saved one does."""
    from dreamer4_torch.train.checkpoint import load_model
    outs = run_workers('checkpoint', 2, tmp_path / 'run', dict(path=str(tmp_path / 'ckpt')))
    single = load_model(tmp_path / 'ckpt', DynamicsWorldModel, device='cpu')
    for out in outs:
        assert int(out['n_sharded']) > 0 and bool(out['same_after_resume'])
        for name, p in single.named_parameters():
            np.testing.assert_array_equal(out[f'saved/{name}'], p.detach().numpy())
            np.testing.assert_array_equal(out[f'loaded/{name}'], p.detach().numpy())


def test_dream_and_sim_trainers_keep_their_ranks_in_step(tmp_path):
    """`DreamTrainer` and `SimTrainer` with a data mesh over 2 ranks: each
    rank dreams (and steps its own env) from its own draws, the updates are
    averaged, so the ranks' dreams differ and their weights stay equal, bit
    for bit, and moved from the seeded start."""
    import torch_parallel_worker as worker
    outs = run_workers('rl_trainers', 2, tmp_path)
    assert not np.array_equal(outs[0]['dream'], outs[1]['dream'])
    torch.manual_seed(0)
    start = dict(DynamicsWorldModel(**worker.RL_MODEL, device='cpu').named_parameters())
    moved = 0
    for name, p in start.items():
        np.testing.assert_array_equal(outs[0][f'w/{name}'], outs[1][f'w/{name}'], err_msg=name)
        moved += not np.array_equal(outs[0][f'w/{name}'], p.detach().numpy())
    assert moved > 0
