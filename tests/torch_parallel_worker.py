"""Worker processes for the port's multi-process tests (gloo on the CPU).

A test writes its inputs to an .npz, then `run_workers` starts one process
per rank: `python tests/torch_parallel_worker.py <job> <rank> <world> <dir>`.
The ranks meet through a `FileStore` in `<dir>`, run the job on the inputs
and each writes `<dir>/out_<rank>.npz`. This module imports torch, numpy
and the port only, never JAX.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
JOIN_TIMEOUT_S = 120


def run_workers(job: str, world: int, workdir: Path, inputs: dict | None = None,
                timeout: float = JOIN_TIMEOUT_S) -> list[dict]:
    """Runs `job` on `world` ranks; returns each rank's outputs."""
    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / 'inputs.npz', **(inputs or {}))
    env = {**os.environ, 'OMP_NUM_THREADS': '1', 'PYTHONUNBUFFERED': '1'}
    procs = [subprocess.Popen([sys.executable, __file__, job, str(r), str(world), str(workdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f'rank {r} of {job} failed:\n{log[-4000:]}'
    return [dict(np.load(workdir / f'out_{r}.npz')) for r in range(world)]


# ------------------------------------------------------------------ jobs

def job_ring(inp, rank, world):
    """The plain ring (`make_ring_attention` over a mesh axis) and the flash
    ring (over the group), whole q/k/v in, on every case of the inputs
    (`<case>/q`, k, v, g; causal and flash flags): output and q/k/v
    gradients of sum(out * g); the flash cases also through
    `flash_ring_blocks` in this process."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from dreamer4_torch.parallel.ring_attention import (flash_ring_blocks, make_ring_attention,
                                                        ring_attention_global)
    group = torch.distributed.group.WORLD
    mesh = init_device_mesh('cpu', (world,), mesh_dim_names=('sp',))
    out = {}
    for case in sorted({k.split('/')[0] for k in inp}):
        q, k, v, g = (torch.from_numpy(inp[f'{case}/{n}']).requires_grad_(n != 'g')
                      for n in ('q', 'k', 'v', 'g'))
        causal, flash = bool(inp[f'{case}/causal']), bool(inp[f'{case}/flash'])
        if flash:
            o = ring_attention_global(q, k, v, group, causal=causal, use_flash=True)
        else:
            o = make_ring_attention(mesh, 'sp', causal=causal)(q, k, v)
        (o * g).sum().backward()
        for name, t in (('out', o), ('dq', q.grad), ('dk', k.grad), ('dv', v.grad)):
            out[f'{case}/{name}'] = t.detach().numpy()
        if flash:
            o1, _, grads = flash_ring_blocks(q.detach(), k.detach(), v.detach(), world,
                                             g.contiguous(), causal=causal)
            for name, t in zip(('out', 'dq', 'dk', 'dv'), (o1, *grads)):
                out[f'{case}/blocks_{name}'] = t.numpy()
    return out


def _trunk(inp):
    import json

    import torch
    from dreamer4_torch.models.transformer import AxialSpaceTimeTransformer
    cfg = json.loads(str(inp['config']))
    model = AxialSpaceTimeTransformer(**cfg, device='cpu')
    model.load_state_dict({k[len('w/'):]: torch.from_numpy(v) for k, v in inp.items()
                           if k.startswith('w/')})
    return model


def job_trunk(inp, rank, world):
    """The trunk built from `config` with the weights `w/<name>`, on
    `tokens`, inside a one-axis mesh `sp` over the ranks: its output and
    every parameter's gradient of sum(out * g)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from dreamer4_torch.parallel.mesh import set_mesh
    model = _trunk(inp)
    mesh = init_device_mesh('cpu', (world,), mesh_dim_names=('sp',))
    with set_mesh(mesh):
        o, _ = model(torch.from_numpy(inp['tokens']))
    (o * torch.from_numpy(inp['g'])).sum().backward()
    out = {'out': o.detach().numpy()}
    out.update({f'grad/{n}': p.grad.numpy() for n, p in model.named_parameters()
                if p.grad is not None})
    return out


def job_batch_sum(inp, rank, world):
    """The gradient of a loss that reads `batch_sum` of each rank's rows,
    before and after `average_gradients`; the process queries and a tensor
    `replicate`d from each rank's own value."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from dreamer4_torch.parallel import distributed
    from dreamer4_torch.parallel.distributed import average_gradients, batch_parallel, batch_sum
    from dreamer4_torch.parallel.mesh import replicate
    mesh = init_device_mesh('cpu', (world,), mesh_dim_names=('data',))
    queries = dict(count=distributed.process_count(), index=distributed.process_index(),
                   main=distributed.is_main_process(),
                   replicated=replicate(torch.full((2,), float(rank)), mesh).to_local().numpy())
    w = torch.nn.Parameter(torch.from_numpy(inp['w']))
    x = torch.from_numpy(inp['x'])
    rows = x.shape[0] // world
    with batch_parallel(mesh):
        total = batch_sum((x[rank * rows:(rank + 1) * rows] @ w).square().sum())
        loss = total.sqrt() + w.square().sum()    # a nonlinear global term and a local one
    loss.backward()
    out = {'loss': loss.detach().numpy(), 'grad': w.grad.numpy().copy()}
    average_gradients([w], mesh)
    out['averaged'] = w.grad.numpy()
    return {**out, **queries}


def tokenizer_config(image_size: int) -> dict:
    return dict(dim=64, dim_latent=16, patch_size=16, image_height=image_size,
                image_width=image_size, num_latent_tokens=8, encoder_depth=2, decoder_depth=2,
                time_block_every=2)


DYNAMICS = dict(dim=64, dim_latent=16, num_latent_tokens=16, num_spatial_tokens=16, max_steps=16,
                depth=2, time_block_every=2, attn_heads=4, attn_dim_head=16,
                num_discrete_actions=(4,), multi_token_pred_len=4, num_register_tokens=4,
                predict_terminals=False, add_action_embed_to_spatial=True)


def sharded_tokenizer_step(image_size: int, mesh=None, steps: int = 2):
    """`steps` `TokenizerTrainer` steps of the tokenizer (seeded weights,
    its loss normalization on, b4 x t2 uniform video from one generator,
    the rows' lengths 1, 1, 2, 2, so the ranks' masks differ) over `mesh`,
    sharded over its `model` axis, or in one process: -> (each step's loss,
    the first step's weights after it and gradients, averaged over the
    ranks, each step's recon normalizer buffer)."""
    import torch
    from dreamer4_torch.models.tokenizer import VideoTokenizer
    from dreamer4_torch.parallel.mesh import shard_batch, shard_params, unsharded, whole
    from dreamer4_torch.train.trainers import TokenizerTrainer
    torch.manual_seed(0)
    model = VideoTokenizer(**tokenizer_config(image_size), device='cpu')
    video = torch.rand((4, 3, 2, image_size, image_size),
                       generator=torch.Generator().manual_seed(2))
    time_lens = torch.tensor([1, 1, 2, 2])
    if mesh is not None:
        shard_params(model, mesh)
        video, time_lens = shard_batch((video, time_lens), mesh)
    trainer = TokenizerTrainer(model, learning_rate=1e-4, with_ema=False, seed=3, mesh=mesh,
                               device='cpu')
    losses, buffers = [], []
    for step in range(steps):
        loss, _ = trainer.train_on_batch(video, time_lens)
        losses.append(float(loss))
        buffers.append(model.recon_loss_normalizer.exp_avg_sq.clone())
        if step == 0:
            grads = {n: whole(p.grad).clone() for n, p in model.named_parameters()}
            with unsharded(model):
                weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    return losses, weights, grads, torch.stack(buffers)


def sharded_dynamics_loss_and_dream(mesh=None):
    """The dynamics model's shortcut-step loss on a b4 x t3 batch and a
    prompted b4 dream, over `mesh` (weights sharded over `model`, the batch
    over `data`) or in one process: -> (loss, the dream's latents)."""
    import torch
    from dreamer4_torch.models.generate import generate
    from dreamer4_torch.models.world_model import DynamicsWorldModel
    from dreamer4_torch.parallel.distributed import batch_parallel, mean_over_data
    from dreamer4_torch.parallel.mesh import local_batch, shard_batch, shard_params, unsharded
    torch.manual_seed(0)
    model = DynamicsWorldModel(**DYNAMICS, device='cpu')
    g = torch.Generator().manual_seed(2)
    batch = dict(latents=torch.randn((4, 3, 16, 16), generator=g) * 0.3,
                 rewards=torch.zeros((4, 3)), discrete_actions=torch.zeros((4, 2, 1)).long())
    b = 4
    context = contextlib.nullcontext()
    if mesh is not None:
        shard_params(model, mesh)
        batch = local_batch(shard_batch(batch, mesh))
        b = batch['latents'].shape[0]
        context = batch_parallel(mesh)
    with torch.no_grad(), unsharded(model), context:
        loss = model(**batch, shortcut_train=True, generator=torch.Generator().manual_seed(3))
        dream = generate(model, torch.Generator().manual_seed(4), time_steps=3, num_steps=2,
                         batch_size=b, prompt_latents=torch.zeros((b, 1, 16, 16)))
    return float(mean_over_data(loss, mesh)), dream.latents


LOSS_TOKENIZER = dict(dim=32, dim_latent=8, patch_size=8, image_height=32, image_width=32,
                      num_latent_tokens=4, encoder_depth=2, decoder_depth=2, time_block_every=2,
                      attn_heads=2, attn_dim_head=16, encoder_add_decorr_aux_loss=True,
                      latent_ortho_loss_weight=0.1, latent_sigreg_loss_weight=0.1,
                      latent_sigreg_num_slices=16, latent_ar_loss_weight=0.1,
                      latent_ar_num_slices=16, has_byol=True,
                      latent_consistency_loss_weight=0.1, h_net_layer=1, h_net_depth=1)

LOSS_WORLD_MODEL = dict(dim=32, dim_latent=8, num_latent_tokens=4, num_spatial_tokens=4,
                        max_steps=8, depth=2, time_block_every=2, attn_heads=2,
                        attn_dim_head=16, num_discrete_actions=(3,), multi_token_pred_len=2,
                        num_register_tokens=2, use_loss_normalization=True, latent_ar=True,
                        latent_ar_layer=0, latent_ar_loss_weight=0.1, latent_ar_num_slices=16,
                        spatial_pre_encoder_depth=1, action_pre_encoder_depth=1, ssl_lapo=True,
                        ssl_tem=True, h_net_layer=1, h_net_depth=1)


def loss_terms(mesh=None) -> dict:
    """Two training forwards and backwards, the weights held, of a tokenizer
    and a world model with every loss term that reduces over the batch (the
    normalized ones, LPIPS, decorrelation, sigreg, latent AR, BYOL, latent
    consistency, the H-Net ratio; LAPO, TEM, self-flow), on b4 rows of
    unequal lengths: over `mesh`'s `data` axis, each rank its rows, or in
    one process. Each pass moves the loss normalizers, so the second
    pass's gradients read the first's EMAs. -> {name: array}: each pass's
    loss terms and gradients, and the normalizers' buffers after it."""
    import torch
    from dreamer4_torch.models.self_flow import SelfFlowHead
    from dreamer4_torch.models.tokenizer import VideoTokenizer, latent_consistency_loss
    from dreamer4_torch.models.world_model import DynamicsWorldModel
    from dreamer4_torch.nn.lpips import init_lpips, lpips_loss
    from dreamer4_torch.parallel.distributed import mean_over_data
    from dreamer4_torch.parallel.mesh import data_parallel
    rows = slice(None)
    if mesh is not None:
        rank, size = mesh.get_local_rank('data'), mesh.size(0)
        rows = slice(rank * 4 // size, (rank + 1) * 4 // size)
    g = torch.Generator().manual_seed(1)
    video = torch.rand((4, 3, 3, 32, 32), generator=g)[rows]
    time_lens = torch.tensor([1, 2, 3, 3])[rows]
    byol_targets = torch.randn((4, 3, 4, 8), generator=g)[rows]
    wm_batch = dict(latents=torch.randn((4, 4, 4, 8), generator=g)[rows] * 0.5,
                    rewards=torch.randn((4, 4), generator=g)[rows],
                    discrete_actions=torch.randint(0, 3, (4, 4, 1), generator=g)[rows],
                    lens=torch.tensor([2, 3, 4, 4])[rows])
    flow = torch.randn((2, 4, 4, 32), generator=g)
    flow_mask = torch.tensor([[1, 1, 0, 0], [1, 1, 1, 0], [1, 1, 1, 1], [1, 1, 1, 1]],
                             dtype=torch.bool)[rows]
    torch.manual_seed(0)
    tokenizer = VideoTokenizer(**LOSS_TOKENIZER, device='cpu')
    world_model = DynamicsWorldModel(**LOSS_WORLD_MODEL, device='cpu')
    head = SelfFlowHead(32, device='cpu')
    lpips = init_lpips(7, device='cpu')
    lpips_fn = lambda recon, clean, gen, lens: lpips_loss(lpips, recon, clean, generator=gen,
                                                          time_lens=lens)
    generator = torch.Generator().manual_seed(3)
    out = {}
    for step in range(2):
        for module in (tokenizer, world_model, head):
            module.zero_grad(set_to_none=True)
        with data_parallel({'tok': tokenizer, 'wm': world_model, 'head': head}, mesh):
            loss, interm = tokenizer(video, time_lens=time_lens, byol_target_latents=byol_targets,
                                     lpips_fn=lpips_fn, return_intermediates=True,
                                     generator=generator)
            consistency = latent_consistency_loss(tokenizer, interm.recon, interm.latents,
                                                  time_lens=time_lens)
            wm_loss, wm_losses, _ = world_model(**wm_batch, shortcut_train=False,
                                                return_intermediates=True, generator=generator)
            self_flow = head(flow[0][rows], flow[1][rows], flow_mask)
            (loss + consistency + wm_loss + self_flow).backward()
        terms = {**{f'tok/{n}': v for n, v in interm.losses._asdict().items()},
                 **{f'wm/{n}': v for n, v in wm_losses._asdict().items()},
                 'tok/total': loss, 'tok/consistency': consistency, 'wm/total': wm_loss,
                 'self_flow': self_flow}
        out.update({f'{step}/loss/{n}': mean_over_data(v.detach(), mesh).numpy()
                    for n, v in terms.items()})
        for prefix, module in (('tok', tokenizer), ('wm', world_model), ('head', head)):
            out.update({f'{step}/grad/{prefix}/{n}': p.grad.numpy().copy()
                        for n, p in module.named_parameters() if p.grad is not None})
            out.update({f'{step}/buffer/{prefix}/{n}': b.numpy().copy()
                        for n, b in module.named_buffers() if n.endswith('exp_avg_sq')})
    return out


def job_loss_terms(inp, rank, world):
    """`loss_terms` over a data mesh of every rank."""
    from dreamer4_torch.parallel.distributed import create_global_mesh
    return loss_terms(create_global_mesh(data=-1))


def job_sharded(inp, rank, world):
    """The 2 x 2 (data, model) mesh: the tokenizer step at the input's
    image size and the dynamics loss and dream."""
    from dreamer4_torch.parallel.mesh import create_mesh
    mesh = create_mesh(num_data=2, num_model=2)
    tok_losses, weights, grads, buffers = sharded_tokenizer_step(int(inp['image_size']), mesh)
    dyn_loss, dream = sharded_dynamics_loss_and_dream(mesh)
    out = {'tok_losses': tok_losses, 'tok_buffers': buffers.numpy(), 'dyn_loss': dyn_loss,
           'dream': dream.numpy()}
    out.update({f'w/{n}': w.numpy() for n, w in weights.items()})
    out.update({f'g/{n}': g.numpy() for n, g in grads.items()})
    return out


def job_checkpoint(inp, rank, world):
    """A world model sharded over a (1, 2) mesh saves from both ranks
    (one step of `BehaviorCloneTrainer` first, so its optimizer state is
    sharded too); then loads back at these 2 ranks, sharded again."""
    import torch
    from dreamer4_torch.models.world_model import DynamicsWorldModel
    from dreamer4_torch.parallel.mesh import create_mesh, shard_params, unsharded
    from dreamer4_torch.train.checkpoint import load_model
    from dreamer4_torch.train.trainers import BehaviorCloneTrainer
    mesh = create_mesh(num_data=1, num_model=2)
    path = Path(str(inp['path']))
    torch.manual_seed(0)
    model = shard_params(DynamicsWorldModel(**CHECKPOINT_MODEL, device='cpu'), mesh)
    trainer = BehaviorCloneTrainer(model, mesh=mesh, device='cpu')
    trainer.train_on_batch(dict(latents=torch.randn(2, 3, 4, 16, generator=torch.Generator()
                                                    .manual_seed(1))))
    trainer.save_checkpoint(path, tag_step=False)
    n_sharded = sum(isinstance(p, torch.distributed.tensor.DTensor) and
                    any(pl.is_shard() for pl in p.placements) for p in model.parameters())
    with unsharded(model):
        saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    loaded = load_model(path, DynamicsWorldModel, device='cpu', mesh=mesh)
    with unsharded(loaded):
        back = {n: p.detach().clone() for n, p in loaded.named_parameters()}
    # a fresh trainer resumes the sharded optimizer state and steps alike
    torch.manual_seed(5)
    other = shard_params(DynamicsWorldModel(**CHECKPOINT_MODEL, device='cpu'), mesh)
    resumed = BehaviorCloneTrainer(other, mesh=mesh, device='cpu')
    resumed.restore(path)
    batch = dict(latents=torch.randn(2, 3, 4, 16, generator=torch.Generator().manual_seed(6)))
    trainer.train_on_batch(batch)
    resumed.train_on_batch(batch)
    with unsharded(model), unsharded(other):
        same_after = all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                           other.parameters()))
    out = {'n_sharded': n_sharded, 'same_after_resume': same_after}
    out.update({f'saved/{n}': t.numpy() for n, t in saved.items()})
    out.update({f'loaded/{n}': t.numpy() for n, t in back.items()})
    return out


def job_rl_trainers(inp, rank, world):
    """One `DreamTrainer` step and one `SimTrainer` step with a data mesh:
    each rank dreams and steps its own env; the updates are averaged. ->
    the weights after both, and the rank's first dream."""
    import torch
    from dreamer4_torch.envs.mocks import MockStateEnv
    from dreamer4_torch.models.world_model import DynamicsWorldModel
    from dreamer4_torch.parallel.distributed import create_global_mesh
    from dreamer4_torch.train.trainers import DreamTrainer, SimTrainer
    mesh = create_global_mesh(data=-1)
    torch.manual_seed(0)
    model = DynamicsWorldModel(**RL_MODEL, device='cpu')
    dream = DreamTrainer(model, time_steps=4, num_steps=2, batch_size=2, mesh=mesh, device='cpu')
    experience, _ = dream.step()
    env = MockStateEnv(dim_state=4, num_actions=3, batch=2, max_steps=4, seed=10 + rank)
    sim = SimTrainer(model, env, num_steps=2, max_timesteps=4, update_epochs=1, mesh=mesh,
                     device='cpu')
    sim.step()
    out = {f'w/{n}': p.detach().numpy() for n, p in model.named_parameters()}
    return {**out, 'dream': experience.latents.numpy()}


RL_MODEL = dict(dim=16, dim_latent=8, num_latent_tokens=4, max_steps=8, depth=1,
                time_block_every=1, num_spatial_tokens=4, num_discrete_actions=(3,),
                attn_dim_head=8, attn_heads=2, multi_token_pred_len=2, num_register_tokens=2,
                dim_state=4, predict_terminals=True)

CHECKPOINT_MODEL = dict(dim=128, dim_latent=16, num_latent_tokens=4, num_spatial_tokens=4,
                        max_steps=8, depth=2, time_block_every=2, attn_heads=4, attn_dim_head=32,
                        num_discrete_actions=(3,), multi_token_pred_len=2,
                        num_register_tokens=2)

JOBS = dict(ring=job_ring, trunk=job_trunk, batch_sum=job_batch_sum, sharded=job_sharded,
            checkpoint=job_checkpoint, rl_trainers=job_rl_trainers, loss_terms=job_loss_terms)


def main():
    job, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4])
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    from dreamer4_torch.parallel import distributed
    distributed.initialize(store=torch.distributed.FileStore(str(workdir / 'store'), world),
                           num_processes=world, process_id=rank, device='cpu',
                           timeout=JOIN_TIMEOUT_S)
    try:
        out = JOBS[job](dict(np.load(workdir / 'inputs.npz')), rank, world)
        np.savez(workdir / f'out_{rank}.npz', **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == '__main__':
    main()
