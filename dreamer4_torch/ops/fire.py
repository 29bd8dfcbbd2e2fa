"""FIRE and latent-gene evolution (counterpart of `dreamer4_tpu/ops/fire.py`).

`apply_fire`: every 2-D parameter is re-initialized by a Newton-Schulz
iteration towards the nearest orthogonal matrix, keeping its Frobenius
norm, optionally followed by shrink-and-perturb (a plasticity reset between
training phases). `evolve_latent_genes`: top-k selection, one tournament per
child, interpolation crossover. `evolve_params`: the same on the world
model's `latent_genes`.

The port keeps a Dense weight as (out, in), flax as (in, out). Given a
module, `apply_fire` iterates on flax's matrix (the tall orientation of the
kernel, as the counterpart chooses it) and walks the parameters in flax's
sorted leaf order, so the perturbation noise, drawn in flax's layout, is
the counterpart's leaf for leaf. Every draw goes through the module-level
`draw`, so a test can replay the counterpart's.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def draw(kind: str, shape, *, generator: torch.Generator | None, device) -> torch.Tensor:
    """One standard normal draw. kind: 'perturb' (one 2-D leaf's noise, in
    flax's layout), 'tournament' (the tournaments' scores), 'mix' (the
    crossover's interpolation logits)."""
    if kind not in ('perturb', 'tournament', 'mix'):
        raise ValueError(f'unknown draw {kind}')
    return torch.randn(shape, generator=generator, device=device)


def _fire_matrix(t: torch.Tensor, num_iters: int, coefs: tuple[float, float]) -> torch.Tensor:
    a, b = coefs
    norm = torch.linalg.norm(t)
    x = t / norm
    transposed = x.shape[0] < x.shape[1]
    if transposed:
        x = x.T
    for _ in range(num_iters):
        x = a * x + b * (x @ (x.T @ x))
    if transposed:
        x = x.T
    x = x * (norm / torch.linalg.norm(x).clamp_min(1e-12))
    return torch.where(norm == 0.0, t, x)


def flax_leaves(model: nn.Module) -> list[tuple[tuple, torch.Tensor, bool]]:
    """The model's parameters in the counterpart's sorted leaf order:
    (flax path, parameter, whether it is a Dense weight kept transposed).
    Names follow `convert.py`: a parent's `flax_names` backwards, `weight`
    as `kernel` (Dense, Conv) or `embedding` (Embed)."""
    leaves = []
    for name, p in model.named_parameters():
        *parts, leaf = name.split('.')
        module, path = model, []
        for part in parts:
            back = {v: k for k, v in getattr(module, 'flax_names', {}).items()}
            path.append(back.get(part, part))
            module = module._modules[part]
        dense = isinstance(module, nn.Linear) and leaf == 'weight'
        if leaf == 'weight' and isinstance(module, (nn.Linear, nn.Conv2d)):
            leaf = 'kernel'
        elif leaf == 'weight' and isinstance(module, nn.Embedding):
            leaf = 'embedding'
        leaves.append(((*path, leaf), p, dense))
    return sorted(leaves, key=lambda e: e[0])


@torch.no_grad()
def apply_fire(params, generator: torch.Generator | None = None, num_iters: int = 20,
               coefs: tuple[float, float] = (1.5, -0.5), shrink_perturb: bool = False,
               shrink_perturb_factors: tuple[float, float] = (0.5, 0.01)):
    """Re-initialize every 2-D weight. `params`: a module, changed in place
    and returned; or a dict of tensors, whose 2-D entries are taken as
    given, in sorted-name order, and a new dict returned. Shrink-and-
    perturb draws its noise from `generator`."""
    if isinstance(params, nn.Module):
        items = [(p, dense) for _, p, dense in flax_leaves(params)]
    else:
        items = [(params[k], False) for k in sorted(params)]
    scale, noise_scale = shrink_perturb_factors
    new = []
    for p, dense in items:
        if p.ndim != 2:
            new.append(p)
            continue
        w = p.T if dense else p          # the counterpart's matrix
        t = _fire_matrix(w.float(), num_iters, coefs)
        if shrink_perturb:
            noise = draw('perturb', tuple(t.shape), generator=generator, device=t.device)
            t = t * (1.0 - scale) + noise.to(t.dtype) * noise_scale
        new.append((t.T if dense else t).to(p.dtype))
    if isinstance(params, nn.Module):
        for (p, _), t in zip(items, new):
            if t is not p:
                p.copy_(t)
        return params
    out = dict(params)
    out.update({k: t for k, t in zip(sorted(params), new)})
    return out


def _top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest entries along the last axis, ties to
    the lower index (`jax.lax.top_k`'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


@torch.no_grad()
def evolve_latent_genes(genes: torch.Tensor, fitness: torch.Tensor,
                        generator: torch.Generator | None = None, select_frac: float = 0.5,
                        tournament_frac: float = 0.5) -> torch.Tensor:
    """genes (pop, dim), fitness (pop,) -> the next population: the fittest
    `select_frac`, then children, each the interpolation of the two fittest
    of a random tournament over the selected."""
    pop_size, dim_gene = genes.shape
    num_selected = max(1, math.ceil(pop_size * select_frac))
    num_children = pop_size - num_selected
    sel_idx = _top_k_indices(fitness, num_selected)
    fitness_sel, selected = fitness[sel_idx], genes[sel_idx]
    tournament_size = min(max(2, math.ceil(num_selected * tournament_frac)), num_selected)

    scores = draw('tournament', (num_children, num_selected), generator=generator,
                  device=genes.device)
    tournaments = torch.argsort(scores, dim=-1, stable=True)[:, :tournament_size]
    parent_ids = _top_k_indices(fitness_sel[tournaments], 2)             # (children, 2)
    parents = selected[torch.gather(tournaments, 1, parent_ids)]         # (children, 2, dim)
    mix = torch.sigmoid(draw('mix', (num_children, dim_gene), generator=generator,
                             device=genes.device).to(genes.dtype))
    children = parents[:, 0] + (parents[:, 1] - parents[:, 0]) * mix
    return torch.cat([selected, children], dim=0)


@torch.no_grad()
def evolve_params(params, fitness: torch.Tensor, generator: torch.Generator | None = None,
                  gene_key: str = 'latent_genes', **kwargs):
    """`evolve_latent_genes` on the world model's latent genes: a module's
    parameter `gene_key` in place (the module returned), or a dict's entry
    (a new dict returned)."""
    if isinstance(params, nn.Module):
        genes = getattr(params, gene_key)
        genes.copy_(evolve_latent_genes(genes, fitness, generator, **kwargs))
        return params
    out = dict(params)
    out[gene_key] = evolve_latent_genes(params[gene_key], fitness, generator, **kwargs)
    return out
