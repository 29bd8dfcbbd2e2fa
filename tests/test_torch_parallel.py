"""The port's parallelism against the JAX package on the CPU: the sharding
rule on a (4, 2) mesh, ring attention (plain and flash, the kernels' plain
versions here) over gloo against JAX's rings, the trunk with
`time_ring_axis`, and the differentiable batch sum.

Multi-process cases run `tests/torch_parallel_worker.py` ranks that meet
through a `FileStore` in the test's tmp_path. Tolerances: the plain ring
2e-5 absolute / 1e-4 relative and the flash ring 5e-5 / 1e-3, those of
tests/test_ring_attention.py; the trunk 2e-5 / 1e-4 as
tests/test_torch_transformer.py.
"""
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from torch_parallel_worker import run_workers

from dreamer4_tpu.models.tokenizer import VideoTokenizer as JTokenizer
from dreamer4_tpu.models.transformer import AxialSpaceTimeTransformer as JTrunk
from dreamer4_tpu.models.world_model import DynamicsWorldModel as JWorldModel
from dreamer4_tpu.ops.attention import naive_attend
from dreamer4_tpu.ops.masks import build_attend_mask
from dreamer4_tpu.parallel import mesh as jmesh
from dreamer4_tpu.parallel.ring_attention import make_ring_attention, ring_attend
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.models.tokenizer import VideoTokenizer
from dreamer4_torch.models.transformer import AxialSpaceTimeTransformer
from dreamer4_torch.models.world_model import DynamicsWorldModel
from dreamer4_torch.parallel import mesh as tmesh
from dreamer4_torch.parallel import ring_attention as tring

torch.set_num_threads(1)

PLAIN_TOL = dict(atol=2e-5, rtol=1e-4)
FLASH_TOL = dict(atol=5e-5, rtol=1e-3)


def submesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ('sp',))


def qkvg(seed, b, hq, hk, n, d):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, hq, n, d), f(b, hk, n, d), f(b, hk, n, d), f(b, hq, n, d)


def jax_dense(q, k, v, g, causal):
    """Full attention and its q/k/v gradients of sum(out * g)."""
    mask = build_attend_mask(q.shape[-2], k.shape[-2], causal=causal)
    f = lambda q, k, v: naive_attend(q, k, v, mask=mask, softclamp_value=50.0)
    out, vjp = jax.vjp(f, q, k, v)
    return (out, *vjp(jnp.asarray(g)))


def jax_ring(q, k, v, g, causal, world):
    """JAX's `make_ring_attention` over a `world`-device submesh: output
    and gradients of sum(out * g)."""
    ring = jax.jit(make_ring_attention(submesh(world), 'sp', causal=causal))
    out, vjp = jax.vjp(ring, q, k, v)
    return (out, *vjp(jnp.asarray(g)))


def jax_flash_ring(q, k, v, g, world):
    """JAX's flash ring (its Pallas kernels in interpret mode), causal."""
    spec = P(None, None, 'sp', None)

    @partial(jax.shard_map, mesh=submesh(world), in_specs=(spec, spec, spec), out_specs=spec,
             check_vma=False)
    def ring(q_, k_, v_):
        return ring_attend(q_, k_, v_, axis_name='sp', causal=True, use_flash=True,
                           interpret=True)

    out, vjp = jax.vjp(jax.jit(ring), q, k, v)
    return (out, *vjp(jnp.asarray(g)))


# ----------------------------------------------------------------- rings

RING_CASES = {   # name: (seed, b, hq, hk, n, d, causal, flash)
    'plain_causal': (0, 2, 2, 2, 64, 16, True, False),
    'plain_full': (1, 2, 2, 2, 64, 16, False, False),
    'plain_gqa': (2, 1, 4, 2, 32, 16, True, False),
    'flash_causal': (3, 1, 2, 2, 256, 16, True, True),
    'flash_gqa': (4, 1, 4, 2, 256, 16, True, True),
}


@pytest.mark.parametrize('world', [2, 4])
def test_rings_match_jax(world, tmp_path):
    """Every ring case over `world` gloo ranks: the plain ring against
    JAX's `make_ring_attention` on a `world`-device submesh (values and
    gradients); the flash ring against JAX's flash ring at world 2 (its
    interpret-mode kernels) and against JAX's dense attention at world 4;
    `flash_ring_blocks` (one process) equal to the distributed flash ring
    bit for bit."""
    inputs, ref = {}, {}
    for name, (seed, b, hq, hk, n, d, causal, flash) in RING_CASES.items():
        q, k, v, g = qkvg(seed, b, hq, hk, n, d)
        inputs.update({f'{name}/q': q, f'{name}/k': k, f'{name}/v': v, f'{name}/g': g,
                       f'{name}/causal': causal, f'{name}/flash': flash})
        if not flash:
            ref[name] = jax_ring(q, k, v, g, causal, world)
        elif world == 2:
            ref[name] = jax_flash_ring(q, k, v, g, world)
        else:
            ref[name] = jax_dense(q, k, v, g, causal)
    outs = run_workers('ring', world, tmp_path, inputs)
    for name, (*_, flash) in RING_CASES.items():
        tol = FLASH_TOL if flash else PLAIN_TOL
        for r, out in enumerate(outs):
            for i, field in enumerate(('out', 'dq', 'dk', 'dv')):
                got = out[f'{name}/{field}']
                np.testing.assert_allclose(got, np.asarray(ref[name][i]), **tol,
                                           err_msg=f'{name} {field} rank {r}')
                np.testing.assert_array_equal(got, outs[0][f'{name}/{field}'])
                if flash:
                    np.testing.assert_array_equal(got, out[f'{name}/blocks_{field}'],
                                                  err_msg=f'{name} {field} blocks')


def test_fully_masked_block_merges_with_weight_zero():
    """A block after every query (offset -n_local under the causal mask):
    the plain K1 averages such a row over all keys (finite) with an LSE
    near -1e30, so the merge leaves the running output and LSE exactly as
    they were; its K2/K3 step adds exactly zero from the finite global LSE."""
    q, k, v, g = (torch.from_numpy(a) for a in qkvg(5, 1, 4, 2, 128, 16))
    kb, vb = k + 1.0, v - 2.0   # another rank's block
    cfg = dict(causal=True, softclamp_value=50.0, scale=None)
    o0, lse0 = tring._fwd_init(q)
    o1, lse1 = tring.flash_ring_fwd_step(q, k, v, 0, o0, lse0, **cfg)
    assert torch.isfinite(lse1).all()
    from dreamer4_torch.ops.flash_attention import flash_attend
    o_b, lse_b = flash_attend(q, kb, vb, -128, 128, return_lse=True, **cfg)
    assert torch.isfinite(o_b).all() and (lse_b < -1e29).all()
    o2, lse2 = tring.flash_ring_fwd_step(q, kb, vb, -128, o1, lse1, **cfg)
    assert torch.equal(o2, o1) and torch.equal(lse2, lse1)
    out = o1.to(q.dtype)
    zeros = [torch.zeros(t.shape) for t in (q, k, v)]
    grads = tring.flash_ring_bwd_step(q, kb, vb, out, lse1, g, -128, *zeros, **cfg)
    assert all(bool((t == 0).all()) for t in grads)


# ----------------------------------------------------------------- trunk

TRUNK = dict(dim=16, depth=2, attn_heads=2, attn_dim_head=8, time_block_every=2,
             num_special_tokens=1)


def trunk_pair(seed=1, **kw):
    cfg = {**TRUNK, **kw}
    jm = JTrunk(**cfg)
    x = np.random.default_rng(seed).standard_normal((2, 8, 4, 16)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), x)['params']
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32), params)
    tm = AxialSpaceTimeTransformer(**cfg, device='cpu')
    tm.load_state_dict(flax_params_to_torch(params, tm))
    return cfg, params, tm


def trunk_inputs(cfg, tm, tokens, g):
    return {'config': json.dumps(cfg), 'tokens': tokens, 'g': g,
            **{f'w/{k}': v.numpy() for k, v in tm.state_dict().items()}}


def test_trunk_time_ring_over_two_ranks_matches_jax(tmp_path):
    """P = 2 with time_ring_axis='sp' (the plain ring: 4 rows per rank):
    the output against JAX's trunk with the ring over a 2-device mesh and
    without it, and every parameter gradient of sum(out * g) against
    JAX's dense trunk."""
    cfg, params, tm = trunk_pair()
    jm, jm_ring = JTrunk(**cfg), JTrunk(**cfg, time_ring_axis='sp')
    rng = np.random.default_rng(7)
    tokens = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    g = rng.standard_normal(tokens.shape).astype(np.float32)
    with jax.set_mesh(submesh(2)):
        j_ring = np.asarray(jax.jit(lambda p, x: jm_ring.apply({'params': p}, x)[0])(
            params, tokens))
    loss = lambda p: (jm.apply({'params': p}, tokens)[0] * g).sum()
    j_dense = np.asarray(jax.jit(lambda p: jm.apply({'params': p}, tokens)[0])(params))
    j_grads = jax.jit(jax.grad(loss))(params)
    np.testing.assert_allclose(j_ring, j_dense, **PLAIN_TOL)

    outs = run_workers('trunk', 2, tmp_path,
                       trunk_inputs({**cfg, 'time_ring_axis': 'sp'}, tm, tokens, g))
    ref_grads = flax_params_to_torch(jax.tree.map(np.asarray, j_grads), tm)
    for out in outs:
        np.testing.assert_allclose(out['out'], j_ring, **PLAIN_TOL)
        assert set(k[5:] for k in out if k.startswith('grad/')) == set(ref_grads)
        for name, ref in ref_grads.items():
            np.testing.assert_allclose(out[f'grad/{name}'], ref.numpy(), **PLAIN_TOL,
                                       err_msg=name)


def test_trunk_flash_ring_matches_the_unringed_flash_trunk(tmp_path):
    """The flash ring inside the trunk (T = 256 over 2 ranks: 128 rows
    each, the flash gate's floor; values centered on their mean over all
    keys): output and every parameter gradient against the same trunk
    without the ring in this process, which takes the flash branch."""
    cfg = {**TRUNK, 'use_flash_attention': True, 'flash_min_scores': 128 * 128}
    torch.manual_seed(0)
    tm = AxialSpaceTimeTransformer(**cfg, device='cpu')
    rng = np.random.default_rng(3)
    tokens = rng.standard_normal((1, 256, 2, 16)).astype(np.float32)
    g = rng.standard_normal(tokens.shape).astype(np.float32)
    o, _ = tm(torch.from_numpy(tokens))
    (o * torch.from_numpy(g)).sum().backward()
    outs = run_workers('trunk', 2, tmp_path,
                       trunk_inputs({**cfg, 'time_ring_axis': 'sp'}, tm, tokens, g))
    for out in outs:
        np.testing.assert_allclose(out['out'], o.detach().numpy(), **FLASH_TOL)
        for name, p in tm.named_parameters():
            np.testing.assert_allclose(out[f'grad/{name}'], p.grad.numpy(), **FLASH_TOL,
                                       err_msg=name)


def test_mot_trunk_with_time_ring_axis_makes_no_ring_call(monkeypatch):
    """JAX's MoT time layers pass no ring axis: with `time_ring_axis` set,
    a MoT trunk runs its time layers dense, without a mesh, and equals the
    trunk without the option."""
    calls = []
    monkeypatch.setattr(tring, 'ring_attention_global',
                        lambda *a, **kw: calls.append(1))
    import dreamer4_torch.nn.attention as attention
    monkeypatch.setattr(attention, 'ring_attention_global', lambda *a, **kw: calls.append(1))
    cfg = {**TRUNK, 'mot_temporal': True}
    torch.manual_seed(0)
    ring = AxialSpaceTimeTransformer(**cfg, time_ring_axis='sp', device='cpu')
    dense = AxialSpaceTimeTransformer(**cfg, device='cpu')
    dense.load_state_dict(ring.state_dict())
    x = torch.randn(2, 8, 4, 16)
    with torch.no_grad():
        assert torch.equal(ring(x)[0], dense(x)[0])
    assert not calls


# ------------------------------------------------------------ the rule

def world_model_and_tokenizer():
    wm_kw = dict(dim=128, dim_latent=16, num_latent_tokens=4, num_spatial_tokens=4,
                 max_steps=8, depth=2, time_block_every=2, attn_heads=4, attn_dim_head=32,
                 num_discrete_actions=(3,), multi_token_pred_len=2, num_register_tokens=2)
    tok_kw = dict(dim=128, dim_latent=16, patch_size=16, image_height=32, image_width=32,
                  num_latent_tokens=4, encoder_depth=1, decoder_depth=1, time_block_every=1,
                  attn_dim_head=32)
    rngs = {'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)}
    jwm = JWorldModel(**wm_kw)
    wm_vars = jax.jit(lambda r: jwm.init(
        r, latents=jnp.zeros((1, 2, 4, 16)), shortcut_train=False, rewards=jnp.zeros((1, 2)),
        discrete_actions=jnp.zeros((1, 1, 1), jnp.int32)))(rngs)
    jtok = JTokenizer(**tok_kw)
    tok_vars = jax.jit(lambda r: jtok.init(r, jnp.zeros((1, 3, 2, 32, 32))))(rngs)
    return [(wm_vars['params'], DynamicsWorldModel(**wm_kw, device='cpu')),
            (tok_vars['params'], VideoTokenizer(**tok_kw, device='cpu'))]


class FakeMesh:
    """What `param_sharding_rule` reads of a (data, model) DeviceMesh."""
    mesh_dim_names = ('data', 'model')
    ndim = 2

    def __init__(self, shape):
        self.shape = shape

    def size(self, dim):
        return self.shape[dim]


def test_sharding_rule_matches_jax_on_a_4x2_mesh():
    """For every weight of a small world model and tokenizer, the port's
    placement equals JAX's `param_sharding_rule` on conftest's 8 CPU
    devices as a (4, 2) mesh, mapped through the transposition of each
    torch layout (`flax_layouts`). Some weights must be split."""
    from torch.distributed.tensor import Replicate, Shard
    jax_mesh = jmesh.create_mesh(num_data=4, num_model=2)
    fake = FakeMesh((4, 2))
    n_split = 0
    for params, model in world_model_and_tokenizer():
        # each leaf filled with the flax dim JAX splits over `model` (-1:
        # replicated); the converter carries it to the torch name and layout
        split_dim = lambda p, x: np.full(x.shape, next(
            (i for i, a in enumerate(jmesh.param_sharding_rule(p, x, jax_mesh).spec)
             if a == 'model'), -1), np.float32)
        jax_flat = flax_params_to_torch(jax.tree_util.tree_map_with_path(split_dim, params),
                                        model)
        layouts = tmesh.flax_layouts(model)
        named = dict(model.named_parameters())
        assert set(jax_flat) == set(named)
        for name, param in named.items():
            placements = tmesh.param_sharding_rule(name, param, fake, layouts.get(name))
            assert placements[0] == Replicate()
            flax_dim = int(jax_flat[name].reshape(-1)[0])
            if flax_dim < 0:
                assert placements[1] == Replicate(), name
            else:
                layout = layouts.get(name, tuple(range(param.ndim)))
                assert placements[1] == Shard(layout.index(flax_dim)), name
                n_split += 1
    assert n_split >= 8
