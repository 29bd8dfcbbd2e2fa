"""The port's small-attention path (K4/K5's plain versions on the CPU)
against the JAX package at float32, with converted weights.

- `small_attend_flat` (the autograd Function the kernels sit behind) against
  JAX `small_attend` in interpret mode: values 1e-5, q/k/v gradients 1e-4
  (the tolerances of `tests/test_small_attention.py`).
- `Attention(use_fused_small=True)` against the JAX module on the same
  converted weights, over the five variants of
  `tests/test_small_attention.py`, and against the port's own generic path:
  2e-5 absolute, 1e-4 relative (float32 through a few matmuls summed in
  another order); gradients 5e-5 / 1e-3 as there.
- The gate admits every shape of the slice's paths, and every mask the
  trunk builds on them lets each query row see at least one key (a fully
  masked row is where K4 and the TPU kernel would differ).
- `small_plan`, the kernels' launch plan (heads per item, ring stages): its
  choices at the slice's main shapes and the gate's edge, and a plan the
  kernels take (G divides h, at most 8 consumer warps, the shared memory
  within the card's) at every shape the gate admits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamer4_tpu.nn import attention as jattn
from dreamer4_tpu.ops.masks import build_attend_mask as j_build_attend_mask
from dreamer4_tpu.ops.rotary import rotary_frequencies as j_rotary_frequencies
from dreamer4_tpu.ops.small_attention import small_attend as j_small_attend
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.models.transformer import AxialSpaceTimeTransformer
from dreamer4_torch.nn import attention as tattn
from dreamer4_torch.ops import small_attention as sa
from dreamer4_torch.ops.masks import build_attend_mask
from dreamer4_torch.ops.rotary import rotary_frequencies

torch.set_num_threads(1)
T = lambda x: torch.from_numpy(np.array(x))


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def masks(kind, n):
    """The same (n, n) mask in both packages (numpy for JAX's static path)."""
    if kind == 'none':
        return None, None
    kw = (dict(causal=True) if kind == 'causal' else
          dict(num_special=2, block_size_per_special=n, special_attend_only_itself=True))
    return j_build_attend_mask(n, n, **kw), build_attend_mask(n, n, **kw)


@pytest.mark.parametrize('mask_kind', ['none', 'causal', 'special'])
@pytest.mark.parametrize('softclamp', [50.0, None])
def test_small_attend_matches_jax(mask_kind, softclamp):
    B, n, h, dh = 6, 11, 4, 32
    rng = np.random.default_rng(0)
    q, k, v, g = (rand(rng, B, n, h, dh) for _ in range(4))
    jmask, tmask = masks(mask_kind, n)

    def j_loss(q, k, v):
        out = j_small_attend(q, k, v, mask=jmask, softclamp_value=softclamp, interpret=True)
        return jnp.sum(out * g), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (T(x).reshape(B, n * h, dh).requires_grad_() for x in (q, k, v))
    out = sa.small_attend_flat(tq, tk, tv, tmask, h, softclamp_value=softclamp)
    t_grads = torch.autograd.grad(out, (tq, tk, tv), T(g).reshape(B, n * h, dh))
    np.testing.assert_allclose(np.asarray(j_out).reshape(B, n * h, dh), out.detach().numpy(),
                               atol=1e-5, rtol=0)
    for jg, tg in zip(j_grads, t_grads):
        np.testing.assert_allclose(np.asarray(jg).reshape(B, n * h, dh), tg.numpy(), atol=1e-4,
                                   rtol=0)


def test_backward_wrapper_matches_autograd_of_the_plain_forward():
    """K5's plain version is the gradient of K4's, with the mask's
    interleaved bias cached per (n, heads, mask)."""
    rng = np.random.default_rng(1)
    B, n, h, dh = 3, 9, 2, 16
    q, k, v, do = (T(rand(rng, B, n * h, dh)) for _ in range(4))
    mask = build_attend_mask(n, n, causal=True)
    bias = sa.build_interleaved_bias(n, h, mask)
    assert bias is sa.build_interleaved_bias(n, h, mask.clone())
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(sa.small_attend_flat_reference(qg, kg, vg, bias, 30.0),
                               (qg, kg, vg), do)
    got = sa.small_attend_flat_bwd(q, k, v, do, mask, h, softclamp_value=30.0)
    for w, g_ in zip(want, got):
        torch.testing.assert_close(g_, w, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------- the module path

VARIANTS = ['plain', 'qk_norms', 'rotary_per_head', 'residual_values', 'no_gates_no_belief']


def variant_inputs(variant, B=6, n=13, d=32, h=4, dh=16):
    rng = np.random.default_rng(3)
    overrides, jkw, tkw = {}, {}, {}
    tokens = rand(rng, B, n, d)
    if variant == 'qk_norms':
        overrides = dict(rmsnorm_query=True, rmsnorm_key=True)
    elif variant == 'rotary_per_head':
        rot = (rng.random((h, n, dh)) * 3.0).astype(np.float32)   # PoPE's (h, n, dh) layout
        jkw['rotary'], tkw['rotary'] = rot, T(rot)
    elif variant == 'residual_values':
        overrides = dict(value_residual=True)
        rv = rand(rng, B, n, h, dh)
        jkw['residual_values'], tkw['residual_values'] = rv, T(rv)
    elif variant == 'no_gates_no_belief':
        overrides = dict(gate_values=False, belief_attn=False)
        jkw['rotary'], tkw['rotary'] = j_rotary_frequencies(dh, n), rotary_frequencies(dh, n)
    common = dict(dim=d, dim_head=dh, heads=h, rmsnorm_query=False, rmsnorm_key=True,
                  value_residual=False, belief_attn=True, gate_values=True,
                  softclamp_value=50.0)
    common.update(overrides)
    return tokens, common, jkw, tkw


def perturbed(params, seed):
    """flax init leaves the norms at 1 / 0; perturb every leaf so the test
    sees the weights being used."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.1 * rand(rng, *x.shape), params)


def module_pair(variant):
    tokens, common, jkw, tkw = variant_inputs(variant)
    n = tokens.shape[1]
    jmask, tmask = j_build_attend_mask(n, n, causal=True), build_attend_mask(n, n, causal=True)
    jm = jattn.Attention(**common, use_fused_small=True)
    params = perturbed(jm.init(jax.random.PRNGKey(6), tokens, mask=jmask, **jkw)['params'], 7)
    tm = tattn.Attention(**common, use_fused_small=True, device='cpu')
    tm.load_state_dict(flax_params_to_torch(params, tm))
    return (jm, params, tokens, jmask, jkw), (tm, tmask, tkw)


def spy_forward(monkeypatch):
    calls = []
    real = sa._forward
    monkeypatch.setattr(sa, '_forward', lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize('variant', VARIANTS)
def test_fused_attention_module_matches_jax(variant, monkeypatch):
    (jm, params, tokens, jmask, jkw), (tm, tmask, tkw) = module_pair(variant)
    calls = spy_forward(monkeypatch)
    want = jm.apply({'params': params}, tokens, mask=jmask, **jkw).out
    got = tm(T(tokens), mask=tmask, **tkw).out
    assert calls, 'the port did not take the small path'
    np.testing.assert_allclose(np.asarray(want), got.detach().numpy(), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize('variant', [v for v in VARIANTS if v != 'rotary_per_head'])
def test_small_path_matches_generic_path(variant, monkeypatch):
    """The same port module with the small path on and off: output and
    every parameter's gradient. (The per-head rotary table is PoPE's, which
    only the small path takes so far.)"""
    _, (tm, tmask, tkw) = module_pair(variant)
    x = T(variant_inputs(variant)[0])
    calls = spy_forward(monkeypatch)

    def run(fused):
        tm.use_fused_small = fused
        tm.zero_grad(set_to_none=True)
        out = tm(x, mask=tmask, **tkw).out
        out.sin().sum().backward()
        return out.detach(), {n: p.grad.clone() for n, p in tm.named_parameters()
                              if p.grad is not None}

    out_g, grads_g = run(False)
    assert not calls
    out_f, grads_f = run(True)
    assert calls
    torch.testing.assert_close(out_f, out_g, atol=2e-5, rtol=1e-4)
    assert grads_f.keys() == grads_g.keys()
    for name, g in grads_g.items():
        torch.testing.assert_close(grads_f[name], g, atol=5e-5, rtol=1e-3, msg=name)


def test_small_path_refused_where_the_kernels_do_not_fit(monkeypatch):
    """A cached call, cross attention, GQA, a head dim the kernels do not
    take and n above 64 take the generic path."""
    calls = spy_forward(monkeypatch)
    x = torch.randn(2, 5, 32)
    attn = tattn.Attention(32, dim_head=16, heads=2, use_fused_small=True, device='cpu')
    attn(x, allow_small=False)
    attn(x, context=torch.randn(2, 7, 32))
    attn(x, kv_cache=tattn.KVCache.create(2, 2, 8, 16))
    tattn.Attention(32, dim_head=16, heads=2, query_heads=4, use_fused_small=True,
                    device='cpu')(x)
    tattn.Attention(32, dim_head=8, heads=2, use_fused_small=True, device='cpu')(x)
    attn(torch.randn(1, 65, 32))
    assert not calls
    attn(x)
    assert len(calls) == 1


# ---------------------------------------------------------------- the gate

# (n, heads, dim_head): the tokenizer's time layer, the world model's space
# and time layers at b8 x T32, the ragged chip shapes, and this file's and
# the tokenizer tests' shapes (space n = 20 with 16 patches and 4 latents)
SLICE_SHAPES = [(16, 8, 64), (27, 8, 64), (32, 8, 64), (13, 4, 16), (13, 4, 32), (13, 4, 128),
                (11, 4, 32), (9, 2, 16), (20, 4, 16), (3, 4, 16), (64, 8, 64)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_gate_admits_the_slice_shapes(dtype):
    for n, h, dh in SLICE_SHAPES:
        assert sa.small_attention_viable(n, h, dh, dtype), (n, h, dh)
    # the counterpart's efficiency cap: tokenizer space attention, nh = 640
    assert not sa.small_attention_viable(80, 8, 64, dtype)
    # admitted by the counterpart (nh <= 512), beyond the kernels' tiles
    assert not sa.small_attention_viable(80, 4, 64, dtype)
    assert not sa.small_attention_viable(16, 4, 8, dtype)


def trunk_masks(trunk, s, t, monkeypatch):
    """The masks that the self-attention calls of a real uncached trunk
    forward receive, keyed by the attended length."""
    masks = {}
    real = tattn.Attention.forward

    def spy(self, tokens, context=None, mask=None, **kw):
        if context is None:
            masks[tokens.shape[-2]] = mask
        return real(self, tokens, context=context, mask=mask, **kw)

    monkeypatch.setattr(tattn.Attention, 'forward', spy)
    with torch.no_grad():
        trunk(torch.randn(1, t, s, trunk.dim))
    return masks


@pytest.mark.parametrize('special, only_itself, s, t', [
    (16, False, 80, 16),    # the bench tokenizer's encoder
    (16, True, 80, 16),     # its decoder: latents attend only to themselves
    (1, False, 27, 32),     # the bench world model at b8 x T32
    (4, True, 20, 3),       # the tokenizer tests' decoder
])
def test_every_trunk_mask_row_sees_a_key(special, only_itself, s, t, monkeypatch):
    trunk = AxialSpaceTimeTransformer(dim=32, depth=2, attn_heads=2, attn_dim_head=16,
                                      time_block_every=2, num_special_tokens=special,
                                      special_attend_only_itself=only_itself,
                                      use_fused_small=True, device='cpu')
    masks = trunk_masks(trunk, s, t, monkeypatch)
    assert masks.keys() == {s, t}
    for mask in masks.values():
        assert mask is not None and bool(mask.any(dim=1).all())


# ---------------------------------------------------------------- the plan

# (which kernel, dtype, n, heads, dim_head) -> (heads per item, stages): the
# tokenizer's time layer, the world model's space and time layers at b8 x
# T32, the gate's edge n * h = 512 at head dims 64 and 128, a ragged shape
PLAN_PINS = [
    ('fwd', torch.bfloat16, 16, 8, 64, (2, 2)), ('fwd', torch.bfloat16, 27, 8, 64, (2, 2)),
    ('fwd', torch.bfloat16, 32, 8, 64, (2, 2)), ('fwd', torch.bfloat16, 64, 8, 64, (2, 2)),
    ('fwd', torch.float32, 16, 8, 64, (1, 2)), ('fwd', torch.float32, 64, 8, 128, (1, 2)),
    ('bwd', torch.bfloat16, 16, 8, 64, (2, 2)), ('bwd', torch.bfloat16, 27, 8, 64, (2, 2)),
    ('bwd', torch.bfloat16, 32, 8, 64, (2, 2)), ('bwd', torch.bfloat16, 64, 8, 128, (1, 2)),
    ('bwd', torch.float32, 27, 8, 64, (1, 2)), ('bwd', torch.float32, 64, 8, 128, (1, 1)),
    ('fwd', torch.bfloat16, 13, 4, 32, (2, 2)),
]


@pytest.mark.parametrize('which, dtype, n, heads, dh, plan', PLAN_PINS)
def test_small_plan_at_the_slice_shapes(which, dtype, n, heads, dh, plan):
    assert sa.small_plan(n, heads, dh, dtype, which) == plan


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('which', ['fwd', 'bwd'])
def test_small_plan_fits_every_admitted_shape(which, dtype):
    """At every (n, heads, dh) the gate admits (on a grid of n and heads),
    the plan is one the kernels launch: G divides heads, the block has at
    most MAX_CONSUMER_WARPS consumer warps and fits the card's shared
    memory, with at least one stage."""
    for n in (1, 2, 13, 16, 17, 27, 31, 32, 33, 48, 63, 64):
        for heads in (1, 2, 3, 4, 5, 6, 8, 12, 16, 32):
            for dh in sa.SUPPORTED_HEAD_DIMS:
                if not sa.small_attention_viable(n, heads, dh, dtype):
                    continue
                G, stages = sa.small_plan(n, heads, dh, dtype, which)
                assert heads % G == 0 and stages >= 1, (n, heads, dh)
                assert sa.consumer_warps(n, G, dtype) <= sa.MAX_CONSUMER_WARPS
                assert sa.small_smem_bytes(n, dh, dtype, which, G, stages) <= sa.SMEM_LIMIT

