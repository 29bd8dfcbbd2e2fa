"""The port's flash-attention backward against the JAX one.

Three things are held against the JAX package at float32 on the CPU:
  - the port's plain backward (`flash_attend_bwd` on CPU tensors: the plain
    versions of K2, which derives delta from the output, and K3) against
    JAX's fused `flash_attend_bwd` (the Pallas kernels in interpret mode),
    both given the same q, k, v, output, LSE and output gradient;
  - the wrappers `bwd_dq` (taking o, returning dq and delta) and `bwd_dkv`
    (taking that delta) called one by one, against the same;
  - the port's differentiable `flash_attend` (its `torch.autograd.Function`)
    under `torch.autograd.grad` against `jax.grad` of the JAX `flash_attend`
    custom VJP.
The cases mirror tests/test_flash_attention.py's fused-backward tests
(N >= 121, where the JAX VJP takes the fused backward and so the kernel's
special-token period under an offset). Tolerance: 5e-5 absolute, 1e-3
relative, as those tests. The CUDA kernels are held against the plain
versions by tests/test_torch_cuda.py on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamer4_tpu.ops.flash_attention import flash_attend as j_flash_attend
from dreamer4_tpu.ops.flash_attention import flash_attend_bwd as j_flash_attend_bwd
from dreamer4_tpu.ops.flash_attention import flash_attend_fwd as j_flash_attend_fwd
from dreamer4_tpu.ops.flash_attention import make_config
from dreamer4_torch.ops import flash_attention as fa

torch.set_num_threads(1)

# name: (B, Hq, H, N, M, D, offset, kv_len), mask config
CASES = {
    'causal_softclamp': ((1, 2, 2, 128, 128, 32, 0, 128), dict(causal=True)),
    'causal_gqa_no_softclamp': ((1, 4, 2, 128, 128, 32, 0, 128),
                                dict(causal=True, softclamp_value=None)),
    'special': ((1, 2, 2, 128, 128, 32, 0, 128), dict(num_special=4, special_seq_len=32)),
    'causal_gqa_special': ((1, 4, 2, 128, 128, 32, 0, 128),
                           dict(causal=True, num_special=4, special_seq_len=32)),
    'special_only_itself': ((1, 2, 2, 128, 128, 32, 0, 128),
                            dict(num_special=4, special_seq_len=32,
                                 special_attend_only_itself=True)),
    'unaligned_kv_len_offset': ((1, 2, 2, 130, 192, 16, 20, 150), dict(causal=True)),
    'offset_special': ((1, 2, 2, 130, 192, 16, 20, 150),
                       dict(causal=True, num_special=2, special_seq_len=9)),
}


def make_inputs(seed, shape):
    B, Hq, H, N, M, D = shape[:6]
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return mk(B, Hq, N, D), mk(B, H, M, D), mk(B, H, M, D), mk(B, Hq, N, D)


def full_cfg(cfg):
    return dict(dict(softclamp_value=50.0, causal=False, num_special=0, special_seq_len=0,
                     special_attend_only_itself=False), **cfg)


def assert_close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-5, rtol=1e-3)


@pytest.mark.parametrize('case', list(CASES))
def test_plain_backward_matches_jax_fused_backward(case):
    shape, cfg = CASES[case]
    offset, kv_len = shape[6], shape[7]
    q, k, v, g = make_inputs(0, shape)
    cfg = full_cfg(cfg)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, lse = j_flash_attend_fwd(jq, jk, jv, jnp.int32(offset), jnp.int32(kv_len),
                                  return_lse=True, interpret=True, **cfg)
    j_grads = j_flash_attend_bwd(jq, jk, jv, out, lse, jg, jnp.int32(offset),
                                 jnp.int32(kv_len), interpret=True, **cfg)
    N = q.shape[2]
    t_grads = fa.flash_attend_bwd(*map(torch.from_numpy, (q, k, v)),
                                  torch.from_numpy(np.array(out)),
                                  torch.from_numpy(np.array(lse)[..., :N]),
                                  torch.from_numpy(g), offset, kv_len, **cfg)
    for jx, tx in zip(j_grads, t_grads):
        assert tx.shape == jx.shape and tx.dtype == torch.float32
        assert_close(jx, tx.numpy())


@pytest.mark.parametrize('case', list(CASES))
def test_wrappers_match_jax_fused_backward(case):
    """The wrappers' own contract on CPU tensors: `bwd_dq` takes the output
    and returns (dq, delta), delta derived from o by the plain version;
    `bwd_dkv` takes that delta. Held against JAX's fused backward, and the
    delta against `attention_delta` exactly."""
    shape, cfg = CASES[case]
    offset, kv_len = shape[6], shape[7]
    q, k, v, g = make_inputs(4, shape)
    cfg = full_cfg(cfg)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, lse = j_flash_attend_fwd(jq, jk, jv, jnp.int32(offset), jnp.int32(kv_len),
                                  return_lse=True, interpret=True, **cfg)
    j_grads = j_flash_attend_bwd(jq, jk, jv, out, lse, jg, jnp.int32(offset),
                                 jnp.int32(kv_len), interpret=True, **cfg)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    to = torch.from_numpy(np.array(out))
    tlse = torch.from_numpy(np.array(lse)[..., :q.shape[2]])
    dq, delta = fa.bwd_dq(tq, tk, tv, to, tlse, tg, offset, kv_len, **cfg)
    dk, dv = fa.bwd_dkv(tq, tk, tv, tg, tlse, delta, offset, kv_len, **cfg)
    assert delta.dtype == torch.float32 and delta.shape == tlse.shape
    torch.testing.assert_close(delta, fa.attention_delta(to, tg), atol=0, rtol=0)
    for jx, tx in zip(j_grads, (dq, dk, dv)):
        assert tx.shape == jx.shape and tx.dtype == torch.float32
        assert_close(jx, tx.numpy())


@pytest.mark.parametrize('case', list(CASES))
def test_autograd_matches_jax_grad(case):
    shape, cfg = CASES[case]
    offset, kv_len = shape[6], shape[7]
    q, k, v, g = make_inputs(1, shape)
    cfg = full_cfg(cfg)
    jcfg = make_config(interpret=True, **cfg)

    def j_loss(q, k, v):
        return (j_flash_attend(q, k, v, jnp.int32(offset), jnp.int32(kv_len), jcfg) * g).sum()

    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attend(tq, tk, tv, offset, kv_len, **cfg)
    t_grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for jx, tx in zip(j_grads, t_grads):
        assert_close(jx, tx.numpy())


def test_autograd_needs_no_grad_of_every_input():
    """Only k requires grad: the backward still runs, and returns a gradient
    for k equal to the one with all three inputs differentiable."""
    shape, cfg = CASES['causal_gqa_special']
    q, k, v, g = map(torch.from_numpy, make_inputs(2, shape))
    kk = k.clone().requires_grad_()
    (dk_only,) = torch.autograd.grad(fa.flash_attend(q, kk, v, 0, 128, **cfg), (kk,), g)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    _, dk_all, _ = torch.autograd.grad(fa.flash_attend(qa, ka, va, 0, 128, **cfg),
                                       (qa, ka, va), g)
    torch.testing.assert_close(dk_only, dk_all, atol=0, rtol=0)


def test_lse_carries_no_gradient():
    shape, cfg = CASES['causal_softclamp']
    q, k, v, _ = map(torch.from_numpy, make_inputs(3, shape))
    q.requires_grad_()
    out, lse = fa.flash_attend(q, k, v, 0, 128, return_lse=True, **cfg)
    assert out.requires_grad and not lse.requires_grad
