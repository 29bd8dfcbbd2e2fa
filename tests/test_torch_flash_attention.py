"""K1, the port's flash-attention forward, against the JAX kernel.

On the CPU the port's `flash_attend` computes its plain version; it is held
against the JAX `flash_attend` run in Pallas interpret mode, over the grid
of tests/test_flash_attention.py and the rollout's prefill case (N < M,
kv_len < M). Tolerance: 2e-5 absolute, 1e-4 relative, as the JAX kernel's
own parity tests — both are float32 online/offline softmaxes of the same
scores. The CUDA kernel itself is held against the plain version by
tests/test_torch_cuda.py, which runs on a card only, and by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamer4_tpu.ops.flash_attention import flash_attend as j_flash_attend
from dreamer4_tpu.ops.flash_attention import flash_attend_fwd as j_flash_attend_fwd
from dreamer4_tpu.ops.flash_attention import make_config
from dreamer4_torch.ops import flash_attention as fa

torch.set_num_threads(1)


def make_qkv(seed, b, hq, h, n, m, d):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return mk(b, hq, n, d), mk(b, h, m, d), mk(b, h, m, d)


def run_pair(q, k, v, *, causal=False, softclamp=50.0, num_special=0, special_seq_len=0,
             special_only_itself=False, offset=0, kv_len=None):
    kv_len = kv_len if kv_len is not None else k.shape[-2]
    cfg = make_config(softclamp_value=softclamp, causal=causal, num_special=num_special,
                      special_seq_len=special_seq_len,
                      special_attend_only_itself=special_only_itself, interpret=True)
    out_jax = j_flash_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.int32(offset), jnp.int32(kv_len), cfg)
    out_torch = fa.flash_attend(*map(torch.from_numpy, (q, k, v)), offset, kv_len,
                                softclamp_value=softclamp, causal=causal,
                                num_special=num_special, special_seq_len=special_seq_len,
                                special_attend_only_itself=special_only_itself)
    return np.asarray(out_jax), out_torch.numpy()


def assert_close(a, b):
    np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('softclamp', [None, 50.0])
@pytest.mark.parametrize('gqa', [False, True])
def test_matches_jax_kernel(causal, softclamp, gqa):
    hq, h = (8, 4) if gqa else (4, 4)
    q, k, v = make_qkv(0, 2, hq, h, 64, 64, 32)
    assert_close(*run_pair(q, k, v, causal=causal, softclamp=softclamp))


@pytest.mark.parametrize('special_only_itself', [False, True])
def test_special_token_mask(special_only_itself):
    q, k, v = make_qkv(1, 1, 2, 2, 24, 24, 16)
    assert_close(*run_pair(q, k, v, num_special=3, special_seq_len=24,
                           special_only_itself=special_only_itself))


def test_periodic_special_mask_with_offset():
    """The special period applies to (q + offset), as in the kernel."""
    q, k, v = make_qkv(2, 1, 2, 2, 10, 30, 16)
    assert_close(*run_pair(q, k, v, causal=True, num_special=2, special_seq_len=6,
                           offset=7, kv_len=17))


def test_cached_decode_semantics():
    """Single query over a partially-filled KV buffer with causal offset."""
    q, k, v = make_qkv(3, 1, 2, 2, 1, 32, 16)
    assert_close(*run_pair(q, k, v, causal=True, offset=4, kv_len=5))


def test_prefill_over_cache_buffer():
    """The rollout's prefill: N prompt frames over a longer cache buffer,
    kv_len = N, causal, offset 0 (N < M, kv_len < M)."""
    q, k, v = make_qkv(4, 6, 4, 4, 12, 20, 16)
    assert_close(*run_pair(q, k, v, causal=True, offset=0, kv_len=12))


def test_lse_matches_jax_kernel():
    q, k, v = make_qkv(5, 2, 4, 2, 40, 56, 32)
    out_j, lse_j = j_flash_attend_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.int32(3), jnp.int32(50), causal=True,
                                      softclamp_value=30.0, interpret=True, return_lse=True)
    out_t, lse_t = fa.flash_attend(*map(torch.from_numpy, (q, k, v)), 3, 50, causal=True,
                                   softclamp_value=30.0, return_lse=True)
    assert_close(np.asarray(out_j), out_t.numpy())
    assert_close(np.asarray(lse_j)[..., :40], lse_t.numpy())


@pytest.mark.parametrize('bad', ['kv_len', 'heads', 'dtype', 'softclamp'])
def test_wrapper_rejects_bad_input(bad):
    q, k, v = map(torch.from_numpy, make_qkv(6, 1, 4, 2, 8, 8, 16))
    kw = dict(softclamp_value=50.0)
    kv_len = 8
    if bad == 'kv_len':
        kv_len = 9
    elif bad == 'heads':
        q = q[:, :3]
    elif bad == 'dtype':
        k = k.double()
    else:
        kw['softclamp_value'] = 0.0
    with pytest.raises(ValueError):
        fa.flash_attend(q, k, v, 0, kv_len, **kw)
