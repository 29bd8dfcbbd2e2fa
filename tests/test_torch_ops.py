"""The port's ops layer against the JAX package at f32 on the CPU: masks,
naive attention, rotary, norms, codecs, distributions, activations — and
that importing the port loads neither jax nor dreamer4_tpu.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerance: 2e-6 absolute unless stated — float32 results of the same
formulas, differing only in the order of sums.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamer4_tpu.nn.activations import get_activation as j_get_activation
from dreamer4_tpu.nn.norms import MultiHeadRMSNorm as JMultiHeadRMSNorm
from dreamer4_tpu.nn.norms import RMSNorm as JRMSNorm
from dreamer4_tpu.ops import dists as jdists
from dreamer4_tpu.ops.attention import naive_attend as j_naive_attend
from dreamer4_tpu.ops.codecs import get_reward_encoder as j_get_reward_encoder
from dreamer4_tpu.ops.masks import build_attend_mask as j_build_attend_mask
from dreamer4_tpu.ops.rotary import apply_rotations as j_apply_rotations
from dreamer4_tpu.ops.rotary import rotary_frequencies as j_rotary_frequencies
from dreamer4_tpu.ops.utils import l2norm as j_l2norm
from dreamer4_tpu.ops.utils import softclamp as j_softclamp
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.nn.activations import get_activation
from dreamer4_torch.nn.norms import MultiHeadRMSNorm, RMSNorm
from dreamer4_torch.ops import dists
from dreamer4_torch.ops.attention import naive_attend
from dreamer4_torch.ops.codecs import get_reward_encoder
from dreamer4_torch.ops.masks import build_attend_mask
from dreamer4_torch.ops.rotary import apply_rotations, rotary_frequencies
from dreamer4_torch.ops.utils import l2norm, softclamp

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
ATOL = 2e-6


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(j, t, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(j), t.detach().numpy(), atol=atol, rtol=rtol)


@pytest.mark.parametrize('causal,offset,num_special,block,only_itself', [
    (True, 0, 0, None, False),
    (True, 3, 0, None, False),
    (False, 0, 2, 7, False),
    (False, 0, 2, 7, True),
    (True, 2, 1, 5, False),
])
def test_masks_match(causal, offset, num_special, block, only_itself):
    kw = dict(causal=causal, causal_offset=offset, num_special=num_special,
              block_size_per_special=block, special_attend_only_itself=only_itself)
    j = j_build_attend_mask(6, 14, **kw)
    t = build_attend_mask(6, 14, **kw)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_unmasked_is_none():
    assert build_attend_mask(4, 4) is None


@pytest.mark.parametrize('gqa', [False, True])
@pytest.mark.parametrize('softclamp_value', [None, 50.0])
def test_naive_attend_matches(gqa, softclamp_value):
    rng = np.random.default_rng(0)
    hq, h = (4, 2) if gqa else (2, 2)
    q, k, v = rand(rng, 2, hq, 5, 16), rand(rng, 2, h, 7, 16), rand(rng, 2, h, 7, 16)
    mask = np.asarray(j_build_attend_mask(5, 7, causal=True, causal_offset=2))
    j = j_naive_attend(q, k, v, mask=mask, softclamp_value=softclamp_value)
    t = naive_attend(*map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(mask),
                     softclamp_value=softclamp_value)
    close(j, t)


def test_softclamp_l2norm():
    x = rand(np.random.default_rng(1), 3, 9) * 80
    close(j_softclamp(x, 30.0), softclamp(torch.from_numpy(x), 30.0), atol=1e-5)
    close(j_l2norm(x), l2norm(torch.from_numpy(x)))


@pytest.mark.parametrize('offset', [0, 5])
def test_rotary_matches(offset):
    x = rand(np.random.default_rng(2), 2, 3, 4, 16)
    jr = j_rotary_frequencies(16, 6, offset=offset)
    tr = rotary_frequencies(16, 6, offset=offset)
    close(jr, tr, atol=1e-5)
    # a table longer than the sequence is tail-aligned
    close(j_apply_rotations(jr, x), apply_rotations(tr, torch.from_numpy(x)), atol=1e-5)


def test_norms_match_with_converted_params():
    rng = np.random.default_rng(3)
    x = rand(rng, 2, 3, 5, 16)
    jn = JRMSNorm()
    params = jn.init(jax.random.PRNGKey(0), x)['params']
    params = {'scale': np.asarray(params['scale']) + rand(rng, 16) * 0.1}
    tn = RMSNorm(16)
    tn.load_state_dict(flax_params_to_torch(params, tn))
    close(jn.apply({'params': params}, x), tn(torch.from_numpy(x)))

    jm = JMultiHeadRMSNorm(16, 3)
    gamma = rand(rng, 3, 16) * 0.1
    tm = MultiHeadRMSNorm(16, 3)
    tm.load_state_dict(flax_params_to_torch({'gamma': gamma}, tm))
    close(jm.apply({'params': {'gamma': gamma}}, x), tm(torch.from_numpy(x)), atol=1e-5)


def test_norm_keeps_stream_dtype():
    x = torch.randn(2, 8, dtype=torch.bfloat16)
    assert RMSNorm(8)(x).dtype == torch.bfloat16


@pytest.mark.parametrize('name', ['hl_gauss', 'symexp_two_hot'])
def test_codecs_match(name):
    rng = np.random.default_rng(4)
    logits = rand(rng, 3, 41)
    values = rand(rng, 5) * 4
    j = j_get_reward_encoder(name, reward_range=(-5.0, 5.0), num_bins=41)
    t = get_reward_encoder(name, reward_range=(-5.0, 5.0), num_bins=41)
    close(j.decode(logits), t.decode(torch.from_numpy(logits)), atol=1e-5)
    close(j.encode(values), t.encode(torch.from_numpy(values)), atol=1e-5)


def test_discrete_dists_match():
    rng = np.random.default_rng(5)
    logits = (rand(rng, 6, 4), rand(rng, 6, 3))
    targets = np.stack([rng.integers(0, 4, 6), rng.integers(0, 3, 6)], -1).astype(np.int32)
    close(jdists.multi_categorical_log_prob(logits, targets),
          dists.multi_categorical_log_prob([torch.from_numpy(l) for l in logits],
                                           torch.from_numpy(targets)))
    # sampling is the Gumbel-max trick with JAX's own noise
    key = jax.random.PRNGKey(7)
    j = jdists.multi_categorical_sample(key, logits, temperature=0.7)
    keys = jax.random.split(key, 2)
    gumbels = [torch.from_numpy(np.array(jax.random.gumbel(k, l.shape)))
               for k, l in zip(keys, logits)]
    t = dists.multi_categorical_sample([torch.from_numpy(l) for l in logits], gumbels, 0.7)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize('name', ['silu', 'relu_squared', 'relu', 'gelu', 'sugar_bsilu'])
def test_activations_match(name):
    x = rand(np.random.default_rng(6), 64) * 3
    close(j_get_activation(name)(jnp.asarray(x)), get_activation(name)(torch.from_numpy(x)),
          atol=1e-5)


def test_sugar_bsilu_refuses_grad():
    """Its SUGAR backward against the JAX `custom_vjp`: ReLU in the forward,
    B-SiLU's derivative as the gradient (it no longer refuses autograd)."""
    x = rand(np.random.default_rng(7), 64) * 4
    w = rand(np.random.default_rng(8), 64)
    j_fn = lambda x: (j_get_activation('sugar_bsilu')(x) * w).sum()
    j_val, j_grad = jax.value_and_grad(j_fn)(jnp.asarray(x))
    tx = torch.from_numpy(x.copy()).requires_grad_()
    out = get_activation('sugar_bsilu')(tx)
    (out * torch.from_numpy(w)).sum().backward()
    assert torch.equal(out.detach(), torch.relu(tx.detach()))
    close(j_val, (out * torch.from_numpy(w)).sum().detach(), atol=1e-5)
    close(j_grad, tx.grad, atol=1e-6)
    assert (tx.grad[tx.detach() < 0] != 0).any()   # not ReLU's gradient


def test_import_leaves_jax_out():
    code = ('import sys, dreamer4_torch, dreamer4_torch.convert, '
            'dreamer4_torch.ops.flash_attention, dreamer4_torch.ops.cuda_build; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "dreamer4_tpu")]; '
            'print(bad); sys.exit(1 if bad else 0)')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    """Every kernel source is found, with the local headers it includes,
    transitively; an edit of a header changes the library name of every
    source that includes it, so a stale build is never loaded, and of no
    other. Needs no nvcc."""
    import shutil

    from dreamer4_torch.ops import cuda_build

    csrc = tmp_path / 'csrc'
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, 'CSRC_DIR', csrc)
    monkeypatch.setattr(cuda_build, 'nvcc_version', lambda: 'nvcc, a fixed version')
    names = cuda_build.kernel_names()
    assert names == ['attn_pool', 'flash_attn_bwd_dkv', 'flash_attn_bwd_dq', 'flash_attn_fwd',
                     'glu_ff', 'multi_tensor_optim', 'small_attn_bwd', 'small_attn_fwd']
    standalone = ['attn_pool', 'glu_ff', 'multi_tensor_optim']
    attention = [name for name in names if name not in standalone]
    for name in attention:
        # the small kernels' header includes both flash headers (the bf16
        # fragments, the mbarriers of their bulk-async ring)
        headers = (['small_attn_common.cuh'] if name.startswith('small') else []) + [
            'flash_attn_common.cuh', 'flash_attn_sm90.cuh']
        assert [p.name for p in cuda_build.source_files(name)] == [f'{name}.cu', *headers]
    for name in standalone:
        assert [p.name for p in cuda_build.source_files(name)] == [f'{name}.cu']
    before = {name: cuda_build.library_path(name) for name in names}
    assert before == {name: cuda_build.library_path(name) for name in names}
    header = csrc / 'flash_attn_common.cuh'
    header.write_text(header.read_text() + '\n// edited\n')
    assert all(cuda_build.library_path(name) != before[name] for name in attention)
    assert all(cuda_build.library_path(name) == before[name] for name in standalone)
