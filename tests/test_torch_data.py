"""The port's data plane (`dreamer4_torch/data/`: the replay buffer, the
video datasets, the native prefetch sampler and the experience <-> buffer
bridge) against the JAX package's, on the CPU.

The port keeps copies of the JAX package's numpy modules, so everything
here is held exactly: the files a buffer writes (byte for byte, so a
buffer written by either package opens in the other), sampled batches,
dataset batches, the native and the synchronous prefetch paths, and the
experiences read back from a buffer.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamer4_torch.data import datasets as tds
from dreamer4_torch.data import experience as texp
from dreamer4_torch.data import prefetch as tpf
from dreamer4_torch.data.replay_buffer import ReplayBuffer as TBuffer
from dreamer4_torch.nn.action_embedder import Actions as TActions
from dreamer4_tpu.data import datasets as jds
from dreamer4_tpu.data import experience as jexp
from dreamer4_tpu.data import prefetch as jpf
from dreamer4_tpu.data.replay_buffer import ReplayBuffer as JBuffer
from dreamer4_tpu.data.video_io import save_gif
from dreamer4_tpu.nn.action_embedder import Actions as JActions

REPO = Path(__file__).resolve().parent.parent

FIELDS = dict(video=('uint8', (3, 8, 8)), rewards='float', terminated='bool',
              discrete_actions='int', proprio=('float', (2,)))
META = dict(task=('int', ()), goal=('float', (3,)))


def fill(buffer_cls, folder, seed=0, n_episodes=7, max_timesteps=12):
    """A buffer of `n_episodes` episodes of random lengths (one batched
    write of two, the rest one by one), written from one seed."""
    rng = np.random.default_rng(seed)
    buf = buffer_cls(folder, max_episodes=6, max_timesteps=max_timesteps,
                     fields=FIELDS, meta_fields=META)

    def step_data(b=None):
        shape = () if b is None else (b,)
        return dict(video=rng.integers(0, 256, (*shape, 3, 8, 8)).astype(np.uint8),
                    rewards=rng.standard_normal(shape).astype(np.float32),
                    terminated=rng.random(shape) < 0.2,
                    discrete_actions=rng.integers(0, 4, shape),
                    proprio=rng.standard_normal((*shape, 2)).astype(np.float32))

    with buf.batched_episode(2, task=np.array([3, 4]),
                             goal=rng.standard_normal((2, 3)).astype(np.float32)):
        for _ in range(int(rng.integers(2, max_timesteps))):
            buf.store_batch(**step_data(2))
    for i in range(n_episodes - 2):   # wraps around the 6 slots
        with buf.one_episode(task=i, goal=rng.standard_normal(3).astype(np.float32)):
            for _ in range(int(rng.integers(1, max_timesteps + 1))):
                buf.store(**step_data())
    return buf


def assert_same_files(a: Path, b: Path):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def assert_equal_dicts(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=k)


# ----------------------------------------------------------- replay buffer

def test_replay_buffer_files_are_byte_equal_and_open_across_packages(tmp_path):
    jbuf = fill(JBuffer, tmp_path / 'jax')
    tbuf = fill(TBuffer, tmp_path / 'torch')
    assert_same_files(tmp_path / 'jax', tmp_path / 'torch')

    # each package reopens the other's buffer with equal episodes
    t_of_j, j_of_t = TBuffer.open(tmp_path / 'jax'), JBuffer.open(tmp_path / 'torch')
    assert t_of_j.num_episodes == jbuf.num_episodes == 6
    assert t_of_j.fields == jbuf.fields and t_of_j.meta_fields == jbuf.meta_fields
    for i in range(jbuf.num_episodes):
        assert_equal_dicts(t_of_j.get_episode(i), jbuf.get_episode(i))
        assert_equal_dicts(j_of_t.get_episode(i, truncate=False),
                           tbuf.get_episode(i, truncate=False))

    # a write through the port into the JAX package's buffer, read back there
    with t_of_j.one_episode(task=9, goal=np.ones(3, np.float32)) as slot:
        t_of_j.store(video=np.full((3, 8, 8), 7, np.uint8), rewards=1.5, terminated=True,
                     discrete_actions=2, proprio=np.array([1.0, -1.0], np.float32))
    ep = JBuffer.open(tmp_path / 'jax').get_episode(slot)
    assert ep['_length'] == 1 and ep['task'] == 9 and float(ep['rewards'][0]) == 1.5


@pytest.mark.parametrize('seq_len', [None, 5, 12])
def test_sample_batch_matches_jax(tmp_path, seq_len):
    buf = fill(JBuffer, tmp_path / 'buf')
    tbuf = TBuffer.open(tmp_path / 'buf')
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        assert_equal_dicts(tbuf.sample_batch(trng, 4, seq_len),
                           buf.sample_batch(jrng, 4, seq_len))


# ---------------------------------------------------------------- datasets

def make_video_folder(path, n_videos=5, size=16, sidecars=False):
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n_videos):
        frames = 3 + i % 3
        save_gif(path / f'ep{i}.gif', rng.random((3, frames, size, size)).astype(np.float32))
        if sidecars:
            np.save(path / f'ep{i}.actions.npy', rng.integers(0, 3, (frames,)).astype(np.int64))
            np.save(path / f'ep{i}.rewards.npy', rng.random((frames,)).astype(np.float32))
            np.save(path / f'ep{i}.terminated.npy', rng.random((frames,)) < 0.3)
    return path


def snake_buffer(buffer_cls, folder):
    rng = np.random.default_rng(5)
    buf = buffer_cls(folder, max_episodes=6, max_timesteps=9,
                     fields=dict(video=('uint8', (3, 8, 8)), rewards='float',
                                 terminated='bool', discrete_actions='int'))
    for _ in range(6):
        with buf.one_episode():
            for _ in range(int(rng.integers(2, 10))):
                buf.store(video=rng.integers(0, 256, (3, 8, 8)).astype(np.uint8),
                          rewards=float(rng.standard_normal()), terminated=False,
                          discrete_actions=int(rng.integers(4)))
    return buf


@pytest.mark.parametrize('kind', ['folder', 'glob', 'sidecars', 'replay_buffer'])
def test_dataset_batches_match_jax(tmp_path, kind):
    if kind == 'replay_buffer':
        snake_buffer(JBuffer, tmp_path / 'buf')
        jdata = jds.VideoDatasetFromReplayBuffer(JBuffer.open(tmp_path / 'buf'), num_frames=4,
                                                 seed=1)
        tdata = tds.VideoDatasetFromReplayBuffer(TBuffer.open(tmp_path / 'buf'), num_frames=4,
                                                 seed=1)
    else:
        folder = make_video_folder(tmp_path / 'videos', sidecars=kind == 'sidecars')
        spec = str(folder / 'ep*.gif') if kind == 'glob' else str(folder)
        cls = 'VideoTrajectoryDataset' if kind == 'sidecars' else 'VideoDataset'
        jdata = getattr(jds, cls)(spec, image_size=(8, 8), num_frames=4, seed=1)
        tdata = getattr(tds, cls)(spec, image_size=(8, 8), num_frames=4, seed=1)
        assert [p.name for p in tdata.paths] == [p.name for p in jdata.paths]
    jit = jds.batch_iterator(jdata, 2, rng=np.random.default_rng(2))
    tit = tds.batch_iterator(tdata, 2, rng=np.random.default_rng(2))
    for _ in range(4):   # past one epoch: a new permutation
        assert_equal_dicts(next(tit), next(jit))


def test_prefetch_batches_and_pixel_shift_match_jax():
    video = np.random.default_rng(0).random((3, 3, 4, 12, 12)).astype(np.float32)
    for prob in (0.0, 0.5, 1.0):
        jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
        for _ in range(3):
            (jv, jid), (tv, tid) = (jds.randomly_apply_aug(jrng, video, prob=prob),
                                    tds.randomly_apply_aug(trng, video, prob=prob))
            assert jid == tid
            np.testing.assert_array_equal(tv, jv)
    batches = [{'x': np.full((2,), i)} for i in range(5)]
    assert [int(b['x'][0]) for b in tds.prefetch_batches(iter(batches))] == list(range(5))

    def failing():
        yield {'x': 0}
        raise ValueError('broken source')

    with pytest.raises(ValueError, match='broken source'):
        list(tds.prefetch_batches(failing()))


# ---------------------------------------------------------------- prefetch

def test_native_prefetch_library_builds_into_package_build_dir():
    assert tpf.available(), tpf.load_error()
    path = tpf.library_path()
    assert path.parent == REPO / 'dreamer4_torch' / 'build' and path.exists()


@pytest.mark.parametrize('convert', [(), ('video',)])
def test_prefetch_sampler_matches_jax_and_sync_path(tmp_path, monkeypatch, convert):
    """The port's native sampler, the JAX package's and the port's
    synchronous fallback give equal batches, each `sample_batch` under the
    same draws (uint8 fields mapped to [0, 1] float32 when asked); the
    reused double buffers hold zeros past each episode's end."""
    jbuf = fill(JBuffer, tmp_path / 'buf')
    tbuf = TBuffer.open(tmp_path / 'buf')

    def sampler(module, buf):
        s = module.PrefetchSampler(buf, batch_size=5, seq_len=10,
                                   rng=np.random.default_rng(11), convert_uint8_fields=convert,
                                   num_workers=3)
        for out in s._bufs:   # stale data from an earlier batch must not survive
            for v in out.values():
                v.fill(1)
        return s

    native_t, native_j = sampler(tpf, tbuf), sampler(jpf, jbuf)
    with monkeypatch.context() as m:
        m.setattr(tpf, '_load_library', lambda: None)
        sync_t = sampler(tpf, tbuf)
    assert native_t.engine._handle is not None and sync_t.engine._handle is None
    ref_rng = np.random.default_rng(11)
    for _ in range(4):
        ref = tbuf.sample_batch(ref_rng, 5, 10)
        for k in convert:
            ref[k] = ref[k].astype(np.float32) / 255.0
        got_t, got_j, got_sync = (dict(next(s)) for s in (native_t, native_j, sync_t))
        assert_equal_dicts(got_t, got_j)
        assert_equal_dicts(got_sync, got_t)
        assert sorted(got_t) == sorted(ref)
        for k, v in ref.items():
            if k in convert:
                np.testing.assert_allclose(got_t[k], v, rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(got_t[k], v, err_msg=k)
    for s in (native_t, native_j, sync_t):
        s.close()


# ------------------------------------------------------------- experience

def experience_arrays(seed=0, b=3, t=5):
    rng = np.random.default_rng(seed)
    return dict(
        latents=rng.standard_normal((b, t, 4, 6)).astype(np.float32),
        video=rng.random((b, 3, t, 8, 8)).astype(np.float32),
        rewards=rng.standard_normal((b, t)).astype(np.float32),
        values=rng.standard_normal((b, t)).astype(np.float32),
        actions=rng.integers(0, 4, (b, t, 1)).astype(np.int32),
        log_probs=rng.standard_normal((b, t, 1)).astype(np.float32),
        lens=np.array([t, 2, 4][:b], np.int32),
        terminals=np.array([False, True, True][:b]),
        is_truncated=np.array([True, False, False][:b]),
        episode_return=rng.standard_normal(b).astype(np.float32))


def jax_experience(a):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    return jexp.Experience(latents=j['latents'], video=j.get('video'), rewards=j['rewards'],
                           values=j['values'], actions=JActions(j['actions'], None),
                           log_probs=JActions(j['log_probs'], None), lens=j['lens'],
                           terminals=j['terminals'], is_truncated=j['is_truncated'],
                           episode_return=j['episode_return'], step_size=16)


def torch_experience(a):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    t['actions'], t['lens'] = t['actions'].long(), t['lens'].long()
    return texp.Experience(latents=t['latents'], video=t.get('video'), rewards=t['rewards'],
                           values=t['values'], actions=TActions(t['actions'], None),
                           log_probs=TActions(t['log_probs'], None), lens=t['lens'],
                           terminals=t['terminals'], is_truncated=t['is_truncated'],
                           episode_return=t['episode_return'], step_size=16)


def test_experience_buffer_round_trip_matches_jax(tmp_path):
    """Without video (which the JAX package cannot store, below) both
    packages write byte-equal buffers and read equal experiences back."""
    a = experience_arrays()
    a.pop('video')
    b = experience_arrays(1, b=2, t=3)
    b.pop('video')
    je, te = jax_experience(a), torch_experience(a)
    assert texp.experience_buffer_fields(te) == jexp.experience_buffer_fields(je)

    jbuf = jexp.create_experience_replay_buffer(je, tmp_path / 'jax', 4, 6)
    tbuf = texp.create_experience_replay_buffer(te, tmp_path / 'torch', 4, 6)
    for arrays in (a, b):
        jexp.add_experience_to_buffer(jax_experience(arrays), jbuf)
        texp.add_experience_to_buffer(torch_experience(arrays), tbuf)
    assert_same_files(tmp_path / 'jax', tmp_path / 'torch')

    batch = tbuf.sample_batch(np.random.default_rng(0), 4, 6)
    jout = jexp.experience_from_batch(batch)
    tout = texp.experience_from_batch(batch, device='cpu')
    assert tout.step_size == jout.step_size == 16
    for name in ('latents', 'rewards', 'values', 'lens', 'terminals', 'is_truncated',
                 'episode_return'):
        np.testing.assert_array_equal(getattr(tout, name).numpy(),
                                      np.asarray(getattr(jout, name)), err_msg=name)
    for name in ('actions', 'log_probs'):
        np.testing.assert_array_equal(getattr(tout, name).discrete.numpy(),
                                      np.asarray(getattr(jout, name).discrete), err_msg=name)
    # the tensors are copies: the batch's arrays may be reused
    batch['latents'][:] = 0
    assert tout.latents.abs().sum() > 0


def test_experience_buffer_stores_video_by_frame(tmp_path):
    """The JAX package sizes the buffer's `video` field from (t, h, w)
    (`experience_buffer_fields`, `dreamer4_tpu/data/experience.py:169`), so
    storing an experience with video raises there; the port stores each
    frame as (c, h, w) and reads the video back."""
    a = experience_arrays()
    je, te = jax_experience(a), torch_experience(a)
    assert jexp.experience_buffer_fields(je)[0]['video'] == ('float', (5, 8, 8))
    assert texp.experience_buffer_fields(te)[0]['video'] == ('float', (3, 8, 8))
    with pytest.raises(ValueError, match='broadcast'):
        jexp.add_experience_to_buffer(
            je, jexp.create_experience_replay_buffer(je, tmp_path / 'jax', 4, 6))

    tbuf = texp.create_experience_replay_buffer(te, tmp_path / 'torch', 4, 6)
    texp.add_experience_to_buffer(te, tbuf)
    out = texp.experience_from_batch({**tbuf.get_episode(1, truncate=False),
                                      'video': tbuf.get_episode(1, truncate=False)['video'][None]},
                                     device='cpu')
    # every row stores the longest row's frames; the episode's length is its own
    assert tbuf.episode_length(1) == a['lens'][1]
    np.testing.assert_array_equal(out.video[0, :, :5].numpy(), a['video'][1])


def test_experience_from_batch_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        texp.experience_from_batch({'latents': np.zeros((1, 2, 3, 4), np.float32)})


def test_data_plane_cli_and_serving_import_no_jax():
    code = ('import sys, dreamer4_torch, dreamer4_torch.cli, dreamer4_torch.data, '
            'dreamer4_torch.data.video_io, dreamer4_torch.envs.snake, '
            'dreamer4_torch.envs.wrappers, dreamer4_torch.envs.world_model_env, '
            'dreamer4_torch.serve.server, dreamer4_torch.train.logging; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "dreamer4_tpu")]; '
            'print(bad); sys.exit(1 if bad else 0)')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
