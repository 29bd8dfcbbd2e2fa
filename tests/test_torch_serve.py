"""Serving in the port (`envs/snake.py`, `envs/wrappers.py`,
`envs/world_model_env.py`, `serve/server.py`) against the JAX package's, on
the CPU.

Snake, the record wrappers and the PNG encoder are copies and are held
exactly. `DynamicsWorldModelWrapper` gets the JAX models' weights
(converted) and the JAX wrapper's draws, replayed through
`envs.world_model_env.draw`: per call c (reset is 0, step i is i) the JAX
wrapper splits its key into (key, sub) and `sub` into the noise, forward
and terminal keys; the frame's starting noise is `normal(k_noise)`, its
terminal draw `uniform(k_term)` (`jax.random.bernoulli`'s draw), and with
pixel observations a second split gives the tokenizer decode's key, whose
normal draw is recorded by wrapping `jax.random.normal` while the JAX
decode runs.

Tolerances, float32: observations (latents, or decoded pixels in [0, 1])
and rewards 1e-4 absolute (one dreamed frame is five passes of the world
model, then a decoder pass: at most 4e-6 apart here); terminal and
truncation flags exactly equal. Served frames are PNGs of the
observations rounded to uint8, so they may differ by 1 where a pixel lies
at a rounding boundary.
"""
import functools
import json
import struct
import threading
import urllib.error
import urllib.request
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamer4_tpu.data.replay_buffer import ReplayBuffer as JBuffer
from dreamer4_tpu.envs import snake as jsnake
from dreamer4_tpu.envs import wrappers as jwrappers
from dreamer4_tpu.envs.world_model_env import DynamicsWorldModelWrapper as JWrapper
from dreamer4_tpu.models.tokenizer import VideoTokenizer as JTokenizer
from dreamer4_tpu.models.world_model import DynamicsWorldModel as JWorldModel
from dreamer4_tpu.serve import server as jserver
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.data.replay_buffer import ReplayBuffer as TBuffer
from dreamer4_torch.envs import snake as tsnake
from dreamer4_torch.envs import world_model_env
from dreamer4_torch.envs import wrappers as twrappers
from dreamer4_torch.envs.world_model_env import DynamicsWorldModelWrapper
from dreamer4_torch.models.tokenizer import VideoTokenizer
from dreamer4_torch.models.world_model import DynamicsWorldModel
from dreamer4_torch.serve import server as tserver

torch.set_num_threads(1)
TOL = 1e-4
# tests/test_serving_and_wrappers.py:84-88, with a terminal head (the default)
WM = dict(dim=16, dim_latent=8, num_latent_tokens=4, max_steps=8, depth=1, time_block_every=1,
          num_spatial_tokens=4, num_discrete_actions=(4,), attn_dim_head=8, attn_heads=2,
          multi_token_pred_len=2, num_register_tokens=2)
# latents sized for WM
TOKENIZER = dict(dim=16, dim_latent=8, patch_size=16, image_height=32, image_width=32,
                 num_latent_tokens=4, encoder_depth=1, decoder_depth=1, time_block_every=1,
                 attn_dim_head=8, attn_heads=2)
WRAPPER = dict(num_steps=2, max_timesteps=4, seed=5)


# ------------------------------------------------------------------ models

@functools.cache
def jax_variables():
    jm, jt = JWorldModel(**WM), JTokenizer(**TOKENIZER)
    wm_vars = jax.jit(lambda rngs: jm.init(
        rngs, latents=jnp.zeros((1, 3, 4, 8)), shortcut_train=False, rewards=jnp.zeros((1, 3)),
        discrete_actions=jnp.zeros((1, 2, 1), jnp.int32)))(
        {'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)})
    tok_vars = jax.jit(lambda rngs: jt.init(rngs, jnp.zeros((1, 3, 2, 32, 32))))(
        {'params': jax.random.PRNGKey(2), 'sample': jax.random.PRNGKey(3)})
    return jax.tree.map(np.asarray, wm_vars), jax.tree.map(np.asarray, tok_vars)


def build_wrappers(pixels: bool, batch_size: int):
    """The JAX wrapper and the port's over the same weights."""
    wm_vars, tok_vars = jax_variables()
    tm = DynamicsWorldModel(**WM, device='cpu')
    tm.load_state_dict(flax_params_to_torch(wm_vars['params'], tm))
    tt = None
    if pixels:
        tt = VideoTokenizer(**TOKENIZER, device='cpu')
        tt.load_state_dict(flax_params_to_torch(tok_vars['params'], tt, state=tok_vars['state']))
    jw = JWrapper(JWorldModel(**WM), wm_vars, tokenizer=JTokenizer(**TOKENIZER) if pixels else None,
                  tokenizer_variables=tok_vars if pixels else None, batch_size=batch_size,
                  **WRAPPER)
    tw = DynamicsWorldModelWrapper(tm, tokenizer=tt, batch_size=batch_size, device='cpu',
                                   **WRAPPER)
    return jw, tw


@functools.cache
def jax_decode_noise_fn(batch_size: int):
    """key -> the normal draw of the JAX tokenizer's decode under that key
    (recorded while a jitted decode is traced and returned from it)."""
    _, tok_vars = jax_variables()
    jt, real = JTokenizer(**TOKENIZER), jax.random.normal

    def run(key):
        values = []

        def recording(*args, **kwargs):
            values.append(real(*args, **kwargs))
            return values[-1]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, 'normal', recording)
            jt.apply(tok_vars, jnp.zeros((batch_size, 1, 4, 8)), method=jt.decode,
                     rngs={'sample': key})
        assert len(values) == 1
        return values[0]

    return jax.jit(run)


def jax_wrapper_draws(seed: int, calls: int, batch_size: int, pixels: bool):
    """The JAX wrapper's draws for `calls` calls (reset, then steps), in
    the port's `envs.world_model_env.draw` signature."""
    draws = {'noise': [], 'terminal': [], 'decode': []}
    key = jax.random.PRNGKey(seed)
    for _ in range(calls):
        key, sub = jax.random.split(key)
        k_noise, _, k_term = jax.random.split(sub, 3)
        draws['noise'].append(np.asarray(jax.random.normal(k_noise, (batch_size, 1, 4, 8))))
        draws['terminal'].append(np.asarray(jax.random.uniform(k_term, (batch_size,))))
        if pixels:
            key, sub = jax.random.split(key)
            draws['decode'].append(np.asarray(jax_decode_noise_fn(batch_size)(sub)))

    def draw(kind, frame, shape, *, generator, device):
        x = draws[kind][frame]
        assert x.shape == tuple(shape), (kind, x.shape, shape)
        return torch.from_numpy(x.copy()).to(device)

    return draw


def replay_wrapper_draws(monkeypatch, calls, batch_size, pixels):
    monkeypatch.setattr(world_model_env, 'draw',
                        jax_wrapper_draws(WRAPPER['seed'], calls, batch_size, pixels))


# ------------------------------------------------------------------- snake

def test_snake_and_wrappers_match_jax(tmp_path):
    """Snake episodes from one seed, and what the three wrappers record or
    pass on, are equal in both packages."""
    actions = np.random.default_rng(0).integers(0, 4, 60)

    def run(snake, wrappers, buffer_cls, root):
        buf = buffer_cls(root / 'buf', max_episodes=8, max_timesteps=21,
                         fields=dict(video=('uint8', (3, 16, 16)), rewards='float',
                                     terminated='bool', discrete_actions='int'))
        env = wrappers.RecordToReplayBufferEnvWrapper(
            wrappers.RecordToFolderEnvWrapper(
                snake.SnakeEnv(grid_size=4, max_steps=20, image_size=16, seed=3),
                root / 'eps'), buf)
        trace = [env.reset(seed=1)[0]]
        for a in actions:
            obs, reward, terminated, truncated, info = env.parse_step(env.step(int(a)))
            trace += [obs, reward, terminated, truncated, info]
            if terminated or truncated:
                trace.append(env.reset()[0])
        env.close()
        return trace

    jtrace = run(jsnake, jwrappers, JBuffer, tmp_path / 'jax')
    ttrace = run(tsnake, twrappers, TBuffer, tmp_path / 'torch')
    assert len(jtrace) == len(ttrace)
    for j, t in zip(jtrace, ttrace):
        if isinstance(j, np.ndarray):
            assert t.dtype == j.dtype
            np.testing.assert_array_equal(t, j)
        else:
            assert type(t) is type(j) and t == j, (t, j)
    for sub in ('buf', 'eps'):
        names = sorted(p.name for p in (tmp_path / 'jax' / sub).iterdir())
        assert names == sorted(p.name for p in (tmp_path / 'torch' / sub).iterdir())
        assert len(names) > 3
        for name in names:
            assert ((tmp_path / 'jax' / sub / name).read_bytes()
                    == (tmp_path / 'torch' / sub / name).read_bytes()), name

    calls = {'jax': [], 'torch': []}

    class Env:
        def __init__(self, log):
            self.log = log

        def reset(self, **kw):
            return np.zeros(3), {}

        def step(self, action):
            self.log.append(action)
            return np.zeros(3), 0.0, False, False, {}

    for wrappers, log in ((jwrappers, calls['jax']), (twrappers, calls['torch'])):
        double = lambda a: (a[0], a[1] * 2.0) if isinstance(a, tuple) else a * 2.0
        env = wrappers.ActionTransformWrapper(Env(log), transform_fn=double, clip=(-1, 1))
        env.reset()
        env.step(np.array([0.4, -3.0]))
        env.step((1, np.array([0.7])))
    np.testing.assert_array_equal(calls['torch'][0], calls['jax'][0])
    assert calls['torch'][1][0] == calls['jax'][1][0]
    np.testing.assert_array_equal(calls['torch'][1][1], calls['jax'][1][1])

    rng = np.random.default_rng(4)
    for obs in (rng.random((3, 8, 8)), (rng.random((8, 8, 3)) * 255).astype(np.uint8),
                {'image': rng.random((1, 4, 4))}, {'pixels': rng.random((4, 4, 1))},
                rng.random(5), {'state': rng.random(3)}):
        j, t = jwrappers.extract_image(obs), twrappers.extract_image(obs)
        assert (j is None) == (t is None)
        if j is not None:
            np.testing.assert_array_equal(t, j)


def test_encode_png_gives_equal_bytes():
    rng = np.random.default_rng(0)
    for image in (rng.random((3, 5, 7)).astype(np.float32), rng.random((1, 4, 4)),
                  (rng.random((6, 3, 3)) * 255).astype(np.uint8), rng.random((3, 2, 2)) * 3 - 1):
        png = tserver.encode_png(image)
        assert png == jserver.encode_png(image)
        assert png[:8] == b'\x89PNG\r\n\x1a\n'


# ------------------------------------------------------------------ wrapper

@pytest.mark.parametrize('pixels,batch_size', [(False, 1), (True, 2)])
def test_world_model_wrapper_matches_jax(monkeypatch, pixels, batch_size):
    jw, tw = build_wrappers(pixels, batch_size)
    steps = WRAPPER['max_timesteps']
    replay_wrapper_draws(monkeypatch, steps + 1, batch_size, pixels)
    jobs, _ = jw.reset()
    tobs, _ = tw.reset()
    shape = (batch_size, 3, 32, 32) if pixels else (batch_size, 4, 8)
    assert jobs.shape == tobs.shape == shape
    np.testing.assert_allclose(tobs, jobs, atol=TOL, rtol=0)
    actions = np.random.default_rng(1).integers(0, 4, (steps, batch_size))
    terminals = []
    for i in range(steps):
        action = int(actions[i, 0]) if batch_size == 1 else actions[i]
        jout, tout = jw.step(action), tw.step(action)
        np.testing.assert_allclose(tout[0], jout[0], atol=TOL, rtol=0, err_msg=f'obs {i}')
        np.testing.assert_allclose(tout[1], jout[1], atol=TOL, rtol=0, err_msg=f'reward {i}')
        for k in (2, 3):
            np.testing.assert_array_equal(tout[k], jout[k])
        if batch_size == 1:   # the counterpart's return types at batch 1
            assert [type(x) for x in tout[1:4]] == [float, bool, bool]
        terminals.append(np.asarray(tout[2]))
    assert tout[3] if batch_size == 1 else tout[3].all()   # truncated at max_timesteps
    # the draws were live: some frames ended an episode and some did not
    assert 0 < np.mean(terminals) < 1


# ------------------------------------------------------------------ servers

def decode_png(data: bytes) -> np.ndarray:
    """(h, w, 3) uint8 of a PNG as `encode_png` writes it (filter 0)."""
    pos, idat, w, h = 8, b'', 0, 0
    while pos < len(data):
        (length,), tag = struct.unpack('>I', data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b'IHDR':
            w, h = struct.unpack('>II', body[:8])
        elif tag == b'IDAT':
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not rows[:, 0].any()
    return rows[:, 1:].reshape(h, w, 3)


class Served:
    """A server on a free local port, in a thread, for the block."""

    def __init__(self, server):
        self.server = server
        self.url = f'http://127.0.0.1:{server.httpd.server_address[1]}'

    def __enter__(self):
        self.thread = threading.Thread(target=self.server.httpd.serve_forever, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.httpd.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()

    def get(self, path):
        with urllib.request.urlopen(self.url + path, timeout=60) as r:
            body = r.read()
        return json.loads(body) if path.startswith('/api') else body.decode()

    def post(self, path, payload=None):
        req = urllib.request.Request(self.url + path, method='POST',
                                     data=json.dumps(payload or {}).encode(),
                                     headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())


def test_served_world_model_matches_jax(monkeypatch):
    """Serving end to end: each package's `WebEnvServer` over its own
    wrapper (the same weights, the JAX draws replayed) answers `/reset` and
    three `/step`s with equal flags, rewards within the tolerance and
    decoded frames within one level of 255."""
    jw, tw = build_wrappers(pixels=True, batch_size=1)
    replay_wrapper_draws(monkeypatch, 4, 1, pixels=True)
    answers = {}
    for name, server_module, env in (('jax', jserver, jw), ('torch', tserver, tw)):
        with Served(server_module.WebEnvServer(env, port=0, host='127.0.0.1')) as s:
            answers[name] = [s.post('/reset')] + [s.post('/step', {'action': a})
                                                 for a in (1, 3, 2)]
            page = s.get('/')
        assert {'jax': 'dreamer4_tpu', 'torch': 'dreamer4_torch'}[name] in page
        for marker in ("post('/step'", "post('/reset'", 'data.frame', 'KEYMAP', 'steps_left'):
            assert marker in page
    for j, t in zip(answers['jax'], answers['torch']):
        assert sorted(j) == sorted(t)
        jf, tf = decode_png(jserver.base64.b64decode(j['frame'])), \
            decode_png(tserver.base64.b64decode(t['frame']))
        assert jf.shape == tf.shape == (32, 32, 3)
        assert np.abs(jf.astype(int) - tf.astype(int)).max() <= 1
        assert t['steps_left'] == j['steps_left']
        if 'reward' in j:
            assert abs(t['reward'] - j['reward']) <= TOL
            assert all(t[k] == j[k] for k in ('terminated', 'truncated', 'done'))


def test_served_snake_and_inspector_match_jax(tmp_path):
    """Snake served from one seed gives equal answers (the Snake command
    of `serve-world-model`), and the replay-buffer inspector's `/api/*`
    JSON is equal in both packages."""
    answers = {}
    for name, server_module, snake in (('jax', jserver, jsnake), ('torch', tserver, tsnake)):
        with Served(server_module.WebEnvServer(snake.SnakeEnv(grid_size=4, seed=0), port=0,
                                               host='127.0.0.1')) as s:
            answers[name] = [s.post('/reset')] + [s.post('/step', {'action': a})
                                                 for a in (1, 1, 2, 3, 0)]
    assert answers['torch'] == answers['jax']
    assert answers['torch'][1]['steps_left'] == 19

    buf = JBuffer(tmp_path / 'buf', max_episodes=4, max_timesteps=10,
                  fields=dict(video=('uint8', (3, 8, 8)), rewards='float', terminated='bool',
                              actions=('int', (1,))))
    rng = np.random.default_rng(0)
    for n in (4, 2):
        with buf.one_episode():
            for t in range(n):
                buf.store(video=(rng.random((3, 8, 8)) * 255).astype('uint8'),
                          rewards=float(t), terminated=t == n - 1, actions=np.array([t % 4]))
    paths = ('/api/stats', '/api/episodes', '/api/episode/0', '/api/episode/1', '/api/episode/7')
    pages = {}
    for name, server_module, buffer_cls in (('jax', jserver, JBuffer),
                                             ('torch', tserver, TBuffer)):
        server = server_module.InspectReplayBufferServer(buffer_cls.open(tmp_path / 'buf'),
                                                         port=0, host='127.0.0.1')
        with Served(server) as s:
            got = []
            for path in paths:
                try:
                    got.append(s.get(path))
                except urllib.error.HTTPError as e:
                    got.append((e.code, json.loads(e.read())))
            pages[name] = got
            page = s.get('/')
        assert {'jax': 'dreamer4_tpu', 'torch': 'dreamer4_torch'}[name] in page
        for marker in ("'/api/stats'", "'/api/episodes'", "'/api/episode/'", 'ep.fields'):
            assert marker in page
    assert pages['torch'] == pages['jax']
    assert pages['torch'][0]['num_episodes'] == 2 and len(pages['torch'][2]['frames']) == 4
    assert pages['torch'][-1][0] == 404
