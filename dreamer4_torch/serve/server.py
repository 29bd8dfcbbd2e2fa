"""HTTP serving of environments / world models (a copy of
`dreamer4_tpu/serve/server.py`).

Equivalent of the reference `web_env/server.py:33-137` (WebEnvServer:
/reset and /step JSON endpoints with base64 PNG frames + a browser UI) and
`web_env/inspect_server.py:37-178` (replay-buffer inspector). Stdlib only.
"""
from __future__ import annotations

import base64
import io
import json
import struct
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

# browser UIs shipped with the package (the reference's `web_env/index.html`
# interactive play page and `web_env/inspect_index.html` episode inspector,
# re-implemented): served at `/` by WebEnvServer / InspectReplayBufferServer
_STATIC_DIR = Path(__file__).parent / 'static'


def _static_html(name: str) -> bytes:
    return (_STATIC_DIR / name).read_bytes()


def encode_png(image: np.ndarray) -> bytes:
    """Minimal RGB PNG encoder (no external deps). image: (3, h, w) float or
    (h, w, 3) uint8."""
    if image.ndim == 3 and image.shape[0] in (1, 3):
        image = np.moveaxis(image, 0, -1)
    if image.dtype != np.uint8:
        image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    if image.shape[-1] == 1:
        image = np.repeat(image, 3, axis=-1)
    h, w = image.shape[:2]

    raw = b''.join(b'\x00' + image[y].tobytes() for y in range(h))

    def chunk(tag, data):
        body = tag + data
        return struct.pack('>I', len(data)) + body + struct.pack('>I', zlib.crc32(body))

    ihdr = struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0)
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', ihdr)
            + chunk(b'IDAT', zlib.compress(raw))
            + chunk(b'IEND', b''))


class WebEnvServer:
    """Serves any gym-style env (including DynamicsWorldModelWrapper)."""

    def __init__(self, env, port: int = 8000, host: str = '0.0.0.0'):
        self.env = env
        self.port = port
        self.host = host
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ('/', '/index.html'):
                    body = _static_html('play.html')
                    self.send_response(200)
                    self.send_header('Content-Type', 'text/html')
                    self.send_header('Content-Length', str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._json({'error': 'not found'}, 404)

            def do_POST(self):
                length = int(self.headers.get('Content-Length', 0))
                payload = json.loads(self.rfile.read(length) or b'{}') if length else {}

                if self.path == '/reset':
                    out = outer.env.reset()
                    obs = out[0] if isinstance(out, tuple) else out
                    self._json({'frame': outer._frame_b64(obs),
                                'steps_left': outer._steps_left()})
                elif self.path == '/step':
                    action = payload.get('action', 0)
                    obs, reward, terminated, truncated, info = outer._parse(outer.env.step(action))
                    terminated = bool(np.asarray(terminated).reshape(-1)[0])
                    truncated = bool(np.asarray(truncated).reshape(-1)[0])
                    self._json({
                        'frame': outer._frame_b64(obs),
                        'reward': float(np.asarray(reward).reshape(-1)[0]),
                        'terminated': terminated,
                        'truncated': truncated,
                        'done': terminated or truncated,
                        'steps_left': outer._steps_left(),
                    })
                else:
                    self._json({'error': 'not found'}, 404)

        self.httpd = ThreadingHTTPServer((host, port), Handler)

    def _steps_left(self):
        """Remaining steps if the env (or its innermost wrapped env) exposes
        max_steps/steps counters (reference `web_env/server.py:45-51`)."""
        env = self.env
        for _ in range(8):  # unwrap nested wrappers
            if hasattr(env, 'max_steps') and hasattr(env, 'steps'):
                return int(env.max_steps) - int(env.steps)
            if hasattr(env, 'max_timesteps') and hasattr(env, 'steps'):
                return int(env.max_timesteps) - int(env.steps)
            inner = getattr(env, 'env', None)
            if inner is None:
                return None
            env = inner
        return None

    @staticmethod
    def _parse(step_out):
        n = len(step_out)
        obs = step_out[0]
        reward = step_out[1] if n >= 2 else 0.0
        terminated = step_out[2] if n >= 3 else False
        truncated = step_out[3] if n >= 4 else False
        info = step_out[4] if n >= 5 else {}
        return obs, reward, terminated, truncated, info

    def _frame_b64(self, obs) -> str:
        if isinstance(obs, dict):
            obs = obs.get('image', next(iter(obs.values())))
        obs = np.asarray(obs)
        if obs.ndim == 4:  # batched
            obs = obs[0]
        return base64.b64encode(encode_png(obs)).decode()

    def serve_forever(self):
        print(f'serving on http://{self.host}:{self.port}')
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()





class InspectReplayBufferServer:
    """Replay-buffer web inspector (reference `web_env/inspect_server.py:37-178`):
    /api/stats, /api/episodes, /api/episode/<id> with base64 PNG frames."""

    def __init__(self, buffer, port: int = 8001, host: str = '0.0.0.0',
                 max_frames: int = 64):
        self.buffer = buffer
        self.port = port
        self.host = host
        self.max_frames = max_frames
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header('Content-Type', 'application/json')
                self.send_header('Content-Length', str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                buf = outer.buffer
                if self.path in ('/', '/index.html'):
                    body = _static_html('inspect.html')
                    self.send_response(200)
                    self.send_header('Content-Type', 'text/html')
                    self.send_header('Content-Length', str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == '/api/stats':
                    lengths = [buf.episode_length(i) for i in range(buf.num_episodes)]
                    self._json(dict(
                        num_episodes=buf.num_episodes,
                        max_episodes=buf.max_episodes,
                        max_timesteps=buf.max_timesteps,
                        fields={k: [str(np.dtype(d)), list(s)]
                                for k, (d, s) in buf.fields.items()},
                        mean_episode_length=float(np.mean(lengths)) if lengths else 0.0,
                    ))
                elif self.path == '/api/episodes':
                    out = []
                    for i in range(buf.num_episodes):
                        ep = buf.get_episode(i)
                        out.append(dict(
                            index=i,
                            length=int(ep['_length']),
                            total_reward=float(np.sum(ep.get('rewards', 0.0))),
                        ))
                    self._json(dict(episodes=out))
                elif self.path.startswith('/api/episode/'):
                    idx = int(self.path.rsplit('/', 1)[1])
                    if not (0 <= idx < buf.num_episodes):
                        return self._json({'error': 'out of range'}, 404)
                    ep = buf.get_episode(idx)
                    frames = []
                    video = ep.get('video')
                    if video is not None:
                        for t in range(min(len(video), outer.max_frames)):
                            frame = video[t]
                            if frame.dtype == np.uint8:
                                frame = frame.astype(np.float32) / 255.0
                            frames.append(base64.b64encode(encode_png(frame)).decode())
                    # every other per-frame field small enough to display
                    # (actions, proprio, ...) rides along for the UI's
                    # per-frame field cards (reference
                    # `inspect_server.py:99-115` sends all fields per frame)
                    fields = {}
                    for k, v in ep.items():
                        if k in ('_length', 'video', 'rewards', 'terminated'):
                            continue
                        arr = np.asarray(v)
                        if (arr.ndim >= 1 and arr.dtype.kind in 'ifub'
                                and arr.size <= 16 * max(arr.shape[0], 1)):
                            fields[k] = arr.tolist()
                    self._json(dict(
                        index=idx,
                        length=int(ep['_length']),
                        rewards=np.asarray(ep.get('rewards', [])).tolist(),
                        terminated=np.asarray(ep.get('terminated', [])).tolist(),
                        fields=fields,
                        frames=frames,
                    ))
                else:
                    self._json({'error': 'not found'}, 404)

        self.httpd = ThreadingHTTPServer((host, port), Handler)

    def serve_forever(self):
        print(f'inspecting on http://{self.host}:{self.port}')
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
