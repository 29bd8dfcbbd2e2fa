"""The port's command line (`python -m dreamer4_torch.cli`) and its
logging helpers, on the CPU (`--device cpu`), at tiny widths.

Each command takes the JAX command's options and `--device`; the tokenizer
trains, resumes from its checkpoint, and a dynamics model trains on top of
it from a folder of GIFs with `<stem>.<key>.npy` sidecars (checkpoints,
`latest`, the EMA sub-checkpoint, `metrics.jsonl` and the sample GIFs);
`serve-world-model` builds its environment from those checkpoints, and
`inspect-replay-buffer` prints the JAX command's JSON.
"""
import json
import re
import threading
import urllib.request

import numpy as np
import pytest
import torch

import dreamer4_tpu.cli as jcli
import dreamer4_torch.cli as tcli
from dreamer4_tpu.data.replay_buffer import ReplayBuffer as JBuffer
from dreamer4_tpu.data.video_io import save_gif
from dreamer4_torch.envs.snake import SnakeEnv
from dreamer4_torch.envs.world_model_env import DynamicsWorldModelWrapper
from dreamer4_torch.serve import server as tserver
from dreamer4_torch.train.checkpoint import load_model
from dreamer4_torch.models.world_model import DynamicsWorldModel

torch.set_num_threads(1)

# tests/test_cli.py:30-36
TOKENIZER_ARGS = ['--batch-size', '2', '--grad-accum', '2', '--seq-len', '3',
                  '--dim', '16', '--dim-latent', '8', '--patch-size', '8',
                  '--image-size', '16', '--num-latent-tokens', '2',
                  '--encoder-depth', '1', '--decoder-depth', '1',
                  '--time-block-every', '1',
                  '--log-every', '1', '--checkpoint-every', '2',
                  '--sample-every', '2', '--device', 'cpu']
DYNAMICS_ARGS = ['--batch-size', '2', '--seq-len', '3', '--dim', '16', '--depth', '1',
                 '--num-spatial-tokens', '2', '--num-discrete-actions', '3',
                 '--log-every', '1', '--checkpoint-every', '2', '--sample-every', '2',
                 '--device', 'cpu']


def make_gif_folder(path, n_videos=4, frames=3, size=16):
    """tests/test_cli.py:12-27, with sidecars."""
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n_videos):
        save_gif(path / f'ep{i}.gif', rng.random((3, frames, size, size)).astype(np.float32))
        np.save(path / f'ep{i}.actions.npy', rng.integers(0, 3, (frames,)).astype(np.int64))
        np.save(path / f'ep{i}.rewards.npy', rng.random((frames,)).astype(np.float32))
        np.save(path / f'ep{i}.terminated.npy', np.zeros((frames,), bool))
    return path


def options(cmd, command: str, capsys) -> set[str]:
    with pytest.raises(SystemExit) as e:
        cmd.COMMANDS[command](['--help'])
    assert e.value.code == 0
    return set(re.findall(r'(--[a-z][a-z-]*)', capsys.readouterr().out)) - {'--help'}


@pytest.mark.parametrize('command', list(jcli.COMMANDS))
def test_port_cli_takes_the_jax_options_and_device(command, capsys):
    assert list(tcli.COMMANDS) == list(jcli.COMMANDS)
    assert options(tcli, command, capsys) == options(jcli, command, capsys) | {'--device'}


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """Tokenizer: 2 steps, then a resumed run to 3; dynamics: 2 steps on
    the tokenizer's checkpoint. Returns (data, tokenizer dir, dynamics dir,
    what the commands printed)."""
    root = tmp_path_factory.mktemp('cli')
    data = make_gif_folder(root / 'videos')
    tok, dyn = root / 'tok', root / 'dyn'
    printed = []
    capture = pytest.MonkeyPatch()
    capture.setattr('builtins.print', lambda *a, **k: printed.append(' '.join(map(str, a))))
    try:
        for steps in ('2', '3'):
            tcli.main(['train-video-tokenizer', '--dataset', str(data), '--output', str(tok),
                       '--num-steps', steps, *TOKENIZER_ARGS])
        tcli.main(['train-dynamics', '--dataset', str(data), '--tokenizer-checkpoint', str(tok),
                   '--output', str(dyn), '--num-steps', '2', *DYNAMICS_ARGS])
    finally:
        capture.undo()
    return data, tok, dyn, printed


def test_port_cli_trains_resumes_and_checkpoints(trained):
    data, tok, dyn, printed = trained
    assert f'resumed from {tok} at step 2' in printed
    assert f'saved dynamics model to {dyn}' in printed
    for out, step in ((tok, 3), (dyn, 2)):
        assert (out / 'latest').resolve() == (out / f'ckpt-{step}').resolve()
        assert (out / f'ckpt-{step}' / 'ema' / 'config.json').exists()
        meta = json.loads((out / f'ckpt-{step}' / 'train_meta.json').read_text())
        assert meta['step'] == step and meta['has_ema']
        metrics = [json.loads(line) for line in
                   (out / 'logs' / 'metrics.jsonl').read_text().splitlines()]
        assert [m['step'] for m in metrics] == list(range(1, step + 1))   # across the resume
        assert all(np.isfinite(m['loss']) for m in metrics)
    assert (tok / 'ckpt-2' / 'config.json').exists()
    assert list((tok / 'logs').glob('recon_*.gif')) and list((dyn / 'logs').glob('dream_*.gif'))
    # `latest` and the EMA weights are what a later command loads
    assert tcli._resolve_model_checkpoint(str(tok)) == (tok / 'ckpt-3' / 'ema').resolve()
    assert tcli._resolve_model_checkpoint(str(dyn), prefer_ema=False) == \
        (dyn / 'ckpt-2').resolve()
    # the resolution of both packages agrees
    assert jcli._resolve_model_checkpoint(str(dyn)) == tcli._resolve_model_checkpoint(str(dyn))


def test_port_cli_serves_the_trained_world_model(trained, monkeypatch):
    _, tok, dyn, _ = trained
    served = []
    monkeypatch.setattr(tserver.WebEnvServer, 'serve_forever',
                        lambda self: served.append(self))
    for args in ([], ['--checkpoint', str(dyn), '--tokenizer-checkpoint', str(tok)]):
        tcli.main(['serve-world-model', '--port', '0', '--device', 'cpu', *args])
    snake, wm = (s.env for s in served)
    assert isinstance(snake, SnakeEnv) and snake.grid_size == 4
    assert isinstance(wm, DynamicsWorldModelWrapper) and wm.tokenizer is not None
    ema = load_model(dyn / 'ckpt-2' / 'ema', DynamicsWorldModel, device='cpu')
    for name, p in ema.state_dict().items():
        assert torch.equal(wm.model.state_dict()[name], p), name
    obs, _ = wm.reset()
    assert obs.shape == (1, 3, 16, 16) and np.isfinite(obs).all()
    obs, reward, terminated, truncated, _ = wm.step(2)
    assert obs.shape == (1, 3, 16, 16) and np.isfinite(reward)
    assert isinstance(terminated, bool) and truncated is False


def test_port_cli_inspect_prints_the_jax_json(tmp_path, capsys):
    buf = JBuffer(tmp_path / 'buf', max_episodes=4, max_timesteps=6,
                  fields=dict(video=('uint8', (3, 8, 8)), rewards='float',
                              discrete_actions='int'))
    for n in (3, 5):
        with buf.one_episode():
            for t in range(n):
                buf.store(video=np.full((3, 8, 8), t, np.uint8), rewards=float(t),
                          discrete_actions=t % 4)
    printed = []
    for cli in (jcli, tcli):
        cli.main(['inspect-replay-buffer', '--buffer', str(tmp_path / 'buf')])
        printed.append(capsys.readouterr().out)
    assert printed[1] == printed[0]
    assert json.loads(printed[1])['mean_episode_length'] == 4.0


def test_port_cli_refuses_the_cpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    data = make_gif_folder(tmp_path / 'videos', n_videos=2)
    args = [a for a in TOKENIZER_ARGS if a not in ('--device', 'cpu')]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(['train-video-tokenizer', '--dataset', str(data), '--output',
                   str(tmp_path / 'tok'), '--num-steps', '1', *args])
    assert not (tmp_path / 'tok').exists()


def test_port_metric_logger_profile_block_and_timeit(tmp_path):
    from dreamer4_torch.train.logging import MetricLogger, profile_block, timeit

    logger = MetricLogger(tmp_path / 'logs', use_tensorboard=False)
    logger.log(0, loss=1.5, reward=0.2)
    logger.log(1, loss=torch.tensor(1.25))
    logger.log_video(1, 'sample', np.random.default_rng(0).random((2, 3, 2, 4, 4)))
    logger.close()
    lines = [json.loads(l) for l in (tmp_path / 'logs' / 'metrics.jsonl').read_text().splitlines()]
    assert [l['step'] for l in lines] == [0, 1] and lines[1]['loss'] == 1.25
    assert list((tmp_path / 'logs').glob('sample_00000001.gif'))

    x = torch.ones(64, 64)
    with profile_block(tmp_path / 'trace') as prof:
        (x @ x).sum()
    assert any('matmul' in e.key or 'mm' in e.key for e in prof.key_averages())
    assert json.loads((tmp_path / 'trace' / 'trace.json').read_text())['traceEvents']
    assert timeit(lambda a: a @ a, x, iters=2) > 0


def test_port_device_names_the_current_card(monkeypatch):
    """`--device cuda` and the default both name the current card by its
    index, the device a model built there reports, so the wrappers'
    and trainers' same-device checks accept either spelling."""
    from dreamer4_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    assert resolve_device('cuda') == resolve_device(None) == torch.device('cuda', 0)
    assert resolve_device('cuda:1') == torch.device('cuda', 1)
    assert resolve_device('cpu') == torch.device('cpu')


def test_port_cli_trains_and_serves_continuous_actions(trained, tmp_path, monkeypatch):
    """`train-dynamics --num-continuous-actions 6` on GIFs with float action
    sidecars (and proprio ones, which the command leaves), then the served
    world model answers a `/step` whose action is a list of 6 floats."""
    _, tok, _, _ = trained
    data = make_gif_folder(tmp_path / 'videos', n_videos=2)
    rng = np.random.default_rng(1)
    for i in range(2):
        np.save(data / f'ep{i}.actions.npy', rng.uniform(-1, 1, (2, 6)).astype(np.float32))
        np.save(data / f'ep{i}.proprio.npy', rng.standard_normal((3, 4)).astype(np.float32))
    dyn = tmp_path / 'dyn'
    at = DYNAMICS_ARGS.index('--num-discrete-actions')
    args = DYNAMICS_ARGS[:at] + DYNAMICS_ARGS[at + 2:]
    monkeypatch.setattr('builtins.print', lambda *a, **k: None)
    tcli.main(['train-dynamics', '--dataset', str(data), '--tokenizer-checkpoint', str(tok),
               '--output', str(dyn), '--num-steps', '2', '--num-continuous-actions', '6',
               *args])
    monkeypatch.undo()
    metrics = [json.loads(line) for line in
               (dyn / 'logs' / 'metrics.jsonl').read_text().splitlines()]
    assert [m['step'] for m in metrics] == [1, 2] and all(np.isfinite(m['loss']) for m in metrics)
    assert list((dyn / 'logs').glob('dream_*.gif'))

    env = tcli.world_model_env(str(dyn), str(tok), device='cpu')
    assert env.na_c == 6 and env.model.config['num_continuous_actions'] == 6
    server = tserver.WebEnvServer(env, port=0, host='127.0.0.1')
    thread = threading.Thread(target=server.httpd.serve_forever, daemon=True)
    thread.start()
    url = f'http://127.0.0.1:{server.httpd.server_address[1]}'

    def post(path, payload):
        req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                     headers={'Content-Type': 'application/json'})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    try:
        assert post('/reset', {})['frame']
        out = post('/step', {'action': [0.5, -0.5, 0.1, 0.0, 0.9, -0.9]})
        assert out['frame'] and np.isfinite(out['reward']) and out['terminated'] in (True, False)
    finally:
        server.shutdown()
        thread.join(timeout=10)
