"""The port's Snake, moving-sprites and reacher recipes
(`dreamer4_torch/examples/`) against the JAX recipes in `examples/`, at
float32 on the CPU, as tests/test_torch_recipes_cartpole.py holds the
CartPole ones:

  - flags and defaults as the JAX recipe's, plus `--device` (`--cpu` in
    the reacher recipe; the scripted Snake collector runs no model and
    takes none);
  - each `build_model` / `build_tokenizer` passes exactly the JAX recipe's
    keywords; with the JAX init's weights one training loss agrees at rtol
    1e-5, the JAX draws replayed;
  - `SnakeVectorAdapter` (observations, shaped rewards, terminations,
    apple counts, recorded frames), the scripted collector (its replay
    buffer's files, byte for byte, and its apple counts), the sprite
    episodes and the reacher trajectories: exactly the JAX recipe's for
    the same seeds and actions;
  - the Snake gate's bookkeeping and the reacher's divergence metric
    against the JAX recipe's code on the same arrays;
  - every recipe's `main` runs at tiny flags with `--device cpu`.
"""
import sys
from argparse import Namespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamer4_torch.examples import dataset_moving_sprites as t_sprites_data
from dreamer4_torch.examples import train_moving_sprites_dynamics as t_sprites_dyn
from dreamer4_torch.examples import train_moving_sprites_tokenizer as t_sprites_tok
from dreamer4_torch.examples import train_reacher_proprio_dynamics as t_reacher
from dreamer4_torch.examples import train_snake_ppo as t_snake_ppo
from dreamer4_torch.examples import train_snake_rl_collector as t_snake
from test_torch_recipes_cartpole import (EXAMPLES, assert_same_flags,
                                         assert_tokenizer_loss_matches_jax,
                                         assert_wm_loss_matches_jax, flag_defaults, jax_main,
                                         recorded_kwargs)

sys.path.insert(0, str(EXAMPLES))

import dataset_moving_sprites as j_sprites_data  # noqa: E402
import train_reacher_proprio_dynamics as j_reacher  # noqa: E402
import train_snake_ppo as j_snake_ppo  # noqa: E402
import train_snake_rl_collector as j_snake  # noqa: E402

torch.set_num_threads(1)


# ------------------------------------------------------------------ flags

FLAG_CASES = {
    'train_snake_rl_collector': (t_snake.main, ()),
    'train_moving_sprites_tokenizer': (t_sprites_tok.main, ()),
    'train_moving_sprites_dynamics': (t_sprites_dyn.main, ()),
    'train_reacher_proprio_dynamics': (t_reacher.main, ('cpu',)),
}


@pytest.mark.parametrize('name', list(FLAG_CASES))
def test_recipe_flags_match_jax(name, monkeypatch):
    port_main, dropped = FLAG_CASES[name]
    assert_same_flags(jax_main(name), port_main, monkeypatch, dropped)


def test_scripted_snake_flags_match_jax(monkeypatch):
    """No model runs, so no `--device`."""
    assert (flag_defaults(lambda: t_snake_ppo.main([]), monkeypatch)
            == flag_defaults(jax_main('train_snake_ppo'), monkeypatch))


# ----------------------------------------------------------------- models

# examples/train_snake_rl_collector.py:190-199 at the default flags (a 4x4
# grid: a 48-dim state)
SNAKE_KW = dict(dim=64, dim_latent=16, num_latent_tokens=4, num_spatial_tokens=4, max_steps=16,
                depth=2, time_block_every=2, attn_heads=4, attn_dim_head=16,
                num_discrete_actions=(4,), multi_token_pred_len=4, num_register_tokens=4,
                dim_state=48, dim_critic_state=48, predict_terminals=True,
                policy_entropy_weight=0.01, keep_reward_ema_stats=True,
                reward_range=(-12.0, 82.0))
# examples/train_moving_sprites_tokenizer.py:42-46
SPRITES_TOKENIZER_KW = dict(dim=128, dim_latent=16, patch_size=8, image_height=32,
                            image_width=32, channels=1, num_latent_tokens=8, encoder_depth=2,
                            decoder_depth=2, time_block_every=2, attn_dim_head=32,
                            attn_heads=4)
# examples/train_moving_sprites_dynamics.py:48-62 (the tokenizer's 8 x 16
# latents)
SPRITES_KW = dict(dim=128, dim_latent=16, num_latent_tokens=8, num_spatial_tokens=8,
                  max_steps=16, depth=4, time_block_every=2, attn_heads=4, attn_dim_head=32,
                  num_discrete_actions=(9,), multi_token_pred_len=4, predict_terminals=False)
# examples/train_reacher_proprio_dynamics.py:112-114
REACHER_TOKENIZER_KW = dict(dim=64, dim_latent=16, patch_size=8, image_height=32,
                            image_width=32, num_latent_tokens=8, encoder_depth=2,
                            decoder_depth=2, time_block_every=2)
# examples/train_reacher_proprio_dynamics.py:130-136
REACHER_KW = dict(dim=64, dim_latent=16, num_latent_tokens=8, num_spatial_tokens=8,
                  max_steps=16, depth=2, time_block_every=2, attn_heads=4, attn_dim_head=16,
                  num_continuous_actions=6, continuous_dist_type='beta',
                  continuous_target_action_range=(-1.0, 1.0), dim_proprio=4,
                  multi_token_pred_len=4, num_register_tokens=4, predict_terminals=False,
                  add_action_embed_to_spatial=True)

SPRITES_TOKENIZER = Namespace(dim_latent=16, num_latent_tokens=8)
WM_CASES = {
    'snake': (t_snake, lambda: t_snake.build_model(t_snake.parse_args([]),
                                                   Namespace(dim_state=48), 'cpu'), SNAKE_KW),
    'sprites': (t_sprites_dyn, lambda: t_sprites_dyn.build_model(
        t_sprites_dyn.parse_args([]), SPRITES_TOKENIZER, 'cpu'), SPRITES_KW),
    'reacher': (t_reacher, lambda: t_reacher.build_model(t_reacher.parse_args([]), 'cpu'),
                REACHER_KW),
}


@pytest.mark.parametrize('case', list(WM_CASES))
def test_world_models_match_jax(case, monkeypatch):
    module, build, want = WM_CASES[case]
    got, tm = recorded_kwargs(monkeypatch, module, 'DynamicsWorldModel', build)
    assert got == want
    assert_wm_loss_matches_jax(want, tm, monkeypatch, continuous=case == 'reacher')


TOKENIZER_CASES = {
    'sprites': (t_sprites_tok, lambda: t_sprites_tok.build_model(t_sprites_tok.parse_args([]),
                                                                 'cpu'),
                SPRITES_TOKENIZER_KW, (2, 1, 3, 32, 32)),
    'reacher': (t_reacher, lambda: t_reacher.build_tokenizer(t_reacher.parse_args([]), 'cpu'),
                REACHER_TOKENIZER_KW, (2, 3, 3, 32, 32)),
}


@pytest.mark.parametrize('case', list(TOKENIZER_CASES))
def test_tokenizers_match_jax(case, monkeypatch):
    module, build, want, video_shape = TOKENIZER_CASES[case]
    got, tt = recorded_kwargs(monkeypatch, module, 'VideoTokenizer', build)
    assert got == want
    assert_tokenizer_loss_matches_jax(want, tt, monkeypatch, video_shape)


# ------------------------------------------------------------ environments

@pytest.mark.parametrize('record', [False, True])
def test_snake_vector_adapter_matches_jax(record):
    """Shaped rewards (the recipe's defaults), every output, the apple
    bookkeeping and, recording, the 2x frames: exactly the JAX adapter's."""
    kw = dict(n_envs=3, grid_size=4, max_steps=20, seed=7, record=record, apple_reward=5.0,
              collision_penalty=-10.0, aliveness_penalty=-0.01)
    a, b = j_snake.SnakeVectorAdapter(**kw), t_snake.SnakeVectorAdapter(**kw)
    rng = np.random.default_rng(0)
    for episode in range(3):
        for x, y in zip(a.reset(), b.reset()):
            np.testing.assert_array_equal(x.get('state'), y.get('state'))
        for _ in range(21):
            actions = rng.integers(0, 4, 3)
            for x, y in zip(a.step(actions), b.step(actions)):
                if isinstance(x, dict):
                    np.testing.assert_array_equal(x.get('state'), y.get('state'))
                else:
                    np.testing.assert_array_equal(x, y)
        if record:
            fa, fb = a.take_frames(), b.take_frames()
            assert fa.shape == (3, 22, 3, 8, 8) and fa.dtype == np.uint8
            np.testing.assert_array_equal(fa, fb)
    assert a.finished_apples == b.finished_apples and len(a.finished_apples) == 9
    np.testing.assert_array_equal(a.last_episode_apples, b.last_episode_apples)
    assert a.dim_state == b.dim_state == 48


def test_scripted_snake_collector_matches_jax(tmp_path):
    """The same buffer files, byte for byte, and apple counts."""
    j_buffer = j_snake_ppo.collect(str(tmp_path / 'jax'), num_episodes=12, target_apples=1.0)
    buffer, apples = t_snake_ppo.collect(str(tmp_path / 'port'), num_episodes=12,
                                         target_apples=1.0)
    assert len(j_buffer) == len(buffer) == 12
    files = sorted(p.name for p in (tmp_path / 'jax').iterdir())
    assert files == sorted(p.name for p in (tmp_path / 'port').iterdir())
    for name in files:
        assert (tmp_path / 'jax' / name).read_bytes() == (tmp_path / 'port' / name).read_bytes()
    assert np.mean(apples) >= 5.0   # the greedy policy passes the gate
    with pytest.raises(AssertionError, match='collector quality regression'):
        t_snake_ppo.collect(str(tmp_path / 'gate'), num_episodes=2, target_apples=100.0)


def test_sprite_and_reacher_data_match_jax(tmp_path):
    """`write_dataset` and `make_dataset`: the same files, byte for byte."""
    j_sprites_data.write_dataset(str(tmp_path / 'js'), num_episodes=4, seed=3)
    t_sprites_data.write_dataset(str(tmp_path / 'ts'), num_episodes=4, seed=3)
    j_reacher.make_dataset(tmp_path / 'jr', 2, seed=5)
    t_reacher.make_dataset(tmp_path / 'tr', 2, seed=5)
    for a, b in (('js', 'ts'), ('jr', 'tr')):
        names = sorted(p.name for p in (tmp_path / a).iterdir())
        assert names and names == sorted(p.name for p in (tmp_path / b).iterdir())
        for name in names:
            assert (tmp_path / a / name).read_bytes() == (tmp_path / b / name).read_bytes()


# -------------------------------------------------------- gates and metrics

def jax_gate(finished_apples, args):
    """examples/train_snake_rl_collector.py:225-250 on the adapter's list:
    -> (solved, window avg, window best)."""
    window = finished_apples[-args.window:]
    avg = float(np.mean(window)) if window else 0.0
    best = max(window) if window else 0
    best_ever = max(finished_apples) if finished_apples else 0
    if args.gate == 'episode' and best_ever >= args.target_apples:
        return True, avg, best
    if len(window) >= args.window:
        if args.gate == 'window-avg' and avg >= args.target_apples:
            return True, avg, best
    return False, avg, best


@pytest.mark.parametrize('gate', ['episode', 'window-avg'])
def test_snake_gate_bookkeeping_matches_jax(gate):
    """After each iteration (0-40 episodes finishing, some iterations more
    than the window), the port's `gate` decides as the JAX recipe's loop."""
    rng = np.random.default_rng(1)
    for target in (2.0, 3.0, 5.0):
        args = Namespace(window=20, gate=gate, target_apples=target)
        finished: list[int] = []
        decisions = []
        for _ in range(40):
            finished += rng.integers(0, 4 if target > 3 else 6,
                                     rng.integers(0, 41)).tolist()
            passed, avg, best, _ = t_snake.gate(finished, args)
            assert (passed, avg, best) == jax_gate(finished, args)
            decisions.append(passed)
        assert any(decisions) or target == 5.0


def test_reacher_divergence_matches_jax():
    """examples/train_reacher_proprio_dynamics.py:185-191 on the same dream
    arrays."""
    rng = np.random.default_rng(2)
    pos = dict(latents=rng.standard_normal((1, 10, 8, 16)).astype(np.float32),
               proprio=rng.standard_normal((1, 10, 4)).astype(np.float32))
    neg = dict(latents=pos['latents'] + 0.01 * rng.standard_normal((1, 10, 8, 16)).astype(
        np.float32), proprio=rng.standard_normal((1, 10, 4)).astype(np.float32))
    P, N = ({k: jnp.asarray(v) for k, v in d.items()} for d in (pos, neg))
    want = (float(jnp.abs(P['latents'] - N['latents'])[:, 3:].mean()),
            float(jnp.abs(P['latents'])[:, 3:].mean()),
            float(jnp.abs(P['proprio'] - N['proprio'])[:, 3:].mean()))
    np.testing.assert_allclose(t_reacher.divergence(pos, neg), want, rtol=1e-6)


# ------------------------------------------------------------------- mains

def test_snake_recipe_mains_run_on_the_cpu(tmp_path, capsys):
    """The scripted collector; the learned one to a reachable gate, its
    collection phase, then again from its saved policy."""
    assert t_snake_ppo.main(['--buffer', str(tmp_path / 'scripted'),
                             '--num-episodes', '4']) == 0
    argv = ['--device', 'cpu', '--n-envs', '2', '--max-iterations', '3',
            '--target-apples', '0', '--num-episodes', '3', '--buffer', str(tmp_path / 'rl'),
            '--checkpoint', str(tmp_path / 'policy')]
    assert t_snake.main(argv) == 0
    assert (tmp_path / 'policy' / 'config.json').exists()
    assert t_snake.main(argv) == 0
    out = capsys.readouterr().out
    assert 'GATE REACHED at iteration 0' in out and 'loaded collector policy' in out
    assert out.count('collected 3 episodes with the LEARNED policy') == 2
    assert t_snake.main(['--device', 'cpu', '--n-envs', '2', '--max-iterations', '1',
                         '--target-apples', '99', '--buffer', str(tmp_path / 'miss')]) == 1


def test_sprites_recipe_mains_run_on_the_cpu(tmp_path, capsys):
    """The dataset, the tokenizer and the dynamics with one sample GIF."""
    data = str(tmp_path / 'data')
    assert t_sprites_data.main([data]) == 0
    small = ['--device', 'cpu', '--data', data, '--num-steps', '2', '--batch-size', '2',
             '--num-frames', '4', '--dim', '32', '--log-every', '1']
    assert t_sprites_tok.main([*small, '--output', str(tmp_path / 'tok')]) == 0
    assert t_sprites_dyn.main([*small, '--tokenizer-checkpoint', str(tmp_path / 'tok'),
                               '--depth', '2', '--sample-every', '1',
                               '--output', str(tmp_path / 'dyn')]) == 0
    assert (tmp_path / 'sample_1.gif').exists() and (tmp_path / 'dyn' / 'config.json').exists()
    assert capsys.readouterr().out.count('step 1: loss') == 2


def test_reacher_recipe_main_runs_on_the_cpu(tmp_path, capsys):
    rc = t_reacher.main(['--device', 'cpu', '--data', str(tmp_path / 'trajs'),
                         '--num-trajs', '3', '--steps', '2', '--tokenizer-steps', '2',
                         '--batch-size', '2', '--seq-len', '4'])
    out = capsys.readouterr().out
    assert 'forced-action dream divergence' in out
    assert rc == (0 if 'PASS' in out else 1) and ('PASS' in out or 'WEAK' in out)
