"""RL against an environment in the port (`envs/interact.py`, `SimTrainer`,
the state-vector inputs of the world model, the streaming tokenizer encode,
`pad_experience_time` / `combine_experiences`) against the JAX package, at
float32 on the CPU.

Both packages get the same weights (the JAX model's, converted) and each
steps its own copy of the same numpy mock environment from the same seed.
The JAX draws are replayed into the port: the action draws of a rollout
with key `key` (frame i: `fold_in(key, i)`, then `split(fold_in(., 1))[0]`
for the actions) through `envs.interact.draw`, and the draws of each
dynamics training step (recorded by wrapping `jax.random` while a jitted
`apply` with that step's key is traced) through `models.world_model.draw`.
Equal actions then also prove that both environments saw the same
actions.

Tolerances, all float32:
  - `state_to_latents`, `critic_state_embedder`: 1e-6;
  - the streaming encode against JAX's, frame by frame: 1e-5; against the
    port's parallel encode: 2e-5 absolute, 1e-4 relative (the JAX
    package's own test of that invariant);
  - rollouts: actions, lens, terminal and truncation flags, rewards,
    returns, critic states and video exactly equal; latents, values, log
    probs, agent embeddings and the old action unembeddings 1e-5
    absolute, 1e-4 relative; RL losses 1e-5 absolute, 1e-4 relative;
  - `SimTrainer` parameters after each step (the world model's training
    through `MuonAdamAtan2`, then AdamW RL updates, from gradients computed
    apart, Newton-Schulz in float32 in both): 1e-6 wherever every gradient
    of the steps so far was at least 1e-7 in size, and below that, where
    Adam's first steps turn a rounding difference into a sign flip, 2.01 lr
    per update (`assert_updates_close` of tests/test_torch_rl.py). The
    2-D trunk weights that Muon moves (at 10 x `dynamics_lr`, every entry
    from the whole matrix's Newton-Schulz iteration) and, in full-model RL,
    the trunk that AdamW moves at 1e-3 (from its second step on, an Adam
    update moves with the gradient's rounding, 1e-3 relative, times the
    rate) hold 1e-5 there, the world-model trainer's rule
    (tests/test_torch_train.py). The gradients sized are the port's, which
    tests/test_torch_train.py and tests/test_torch_rl.py hold against the
    JAX ones;
  - `pad_experience_time` / `combine_experiences`: exact.
"""
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamer4_tpu.ops.flash_attention as jflash
import dreamer4_tpu.train.optim as joptim
from dreamer4_tpu.data.experience import Experience as JExperience
from dreamer4_tpu.data.experience import combine_experiences as j_combine_experiences
from dreamer4_tpu.data.experience import pad_experience_time as j_pad_experience_time
from dreamer4_tpu.envs.interact import EnvInteractor as JEnvInteractor
from dreamer4_tpu.envs.mocks import MockEnv as JMockEnv
from dreamer4_tpu.envs.mocks import MockStateEnv as JMockStateEnv
from dreamer4_tpu.models.tokenizer import VideoTokenizer as JTokenizer
from dreamer4_tpu.models.world_model import DynamicsWorldModel as JWorldModel
from dreamer4_tpu.nn.action_embedder import Actions as JActions
from dreamer4_tpu.ops.flash_attention import flash_attend_bwd as j_flash_attend_bwd
from dreamer4_tpu.train.trainers import SimTrainer as JSimTrainer
import dreamer4_torch.train.optim as toptim
from dreamer4_torch import EnvInteractor, SimTrainer, VideoTokenizer, interact_with_env
from dreamer4_torch.convert import flax_params_to_torch
from dreamer4_torch.data.experience import Experience, combine_experiences, pad_experience_time
from dreamer4_torch.envs import interact as interact_module
from dreamer4_torch.envs.mocks import MockDictEnv, MockEnv, MockStateEnv
from dreamer4_torch.models import world_model as world_model_module
from dreamer4_torch.models.world_model import DynamicsWorldModel
from dreamer4_torch.nn.action_embedder import Actions
from dreamer4_torch.ops import flash_attention as fa
from dreamer4_torch.train.trainers import rl_param_labels

torch.set_num_threads(1)
T = torch.from_numpy
# tests/test_trainers.py:35-43 with one space and one time layer
SMALL = dict(dim=16, dim_latent=8, num_latent_tokens=4, max_steps=8, depth=2,
             time_block_every=2, num_spatial_tokens=4, num_discrete_actions=(3,),
             attn_dim_head=8, attn_heads=2, multi_token_pred_len=2, num_register_tokens=2,
             predict_terminals=True)
STATE = dict(dim_state=4, dim_critic_state=4)
# tests/test_tokenizer.py:11-26, latents sized for SMALL
TOKENIZER = dict(dim=16, dim_latent=8, patch_size=16, image_height=32, image_width=32,
                 num_latent_tokens=4, encoder_depth=2, decoder_depth=1, time_block_every=2,
                 attn_dim_head=8, attn_heads=2)


def close(a, b, atol, rtol=0.0, err_msg=''):
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
    np.testing.assert_allclose(np.asarray(a), b, atol=atol, rtol=rtol, err_msg=err_msg)


def equal(a, b, err_msg=''):
    b = b.numpy() if isinstance(b, torch.Tensor) else b
    np.testing.assert_array_equal(np.asarray(a), b, err_msg=err_msg)


# ------------------------------------------------------------------ models

@functools.cache
def _jax_params(items):
    cfg = dict(items)
    jm = JWorldModel(**cfg)
    b, t = 2, 4
    init = jax.jit(lambda rngs: jm.init(
        rngs, latents=jnp.zeros((b, t, 4, 8)), shortcut_train=False, rewards=jnp.zeros((b, t)),
        terminals=jnp.zeros((b,), bool), discrete_actions=jnp.zeros((b, t - 1, 1), jnp.int32)))
    params = init({'params': jax.random.PRNGKey(0), 'sample': jax.random.PRNGKey(1)})['params']
    return jax.tree.map(np.asarray, params)


def build_pair(**kw):
    """The JAX world model and the port's with the same weights, as
    tests/test_trainers.py initializes them."""
    cfg = {**SMALL, **kw}
    params = _jax_params(tuple(sorted(cfg.items())))
    tm = DynamicsWorldModel(**cfg, device='cpu')
    tm.load_state_dict(flax_params_to_torch(params, tm))
    return JWorldModel(**cfg), params, tm


@functools.cache
def _jax_tokenizer_variables():
    jt = JTokenizer(**TOKENIZER)
    init = jax.jit(lambda rngs: jt.init(rngs, jnp.zeros((1, 3, 2, 32, 32))))
    variables = init({'params': jax.random.PRNGKey(2), 'sample': jax.random.PRNGKey(3)})
    return jax.tree.map(np.asarray, variables)


def build_tokenizer_pair():
    variables = _jax_tokenizer_variables()
    tt = VideoTokenizer(**TOKENIZER, device='cpu')
    tt.load_state_dict(flax_params_to_torch(variables['params'], tt, state=variables['state']))
    return JTokenizer(**TOKENIZER), variables, tt


# ------------------------------------------------------------- draw replay

def jax_action_draws(key, num_action_types=1):
    """The action draws of the JAX `EnvInteractor` for rollout key `key`,
    in the port's `envs.interact.draw` signature: frame i's action key is
    split(fold_in(fold_in(key, i), 1))[0], split again in
    `ActionEmbedder.sample` and once per action type in
    `multi_categorical_sample`, whose `categorical` adds Gumbel noise."""
    def draw(kind, step, shape, *, generator, device, part=0):
        assert kind == 'action'
        k_act, _ = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, step), 1))
        k_discrete, _ = jax.random.split(k_act)
        x = jax.random.gumbel(jax.random.split(k_discrete, num_action_types)[part], shape)
        return torch.from_numpy(np.array(x)).to(device)
    return draw


_JAX_DRAWS = ('randint', 'normal', 'bernoulli')
_PORT_DRAW_OF = {'step_sizes_log2': 'randint', 'signal_levels': 'randint', 'noise': 'normal',
                 'reward_keep': 'bernoulli'}


def record_jax_training_draws(jm, params, batch, key, shortcut):
    """The JAX training forward's draws for `key`, in call order (the
    wrappers note each draw while a jitted `apply` is traced and return
    its values)."""
    names, real = [], {name: getattr(jax.random, name) for name in _JAX_DRAWS}

    def run(params, batch, key):
        values = []

        def recording(name):
            def fn(*args, **kwargs):
                out = real[name](*args, **kwargs)
                names.append(name)
                values.append(out)
                return out
            return fn

        with pytest.MonkeyPatch.context() as mp:
            for name in _JAX_DRAWS:
                mp.setattr(jax.random, name, recording(name))
            jm.apply({'params': params}, **batch, shortcut_train=shortcut,
                     rngs={'sample': key})
        return values

    values = jax.jit(run)(params, batch, key)
    return [(name, np.asarray(v)) for name, v in zip(names, values)]


def replay(records):
    """A `models.world_model.draw` that hands out `records` in order,
    checking that the port asks for the same kind and shape of draw."""
    queue = list(records)

    def draw(kind, shape, *, generator, device, low=0, high=0, prob=0.0):
        name, x = queue.pop(0)
        assert name == _PORT_DRAW_OF[kind] and x.shape == tuple(shape), (kind, name, x.shape)
        out = torch.from_numpy(np.array(x))
        return (out.long() if name == 'randint' else out).to(device)

    draw.remaining = queue
    return draw


# ------------------------------------------------------ experience checks

def assert_experience_matches(jexp, exp):
    """The port's rollout against the JAX one, field by field."""
    for name in ('lens', 'terminals', 'is_truncated', 'rewards', 'episode_return',
                 'critic_state', 'video'):
        want, got = getattr(jexp, name), getattr(exp, name)
        assert (want is None) == (got is None), name
        if want is not None:
            equal(want, got, name)
    equal(jexp.actions.discrete, exp.actions.discrete, 'actions')
    for name in ('latents', 'values', 'agent_embed'):
        close(getattr(jexp, name), getattr(exp, name), 1e-5, 1e-4, name)
    close(jexp.log_probs.discrete, exp.log_probs.discrete, 1e-5, 1e-4, 'log_probs')
    for jl, tl in zip(jexp.old_action_unembeds[0], exp.old_action_unembeds[0]):
        close(jl, tl, 1e-5, 1e-4, 'old_action_unembeds')
    for name in ('step_size', 'agent_index', 'is_from_world_model', 'prompt_len'):
        assert getattr(jexp, name) == getattr(exp, name), name
    assert exp.proprio is None and exp.actions.continuous is None


# ---------------------------------------------------- state-vector inputs

def test_state_to_latents_and_critic_embed_match_jax():
    """Both new parameters convert one to one (a leftover or missing key
    raises in `flax_params_to_torch`)."""
    jm, params, tm = build_pair(**STATE)
    assert params['state_to_latents']['kernel'].shape == (4, 4 * 8)
    state = np.random.default_rng(0).standard_normal((3, 5, 4)).astype(np.float32)
    apply = partial(jm.apply, {'params': params})
    close(apply(state, method=jm.state_to_latents), tm.state_to_latents(T(state)), 1e-6)
    close(apply(state, method=lambda m, s: m.critic_state_embedder(s)),
          tm.critic_state_embedder(T(state)), 1e-6)
    assert tm.state_to_latents(T(state)).shape == (3, 5, 4, 8)
    assert tm.state_to_latents_proj.bias is None and tm.config['dim_state'] == 4


def test_unported_environment_options_raise():
    """The model takes proprioception, and the interactor refuses it,
    naming the counterpart's interactor as the cause; the state-prediction
    head and its entropy bonus are taken, so are the agent's state
    prediction and the latent-input heads, and the trunk's subsystems
    (refused here before)."""
    model = DynamicsWorldModel(**SMALL, dim_proprio=4, device='cpu')
    with pytest.raises(NotImplementedError, match='EnvInteractor.*policy_step'):
        EnvInteractor(model, device='cpu')
    for kw in (dict(add_state_pred_head=True), dict(state_entropy_bonus_weight=0.5)):
        bonus = DynamicsWorldModel(**SMALL, **STATE, **kw, device='cpu').add_state_entropy_bonus
        assert not bonus   # the bonus needs both
    assert DynamicsWorldModel(**SMALL, **STATE, add_state_pred_head=True,
                              state_entropy_bonus_weight=0.5,
                              device='cpu').add_state_entropy_bonus
    for name in ('agent_predicts_state', 'actor_critic_latent_input'):
        EnvInteractor(DynamicsWorldModel(**SMALL, **STATE, **{name: True}, device='cpu'),
                      device='cpu')
    # the trunk's subsystems build, and the interactor takes such a model
    for name, value in (('use_time_rnn', True), ('mot_temporal', True), ('h_net_layer', 1)):
        EnvInteractor(DynamicsWorldModel(**SMALL, **STATE, **{name: value}, device='cpu'),
                      device='cpu')


# ------------------------------------------------------- streaming encode

def test_streaming_encode_matches_jax_frame_by_frame():
    jt, variables, tt = build_tokenizer_pair()
    video = np.random.default_rng(1).random((2, 3, 4, 32, 32)).astype(np.float32)

    @partial(jax.jit, static_argnames=('first',))
    def jax_frame(frame, cache, first):
        if first:
            return jt.apply(variables, frame, method=jt.encode, max_time=4, return_cache=True)
        return jt.apply(variables, frame, method=jt.encode, cache=cache, return_cache=True)

    jcache = tcache = None
    with torch.no_grad():
        for i in range(4):
            frame = video[:, :, i:i + 1]
            jl, jcache = jax_frame(frame, jcache, first=i == 0)
            kw = dict(max_time=4) if i == 0 else dict(cache=tcache)
            tl, tcache = tt.encode(T(frame), return_cache=True, **kw)
            close(jl, tl, 1e-5, err_msg=f'frame {i}')
            assert tcache.transformer.token_count == i + 1
            assert tcache.spt is None and tcache.pre_conv is None and tcache.post_conv is None


def test_torch_streaming_encode_matches_parallel():
    """tests/test_tokenizer.py:71-97 on the port: frame by frame over the
    cache == the whole video at once."""
    torch.manual_seed(0)
    tt = VideoTokenizer(**TOKENIZER, device='cpu')
    video = torch.randn(2, 3, 4, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        parallel = tt.encode(video)
        cache, outs = None, []
        for i in range(4):
            kw = dict(max_time=4) if cache is None else dict(cache=cache)
            latents, cache = tt.encode(video[:, :, i:i + 1], return_cache=True, **kw)
            outs.append(latents)
        assert tt.encode(video[:, :, :1], max_time=4).shape == (2, 1, 4, 8)   # no cache asked
    close(parallel, torch.cat(outs, dim=1), 2e-5, 1e-4)


# ------------------------------------------------------ padding, combining

def make_experiences(lengths, with_video=False, seed=0):
    """JAX and port experiences of the given (batch, time) sizes, from one
    numpy draw."""
    rng = np.random.default_rng(seed)
    jexps, texps = [], []
    for b, t in lengths:
        arrays = dict(latents=rng.standard_normal((b, t, 2, 4)).astype(np.float32),
                      rewards=rng.standard_normal((b, t)).astype(np.float32),
                      values=rng.standard_normal((b, t)).astype(np.float32),
                      actions=rng.integers(0, 3, (b, t, 1)).astype(np.int32),
                      log_probs=-rng.random((b, t, 1)).astype(np.float32),
                      terminals=rng.random(b) < 0.5)
        if with_video:
            arrays['video'] = rng.random((b, 3, t, 8, 8)).astype(np.float32)
        common = dict(step_size=4, lens=None if len(jexps) == 0 else np.full((b,), t))
        jexps.append(JExperience(**{k: jnp.asarray(v) for k, v in arrays.items()
                                    if k not in ('actions', 'log_probs')},
                                 actions=JActions(jnp.asarray(arrays['actions']), None),
                                 log_probs=JActions(jnp.asarray(arrays['log_probs']), None),
                                 step_size=4,
                                 lens=None if common['lens'] is None
                                 else jnp.asarray(common['lens'])))
        texps.append(Experience(**{k: T(v) for k, v in arrays.items()
                                   if k not in ('actions', 'log_probs')},
                                actions=Actions(T(arrays['actions']).long(), None),
                                log_probs=Actions(T(arrays['log_probs']), None),
                                step_size=4,
                                lens=None if common['lens'] is None
                                else T(common['lens']).long()))
    return jexps, texps


def assert_same_experience(jexp, exp):
    for name in ('latents', 'rewards', 'values', 'terminals', 'lens', 'is_truncated', 'video'):
        want, got = getattr(jexp, name), getattr(exp, name)
        assert (want is None) == (got is None), name
        if want is not None:
            equal(want, got, name)
    equal(jexp.actions.discrete, exp.actions.discrete)
    equal(jexp.log_probs.discrete, exp.log_probs.discrete)
    assert exp.step_size == jexp.step_size == 4


@pytest.mark.parametrize('length', [3, 7])
def test_pad_experience_time_matches_jax(length):
    jexps, texps = make_experiences([(2, 3)], with_video=True)
    want = j_pad_experience_time(jexps[0], length)
    got = pad_experience_time(texps[0], length)
    assert_same_experience(want, got)
    assert got.time_steps == length and got.video.shape == (2, 3, length, 8, 8)
    assert got.lens.tolist() == [3, 3] and got.is_truncated.tolist() == [True, True]
    with pytest.raises(ValueError):
        pad_experience_time(texps[0], 2)


def test_combine_experiences_matches_jax():
    """tests/test_data_and_envs.py:67-78, with every field held against
    JAX."""
    jexps, texps = make_experiences([(2, 3), (1, 5)])
    want, got = j_combine_experiences(jexps), combine_experiences(texps)
    assert_same_experience(want, got)
    assert got.latents.shape == (3, 5, 2, 4)
    assert got.lens.tolist() == [3, 3, 5] and got.step_size == 4


def test_combine_experiences_pads_video_at_its_time_axis():
    """The counterpart pads `video` (b, c, t, h, w) at axis 1, its channels:
    equal lengths come out with 5 channels, unequal ones raise. The port
    pads the time axis and keeps 3 channels."""
    jexps, texps = make_experiences([(2, 5), (1, 5)], with_video=True)
    assert j_combine_experiences(jexps).video.shape == (3, 5, 5, 8, 8)
    got = combine_experiences(texps)
    assert got.video.shape == (3, 3, 5, 8, 8)
    equal(np.concatenate([np.asarray(e.video) for e in jexps]), got.video)

    jexps, texps = make_experiences([(2, 3), (1, 5)], with_video=True, seed=1)
    with pytest.raises(TypeError):
        j_combine_experiences(jexps)
    got = combine_experiences(texps)
    assert got.video.shape == (3, 3, 5, 8, 8) and got.lens.tolist() == [3, 3, 5]
    equal(texps[0].video, got.video[:2, :, :3])
    assert not got.video[:2, :, 3:].any()
    equal(texps[1].video, got.video[2:])


# ------------------------------------------------------------- interactor

def run_pair(jm, params, tm, make_env, key, monkeypatch, jtok=None, tok_variables=None, tt=None,
             **kw):
    """One rollout in each package, on copies of one environment."""
    jexp = JEnvInteractor(jm, tokenizer=jtok)({'params': params}, make_env('jax'), key,
                                              tokenizer_variables=tok_variables, **kw)
    monkeypatch.setattr(interact_module, 'draw', jax_action_draws(key))
    exp = EnvInteractor(tm, tokenizer=tt, device='cpu')(make_env('port'), torch.Generator(),
                                                        **kw)
    return jexp, exp


def env_factory(jcls, tcls, **kw):
    return lambda side: (jcls if side == 'jax' else tcls)(**kw)


@pytest.mark.parametrize('batch', [None, 4])
def test_env_interactor_state_env_matches_jax(batch, monkeypatch):
    """MockStateEnv unbatched (b 1, the action handed over as an int) and
    vectorized (b 4); truncated episodes end in a bootstrap frame."""
    jm, params, tm = build_pair(**STATE)
    make_env = env_factory(JMockStateEnv, MockStateEnv, dim_state=4, num_actions=3,
                           max_steps=6, batch=batch, seed=3)
    jexp, exp = run_pair(jm, params, tm, make_env, jax.random.PRNGKey(7), monkeypatch,
                         max_timesteps=6, num_steps=2)
    assert_experience_matches(jexp, exp)
    assert exp.latents.shape[0] == (batch or 1) and exp.critic_state.shape[-1] == 4
    if batch == 4:   # frame 6 is the bootstrap of the truncated episodes
        assert exp.time_steps == 7 and exp.is_truncated.any()
        assert exp.lens.max() == 7 and not exp.actions.discrete[:, 6].any()


def test_env_interactor_image_env_matches_jax(monkeypatch):
    """MockEnv pixels through the streaming encode of a tokenizer."""
    jm, params, tm = build_pair()
    jt, tok_variables, tt = build_tokenizer_pair()
    make_env = env_factory(JMockEnv, MockEnv, image_size=(32, 32), num_actions=3, batch=2,
                           seed=5)
    jexp, exp = run_pair(jm, params, tm, make_env, jax.random.PRNGKey(2), monkeypatch,
                         jtok=jt, tok_variables=tok_variables, tt=tt, max_timesteps=4,
                         num_steps=2)
    assert_experience_matches(jexp, exp)
    assert exp.video.shape[:3] == (2, 3, min(exp.time_steps, 4)) and exp.critic_state is None
    # the streamed latents are those of the whole recorded video
    with torch.no_grad():
        close(tt.encode(exp.video), exp.latents[:, :exp.video.shape[2]], 2e-5, 1e-4)


def test_env_interactor_agent_one_matches_jax(monkeypatch):
    """tests/test_multiagent.py:121-133: two agents, acting as agent 1, the
    previous reward fed back to the agent token."""
    jm, params, tm = build_pair(**STATE, num_agents=2, add_reward_embed_to_agent_token=True)
    make_env = env_factory(JMockStateEnv, MockStateEnv, dim_state=4, num_actions=3,
                           max_steps=6, batch=2, seed=1)
    jexp, exp = run_pair(jm, params, tm, make_env, jax.random.PRNGKey(8), monkeypatch,
                         max_timesteps=4, num_steps=2, agent_index=1)
    assert_experience_matches(jexp, exp)
    assert exp.agent_index == 1


def test_env_interactor_dict_obs_and_device(monkeypatch):
    """Image and proprio observations (MockDictEnv): the model has no
    proprio input and reads the image only. Entry points run on CUDA unless
    given the CPU."""
    torch.manual_seed(0)
    tm = DynamicsWorldModel(**SMALL, device='cpu')
    tt = VideoTokenizer(**TOKENIZER, device='cpu')
    exp = interact_with_env(tm, MockDictEnv(image_size=(32, 32), batch=2), torch.Generator(),
                            tokenizer=tt, device='cpu', max_timesteps=3, num_steps=2)
    assert exp.latents.shape[2:] == (4, 8) and exp.proprio is None
    assert torch.isfinite(exp.values).all() and exp.video.shape[1] == 3
    with pytest.raises(ValueError, match='tokenizer'):
        interact_with_env(tm, MockEnv(image_size=(32, 32), batch=2), torch.Generator(),
                          device='cpu')
    with pytest.raises(ValueError, match='dim_state'):
        interact_with_env(tm, MockStateEnv(batch=2), torch.Generator(), device='cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        EnvInteractor(tm)
    with pytest.raises(RuntimeError, match='CUDA'):
        SimTrainer(tm, MockStateEnv())


# ------------------------------------------------------------ SimTrainer

class GradSpy:
    """Wraps a train or update step of the port's trainer: after each call,
    notes which entries had a gradient below 1e-7 in size and adds the
    learning rate of each parameter's optimizer group to its bound."""

    def __init__(self, model, optimizer, step_fn, small, lr_sum):
        self.model, self.optimizer, self.step_fn = model, optimizer, step_fn
        self.small, self.lr_sum = small, lr_sum

    def __call__(self, *args, **kwargs):
        out = self.step_fn(*args, **kwargs)
        names = {id(p): n for n, p in self.model.named_parameters()}
        for group in self.optimizer.param_groups:
            for p in group['params']:
                name = names[id(p)]
                if p.grad is not None and p.grad.any():   # the loss reaches p
                    self.small[name] |= p.grad.abs().numpy() < 1e-7
                    self.lr_sum[name] += group['lr']
        return out


def assert_params_close(jparams, tm, small, lr_sum, coarse):
    """Parameters after a step: 1e-6 where no gradient was below 1e-7 in
    size, 1e-5 for the `coarse` ones; elsewhere 2.01 lr per update (see the
    module docstring)."""
    want = flax_params_to_torch(jax.tree.map(np.asarray, jparams), tm)
    for name, p in tm.named_parameters():
        diff = np.abs(want[name].numpy() - p.detach().numpy())
        tol = 1e-5 if name in coarse else 1e-6
        assert not (diff[~small[name]] > tol).any(), (name, diff[~small[name]].max())
        assert (diff <= 2.01 * lr_sum[name] + tol).all(), (name, diff.max())


SIM_CASES = {
    # tests/test_trainers.py:88-153: the online loop on a vectorized env,
    # the static padded time dim, minibatched epochs (2 x 2 updates)
    'heads_only_minibatched': dict(env=dict(max_steps=5, batch=4, seed=3),
                                   trainer=dict(max_timesteps=5, update_epochs=2,
                                                minibatch_size=2)),
    # tests/test_trainers.py:172-190: full-model RL (trunk rate 1e-3), here
    # with the dynamics training too, and through the flash branch: the
    # rollouts are padded to 128 frames, whose 128 x 128 scores reach the
    # gate in the dynamics step and the RL replay
    'full_model_flash': dict(env=dict(max_steps=127, batch=2, seed=2),
                             trainer=dict(max_timesteps=127, update_epochs=1,
                                          rl_trunk_lr=1e-3),
                             model=dict(use_flash_attention=True)),
}


def run_sim_pair(case_cfg, monkeypatch, steps=2):
    """`steps` SimTrainer steps in both packages from the same weights and
    seeds, every port step checked against the JAX one."""
    monkeypatch.setattr(joptim, '_batched_orthogonalize',
                        partial(joptim._batched_orthogonalize, ns_dtype=jnp.float32))
    monkeypatch.setattr(toptim, 'batched_orthogonalize',
                        partial(toptim.batched_orthogonalize, ns_dtype=torch.float32))
    cfg = {**STATE, **case_cfg.get('model', {})}
    jm, params, tm = build_pair(**cfg)
    env_kw = dict(dim_state=4, num_actions=3, **case_cfg['env'])
    kw = dict(num_steps=2, seed=1, **case_cfg['trainer'])
    jtrainer = JSimTrainer(jm, {'params': params}, JMockStateEnv(**env_kw), **kw)
    trainer = SimTrainer(tm, MockStateEnv(**env_kw), device='cpu', **kw)

    wm_calls, j_wm_step = [], jtrainer._wm_step

    def spy(ts, batch, key, shortcut_train):
        wm_calls.append((batch, key, shortcut_train))
        return j_wm_step(ts, batch, key, shortcut_train=shortcut_train)

    jtrainer._wm_step = spy
    small = {n: np.zeros(p.shape, bool) for n, p in tm.named_parameters()}
    lr_sum = dict.fromkeys(small, 0.0)
    # Muon's weights and those of a full-model trunk group (see the module
    # docstring)
    coarse = {n for n, kind in trainer.wm_optimizer.labels().items() if kind == 'muon'}
    coarse |= {n for n, label in rl_param_labels(tm, full_model=True).items()
               if label == 'trunk' and 'rl_trunk_lr' in case_cfg['trainer']}
    trainer._wm_step = GradSpy(tm, trainer.wm_optimizer, trainer._wm_step, small, lr_sum)
    trainer._update = GradSpy(tm, trainer.optimizer, trainer._update, small, lr_sum)

    key = jax.random.PRNGKey(4)
    for i in range(steps):
        jparams = jtrainer.rl_state.params
        jexp, jouts = jtrainer.step(jax.random.fold_in(key, i))
        batch, wm_key, shortcut = wm_calls[i]
        records = record_jax_training_draws(JWorldModel(**{**SMALL, **cfg,
                                                           'use_flash_attention': False}),
                                            jparams, batch, wm_key, shortcut)
        monkeypatch.setattr(world_model_module, 'draw', replay(records))
        monkeypatch.setattr(interact_module, 'draw',
                            jax_action_draws(jax.random.fold_in(jax.random.fold_in(key, i), 0)))
        exp, outs = trainer.step()
        assert world_model_module.draw.remaining == []
        assert_experience_matches(jexp, exp)
        assert exp.time_steps == kw['max_timesteps'] + 1 == jexp.time_steps
        assert len(outs) == len(jouts)
        for jout, tout in zip(jouts, outs):
            close(jout.policy_loss, tout.policy_loss, 1e-5, 1e-4)
            close(jout.value_loss, tout.value_loss, 1e-5, 1e-4)
        assert_params_close(jtrainer.rl_state.params, tm, small, lr_sum, coarse)
        assert (float(np.mean(np.asarray(jexp.episode_return)))
                == float(np.mean(exp.episode_return.numpy())))
    assert trainer.rl_state.step == int(jtrainer.rl_state.step)
    return trainer, [shortcut for _, _, shortcut in wm_calls]


def spy_flash(monkeypatch):
    """Counts the calls of JAX's fused flash backward (the Pallas kernels,
    in interpret mode on the CPU) and of the plain versions of K1-K3 that
    the port's flash branch runs on the CPU."""
    counts = {'jax_fused_bwd': 0, 'port_fwd': 0, 'port_dq': 0, 'port_dkv': 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jflash, 'flash_attend_bwd', spy('jax_fused_bwd', j_flash_attend_bwd))
    monkeypatch.setattr(fa, 'flash_attend_reference', spy('port_fwd', fa.flash_attend_reference))
    monkeypatch.setattr(fa, 'bwd_dq_reference', spy('port_dq', fa.bwd_dq_reference))
    monkeypatch.setattr(fa, 'bwd_dkv_reference', spy('port_dkv', fa.bwd_dkv_reference))
    return counts


@pytest.mark.parametrize('case', list(SIM_CASES))
def test_sim_trainer_two_steps_match_jax(case, monkeypatch):
    """Two steps; with 'full_model_flash' the one time layer of the dynamics
    step and of the RL replay takes the flash branch in both packages
    (a rollout frame, 1 x 128 scores, and space attention, 15 x 15, stay
    under the gate)."""
    counts = spy_flash(monkeypatch)
    trainer, shortcuts = run_sim_pair(SIM_CASES[case], monkeypatch)
    groups = {g['name'] for g in trainer.optimizer.param_groups}
    full_model = case == 'full_model_flash'
    assert groups == ({'policy', 'value', 'trunk'} if full_model else {'policy', 'value'})
    assert trainer.rl_state.step == 2 * (1 if full_model else 4)
    # seed 1 draws a shortcut dynamics step, then (with no permutations
    # between) a plain one
    assert shortcuts == ([True, False] if full_model else [True, True])
    if full_model:   # per step: one backward of the dynamics step, one of the update
        assert counts['port_dq'] == counts['port_dkv'] == 4 and counts['port_fwd'] >= 4
        assert counts['jax_fused_bwd'] >= 1
    else:
        assert counts == dict.fromkeys(counts, 0)


def test_sim_trainer_call_returns_mean_episode_returns():
    """`__call__` returns one finite mean episode return per step; heads-only
    RL without the dynamics training leaves the trunk as it was."""
    torch.manual_seed(0)
    tm = DynamicsWorldModel(**SMALL, **STATE, device='cpu')
    trainer = SimTrainer(tm, MockStateEnv(dim_state=4, num_actions=3, max_steps=5, batch=2),
                         max_timesteps=5, num_steps=2, update_epochs=1, train_dynamics=False,
                         device='cpu')
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    returns = trainer(2)
    assert len(returns) == 2 and all(np.isfinite(returns))
    labels = rl_param_labels(tm)
    assert labels['critic_state_embedder.weight'] == 'value'
    for name, p in tm.named_parameters():
        assert torch.equal(p, before[name]) == (labels[name] == 'frozen'), name


def test_sim_trainer_combines_pixel_rollouts():
    """Two pixel rollouts per step (the case where the counterpart's
    `combine_experiences` pads the video's channels): the step trains on
    both, 3-channel video padded in time with the latents."""
    torch.manual_seed(0)
    tm = DynamicsWorldModel(**SMALL, device='cpu')
    tt = VideoTokenizer(**TOKENIZER, device='cpu')
    trainer = SimTrainer(tm, MockEnv(image_size=(32, 32), batch=2, seed=4), tokenizer=tt,
                         num_rollouts_per_step=2, max_timesteps=3, num_steps=2,
                         update_epochs=1, device='cpu')
    exp, outs = trainer.step()
    assert exp.latents.shape == (4, 4, 4, 8) and exp.video.shape == (4, 3, 4, 32, 32)
    assert len(outs) == 1 and torch.isfinite(outs[0].policy_loss)
