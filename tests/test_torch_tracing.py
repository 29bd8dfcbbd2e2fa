"""The port's spans (`dreamer4_torch/tracing.py`): none is opened without a
profiler; under one, every train step holds its parts in order, the
attention calls sit inside the forward, and `profile_block`'s Chrome trace
holds them. On a card, the kernels K1 and K4 run inside the spans of their
paths. This file imports torch and the port only, so it runs on a machine
without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -q
"""
import json

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dreamer4_torch import (BehaviorCloneTrainer, DynamicsWorldModel, TokenizerTrainer,
                            VideoTokenizer)
from dreamer4_torch.nn.attention import Attention, FlashSpec
from dreamer4_torch.tracing import span
from dreamer4_torch.train.logging import profile_block

WM = dict(dim=32, dim_latent=8, num_latent_tokens=4, num_spatial_tokens=4, max_steps=16,
          depth=2, time_block_every=2, attn_heads=2, attn_dim_head=16,
          num_discrete_actions=(4,), multi_token_pred_len=2, num_register_tokens=2)
TOK = dict(dim=32, dim_latent=8, patch_size=8, image_height=16, image_width=16,
           num_latent_tokens=4, encoder_depth=2, decoder_depth=2, time_block_every=2,
           attn_dim_head=16, attn_heads=2)
PARTS = ('dreamer4.forward', 'dreamer4.backward', 'dreamer4.optimizer', 'dreamer4.ema')


def trainer_and_batches(kind: str, grad_accum: int, steps: int):
    """A tiny trainer on the CPU and `steps` calls of its `train_on_batch`."""
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(1)
    if kind == 'tokenizer':
        trainer = TokenizerTrainer(VideoTokenizer(**TOK, device='cpu'), grad_accum=grad_accum,
                                   device='cpu')
        calls = [(torch.rand((2, 3, 2, 16, 16), generator=g),) for _ in range(steps)]
    else:
        trainer = BehaviorCloneTrainer(DynamicsWorldModel(**WM, device='cpu'),
                                       grad_accum=grad_accum, device='cpu')
        calls = [(dict(latents=torch.randn((2, 4, 4, 8), generator=g).tanh(),
                       rewards=torch.randn((2, 4), generator=g),
                       discrete_actions=torch.randint(0, 4, (2, 4, 1), generator=g)),)
                 for _ in range(steps)]
    return trainer, calls


def host_spans(prof) -> list[tuple[int, int, str]]:
    """The trace's `dreamer4.*` host ranges, (start, end, name), by start."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CPU and e.name().startswith('dreamer4.'))


def test_no_span_opens_without_a_profiler(monkeypatch):
    """Without a profiler `span` never calls `record_function`, through a
    whole train step; under one it does."""
    def refuse(name):
        raise AssertionError(f'record_function({name!r}) without a profiler')

    trainer, calls = trainer_and_batches('world_model', 1, 1)
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    with span('dreamer4.test'):
        pass
    trainer.train_on_batch(*calls[0])
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match='dreamer4.test'):
            with span('dreamer4.test'):
                pass


@pytest.mark.parametrize('kind', ['world_model', 'tokenizer'])
@pytest.mark.parametrize('grad_accum', [1, 2])
def test_train_step_holds_its_parts_in_order(kind, grad_accum):
    """One `dreamer4.train_step` per call; inside it forward, backward,
    optimizer and, on a step that applied an update, EMA, in that order
    and apart; the attention calls (the plain path on the CPU) inside the
    forward. Under `MultiSteps` the optimizer's span is on every call."""
    steps = 4
    trainer, calls = trainer_and_batches(kind, grad_accum, steps)
    trainer.train_on_batch(*calls[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for c in calls:
            trainer.train_on_batch(*c)
    spans = host_spans(prof)
    step_spans = [s for s in spans if s[2] == 'dreamer4.train_step']
    assert len(step_spans) == steps
    attention_names = set()
    for i, (lo, hi, _) in enumerate(step_spans):
        inside = [s for s in spans
                  if lo <= s[0] and s[1] <= hi and s[2] != 'dreamer4.train_step']
        parts = [s for s in inside if s[2] in PARTS]
        applied = (i + 2) % grad_accum == 0    # the warm call was the first micro-step
        assert [s[2] for s in parts] == list(PARTS if applied else PARTS[:3])
        assert all(a[1] <= b[0] for a, b in zip(parts, parts[1:]))
        forward = parts[0]
        attention = [s for s in inside if s[2].startswith('dreamer4.attention.')]
        assert attention
        assert all(forward[0] <= s[0] and s[1] <= forward[1] for s in attention)
        attention_names |= {s[2] for s in attention}
    assert attention_names == {'dreamer4.attention.plain'}
    assert all(any(lo <= s[0] and s[1] <= hi for lo, hi, _ in step_spans) for s in spans)


def test_profile_block_trace_holds_the_spans(tmp_path):
    """`profile_block` around train steps writes a Chrome trace that holds
    every part's span."""
    trainer, calls = trainer_and_batches('world_model', 1, 2)
    with profile_block(tmp_path / 'trace'):
        for c in calls:
            trainer.train_on_batch(*c)
    trace = json.loads((tmp_path / 'trace' / 'trace.json').read_text())
    names = {e.get('name') for e in trace['traceEvents']}
    assert {'dreamer4.train_step', 'dreamer4.attention.plain', *PARTS} <= names


@pytest.mark.cuda
def test_kernels_run_inside_their_paths_spans():
    """On the card K1 runs inside `dreamer4.attention.flash` and K4 inside
    `dreamer4.attention.small`: each traced kernel's launch (matched by
    correlation id) starts inside an instance of its path's span."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU or interpret mode')
    torch.manual_seed(0)
    g = torch.Generator(device='cuda').manual_seed(0)
    flash = Attention(64, dim_head=32, heads=2, device='cuda')
    small = Attention(64, dim_head=32, heads=2, use_fused_small=True, device='cuda')
    x_flash = torch.randn((2, 128, 64), generator=g, device='cuda')
    x_small = torch.randn((8, 16, 64), generator=g, device='cuda')
    with torch.no_grad():
        flash(x_flash, flash_spec=FlashSpec(causal=True))
        small(x_small)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                flash(x_flash, flash_spec=FlashSpec(causal=True))
                small(x_small)
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    spans = host_spans(prof)
    launch_start = {e.correlation_id(): e.start_ns() for e in events
                    if e.device_type() == DeviceType.CPU and 'Launch' in e.name()}
    for stem, path in (('flash_fwd', 'flash'), ('small_fwd', 'small')):
        kernels = [e for e in events if e.device_type() == DeviceType.CUDA and stem in e.name()]
        assert kernels, stem
        name = f'dreamer4.attention.{path}'
        assert sum(s[2] == name for s in spans) == 3
        for k in kernels:
            t = launch_start[k.correlation_id()]
            assert any(s <= t <= e for s, e, n in spans if n == name), (stem, path)
