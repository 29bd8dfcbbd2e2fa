"""The reduction of the port's spans (`benchmark/spans.py`) on synthetic
kineto events: device time by correlation id, launches from another thread,
nested spans, idle time clipped to a span, idle time between steps; and the
readers of the spans' host time, which give nothing where the trace holds
no span."""
from __future__ import annotations

import pytest
from torch.autograd import DeviceType

from benchmark import harness, spans

READERS = ['host_ms.forward.train', 'host_ms.backward.train', 'host_ms.ema.train']


class Event:
    """What the reduction reads of a kineto event."""

    def __init__(self, name, start, end, device=DeviceType.CPU, corr=0, thread=1,
                 annotation=False):
        self._name, self._start, self._end = name, start, end
        self._device, self._corr, self._thread = device, corr, thread
        self._annotation = annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def device_type(self):
        return self._device

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._thread

    def is_user_annotation(self):
        return self._annotation


def launch(start, corr, thread=1):
    return Event('cudaLaunchKernel', start, start + 5, corr=corr, thread=thread)


def kernel(start, end, corr, name='elementwise_kernel'):
    return Event(name, start, end, device=DeviceType.CUDA, corr=corr)


def one_step():
    """One step in [100, 1000]: forward [110, 400] with an attention call
    [150, 250], backward [400, 700], whose kernels the autograd thread
    launches, optimizer [700, 900]; a copy in the optimizer, one launch
    between steps."""
    return [
        Event('dreamer4.train_step', 100, 1000),
        Event('dreamer4.forward', 110, 400),
        Event('dreamer4.attention.plain', 150, 250),
        Event('dreamer4.backward', 400, 700),
        Event('dreamer4.optimizer', 700, 900),
        # the profiler's device copy of a span is no kernel
        Event('dreamer4.forward', 200, 600, device=DeviceType.CUDA, annotation=True),
        launch(120, 1), kernel(130, 180, 1),                 # forward, outside the attention
        launch(160, 2), kernel(200, 300, 2),                 # the attention
        launch(450, 3, thread=2), kernel(460, 560, 3),       # backward, another thread
        launch(500, 4, thread=2), kernel(600, 640, 4),
        Event('cudaMemcpyAsync', 710, 720, corr=5),
        kernel(720, 730, 5, name='Memcpy DtoD (Device -> Device)'),
        launch(750, 6), kernel(760, 860, 6),                 # optimizer
        launch(1050, 7), kernel(1060, 1070, 7),              # between steps
        Event('aten::mul', 120, 125),
    ]


def test_device_time_and_launches_follow_correlation_ids():
    out = spans.reduce(one_step(), 100, 1100, [])['by_name']
    assert out['dreamer4.forward']['device_s'] == pytest.approx((50 + 100) / 1e9)
    assert out['dreamer4.forward']['launches'] == 2
    assert out['dreamer4.attention.plain']['device_s'] == pytest.approx(100 / 1e9)
    assert out['dreamer4.attention.plain']['launches'] == 1
    # launched from the autograd thread while the caller waits in backward
    assert out['dreamer4.backward']['device_s'] == pytest.approx(140 / 1e9)
    assert out['dreamer4.backward']['launches'] == 2
    # a copy counts its device time, not as a launch
    assert out['dreamer4.optimizer']['device_s'] == pytest.approx(110 / 1e9)
    assert out['dreamer4.optimizer']['launches'] == 1
    assert out['dreamer4.train_step']['device_s'] == pytest.approx(400 / 1e9)
    assert {n: v['count'] for n, v in out.items()} == {
        'dreamer4.train_step': 1, 'dreamer4.forward': 1, 'dreamer4.attention.plain': 1,
        'dreamer4.backward': 1, 'dreamer4.optimizer': 1}
    assert out['dreamer4.forward']['host_s'] == pytest.approx(290 / 1e9)


def test_nested_instances_of_one_name_count_once():
    events = [Event('dreamer4.forward', 0, 100), Event('dreamer4.forward', 20, 50),
              Event('dreamer4.forward', 200, 300), launch(30, 1), kernel(40, 60, 1)]
    out = spans.reduce(events, 0, 300, [])['by_name']['dreamer4.forward']
    assert out['count'] == 3
    assert out['host_s'] == pytest.approx(200 / 1e9)
    assert out['launches'] == 1 and out['device_s'] == pytest.approx(20 / 1e9)


def test_idle_time_is_clipped_to_each_span():
    events = one_step()
    got = spans.reduce(events, 100, 1100, spans.busy_intervals(events))
    out = got['by_name']
    # busy: [130, 180], [200, 300], [460, 560], [600, 640], [720, 730], [760, 860], [1060, 1070]
    assert out['dreamer4.forward']['idle_s'] == pytest.approx((20 + 20 + 100) / 1e9)
    assert out['dreamer4.attention.plain']['idle_s'] == pytest.approx(20 / 1e9)
    assert out['dreamer4.backward']['idle_s'] == pytest.approx((60 + 40 + 60) / 1e9)
    assert out['dreamer4.optimizer']['idle_s'] == pytest.approx((20 + 30 + 40) / 1e9)
    assert out['dreamer4.train_step']['idle_s'] == pytest.approx(
        (30 + 20 + 160 + 40 + 80 + 30 + 140) / 1e9)
    # between steps: [1000, 1060] and [1070, 1100]
    assert got['between_steps_idle_s'] == pytest.approx(90 / 1e9)


def test_between_steps_idle_needs_a_train_step():
    events = [Event('dreamer4.forward', 0, 100), launch(10, 1), kernel(20, 30, 1)]
    assert spans.reduce(events, 0, 200, spans.busy_intervals(events))['between_steps_idle_s'] is None


def ctx_of(events, steps):
    """What `harness.run_traced` hands the readers of host ranges."""
    host_ranges = {}
    for e in events:
        if e.device_type() == DeviceType.CPU:
            host_ranges[e.name()] = host_ranges.get(e.name(), 0.0) + (e.end_ns() - e.start_ns()) / 1e9
    return {'records': [{}] * steps, 'host_ranges_s': host_ranges}


def test_host_readers_give_ms_per_step():
    ctx = ctx_of(one_step() + [Event('dreamer4.ema', 900, 950)], steps=2)
    read = lambda name: harness.metric_reader(name).read(ctx)
    assert read('host_ms.forward.train') == pytest.approx(1e3 * 290e-9 / 2)
    assert read('host_ms.backward.train') == pytest.approx(1e3 * 300e-9 / 2)
    assert read('host_ms.ema.train') == pytest.approx(1e3 * 50e-9 / 2)


@pytest.mark.parametrize('reader', READERS)
def test_host_readers_are_silent_without_spans(reader):
    read = harness.metric_reader(reader).read
    # a program without spans
    bare = [e for e in one_step() if not e.name().startswith('dreamer4.')]
    assert read(ctx_of(bare, 1)) is None
    # a window run, not traced
    assert read({'records': [{}], 'step_ms': [1.0]}) is None
