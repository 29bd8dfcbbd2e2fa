"""The per-layer readers that take the port's launch counters: a kernel
family's share of its roofline stands on the launches the port counted and
the traced kernels' own device time, and on nothing where the two disagree."""
from __future__ import annotations

import pytest

from benchmark import harness

FLASH = harness.metric_reader('flash_roofline')
SMALL = harness.metric_reader('small_roofline')


def flash_ctx(k1: int, dq: int, dkv: int, kernels):
    return {'launch_counts': {'flash_attention.K1_LAUNCHES': k1,
                              'flash_attention.BWD_DQ_LAUNCHES': dq,
                              'flash_attention.BWD_DKV_LAUNCHES': dkv},
            'kernels': kernels,
            'bounds_s': {'flash_fwd': 1e-3, 'bwd_dq': 2e-3, 'bwd_dkv': 5e-3}}


def test_roofline_is_counted_bounds_over_traced_time():
    kernels = [('void flash_fwd_sm90<64>(Sm90Params)', 2e-3), ('void flash_fwd_sm90<64>', 4e-3),
               ('void bwd_dq_sm90<64>', 3e-3), ('elementwise_kernel', 1.0)]
    got = FLASH.read(flash_ctx(2, 1, 0, kernels))
    assert got == pytest.approx(100 * (2 * 1e-3 + 2e-3) / (2e-3 + 4e-3 + 3e-3))


@pytest.mark.parametrize('counts', [(3, 1, 0), (2, 1, 1), (1, 1, 0)])
def test_roofline_is_silent_where_trace_and_counters_disagree(counts):
    kernels = [('flash_fwd_sm90', 2e-3), ('flash_fwd_sm90', 2e-3), ('bwd_dq_sm90', 3e-3)]
    assert FLASH.read(flash_ctx(*counts, kernels)) is None


def test_roofline_is_silent_where_nothing_was_launched():
    assert FLASH.read(flash_ctx(0, 0, 0, [('elementwise_kernel', 1.0)])) is None
    assert SMALL.read({'launch_counts': {}, 'kernels': [], 'bounds_s': {}}) is None
    assert FLASH.read({'records': []}) is None


@pytest.mark.parametrize('reader', [FLASH, SMALL])
def test_the_readers_counters_are_the_ports(reader):
    import dreamer4_torch.ops.flash_attention  # noqa: F401
    import dreamer4_torch.ops.small_attention  # noqa: F401

    counts = harness.launch_counts()
    assert set(reader.FAMILIES.values()) <= set(counts)


def test_launch_counts_follow_the_ports_counters():
    import dreamer4_torch.ops.flash_attention as fa
    import dreamer4_torch.ops.small_attention as sa

    before = harness.launch_counts()
    fa.K1_LAUNCHES['sm90'] += 2
    sa.BWD_LAUNCHES += 1
    try:
        after = harness.launch_counts()
    finally:
        fa.K1_LAUNCHES['sm90'] -= 2
        sa.BWD_LAUNCHES -= 1
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {'flash_attention.K1_LAUNCHES': 2, 'small_attention.BWD_LAUNCHES': 1}
