"""optimizer_ms.train: the host time of the profiler's own range around the
optimizer's step (`Optimizer.step#MuonAdamAtan2.step`), per traced train step."""

RANGE = 'Optimizer.step#MuonAdamAtan2.step'


def read(ctx):
    if 'host_ranges_s' not in ctx or RANGE not in ctx['host_ranges_s']:
        return None
    return 1e3 * ctx['host_ranges_s'][RANGE] / len(ctx['records'])
