"""host_ms.ema.train: the host time of the port's span around the EMA update
(`dreamer4.ema`, `dreamer4_torch/tracing.py`), per traced train step."""

SPAN = 'dreamer4.ema'


def read(ctx):
    if 'host_ranges_s' not in ctx or SPAN not in ctx['host_ranges_s']:
        return None
    return 1e3 * ctx['host_ranges_s'][SPAN] / len(ctx['records'])
