"""host_ms.forward.train: the host time of the port's span around the training forward and the
losses added to it (`dreamer4.forward`, `dreamer4_torch/tracing.py`), per
traced train step."""

SPAN = 'dreamer4.forward'


def read(ctx):
    if 'host_ranges_s' not in ctx or SPAN not in ctx['host_ranges_s']:
        return None
    return 1e3 * ctx['host_ranges_s'][SPAN] / len(ctx['records'])
