"""host_ms.backward.train: the host time of the port's span around the backward
(`dreamer4.backward`, `dreamer4_torch/tracing.py`): the caller waits in it
while the autograd engine launches the backward's kernels; per traced
train step."""

SPAN = 'dreamer4.backward'


def read(ctx):
    if 'host_ranges_s' not in ctx or SPAN not in ctx['host_ranges_s']:
        return None
    return 1e3 * ctx['host_ranges_s'][SPAN] / len(ctx['records'])
