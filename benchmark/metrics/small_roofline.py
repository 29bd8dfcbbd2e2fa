"""small_roofline: the small-attention kernels K4/K5 (`csrc/small_attn_*.cu`)
against their least time: each launch the port counted over the traced steps
at its bound (`benchmark/flops.py`, the configuration's time-attention shape),
over the traced kernels' own device time (`harness.roofline_pct`)."""
from benchmark.harness import roofline_pct

# each kernel's name in the trace, and the port's counter of its launches
FAMILIES = {'small_fwd': 'small_attention.FWD_LAUNCHES',
            'small_bwd': 'small_attention.BWD_LAUNCHES'}


def read(ctx):
    return roofline_pct(ctx, FAMILIES)
