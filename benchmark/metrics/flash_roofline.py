"""flash_roofline: the time-attention kernels K1-K3 (`csrc/flash_attn_*.cu`)
against their least time: each launch the port counted over the traced steps
at its bound (`benchmark/flops.py`, the configuration's time-attention shape),
over the traced kernels' own device time (`harness.roofline_pct`)."""
from benchmark.harness import roofline_pct

# each kernel's name in the trace, and the port's counter of its launches
FAMILIES = {'flash_fwd': 'flash_attention.K1_LAUNCHES',
            'bwd_dq': 'flash_attention.BWD_DQ_LAUNCHES',
            'bwd_dkv': 'flash_attention.BWD_DKV_LAUNCHES'}


def read(ctx):
    return roofline_pct(ctx, FAMILIES)
