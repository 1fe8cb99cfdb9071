"""Kernel B3's share of its HBM roofline (``kernels/csrc/qinf_wire.cu``,
quantize and pack): the bytes a step's launches must move
(``perfbench/yardstick.py::b3_bytes``) over the card's bandwidth, against
the device time of every B3 launch of the traced steps.  Nothing where
the trace holds another number of launches than the program counted."""

from perfbench.yardstick import roofline_pct

WRAPS = []
KERNEL = "qinf_quantize_pack"
COUNTER = "qinf_quantize_pack_blocks"


def read(ctx):
    times = ctx.trace.kernels(KERNEL)
    if not times or len(times) != ctx.launches.get(COUNTER):
        return None
    return roofline_pct(ctx.trace.steps * ctx.yard["b3_bytes"], sum(times))
