"""Kernel B4's share of its HBM roofline (``kernels/csrc/qinf_wire.cu``,
unpack, dequantize and mix): the bytes a step's launches must move,
their weight tables included (``perfbench/yardstick.py::b4_bytes``),
over the card's bandwidth, against the device time of every B4 launch
of the traced steps.  Nothing where the trace holds another number of
launches than the program counted."""

from perfbench.yardstick import roofline_pct

WRAPS = []
KERNEL = "qinf_unpack_dequant_mix"
COUNTER = "qinf_unpack_dequant_mix_blocks"


def read(ctx):
    times = ctx.trace.kernels(KERNEL)
    if not times or len(times) != ctx.launches.get(COUNTER):
        return None
    return roofline_pct(ctx.trace.steps * ctx.yard["b4_bytes"], sum(times))
