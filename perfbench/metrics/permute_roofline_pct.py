"""The row permutes' share of their HBM roofline: the bytes the routed
rows' dispatch and combine and their transposes must move
(``perfbench/moe_yard.py``, rows and widths from the program's
``moe/rows`` and ``moe/shape`` counters) over 3.35 TB/s, against the
device time of every launch of the two Triton kernels
(``moe_gather_kernel``, ``moe_combine_kernel``, ``kernels/moe.py``) in
the traced steps."""
from perfbench import moe_yard, spans
from perfbench.yardstick import roofline_pct

WRAPS = []
KERNELS = ("moe_gather", "moe_combine")


def read(ctx):
    w = spans.window(ctx)
    calls = None if w is None else moe_yard.layer_calls(w)
    times = [t for k in KERNELS for t in ctx.trace.kernels(k)]
    if not calls or not times:
        return None
    nbytes = sum(moe_yard.permute_bytes(c.live, c.nodes * c.tokens, c.k,
                                        c.D) for c in calls)
    return roofline_pct(nbytes, sum(times))
