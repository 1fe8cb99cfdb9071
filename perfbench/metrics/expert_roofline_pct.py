"""The held experts' share of their roofline: the least time the H100
takes for the products the routed rows need (``perfbench/moe_yard.py``:
18 rows D F FLOPs at the 67 TFLOP/s f32 rate, since the program trains
f32 with TF32 off, or their bytes at 3.35 TB/s, whichever is longer)
over the device time of the ``moe/experts`` phases, rows and widths from
the program's ``moe/rows`` and ``moe/shape`` counters."""
from perfbench import moe_yard, spans
from perfbench.yardstick import PEAKS

WRAPS = []


def read(ctx):
    w = spans.window(ctx)
    ms = None if w is None else w.device_ms("moe/experts")
    calls = None if w is None else moe_yard.layer_calls(w)
    if ms is None or not calls:
        return None
    flops = sum(moe_yard.expert_flops(c.live, c.D, c.F) for c in calls)
    nbytes = sum(moe_yard.expert_bytes(c.live, len(c.rows), c.D, c.F)
                 for c in calls)
    least = max(flops / PEAKS["f32_flops_per_s"],
                nbytes / PEAKS["hbm_bytes_per_s"])
    ctx.note(f"expert_roofline_pct: {flops / w.steps} FLOPs and "
             f"{nbytes / w.steps} bytes a step over {ms} ms")
    return 100 * least / (ms * w.steps / 1e3)
