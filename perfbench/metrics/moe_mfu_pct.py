"""The whole step's share of the card's peak with the routed experts
counted as they ran: 6 x the parameters each token uses x the tokens
(the cell's yard, with each expert layer call's held experts counted by
the rows the program's ``moe/rows`` counter says they computed instead
of at every token; ``perfbench/moe_yard.py``) over the traced window's
time at the H100's dense TF32 rate, 495 TFLOP/s, as ``mfu_pct``.  The
share of the 67 TFLOP/s f32 rate is printed beside it."""
from perfbench import moe_yard, spans
from perfbench.yardstick import PEAKS

WRAPS = []


def read(ctx):
    w = spans.window(ctx)
    calls = None if w is None else moe_yard.layer_calls(w)
    if not calls or "flops" not in ctx.yard:
        return None
    flops = moe_yard.step_flops(ctx.yard["flops"], w.steps, calls)
    per_s = flops / ctx.trace.window_s
    ctx.note(f"moe_mfu_pct against the f32 rate (67 TFLOP/s): "
             f"{100 * per_s / PEAKS['f32_flops_per_s']}")
    return 100 * per_s / PEAKS["tf32_flops_per_s"]
