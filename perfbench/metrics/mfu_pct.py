"""The whole step's share of the card's peak: model FLOPs (6 x
parameters x the tokens each sees, ``perfbench/yardstick.py::
model_flops``) of the traced steps over the traced window's time at the
H100's dense TF32 rate, 495 TFLOP/s, the fastest at which it takes f32
operands into a product.  The share of the 67 TFLOP/s f32 rate is
printed beside it."""

from perfbench.yardstick import PEAKS

WRAPS = []


def read(ctx):
    flops = ctx.trace.steps * ctx.yard["flops"]
    per_s = flops / ctx.trace.window_s
    ctx.note(f"mfu_pct against the f32 rate (67 TFLOP/s): "
             f"{100 * per_s / PEAKS['f32_flops_per_s']}")
    return 100 * per_s / PEAKS["tf32_flops_per_s"]
