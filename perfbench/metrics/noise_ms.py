"""Device ms a step of the noise draws: the program's ``wire/noise``
phase, the stochastic-rounding uniforms drawn into the bucket groups'
tables (``optim/wire.py::WireExchange.bucketed``)."""
from perfbench import spans

WRAPS = []


def read(ctx):
    w = spans.window(ctx)
    return None if w is None else w.device_ms("wire/noise")
