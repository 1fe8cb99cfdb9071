"""Device ms a step of the wire's copies: the program's ``wire/hops``
phase (each hop's buffers through the one-card ``pp`` seam,
``optim/wire.py::stacked_pp``) and its ``wire/stack`` phases (each bucket
group's payload stacks for B4, ``core/bucket.py::mix_from_wire``)."""
from perfbench import spans

WRAPS = []


def read(ctx):
    w = spans.window(ctx)
    return None if w is None else w.device_ms("wire/hops", "wire/stack")
