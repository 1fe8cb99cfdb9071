"""Device ms a step of the wire layer: the bucketed exchange
(``optim/wire.py::WireExchange.bucketed``, ``core/bucket.py``): the
noise draws, kernel B3, the hops' copies, the payload stacks and kernel
B4."""

WRAPS = [("repro_torch.optim.wire:WireExchange.bucketed", "wire")]


def read(ctx):
    return ctx.trace.part_ms("wire")
