"""Device ms a step of the expert layers' row permutes: the program's
``moe/dispatch`` (the routed rows gathered for the held experts) and
``moe/combine`` (their gated outputs added back to the tokens) phases,
forward and backward (``models/moe.py``, ``kernels/moe.py``)."""
from perfbench import spans

WRAPS = []


def read(ctx):
    w = spans.window(ctx)
    return None if w is None else w.device_ms("moe/dispatch", "moe/combine")
