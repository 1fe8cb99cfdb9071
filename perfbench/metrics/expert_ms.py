"""Device ms a step of the held experts: the program's ``moe/experts``
phases, forward and backward (``models/moe.py``: each (node, held
expert)'s SwiGLU on its routed rows by grouped products,
``kernels/moe.py``)."""
from perfbench import spans

WRAPS = []


def read(ctx):
    w = spans.window(ctx)
    return None if w is None else w.device_ms("moe/experts")
