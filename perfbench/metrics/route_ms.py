"""Device ms a step of the expert layers' router: the program's
``moe/route`` phases, forward and backward (``models/moe.py``: the router
product, the softmax, the top k, the balance loss and the sort of the
routed slots by (node, held expert))."""
from perfbench import spans

WRAPS = []


def read(ctx):
    w = spans.window(ctx)
    return None if w is None else w.device_ms("moe/route")
