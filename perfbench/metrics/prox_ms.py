"""Device ms a step of the l1 prox: the program's ``train/prox`` phases,
one a leaf (``optim/decentralized.py::_sharded_update``, ``core/prox.py``),
summed.  Prints the table of the step's phases and their cross-check
against the outside ranges (``perfbench/spans.py``)."""
from perfbench import spans

WRAPS = []


def read(ctx):
    w = spans.window(ctx)
    if w is None:
        return None
    spans.note_table(w, ctx)
    return w.device_ms("train/prox")
