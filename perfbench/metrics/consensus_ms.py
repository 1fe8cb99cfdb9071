"""Device ms a step of the consensus metric: the program's
``train/consensus`` phase, the squared deviation of every leaf from the
node mean that ``optim/decentralized.py::train_step`` reports each
step."""
from perfbench import spans

WRAPS = []


def read(ctx):
    w = spans.window(ctx)
    return None if w is None else w.device_ms("train/consensus")
