"""Host ms a step of the trainer's step: the program's ``train/step``
phase on the host's clock (``time.perf_counter_ns``), the time the host
takes to enqueue a step's work, or waits on a full launch queue."""
from perfbench import spans

WRAPS = []


def read(ctx):
    w = spans.window(ctx)
    return None if w is None else w.host_ms("train/step")
