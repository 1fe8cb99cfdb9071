"""The share of the traced window in which no operation ran on the
device (the H100)."""

WRAPS = []


def read(ctx):
    busy = ctx.trace.busy_s
    if busy <= 0:
        return None
    return 100 * (ctx.trace.window_s - busy) / ctx.trace.window_s
