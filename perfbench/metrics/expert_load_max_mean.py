"""The held experts' load spread: in each expert layer's call, the most
rows any (node, held expert) computed over the mean of them, averaged
over the traced steps' calls (the program's ``moe/rows`` counter,
``perfbench/moe_yard.py``).  1 is an even load."""
from perfbench import moe_yard, spans

WRAPS = []


def read(ctx):
    w = spans.window(ctx)
    calls = None if w is None else moe_yard.counted_rows(w)
    if not calls:
        return None
    spread = [c.max() / c.mean() for c in calls if c.sum() > 0]
    ctx.note(f"moe rows a layer call: {[int(c.sum()) for c in calls]}; "
             f"max / mean a held expert {spread}")
    return float(sum(spread) / len(spread)) if spread else None
