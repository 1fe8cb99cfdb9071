"""The expert layer's frozen arithmetic: the FLOPs and bytes the held
experts' products and the row permutes around them must do, and the
whole step's FLOPs with the routed experts counted by the rows they
computed.

Everything comes from two counters the program keeps while a profiler
records (``repro_torch.obs.trace.count``, read after the window): a
layer call's rows of each (node, held expert), accumulated on the device
(``moe/rows``), and the call's widths (``moe/shape``: nodes, tokens a
node, routed experts a token, D, F).  A program that keeps neither gives
nothing to read.  Bytes follow the roofline rule: each input byte read
once and each output byte written once, f32.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from perfbench import spans

F32 = 4
#: the counters the program keeps of the rows each held expert computed,
#: and of the widths of the layer call
COUNTER, SHAPE = "moe/rows", "moe/shape"


@dataclasses.dataclass
class Call:
    """One expert layer's call: ``rows`` (nodes x held,) each group's
    rows; ``nodes``, ``tokens`` a node, ``k`` routed experts a token, the
    widths ``D`` and ``F``."""
    rows: np.ndarray
    nodes: int
    tokens: int
    k: int
    D: int
    F: int

    @property
    def live(self) -> int:
        return int(self.rows.sum())


def layer_calls(w: spans.Window) -> Optional[List[Call]]:
    """The window's expert layer calls, oldest first; None where the
    program keeps no such counters."""
    try:
        from repro_torch.obs.trace import counted
    except ImportError:
        return None
    steps = {r.step for r in w.records if r.name == spans.STEP}
    rows = [v for s, v in counted(COUNTER) if s in steps]
    shapes = [v for s, v in counted(SHAPE) if s in steps]
    if not rows or len(rows) != len(shapes):
        return None
    return [Call(r.numpy().astype(np.int64),
                 *(int(x) for x in sh.tolist())) for r, sh in
            zip(rows, shapes)]


def counted_rows(w: spans.Window) -> Optional[List[np.ndarray]]:
    """Each layer call's rows of each group, (nodes x held,), over the
    window's steps; None where the program keeps no such counter."""
    calls = layer_calls(w)
    return None if calls is None else [c.rows for c in calls]


def expert_flops(rows: int, D: int, F: int) -> int:
    """The three products of a held expert's SwiGLU on ``rows`` rows,
    2 rows D F each forward, twice that backward."""
    return 3 * 3 * 2 * rows * D * F


def expert_bytes(rows: int, groups: int, D: int, F: int) -> int:
    """A layer call's expert products, forward and backward: forward
    reads the gathered rows and the groups' three matrices and writes the
    outputs and both SwiGLU inputs (kept for backward); backward reads
    the output gradient, the rows, both inputs, the gates and the
    matrices, and writes the rows' gradient, the gates' gradient and the
    matrices' gradients."""
    weights = 3 * groups * D * F
    fwd = rows * D + weights + rows * D + 2 * rows * F
    bwd = 2 * rows * D + 2 * rows * F + rows + weights + rows * D + rows \
        + weights
    return F32 * (fwd + bwd)


def permute_bytes(rows: int, tokens: int, k: int, D: int) -> int:
    """A layer call's row permutes: the dispatch (gather the routed rows:
    read them, their token index, write them) and the combine (read the
    rows, each token's k slot positions and gates, write the tokens), and
    each one's transpose in backward (a gather of the output gradient; a
    combine of the rows' gradient, without gates)."""
    gather = 2 * F32 * rows * D + 8 * rows
    combine = F32 * rows * D + tokens * k * (8 + F32) + F32 * tokens * D
    combine_t = F32 * rows * D + tokens * k * 8 + F32 * tokens * D
    return 2 * gather + combine + combine_t


def step_flops(yard_flops: int, steps: int, calls: List[Call]) -> int:
    """6 x the parameters each token uses x the tokens, over ``steps``:
    the cell's yard (``yard_flops`` a step: 6 x every parameter x the
    labelled tokens, the held experts' included) with each call's held
    experts counted by the rows they computed instead of at every token
    of their node."""
    every = sum(6 * 3 * (len(c.rows) // c.nodes) * c.D * c.F * c.nodes
                * c.tokens for c in calls)
    return yard_flops * steps - every + sum(
        expert_flops(c.live, c.D, c.F) for c in calls)
