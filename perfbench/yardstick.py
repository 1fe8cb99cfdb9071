"""The benchmark's frozen arithmetic: the chip's peaks, the bytes kernels
B3 and B4 must move in a step, and a step's model FLOPs.

Everything here is computed from the configuration's parameter shapes
and the cell's traffic, never read from the program, so a change to the
program cannot move the yardstick.  Bytes follow the roofline rule: each
input byte read once and each output byte written once.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

#: NVIDIA H100 SXM5 80 GB (data sheet; dense, at its 700 W limit)
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    #: TF32 tensor cores: the fastest rate at which the card takes f32
    #: operands into a product, the denominator of ``mfu_pct``
    "tf32_flops_per_s": 495e12,
    #: f32 outside the tensor cores: ``mfu_pct``'s diagnostic line only
    "f32_flops_per_s": 67e12,
}


def block_of(last: int, block: int) -> int:
    """The quantization block of a leaf whose last dim is ``last``: the
    last dim itself where it is even and narrower than ``block``."""
    return last if last % 2 == 0 and last < block else block


def wire_groups(shapes: Sequence[Tuple[int, ...]], bits: int, block: int
                ) -> List[Dict[str, int]]:
    """The row tables one node's leaves (per-node ``shapes``) fill, one
    per quantization block width, in order of first appearance: each
    ``{"block", "rows", "packed"}`` (packed: code bytes a row)."""
    per_code = 4 if bits + 1 <= 4 else 8
    groups: Dict[int, Dict[str, int]] = {}
    for shape in shapes:
        shape = tuple(shape) or (1,)
        blk = block_of(shape[-1], block)
        rows = int(np.prod(shape[:-1], dtype=np.int64)) * -(-shape[-1] // blk)
        g = groups.setdefault(blk, {"block": blk, "rows": 0,
                                    "packed": blk * per_code // 8})
        g["rows"] += rows
    return list(groups.values())


def b3_bytes(groups, nodes: int) -> int:
    """Quantize and pack, a step: every node reads its f32 rows and as
    many f32 uniforms, and writes the packed codes and a 4-byte scale a
    row."""
    return nodes * sum(g["rows"] * (8 * g["block"] + g["packed"] + 4)
                       for g in groups)


def b4_bytes(groups, nodes: int, senders: int, rounds: int) -> int:
    """Unpack, dequantize and mix, a step: every node reads ``senders``
    payloads (its own and one a hop) and writes ``rounds`` f32 mixes and
    its f32 own payload; plus each launch's (rounds, senders) f32 weight
    table a node."""
    rows = sum(g["rows"] * (senders * (g["packed"] + 4)
                            + 4 * (rounds + 1) * g["block"])
               for g in groups)
    return nodes * (rows + len(groups) * 4 * rounds * senders)


def model_flops(leaves, streams: Dict[str, str], tokens: Dict[str, int]
                ) -> int:
    """6 x parameters x the tokens each parameter sees, a step: ``leaves``
    [(path, spec)], ``streams`` maps a path prefix to the input stream its
    parameters read (every other parameter reads ``"labels"``), ``tokens``
    each stream's tokens a step over every node."""
    total = 0
    for path, spec in leaves:
        stream = next((s for p, s in streams.items() if path.startswith(p)),
                      "labels")
        total += int(np.prod(spec["shape"], dtype=np.int64)) * tokens[stream]
    return 6 * total


def roofline_pct(nbytes: float, seconds: float) -> float:
    """Share of the HBM roofline: the least time ``nbytes`` take over the
    time taken, in percent."""
    return 100.0 * nbytes / PEAKS["hbm_bytes_per_s"] / seconds
