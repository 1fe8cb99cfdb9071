"""Wall-clock spans that are correct under CUDA's asynchronous launches.

A kernel launch returns before the card has run it, so a host clock around
device work measures the enqueue.  :func:`span` synchronises the device it
is given on entry and on exit, so ``elapsed_s`` covers the work itself::

    with span("run_total", device) as sp:
        for t in range(steps):
            state = runner.step(state, draws)
    sp.elapsed_s
"""
from __future__ import annotations

import contextlib
import time

import torch


class Span:
    """Handle yielded by :func:`span`; ``elapsed_s`` is set on exit."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.elapsed_s: float = 0.0


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def span(name: str, device="cpu"):
    """Time a block, fenced by ``torch.cuda.synchronize`` on a CUDA
    device."""
    device = torch.device(device)
    sp = Span(name)
    _fence(device)
    t0 = time.perf_counter()
    try:
        yield sp
    finally:
        _fence(device)
        sp.elapsed_s = time.perf_counter() - t0
