"""Spans: fenced wall-clock spans, and the phases of a step seen by a
profiler.

A kernel launch returns before the card has run it, so a host clock around
device work measures the enqueue.  :func:`span` synchronises the device it
is given on entry and on exit, so ``elapsed_s`` covers the work itself::

    with span("run_total", device) as sp:
        for t in range(steps):
            state = runner.step(state, draws)
    sp.elapsed_s

:func:`phase` names a part of a step without fencing anything.  It is on
only while a ``torch.profiler`` window records; outside one it is a flag
test and a null context.  Inside one it opens a ``record_function`` range
of its name (so the phase sits on the profiler's clock beside the device
trace), and keeps a :class:`Span` record in a bounded ring: its host
times, its parent phase, the step it belongs to, the bytes its work must
move, and on a CUDA device two timing events on the current stream.  The
events' times are resolved by :func:`recorded`, which the caller calls
after it has synchronised::

    with torch.profiler.profile(activities=[...]):
        for t in range(steps):
            state, _ = runner.step(state, batch, draws)
        torch.cuda.synchronize()
    for sp in trace.recorded():
        print(sp.name, sp.parent, sp.step, sp.device_ms, sp.bytes)

A phase never synchronises, reads nothing from the device and allocates
nothing on it, unless its ``bytes`` are counted on the device: a phase
whose work depends on data the host has not seen (the MoE layer's routed
rows) gives a zero-dim device tensor, or a callable returning one, which
:func:`recorded` reads.

:func:`count` keeps a device counter the same way: on only while a
profiler records, each call's tensor (a clone) kept with the step it
belongs to, read once by :func:`counted` after the window.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Deque, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

#: records the ring keeps (the oldest go first)
RING_SIZE = 4096


@dataclasses.dataclass(eq=False)
class Span:
    """One span: :func:`span` sets ``elapsed_s``; :func:`phase` sets the
    rest, and :func:`recorded` the device times, in ms from the first
    record's start in the ring (None on the CPU, or while the work is not
    done)."""
    name: str
    parent: Optional[str] = None
    step: int = 0
    bytes: Optional[int] = None
    host_t0_ns: int = 0
    host_t1_ns: int = 0
    device_t0_ms: Optional[float] = None
    device_t1_ms: Optional[float] = None
    elapsed_s: float = 0.0
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = \
        dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.host_t1_ns - self.host_t0_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        if self.device_t0_ms is None or self.device_t1_ms is None:
            return None
        return self.device_t1_ms - self.device_t0_ms


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


class Recorder:
    """The phases' ring, the phases open now (innermost last), the
    ordinal of the last root phase (a phase with no parent: a step) and
    the counters' ring of (name, step, device tensor)."""

    def __init__(self, size: int = RING_SIZE) -> None:
        self.ring: Deque[Span] = collections.deque(maxlen=size)
        self.counts: Deque[Tuple[str, int, torch.Tensor]] = \
            collections.deque(maxlen=size)
        self.open: List[Span] = []
        self.ordinal = 0

    def recorded(self) -> List[Span]:
        """The ring's records, oldest first, their device times resolved
        where both events have completed."""
        recs = list(self.ring)
        origin = next((r.events[0] for r in recs if r.events), None)
        still_open = {id(r) for r in self.open}
        for r in recs:
            if isinstance(r.bytes, torch.Tensor):
                r.bytes = int(r.bytes)
            if r.events is None or id(r) in still_open \
                    or not r.events[1].query():
                r.device_t0_ms = r.device_t1_ms = None
                continue
            r.device_t0_ms = origin.elapsed_time(r.events[0])
            r.device_t1_ms = origin.elapsed_time(r.events[1])
        return recs

    def clear(self) -> None:
        self.ring.clear()
        self.counts.clear()


RECORDER = Recorder()


class _Phase:
    __slots__ = ("sp", "cuda", "rf")

    def __init__(self, name: str, device, nbytes) -> None:
        self.sp = Span(name, bytes=nbytes() if callable(nbytes) else nbytes)
        self.cuda = (device is not None
                     and torch.device(device).type == "cuda")

    def __enter__(self) -> None:
        rec, sp = RECORDER, self.sp
        if rec.open:
            sp.parent, sp.step = rec.open[-1].name, rec.open[-1].step
        else:
            rec.ordinal += 1
            sp.step = rec.ordinal
        rec.open.append(sp)
        rec.ring.append(sp)
        self.rf = _profiler.record_function(sp.name)
        self.rf.__enter__()
        if self.cuda:
            sp.events = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            sp.events[0].record()
        sp.host_t0_ns = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        sp = self.sp
        sp.host_t1_ns = time.perf_counter_ns()
        if self.cuda:
            sp.events[1].record()
        self.rf.__exit__(*exc)
        RECORDER.open.pop()


_OFF = contextlib.nullcontext()


def phase(name: str, device=None, bytes=None):
    """A phase of a step named ``name`` (see the module docstring), timed
    on the device where ``device`` is a CUDA device; ``bytes``: what its
    work must move, by the program's count from tensor sizes: an int, a
    zero-dim device tensor, or a callable giving either, called only
    while a profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Phase(name, device, bytes)


def count(name: str, value) -> None:
    """Add ``value`` (a device tensor, or a callable giving one, called
    only while a profiler records) to counter ``name`` of the step the
    innermost open phase belongs to."""
    if not _profiler._is_profiler_enabled:
        return
    rec = RECORDER
    v = value() if callable(value) else value
    step = rec.open[-1].step if rec.open else rec.ordinal
    rec.counts.append((name, step, v.detach().clone()))


def counted(name: str) -> List[Tuple[int, torch.Tensor]]:
    """Counter ``name``'s calls so far, oldest first: (step, the value on
    the host); call it once the device has run their work."""
    return [(step, v.cpu()) for n, step, v in RECORDER.counts if n == name]


def recorded() -> List[Span]:
    """The phases recorded so far (at most :data:`RING_SIZE`, oldest
    first), with their device times; call it once the device has run
    their work (after a ``synchronize``)."""
    return RECORDER.recorded()


def clear() -> None:
    """Forget every recorded phase."""
    RECORDER.clear()
