"""The traced run's tools: ``torch.profiler.record_function`` ranges put
around the program's callables from outside, a profiler window with an
idle guard at each edge, and the reading of its trace.

A device operation belongs to the innermost ``bench/`` range around its
launch on the host (the runtime call of the same correlation id): the
backward pass's kernels are launched from the autograd engine's thread
while the caller waits inside its range, so the launch time decides and
not the thread.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

#: idle host time at each edge of the profiled window: the profiler keeps
#: a device event only where its time, converted to the host's clock,
#: falls inside the window, and that conversion has read up to 4.6 ms
#: behind the host on the card
GUARD_S = 0.05
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
PREFIX = "bench/"


def _resolve(target: str):
    """``"package.module:Class.attr"`` -> (owner object, attribute)."""
    mod, _, qual = target.partition(":")
    owner = importlib.import_module(mod)
    *path, attr = qual.split(".")
    for p in path:
        owner = getattr(owner, p)
    return owner, attr


@contextlib.contextmanager
def ranges(torch, wraps: Sequence[Tuple[str, str]]):
    """Each ``(target, name)`` of ``wraps``: the callable ``target``
    runs inside a ``bench/<name>`` range while the block runs; restored
    on exit."""
    saved = []

    def spanned(name, fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            with torch.profiler.record_function(PREFIX + name):
                return fn(*a, **k)
        return inner

    try:
        for target, name in wraps:
            owner, attr = _resolve(target)
            fn = owner.__dict__[attr] if isinstance(owner, type) else \
                getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, spanned(name, fn))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


@contextlib.contextmanager
def guarded_profile(torch, device):
    """A profiler window over host and device activities, idle for
    :data:`GUARD_S` at each edge; the caller fences its own work."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        _sync(torch, device)
        time.sleep(GUARD_S)
        yield prof
        _sync(torch, device)
        time.sleep(GUARD_S)


def warm(torch, device) -> None:
    """One unmeasured profiler window: a process's first window has come
    back with no device event at all on the card."""
    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        return
    x = torch.zeros(1024, device=device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(20):
            x.add_(1.0)
        torch.cuda.synchronize()


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def events_of(prof) -> List[dict]:
    """The profile's chrome-trace events (written to and read from a
    temporary file, removed after)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """What one profiled window of ``steps`` steps says: its device
    operations, each attributed to the innermost ``bench/`` range, and
    the ``bench/window`` range that fences the steps."""

    def __init__(self, events: List[dict], steps: int) -> None:
        self.steps = steps
        xs = [e for e in events if e.get("ph") == "X"]
        spans = [e for e in xs if e.get("cat") == "user_annotation"
                 and e.get("name", "").startswith(PREFIX)]
        win = [e for e in spans if e["name"] == PREFIX + "window"]
        if len(win) != 1:
            raise ValueError(f"{len(win)} bench/window ranges in the trace")
        w = win[0]
        self.w0, self.w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.host_tid = w.get("tid")
        self.spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                             e["name"][len(PREFIX):]) for e in spans
                            if e is not w)
        launched = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                    if e.get("cat") in LAUNCH_CATS
                    and "correlation" in e.get("args", {})}
        self.device = []            # (start us, end us, name, part or None)
        for e in xs:
            if e.get("cat") not in DEVICE_CATS:
                continue
            t0 = float(e["ts"])
            t1 = t0 + float(e["dur"])
            if t1 <= self.w0 or t0 >= self.w1:
                continue
            at = launched.get(e.get("args", {}).get("correlation"))
            self.device.append((t0, t1, e["name"], self._part(at)))
        self.host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                            e["name"]) for e in xs
                           if e.get("cat") in HOST_CATS
                           and e.get("tid") == self.host_tid)

    def _part(self, t: Optional[float]) -> Optional[str]:
        if t is None:
            return None
        inside = [s for s in self.spans if s[0] <= t <= s[1]
                  and s[2] != "step"]
        return min(inside, key=lambda s: s[1] - s[0])[2] if inside else None

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    def busy(self):
        return _union((max(a, self.w0), min(b, self.w1))
                      for a, b, _, _ in self.device)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def part_ms(self, *parts: str) -> Optional[float]:
        """Device ms a step of the operations whose innermost range is
        one of ``parts``; None where no operation is."""
        ds = [b - a for a, b, _, p in self.device if p in parts]
        return sum(ds) / 1e3 / self.steps if ds else None

    def kernels(self, pattern: str) -> List[float]:
        """Durations (s) of the device operations whose name holds
        ``pattern``."""
        return [(b - a) / 1e6 for a, b, n, _ in self.device if pattern in n]

    def top_ops(self, k: int = 10):
        by: Dict[str, float] = {}
        for a, b, n, _ in self.device:
            by[n] = by.get(n, 0.0) + (b - a) / 1e6
        return sorted(([n[:120], s] for n, s in by.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The longest stretches of the window with no device operation,
        each named by the innermost host event running when it began."""
        busy = self.busy()
        edges = [self.w0] + [x for iv in busy for x in iv] + [self.w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        out = []
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            inside = [h for h in self.host if h[0] <= a < h[1]]
            name = (min(inside, key=lambda h: h[1] - h[0])[2][:120]
                    if inside else "host between calls")
            out.append([name, (b - a) / 1e6])
        return out
