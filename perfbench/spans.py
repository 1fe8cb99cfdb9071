"""The program's own phases of a step in the traced window: the spans
``repro_torch.obs.trace.phase`` records while the profiler runs (the
table of PERF.md section 3), read by the per-layer metrics ``prox_ms``,
``noise_ms``, ``hop_copy_ms``, ``consensus_ms`` and ``host_step_ms``.

A window is the traced steps' ``train/step`` records and the records of
the same steps.  It exists only where exactly ``ctx.trace.steps`` step
records carry device times: a lost span then shows as a missing number,
not a wrong one.  A program without phases (an older checkout) records
nothing, and every reader is silent.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from perfbench.yardstick import PEAKS

STEP = "train/step"


def program_records() -> list:
    """The program's recorded phases, device times resolved; none where
    the program has no phases."""
    try:
        from repro_torch.obs.trace import recorded
    except ImportError:
        return []
    return recorded()


def _union_ms(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class Window:
    """The phases of the traced steps; every figure is a mean a step."""

    def __init__(self, records: List, steps: int) -> None:
        self.records, self.steps = records, steps

    @classmethod
    def of(cls, records: List, steps: int) -> Optional["Window"]:
        """The window of the steps of ``records``; None unless exactly
        ``steps`` step records carry device times."""
        timed = [r for r in records
                 if r.name == STEP and r.device_ms is not None]
        if len(timed) != steps:
            return None
        keep = {r.step for r in timed}
        return cls([r for r in records if r.step in keep], steps)

    def names(self) -> List[str]:
        """Every phase's name, in the order first opened."""
        out: List[str] = []
        for r in sorted(self.records, key=lambda r: r.host_t0_ns):
            if r.name not in out:
                out.append(r.name)
        return out

    def _of(self, name: str) -> List:
        return [r for r in self.records if r.name == name]

    def device_ms(self, *names: str) -> Optional[float]:
        """Device ms a step of the phases named ``names``; None where none
        was recorded."""
        rs = [r for n in names for r in self._of(n)]
        if not rs or any(r.device_ms is None for r in rs):
            return None
        return sum(r.device_ms for r in rs) / self.steps

    def host_ms(self, name: str) -> Optional[float]:
        rs = self._of(name)
        return sum(r.host_ms for r in rs) / self.steps if rs else None

    def self_ms(self, name: str) -> Optional[float]:
        """Device ms a step of ``name`` less what its child phases cover
        (children: the same step's phases whose parent is ``name``, cut
        to the span)."""
        rs = self._of(name)
        if not rs or any(r.device_ms is None for r in rs):
            return None
        total = 0.0
        for r in rs:
            kids = [(max(k.device_t0_ms, r.device_t0_ms),
                     min(k.device_t1_ms, r.device_t1_ms))
                    for k in self.records
                    if k.parent == name and k.step == r.step
                    and k.device_ms is not None]
            total += r.device_ms - _union_ms((a, b) for a, b in kids
                                             if b > a)
        return total / self.steps

    def bytes(self, name: str) -> Optional[float]:
        rs = self._of(name)
        if not rs or any(r.bytes is None for r in rs):
            return None
        return sum(r.bytes for r in rs) / self.steps

    def per_step(self, name: str) -> float:
        return len(self._of(name)) / self.steps


def window(ctx) -> Optional[Window]:
    """The program's phases over the traced steps of ``ctx``."""
    return Window.of(program_records(), ctx.trace.steps)


def table(w: Window) -> List[Dict]:
    """One row a phase: its count, device, self and host ms a step, and
    its bytes a step as a share of 3.35 TB/s over its device time."""
    rows = []
    for name in w.names():
        dev, nbytes = w.device_ms(name), w.bytes(name)
        rows.append({
            "span": name, "per_step": w.per_step(name), "device_ms": dev,
            "self_ms": w.self_ms(name), "host_ms": w.host_ms(name),
            "hbm_pct": (100 * nbytes / PEAKS["hbm_bytes_per_s"]
                        / (dev / 1e3) if nbytes and dev else None)})
    return rows


def cross_check(w: Window, part_ms, idle: Dict[str, float]
                ) -> Dict[str, Tuple[Optional[float], Optional[float]]]:
    """The phases against the outside ranges of the same window
    (``part_ms``: ``ctx.trace.part_ms``, device operations' time), each a
    ratio, 1 where they agree: as measured, and with the idle time that
    began under the phases taken out (``idle``: :func:`idle_by_phase`),
    since a phase's events also time the device waiting on the host
    inside it.  Last, the share of the step that the model, update and
    consensus phases cover."""
    def ratio(a, b):
        return a / b if a is not None and b else None

    def less(v, *names):
        return None if v is None else v - sum(idle.get(n, 0.0)
                                               for n in names)

    model, update = w.device_ms("train/model"), w.device_ms("train/update")
    wire, step = w.device_ms("wire/exchange"), w.device_ms(STEP)
    own = update - wire if update is not None and wire is not None else None
    wires = [n for n in idle if n.startswith("wire/")]
    covered = [w.device_ms(n) for n in ("train/model", "train/update",
                                        "train/consensus")]
    cover = sum(covered) if None not in covered else None
    return {
        "train/model / model_ms": (
            ratio(model, part_ms("model")),
            ratio(less(model, "train/model"), part_ms("model"))),
        "wire/exchange / wire_ms": (
            ratio(wire, part_ms("wire")),
            ratio(less(wire, *wires), part_ms("wire"))),
        "(train/update - wire/exchange) / update_ms": (
            ratio(own, part_ms("update")),
            ratio(less(own, "train/update", "train/prox"),
                  part_ms("update"))),
        "(model + update + consensus) / train/step": (
            ratio(cover, step), ratio(cover, step))}


def idle_by_phase(trace) -> Dict[str, float]:
    """Idle device ms a step, by the innermost phase the host was in when
    each stretch of the window with no device operation began (the
    phases' ``record_function`` ranges in the profiler's trace)."""
    busy = trace.busy()
    edges = [trace.w0] + [x for iv in busy for x in iv] + [trace.w1]
    phases = [h for h in trace.host if h[2].startswith(("train/", "wire/"))]
    out: Dict[str, float] = {}
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b <= a:
            continue
        inside = [h for h in phases if h[0] <= a < h[1]]
        name = (min(inside, key=lambda h: h[1] - h[0])[2] if inside
                else "outside the phases")
        out[name] = out.get(name, 0.0) + (b - a) / 1e3 / trace.steps
    return out


def note_table(w: Window, ctx) -> None:
    """Print the span table, the cross-check and the idle time by phase
    through ``ctx.note``."""
    def f(v):
        return "-" if v is None else f"{v:.4f}"

    ctx.note("spans (a step): span | count | device ms | self ms | host ms"
             " | bytes over 3.35 TB/s %")
    for r in table(w):
        ctx.note(f"  {r['span']} | {r['per_step']:g} | {f(r['device_ms'])}"
                 f" | {f(r['self_ms'])} | {f(r['host_ms'])}"
                 f" | {f(r['hbm_pct'])}")
    idle = idle_by_phase(ctx.trace)
    for k, (v, busy) in cross_check(w, ctx.trace.part_ms, idle).items():
        ctx.note(f"  cross-check {k}: {f(v)} (less the idle under the "
                 f"phases: {f(busy)})")
    ctx.note("  idle device ms a step by phase: " + "; ".join(
        f"{k} {v:.4f}" for k, v in sorted(idle.items(),
                                           key=lambda kv: -kv[1])))
