"""The program's phases in the traced window (``perfbench/spans.py``) and
the five readers of them, on made-up records: a step's sums, self time,
host time, the span table's cross-check, and silence where the step
records do not match the traced steps or the program has no phases."""
import sys
import types

import pytest

import bench_small  # noqa: F401  (puts the repository on the path)
from perfbench import harness, spans, traffic
from repro_torch.obs.trace import Span

BENCH = traffic.benchmark()
READERS = ("prox_ms", "noise_ms", "hop_copy_ms", "consensus_ms",
           "host_step_ms")
#: (name, parent, device start ms, end ms, bytes) of one step, from 0
STEP = [("train/step", None, 0, 100, None),
        ("train/model", "train/step", 0, 40, None),
        ("train/update", "train/step", 40, 95, None),
        ("wire/exchange", "train/update", 45, 70, None),
        ("wire/noise", "wire/exchange", 45, 47, 2 * 10 ** 9),
        ("wire/pack", "wire/exchange", 47, 55, None),
        ("wire/hops", "wire/exchange", 55, 58, None),
        ("wire/mix", "wire/exchange", 58, 70, None),
        ("wire/stack", "wire/mix", 58, 59, None),
        ("wire/stack", "wire/mix", 61, 62, None),
        ("train/prox", "train/update", 75, 80, None),
        ("train/prox", "train/update", 80, 82, None),
        ("train/consensus", "train/step", 95, 99, None)]


def _records(steps=2, timed=True):
    out = []
    for s in range(steps):
        t = 100.0 * s
        for i, (name, parent, a, b, nb) in enumerate(STEP):
            out.append(Span(name, parent, step=s + 1, bytes=nb,
                            host_t0_ns=int(1e6 * (10 * s + i)),
                            host_t1_ns=int(1e6 * (10 * s + i + 3)),
                            device_t0_ms=t + a if timed else None,
                            device_t1_ms=t + b if timed else None))
    return out


def _ctx(steps, notes):
    """The outside ranges' ms a step, and a window of 200 us in us whose
    device idles from 50 to 60 (in ``wire/hops``) and from 150 to 200
    (outside the phases)."""
    trace = types.SimpleNamespace(
        steps=steps, part_ms={"model": 40.0, "update": 29.0,
                              "wire": 25.0}.get,
        w0=0.0, w1=200.0, busy=lambda: [[0.0, 50.0], [60.0, 150.0]],
        host=[(0.0, 150.0, "train/step"), (40.0, 100.0, "wire/exchange"),
              (45.0, 70.0, "wire/hops"), (50.0, 52.0, "aten::index")])
    return harness.ReadContext(trace, {}, {}, notes.append)


def _read(monkeypatch, records, steps):
    monkeypatch.setattr(spans, "program_records", lambda: records)
    cell = harness.open_cell("qwen3-1.7b.ring8", BENCH)
    readers = harness.metric_modules(cell, BENCH)
    notes = []
    ctx = _ctx(steps, notes)
    return {n: readers[n].read(ctx) for n in READERS}, notes


def test_a_window_sums_each_phase_a_step_and_its_self_time():
    w = spans.Window.of(_records(), 2)
    assert w.device_ms("train/prox") == pytest.approx(7.0)
    assert w.device_ms("wire/hops", "wire/stack") == pytest.approx(5.0)
    assert w.per_step("train/prox") == 2
    # the update less the exchange and the two prox phases
    assert w.self_ms("train/update") == pytest.approx(55 - 25 - 7)
    assert w.self_ms("wire/mix") == pytest.approx(10.0)
    assert w.self_ms("wire/stack") == pytest.approx(2.0)
    assert w.host_ms("train/step") == pytest.approx(3.0)
    assert w.bytes("wire/noise") == 2e9
    rows = {r["span"]: r for r in spans.table(w)}
    assert rows["wire/noise"]["hbm_pct"] == pytest.approx(
        100 * 2e9 / 3.35e12 / 2e-3)
    assert rows["train/model"]["hbm_pct"] is None
    assert list(rows)[:3] == ["train/step", "train/model", "train/update"]


def test_the_five_readers_and_the_span_table(monkeypatch):
    got, notes = _read(monkeypatch, _records(), 2)
    assert got == pytest.approx({"prox_ms": 7.0, "noise_ms": 2.0,
                                 "hop_copy_ms": 5.0, "consensus_ms": 4.0,
                                 "host_step_ms": 3.0})
    text = "\n".join(notes)
    assert "train/prox | 2 | 7.0000 | 7.0000" in text
    assert ("cross-check train/model / model_ms: 1.0000 (less the idle "
            "under the phases: 1.0000)") in text
    # the 10 us of idle a step under wire/hops: 5e-3 ms of 25 ms
    assert ("cross-check wire/exchange / wire_ms: 1.0000 (less the idle "
            "under the phases: 0.9998)") in text
    assert "(train/update - wire/exchange) / update_ms: 1.0345" in text
    assert "(model + update + consensus) / train/step: 0.9900" in text
    # 10 us and 50 us over 2 steps
    assert ("idle device ms a step by phase: outside the phases 0.0250; "
            "wire/hops 0.0050") in text


@pytest.mark.parametrize("case", ["fewer steps", "more steps", "no device"])
def test_the_readers_are_silent_when_the_steps_do_not_match(monkeypatch,
                                                            case):
    records, steps = {"fewer steps": (_records(2), 3),
                      "more steps": (_records(3), 2),
                      "no device": (_records(2, timed=False), 2)}[case]
    got, notes = _read(monkeypatch, records, steps)
    assert got == dict.fromkeys(READERS) and not notes


def test_a_program_without_phases_leaves_every_reader_silent(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.obs.trace", None)
    assert spans.program_records() == []
    cell = harness.open_cell("qwen3-1.7b.ring8", BENCH)
    readers = harness.metric_modules(cell, BENCH)
    ctx = _ctx(2, [])
    assert all(readers[n].read(ctx) is None for n in READERS)
