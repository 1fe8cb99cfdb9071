"""The phases of a trainer step (``repro_torch.obs.trace.phase``) on a
tiny bucketed ring trainer on the CPU: off without a profiler (no
``record_function`` range, no record), every phase with its parent under
one, the step bit-equal either way, and the contract audit clean with
them on."""
import dataclasses
import pathlib

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch import api as tapi
from repro_torch import tree
from repro_torch.check import contracts as C
from repro_torch.core.draws import GeneratorDraws
from repro_torch.obs import trace

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden_specs"
#: phase -> its parent
PARENTS = {"train/step": None, "train/model": "train/step",
           "train/update": "train/step", "train/prox": "train/update",
           "wire/exchange": "train/update", "wire/noise": "wire/exchange",
           "wire/pack": "wire/exchange", "wire/hops": "wire/exchange",
           "wire/mix": "wire/exchange", "wire/stack": "wire/mix",
           "train/consensus": "train/step"}


@pytest.fixture(scope="module")
def runner():
    """The golden 8x1 bucketed trainer on a ring, with the l1 prox."""
    spec = tapi.ExperimentSpec.load(
        GOLDEN / "trainer_neighbor_bucketed_8x1.json")
    spec = dataclasses.replace(
        spec, prox=tapi.ProxSpec("l1", {"lam": 1e-3}),
        topology=dataclasses.replace(spec.topology, graph="ring"))
    return tapi.build_trainer_runner(spec, device="cpu")


def _step(runner, profiled=False):
    """A fresh state's first step -> (state, metrics), under a CPU
    profiler where ``profiled`` (the profile is returned third)."""
    state = runner.init_state()
    batch = runner.default_data().batch_at(0)
    draws = GeneratorDraws(0, runner.device)
    trace.clear()
    if not profiled:
        return runner.step(state, batch, draws) + (None,)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = runner.step(state, batch, draws)
    return out + (prof,)


def test_the_profiler_flag_is_set_only_inside_a_profile():
    """The phases test this module flag: a torch that renames it or sets
    it otherwise must fail here, not leave the phases silently off."""
    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


def test_without_a_profiler_a_step_opens_no_range_and_records_nothing(
        runner, monkeypatch):
    entered = []
    enter = autograd_profiler.record_function.__enter__
    monkeypatch.setattr(autograd_profiler.record_function, "__enter__",
                        lambda self: entered.append(self.name)
                        or enter(self))
    _step(runner)
    assert entered == [] and trace.recorded() == []


def test_a_profiled_step_records_every_phase_with_its_parent(runner):
    state, _, prof = _step(runner, profiled=True)
    recs = trace.recorded()
    assert {r.name for r in recs} == set(PARENTS)
    assert all(r.parent == PARENTS[r.name] for r in recs)
    assert len({r.step for r in recs}) == 1
    X = tree.leaves(state.plead.X)
    prox = [r for r in recs if r.name == "train/prox"]
    assert len(prox) == len(X)
    # one B6 launch a leaf: z, d, h, q and the Hw and W Q slots read, d,
    # h, the Hw slots and x written
    T = runner.trainer.hw_slots or 1
    assert [r.bytes for r in prox] == [(7 + 3 * T) * x.nbytes for x in X]
    layout = runner.trainer.wire_layout()
    assert sum(r.name == "wire/stack" for r in recs) == len(layout.groups)
    # nested on the host's clock, no device time on the CPU
    step = recs[0]
    assert step.name == "train/step"
    assert all(step.host_t0_ns <= r.host_t0_ns <= r.host_t1_ns
               <= step.host_t1_ns and r.device_ms is None for r in recs)
    ranges = {e.name for e in prof.events()}
    assert set(PARENTS) <= ranges


def test_a_step_is_bit_equal_with_phases_on_and_off(runner):
    off, m_off, _ = _step(runner)
    on, m_on, _ = _step(runner, profiled=True)
    assert len(trace.recorded()) > len(PARENTS)
    for a, b in ((off.plead.X, on.plead.X), (off.plead.D, on.plead.D),
                 (off.plead.comm.H, on.plead.comm.H),
                 (off.plead.comm.Hw, on.plead.comm.Hw)):
        assert all(torch.equal(x, y)
                   for x, y in zip(tree.leaves(a), tree.leaves(b)))
    assert all(torch.equal(torch.as_tensor(m_off[k]), torch.as_tensor(m_on[k]))
               for k in ("loss", "consensus", "step"))


def test_the_contract_audit_finds_no_host_read_with_phases_on(runner):
    trace.clear()
    state = runner.init_state()
    leaves = list(tree.leaves(state.plead.X))
    with profile(activities=[ProfilerActivity.CPU]):
        facts, _ = C.trainer_step_facts(runner, state=state)
    assert sum(r.name == "train/step" for r in trace.recorded()) == 2
    findings = C.audit_trainer(runner, "8x1 ring", facts, leaves)
    assert all(ok for _, ok, _ in findings), findings


def test_the_ring_keeps_the_newest_records(monkeypatch):
    monkeypatch.setattr(trace, "RECORDER", trace.Recorder(size=3))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(2):
            with trace.phase("outer"):
                with trace.phase("inner", bytes=i):
                    pass
    recs = trace.recorded()
    assert [(r.name, r.parent, r.step, r.bytes) for r in recs] == [
        ("inner", "outer", 1, 0), ("outer", None, 2, None),
        ("inner", "outer", 2, 1)]
    trace.clear()
    assert trace.recorded() == []
