"""The port's sweep engine (``repro_torch.sweep``, ``api.SweepSpec``).

* The spec grammar against the reference: the same grids expand to the
  same points, in the same order, with the same names and JSON; the
  golden specs (the sweep's included) write the same JSON; ``parse_axis``,
  the flag layer, ``diff`` and ``group_points`` agree.
* Map mode, bit for bit against the port's own serial runs: every point's
  final state (and for netsim every round's record) equals
  ``api.build(point).run()``.
* Map mode held to the reference's ``SweepRunner`` (x64): each point with
  the reference's draws replayed, within C2's bar.
* Vmap mode (the stacked grid) within rtol = atol = 1e-12 of the serial
  runs in f64 (the whole of its scope: ``test_torch_sweep_vmap.py``).

The tiny sizes of ``tests/test_sweep.py::tiny_spec`` (4 nodes, ``logreg2d``
8 x 3), f64.
"""
import argparse
import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import sweep as jsweep
from repro_torch import api as tapi
from repro_torch import registry as tregistry
from repro_torch import sweep as tsweep
from repro_torch.core.draws import (GeneratorDraws, RecordingDraws,
                                    ReplayDraws, StackedDraws)
from repro_torch.paper import common as tcm
from tests import test_torch_dense as tdense
from tests import test_torch_netsim as tnetsim

GOLDEN = sorted((pathlib.Path(__file__).parent / "golden_specs")
                .glob("*.json"))
F64 = torch.float64
TINY = {"n_features": 8, "n_classes": 3, "n_per_node": 8, "n_batches": 2}
STEP_RTOL, STEP_ATOL = 1e-10, 1e-12          # C2's bar (reference parity)
VMAP_RTOL, VMAP_ATOL = 1e-12, 1e-12          # the reference's vmap bar


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small operations: one intra-op thread (see test_torch_baselines)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_dict(**over):
    """``tests/test_sweep.py::tiny_spec`` as JSON, for either package."""
    d = {"name": "tiny", "n_nodes": 4, "steps": 4, "seed": 0,
         "algorithm": {"name": "prox_lead", "eta": 0.05, "gamma": 0.5},
         "compressor": {"name": "qinf", "params": {"bits": 2, "block": 3}},
         "topology": {"graph": "ring"},
         "prox": {"name": "l1", "params": {"lam": 1e-3}},
         "oracle": {"name": "full", "problem": "logreg2d",
                    "problem_params": dict(TINY)},
         "execution": {"engine": "dense"}}
    d.update(over)
    return d


def tiny(**over):
    return tapi.ExperimentSpec.from_dict(tiny_dict(**over))


def sweep_dict(base: dict, axes, name="grid"):
    return {"name": name, "base": base,
            "axes": [{"path": p, "values": list(v)} for p, v in axes]}


def both(d):
    """The same SweepSpec JSON in both packages."""
    return japi.SweepSpec.from_dict(d), tapi.SweepSpec.from_dict(d)


def _serial(p, **kw):
    return tapi.build(p, device="cpu", dtype=F64).run(**kw)


def _leaves(state):
    out = []

    def walk(t):
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f))
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif torch.is_tensor(t):
            out.append(t)
    walk(state)
    return out


def assert_bit_equal(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for x, y in zip(la, lb):
        assert torch.equal(x, y), what
    assert a.k == b.k, what


GRID16 = [("seed", (0, 1, 2, 3)), ("compressor.bits", (2, 4)),
          ("algorithm.eta", (0.05, 0.03))]


# --- the spec grammar, against the reference ----------------------------------

def test_points_expand_like_the_reference():
    """Cartesian product, later axes fastest; the same names and the same
    JSON point by point."""
    js, ts = both(sweep_dict(tiny_dict(), GRID16))
    jp, tp = js.points(), ts.points()
    assert ts.n_points == js.n_points == len(tp) == 16
    assert [p.name for p in tp] == [p.name for p in jp]
    assert tp[0].name == "tiny@seed=0,compressor.bits=2,algorithm.eta=0.05"
    for a, b in zip(tp, jp):
        assert json.loads(a.to_json()) == json.loads(b.to_json())
    assert json.loads(ts.to_json()) == json.loads(js.to_json())
    assert ts == tapi.SweepSpec.from_json(ts.to_json())


def test_sweep_spec_save_load(tmp_path):
    _, ts = both(sweep_dict(tiny_dict(), GRID16))
    assert tapi.SweepSpec.load(ts.save(tmp_path / "s.json")) == ts
    p = tiny()
    assert tapi.ExperimentSpec.load(p.save(tmp_path / "p.json")) == p


@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_golden_json_identical_to_the_reference(path):
    """Every golden spec, the sweep's included, reads to the reference's
    JSON in the port."""
    d = json.loads(path.read_text())
    cls = (tapi.SweepSpec, japi.SweepSpec) if "base" in d else (
        tapi.ExperimentSpec, japi.ExperimentSpec)
    t, j = cls[0].from_json(path.read_text()), cls[1].from_json(
        path.read_text())
    assert t.to_json() == j.to_json()
    assert json.loads(t.to_json()) == d


@pytest.mark.parametrize("arg", [
    "seed=0:16", "seed=2:9:3", "compressor.bits=2,4,8",
    "algorithm.eta=0.05,0.1", "algorithm.eta.t0=8,16.5",
    "algorithm.params.theta=0.2,0.1", "fault_seed=3,4"])
def test_parse_axis_like_the_reference(arg):
    t, j = tapi.parse_axis(arg), japi.parse_axis(arg)
    assert t.path == j.path and t.values == j.values
    assert [type(v) for v in t.values] == [type(v) for v in j.values]


def test_parse_axis_and_unknown_axes_raise():
    with pytest.raises(ValueError, match="path=values"):
        tapi.parse_axis("seed")
    with pytest.raises(ValueError, match="lo:hi"):
        tapi.parse_axis("seed=1:2:3:4")
    with pytest.raises(ValueError, match="unknown sweep axis"):
        tapi.set_axis_value(tiny(), "topology.graph", "ring")
    with pytest.raises(ValueError, match="at least one value"):
        tapi.AxisSpec("seed", ())


@pytest.mark.parametrize("path,value", [
    ("seed", 3), ("fault_seed", 5), ("algorithm.eta", 0.07),
    ("algorithm.alpha.value", 0.25), ("algorithm.gamma.t0", 4.0),
    ("algorithm.params.theta", 0.1), ("compressor.bits", 4)])
def test_diff_paths_like_the_reference(path, value):
    """``diff`` names the reference's dotted paths: the bits axis as
    ``compressor.params.bits``, ``algorithm.eta`` as
    ``algorithm.eta.value``."""
    t0, j0 = tiny(), japi.ExperimentSpec.from_dict(tiny_dict())
    t1 = tapi.set_axis_value(t0, path, value)
    j1 = japi.set_axis_value(j0, path, value)
    assert json.loads(t1.to_json()) == json.loads(j1.to_json())
    assert t0.diff(t1) == j0.diff(j1) and t0.diff(t1)
    assert t0.diff(t0) == {}


def _namespace(**kw):
    d = dict(schedule="markov_drop:0.2", topology="ring", rounds=16,
             fault="linkdrop:0.1,straggler:0.05", algo="prox-lead",
             compressor="qinf:4", oracle="saga", steps=50, nodes=8,
             features=20, classes=5, l1=0.01, lam2=0.05, seed=3,
             eta=0.1, alpha=0.5, gamma=0.5)
    d.update(kw)
    return argparse.Namespace(**d)


@pytest.mark.parametrize("engine", ["netsim", "dense", "sharded"])
def test_from_flags_like_the_reference(engine):
    args = _namespace(arch="qwen3-1.7b" if engine == "sharded" else None,
                      layers=1, d_model=64)
    if engine != "netsim":
        args.schedule, args.fault = "static", ""
    t = tapi.ExperimentSpec.from_flags(args, engine=engine, name="flags")
    j = japi.ExperimentSpec.from_flags(args, engine=engine, name="flags")
    assert t.to_json() == j.to_json()


@pytest.mark.parametrize("kind,text", [
    ("compressor", "qinf:2"), ("compressor", "randk:0.2"),
    ("compressor", "identity"), ("schedule", "markov_drop:0.3"),
    ("schedule", "random-matching"), ("fault", "noise:0.01")])
def test_parse_component_like_the_reference(kind, text):
    assert tapi.parse_component(kind, text) == japi.parse_component(kind,
                                                                     text)
    faults = "linkdrop:0.1,straggler:0.05,noise:0.01"
    assert [f.to_dict() if hasattr(f, "to_dict") else
            dataclasses.asdict(f) for f in tapi.parse_faults(faults)] == \
        [dataclasses.asdict(f) for f in japi.parse_faults(faults)]


def _group_cases(mod, spec_cls):
    mk = lambda **o: spec_cls.from_dict(tiny_dict(**o))       # noqa: E731
    lessbit = {"name": "lessbit", "eta": 0.05, "alpha": 0.5}
    return [
        [mk(seed=0), mk(seed=1),
         mk(compressor={"name": "qinf", "params": {"bits": 4, "block": 3}}),
         mk(topology={"graph": "exponential"}),
         mk(compressor={"name": "identity"})],
        [mk(algorithm=dict(lessbit, params={"theta": 0.2}),
            prox={"name": "none"}),
         mk(algorithm=lessbit, prox={"name": "none"})]]


def test_group_points_like_the_reference():
    """The reference's partitions (tests/test_sweep.py) on the same
    lists: [[0, 1, 2], [3], [4]] and [[0], [1]]."""
    got = [tsweep.group_points(c)
           for c in _group_cases(tsweep, tapi.ExperimentSpec)]
    want = [jsweep.group_points(c)
            for c in _group_cases(jsweep, japi.ExperimentSpec)]
    assert got == want == [[[0, 1, 2], [3], [4]], [[0], [1]]]


# --- map mode: bit for bit the serial runs -------------------------------------

@pytest.mark.parametrize("oracle", ["full", "sgd", "saga"])
def test_map_16_point_grid_bit_for_bit(oracle):
    """seed x bits x eta, 16 points: every point's final state (X, D, H,
    Hw, the oracle's state, k) equals its serial run's bit for bit."""
    base = tiny_dict(oracle={"name": oracle, "problem": "logreg2d",
                             "problem_params": dict(TINY)})
    ss = tapi.SweepSpec.from_dict(sweep_dict(base, GRID16))
    runner = tapi.build(ss, device="cpu", dtype=F64)
    assert isinstance(runner, tsweep.SweepRunner) and runner.n_points == 16
    final, res = runner.run()
    for i, p in enumerate(runner.points):
        serial, _ = _serial(p)
        assert_bit_equal(runner.point_state(final, i), serial, p.name)
    rep = runner.last_report
    assert rep.engine == "sweep" and rep.extra["points"] == 16
    assert len(res.point_s) == 16 and res.wall_s > 0


def test_map_metric_records_stay_per_point():
    """``metric_fn`` per point every ``metric_every``-th step and the last,
    equal to the serial run's values at those steps."""
    ss = tapi.SweepSpec.from_dict(sweep_dict(tiny_dict(steps=7),
                                             [("seed", (0, 1))]))
    runner = tapi.build(ss, device="cpu", dtype=F64)
    _, res = runner.run(metric_fn=lambda st: (st.X ** 2).sum(),
                        metric_every=3)
    assert res.metrics["metric"].shape == (2, 3)          # t = 0, 3, 6
    for i, p in enumerate(runner.points):
        _, logs = _serial(p, callback=lambda st, t: float((st.X ** 2).sum()),
                          log_every=3)
        assert list(res.metrics["metric"][i]) == logs


def test_map_lessbit_theta_x_seed_on_lsvrg_bit_for_bit():
    """A baseline (LessBit on the L-SVRG oracle) sweeps its own field
    theta x seed."""
    base = tiny_dict(
        algorithm={"name": "lessbit", "eta": 0.05, "alpha": 0.5,
                   "params": {"theta": 0.2}},
        compressor={"name": "qinf", "params": {"bits": 4, "block": 3}},
        prox={"name": "none"}, steps=3,
        oracle={"name": "lsvrg", "problem": "logreg2d",
                "problem_params": dict(TINY)})
    ss = tapi.SweepSpec.from_dict(sweep_dict(
        base, [("algorithm.params.theta", (0.2, 0.1)), ("seed", (0, 5))]))
    runner = tapi.build(ss, device="cpu", dtype=F64)
    final, _ = runner.run()
    for i, p in enumerate(runner.points):
        serial, _ = _serial(p)
        assert_bit_equal(runner.point_state(final, i), serial, p.name)


def _harmonic_base():
    return tiny_dict(
        algorithm={"name": "lead",
                   "eta": {"kind": "harmonic", "value": 0.1, "t0": 8.0},
                   "alpha": 0.5, "gamma": 0.5},
        prox={"name": "none"}, steps=3)


HARMONIC_AXES = [("algorithm.eta.value", (0.1, 0.07)),
                 ("algorithm.eta.t0", (8.0, 16.0))]


def test_map_harmonic_axes_bit_for_bit():
    ss = tapi.SweepSpec.from_dict(sweep_dict(_harmonic_base(),
                                             HARMONIC_AXES))
    runner = tapi.build(ss, device="cpu", dtype=F64)
    final, _ = runner.run()
    for i, p in enumerate(runner.points):
        serial, _ = _serial(p)
        assert_bit_equal(runner.point_state(final, i), serial, p.name)


def _netsim_base():
    return tiny_dict(
        name="ntiny", steps=5, seed=2, fault_seed=3,
        topology={"graph": "ring", "schedule": "alternating"},
        faults=[{"name": "linkdrop", "params": {"rate": 0.2}}],
        execution={"engine": "netsim"})


NETSIM_AXES = [("seed", (2, 3)), ("fault_seed", (3, 4)),
               ("compressor.bits", (2, 4))]


def test_map_netsim_grid_bit_for_bit_with_trajectories():
    ss = tapi.SweepSpec.from_dict(sweep_dict(_netsim_base(), NETSIM_AXES))
    runner = tapi.build(ss, device="cpu", dtype=F64)
    assert runner.n_points == 8
    final, res = runner.run()
    for i, p in enumerate(runner.points):
        serial, traj = _serial(p)
        assert_bit_equal(runner.point_state(final, i), serial, p.name)
        np.testing.assert_array_equal(res.metrics["bits"][i], traj.bits)
        np.testing.assert_array_equal(res.metrics["consensus"][i],
                                      traj.consensus)
        t = res.trajectory(i)
        assert t.total_bits == traj.total_bits and t.bits.dtype == np.int64
    assert res.meta["schedule"].startswith("alternating")
    assert runner.last_report.wire["bits_total"] == float(
        res.metrics["bits"].sum())
    with pytest.raises(ValueError, match="netsim"):
        tsweep.SweepResult(["a"], {}, 1.0).trajectory(0)


def test_step_runs_through_each_points_sim_mixer():
    """The runner protocol: ``init_state`` starts every point's fault
    stream and ``step`` goes through its SimMixer, as a NetsimRunner's
    ``init_state`` and ``step`` do."""
    ss = tapi.SweepSpec.from_dict(sweep_dict(_netsim_base(),
                                             [("seed", (2, 3))]))
    runner = tapi.build(ss, device="cpu", dtype=F64)
    with pytest.raises(RuntimeError, match="init_state"):
        runner.step(None, runner.point_draws())
    states = runner.init_state()
    assert _leaves(states)[0].shape[0] == 2
    stepped = runner.step(states, StackedDraws(
        [GeneratorDraws(7, "cpu"), GeneratorDraws(7, "cpu")]))
    for i, p in enumerate(runner.points):
        serial = tapi.build(p, device="cpu", dtype=F64)
        serial.init_state(GeneratorDraws(p.seed, "cpu"))
        want = serial.step(runner.point_state(states, i),
                           GeneratorDraws(7, "cpu"))
        assert_bit_equal(runner.point_state(stepped, i), want, p.name)
    cons = runner.metrics_fns["consensus"](stepped)
    assert cons.shape == (2,) and bool(torch.isfinite(cons).all())
    assert runner.metrics_fns["iteration"](stepped) == 2


def test_run_cells_curves_equal_the_rows_run_alone():
    """The paper harness batches its rows through the sweep engine (map
    mode): every curve is bit for bit the row run on its own."""
    spec = tcm.paper_cell("lead", eta=0.05, steps=9,
                          compressor=tapi.CompressorSpec(
                              "qinf", {"bits": 2, "block": 3}))
    spec = dataclasses.replace(spec, n_nodes=4, oracle=tapi.OracleSpec(
        "sgd", "logreg2d", problem_params=dict(TINY)))
    cells = [("a", spec), ("b", dataclasses.replace(
        spec, algorithm=dataclasses.replace(spec.algorithm,
                                            eta=tapi.constant(0.03))))]
    xstar = np.full((8, 3), 0.01)
    rows = tcm.run_cells(cells, xstar, 9, log_every=4, device="cpu")
    for (label, sp), r in zip(cells, rows):
        alone, _ = tcm.run_cell(label, sp, xstar, 9, log_every=4,
                                device="cpu")
        assert r.subopt == alone and r.wall_s > 0


# --- the guards ------------------------------------------------------------------

def test_sharded_engine_refused():
    base = json.loads(tapi.ExperimentSpec.load(
        pathlib.Path(__file__).parent / "golden_specs"
        / "trainer_dense_qinf2.json").to_json())
    ss = tapi.SweepSpec.from_dict(sweep_dict(base, [("seed", (0, 1))]))
    with pytest.raises(ValueError, match="sharded.*not supported"):
        tapi.build(ss, device="cpu")


def test_bits_axis_needs_qinf():
    ss = tapi.SweepSpec.from_dict(sweep_dict(
        tiny_dict(compressor={"name": "identity"}),
        [("compressor.bits", (2, 4))]))
    with pytest.raises(ValueError, match="qinf"):
        tapi.build(ss, device="cpu")


def test_structurally_different_points_refused():
    with pytest.raises(ValueError, match="unsupported sweep axis"):
        tsweep.runner_for_points(
            [tiny(), tiny(topology={"graph": "exponential"})], device="cpu")


def test_sweep_engine_wants_a_sweep_spec():
    with pytest.raises(ValueError, match="SweepSpec"):
        tregistry.make("engine", "sweep", spec=tiny(), device="cpu",
                       dtype=None)
    with pytest.raises(ValueError, match="SweepSpec"):
        tiny(execution={"engine": "sweep"})
    with pytest.raises(ValueError, match="SweepSpec"):
        tapi.ExperimentSpec.from_dict(sweep_dict(tiny_dict(),
                                                 [("seed", (0, 1))]))


def test_fault_seed_axis_on_dense_refused():
    ss = tapi.SweepSpec.from_dict(sweep_dict(tiny_dict(),
                                             [("fault_seed", (0, 1))]))
    with pytest.raises(ValueError, match="netsim engine only"):
        tapi.build(ss, device="cpu")


def test_seed_axis_with_seed_dependent_schedule_refused():
    base = tiny_dict(topology={"graph": "ring",
                               "schedule": "random_matching", "rounds": 4},
                     execution={"engine": "netsim"})
    ss = tapi.SweepSpec.from_dict(sweep_dict(base, [("seed", (0, 1))]))
    with pytest.raises(ValueError, match="schedule stack"):
        tapi.build(ss, device="cpu")


def test_schedule_kind_may_not_vary_and_params_must_be_numbers():
    a = tiny()
    b = dataclasses.replace(a, algorithm=dataclasses.replace(
        a.algorithm, eta=tapi.ScheduleSpec("harmonic", 0.05, 2.0)))
    with pytest.raises(ValueError, match="kind"):
        tsweep.plan_points([a, b])
    lb = {"name": "lessbit", "eta": 0.05, "alpha": 0.5}
    c = tiny(algorithm=dict(lb, params={"theta": "x"}))
    d = tiny(algorithm=dict(lb, params={"theta": 0.2}))
    with pytest.raises(ValueError, match="numeric"):
        tsweep.plan_points([c, d])
    with pytest.raises(ValueError, match="batch"):
        tsweep.SweepRunner([a], batch="pmap", device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        tsweep.SweepRunner([], device="cpu")


def test_build_sweep_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ss = tapi.SweepSpec.from_dict(sweep_dict(tiny_dict(),
                                             [("seed", (0, 1))]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.build(ss)


# --- map mode held to the reference's SweepRunner ---------------------------

def _flat(per_step):
    return [a for step in per_step for a in step]


def test_map_mode_matches_reference_sweep_runner_dense():
    """The tiny seed x bits x eta grid through the reference's one-jit
    SweepRunner (x64) and the port's map mode, each point fed the
    reference's draws: X, D, H and Hw within C2's bar."""
    d = sweep_dict(tiny_dict(oracle={"name": "sgd", "problem": "logreg2d",
                                     "problem_params": dict(TINY)}),
                   [("seed", (0, 1)), ("compressor.bits", (2, 8)),
                    ("algorithm.eta", (0.05, 0.03))])
    js, ts = both(d)
    jrun = jsweep.SweepRunner(js.points())
    jfinal, _ = jrun.run()
    streams = []
    for p in js.points():
        _, _, draws = tdense.reference_run(p, p.steps)
        streams.append(ReplayDraws(_flat(draws), "cpu"))
    trun = tsweep.SweepRunner(ts.points(), device="cpu", dtype=F64)
    tfinal, _ = trun.run(draws=StackedDraws(streams))
    assert all(not s.pending for s in streams)
    for i, p in enumerate(ts.points()):
        tdense.assert_states_close(trun.point_state(tfinal, i),
                                   jrun.point_state(jfinal, i),
                                   STEP_RTOL, STEP_ATOL)


def test_map_mode_matches_reference_sweep_runner_netsim():
    """The netsim grid seed x fault_seed x bits, each point fed the
    reference's algorithm and fault draws: states within C2's bar, bits
    equal as integers, consensus to rtol 1e-10."""
    js, ts = both(sweep_dict(_netsim_base(), NETSIM_AXES))
    jrun = jsweep.SweepRunner(js.points())
    jfinal, jres = jrun.run()
    algo, faults = [], []
    for p in js.points():
        jr, _, adraws = tnetsim._ref_netsim_run(p, p.steps)
        algo.append(ReplayDraws(_flat(adraws), "cpu"))
        faults.append(ReplayDraws(tnetsim._ref_fault_stream(
            jr, p, [None] + list(range(1, p.steps + 1))), "cpu"))
    trun = tsweep.SweepRunner(ts.points(), device="cpu", dtype=F64)
    tfinal, tres = trun.run(draws=StackedDraws(algo),
                            fault_draws=StackedDraws(faults))
    assert all(not s.pending for s in algo + faults)
    for i in range(trun.n_points):
        tdense.assert_states_close(trun.point_state(tfinal, i),
                                   jrun.point_state(jfinal, i),
                                   STEP_RTOL, STEP_ATOL)
    np.testing.assert_array_equal(tres.metrics["bits"],
                                  jres.metrics["bits"].astype(np.int64))
    np.testing.assert_allclose(tres.metrics["consensus"],
                               jres.metrics["consensus"], rtol=1e-10,
                               atol=1e-14)


# --- vmap mode: the stacked grid --------------------------------------------

def _assert_close_points(runner, final, serial_of, rtol=VMAP_RTOL,
                         atol=VMAP_ATOL):
    for i, p in enumerate(runner.points):
        serial, _ = serial_of(p)
        got = runner.point_state(final, i)
        for a, b in zip(_leaves(got), _leaves(serial)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                       atol=atol, err_msg=p.name)
        assert got.k == serial.k


@pytest.mark.parametrize("algo", ["prox_lead", "lead", "nids"])
@pytest.mark.parametrize("oracle", ["full", "sgd", "saga"])
def test_vmap_grid_close_to_serial_runs(algo, oracle):
    """seed x bits x eta (NIDS: seed x eta; it compresses nothing), every
    point within rtol = atol = 1e-12 of its serial run in f64."""
    alg = {"name": algo, "eta": 0.05, "gamma": 0.5}
    axes = GRID16 if algo != "nids" else [GRID16[0], GRID16[2]]
    base = tiny_dict(algorithm=alg, steps=5,
                     oracle={"name": oracle, "problem": "logreg2d",
                             "problem_params": dict(TINY)})
    ss = tapi.SweepSpec.from_dict(sweep_dict(base, axes))
    runner = tsweep.SweepRunner(ss.points(), batch="vmap", device="cpu",
                                dtype=F64)
    final, res = runner.run(metric_fn=lambda st: (st.X ** 2).sum())
    assert _leaves(final)[0].shape[0] == runner.n_points
    assert res.metrics["metric"].shape == (runner.n_points, 5)
    _assert_close_points(runner, final, _serial)


@pytest.mark.parametrize("prox", [
    {"name": "none"}, {"name": "l1", "params": {"lam": 0.02}},
    {"name": "l2sq", "params": {"lam": 0.1}},
    {"name": "elastic_net", "params": {"lam1": 0.01, "lam2": 0.1}},
    {"name": "group_lasso", "params": {"lam": 0.02}},
    {"name": "nonneg"}], ids=lambda p: p["name"])
def test_vmap_every_prox_over_the_point_axis(prox):
    """Each registered prox reduces over the iterate's own axes with the
    point axis leading: eta x seed grids stay within the bar."""
    base = tiny_dict(prox=prox, steps=4,
                     oracle={"name": "saga", "problem": "logreg2d",
                             "problem_params": dict(TINY)})
    ss = tapi.SweepSpec.from_dict(sweep_dict(
        base, [("algorithm.eta", (0.05, 0.1)), ("seed", (0, 1))]))
    runner = tsweep.SweepRunner(ss.points(), batch="vmap", device="cpu",
                                dtype=F64)
    final, _ = runner.run()
    _assert_close_points(runner, final, _serial)


def test_vmap_harmonic_and_alpha_gamma_axes():
    base = _harmonic_base()
    ss = tapi.SweepSpec.from_dict(sweep_dict(base, HARMONIC_AXES + [
        ("algorithm.alpha", (0.5, 0.3)), ("algorithm.gamma", (0.5, 0.9))]))
    runner = tsweep.SweepRunner(ss.points(), batch="vmap", device="cpu",
                                dtype=F64)
    final, _ = runner.run()
    _assert_close_points(runner, final, _serial)


def test_vmap_step_from_recorded_draws_matches_map_step():
    """One stacked step against the map step from the same stacked state,
    each point's draws recorded in the one and replayed in the other."""
    ss = tapi.SweepSpec.from_dict(sweep_dict(
        tiny_dict(oracle={"name": "saga", "problem": "logreg2d",
                          "problem_params": dict(TINY)}), GRID16))
    vm = tsweep.SweepRunner(ss.points(), batch="vmap", device="cpu",
                            dtype=F64)
    mp = vm.with_batch("map")
    st = vm.init_state()
    mp.init_state()
    for _ in range(3):
        rec = [RecordingDraws(GeneratorDraws(i + 10, "cpu"))
               for i in range(vm.n_points)]
        got = vm.step(st, StackedDraws(rec))
        want = mp.step(st, StackedDraws([ReplayDraws(r.record, "cpu")
                                         for r in rec]))
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(),
                                       rtol=VMAP_RTOL, atol=VMAP_ATOL)
        st = got


def test_vmap_in_f32_warns_and_stays_close():
    ss = tapi.SweepSpec.from_dict(sweep_dict(tiny_dict(), GRID16[:2]))
    with pytest.warns(UserWarning, match="tolerance"):
        runner = tsweep.SweepRunner(ss.points(), batch="vmap", device="cpu",
                                    dtype=torch.float32)
    final, _ = runner.run()
    for i, p in enumerate(runner.points):
        serial, _ = tapi.build(p, device="cpu").run()
        np.testing.assert_allclose(runner.point_state(final, i).X.numpy(),
                                   serial.X.numpy(), rtol=1e-5, atol=1e-6)


ONCE_REFUSED = {
    "netsim": (_netsim_base(), [("seed", (2, 3))]),
    "lessbit": (tiny_dict(algorithm={"name": "lessbit", "eta": 0.05,
                                     "alpha": 0.5},
                          prox={"name": "none"}), [("seed", (0, 1))]),
    "dgd": (tiny_dict(algorithm={"name": "dgd", "eta": 0.05},
                      compressor={"name": "identity"}),
            [("seed", (0, 1))]),
    "lsvrg": (tiny_dict(oracle={"name": "lsvrg", "problem": "logreg2d",
                                "problem_params": dict(TINY)}),
              [("seed", (0, 1))]),
    "randk": (tiny_dict(compressor={"name": "randk",
                                    "params": {"frac": 0.5}}),
              [("seed", (0, 1))]),
    "topk": (tiny_dict(compressor={"name": "topk", "params": {"frac": 0.5}},
                       algorithm={"name": "prox_lead", "eta": 0.05,
                                  "params": {"allow_biased": True}}),
             [("seed", (0, 1))]),
    "params-axis": (tiny_dict(algorithm={"name": "lessbit", "eta": 0.05,
                                         "params": {"theta": 0.2}},
                              prox={"name": "none"}),
                    [("algorithm.params.theta", (0.2, 0.1))]),
}


@pytest.mark.parametrize("case", sorted(ONCE_REFUSED))
def test_vmap_stacks_the_configs_it_once_refused(case):
    """The netsim engine, the baselines, L-SVRG, RandK/TopK and an
    ``algorithm.params`` axis stack: every point within rtol = atol =
    1e-12 of its serial run (netsim: its bits equal as int64)."""
    base, axes = ONCE_REFUSED[case]
    ss = tapi.SweepSpec.from_dict(sweep_dict(base, axes))
    runner = tsweep.SweepRunner(ss.points(), batch="vmap", device="cpu",
                                dtype=F64)
    final, res = runner.run(num_steps=3)
    assert _leaves(final)[0].shape[0] == runner.n_points
    for i, p in enumerate(runner.points):
        serial, traj = _serial(p, num_steps=3)
        for a, b in zip(_leaves(runner.point_state(final, i)),
                        _leaves(serial)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=VMAP_RTOL,
                                       atol=VMAP_ATOL, err_msg=p.name)
        if case == "netsim":
            np.testing.assert_array_equal(res.metrics["bits"][i], traj.bits)


def test_stacked_draws_give_each_point_its_serial_stream():
    sd = StackedDraws([GeneratorDraws(s, "cpu") for s in (3, 4)])
    u = sd.uniform((2, 5, 6))
    r = sd.randint(5, 7)
    for i, s in enumerate((3, 4)):
        g = GeneratorDraws(s, "cpu")
        assert torch.equal(u[i], g.uniform((5, 6)))
        assert torch.equal(r[i], g.randint(5, 7))
    with pytest.raises(ValueError, match="leading axis"):
        sd.uniform((3, 5))
    coin, mask, pick = sd.bernoulli(0.5), sd.bernoulli(0.3, (6,)), \
        sd.choice(9, 4)
    assert coin.shape == (2,) and mask.shape == (2, 6)
    assert pick.shape == (2, 4)
    for i, s in enumerate((3, 4)):
        g = GeneratorDraws(s, "cpu")
        g.uniform((5, 6))
        g.randint(5, 7)
        assert torch.equal(coin[i], g.bernoulli(0.5))
        assert torch.equal(mask[i], g.bernoulli(0.3, (6,)))
        assert torch.equal(pick[i], g.choice(9, 4))
    with pytest.raises(ValueError, match="at least one"):
        StackedDraws([])


def test_golden_sweep_builds_in_both_modes_on_cpu():
    ss = tapi.SweepSpec.load(pathlib.Path(__file__).parent / "golden_specs"
                             / "sweep_lead_seed_x_bits.json")
    runner = tapi.build(ss, device="cpu")
    assert runner.n_points == 12 and runner.batch == "map"
    vm = runner.with_batch("vmap")
    assert vm.batch == "vmap" and vm.X0 is runner.X0
    assert jax.config.x64_enabled        # the reference side runs in f64
