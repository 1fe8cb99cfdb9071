"""The stacked grid (``repro_torch.sweep``, ``batch='vmap'``) and the serial
dense and netsim runners over a tree-valued iterate.

The problem is logistic regression with an intercept on the paper's data
(``make_logreg_data``), ``X0 = {"W": (n, p, C), "b": (n, C)}``: a test-only
``logreg_bias`` registered in both packages' registries for this module
(the reference takes ``jax.grad`` of its loss; the port's, from
``chip_smoke.register_logreg_bias``, writes the gradient out).  Leaves of two ranks, so a per-point operand must take each
leaf's rank.

* The serial dense and netsim runs (``api.build(spec).run()``) against the
  reference's, its draws replayed: C2's bar, netsim bits equal as int64.
* The stacked tree grid against the reference's ``SweepRunner(points,
  batch='vmap')`` (x64) on grids that draw nothing: rtol = atol = 1e-12.
* The stacked tree grid against the port's serial runs in f64: the nine
  algorithms, the four oracles x bits, Choco and LessBit x QInf, RandK and
  TopK, the netsim engine under every fault, a harmonic ``eta.t0`` axis;
  every point within 1e-12, netsim records (bits as int64) its serial
  run's.
* One stacked step against the map step from the same stacked state, each
  point's draws recorded in the one and replayed in the other.
* ``core.comm.coef`` alone; f32 (a warning, 1e-5 of each serial run); a
  tree whose leaves mix dtypes is refused.

The tiny sizes of ``tests/test_torch_sweep.py`` (4 nodes, 8 x 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro import api as japi
from repro import registry as jregistry
from repro import sweep as jsweep
from repro.core.oracles import FiniteSumProblem as JProblem
from repro.data import synthetic as jsynthetic
from repro_torch import api as tapi
from repro_torch import registry as tregistry
from repro_torch import sweep as tsweep
from repro_torch import tree as ttree
from repro_torch.core.comm import coef
from repro_torch.core.draws import (GeneratorDraws, RecordingDraws,
                                    ReplayDraws, StackedDraws)
from tests import test_torch_baselines as tbase
from tests import test_torch_netsim as tnetsim
from tests.test_torch_sweep import (STEP_ATOL, STEP_RTOL, TINY, VMAP_ATOL,
                                    VMAP_RTOL, sweep_dict, tiny_dict)

F64 = torch.float64
PROBLEM = chip_smoke.TREE_PROBLEM
NO_PROX = {"name": "none"}
L1 = {"name": "l1", "params": {"lam": 1e-3}}


# --- the problem, in both packages --------------------------------------------

def reference_logreg_bias(n_nodes: int = 8, n_features: int = 784,
                          n_classes: int = 10, n_per_node: int = 150,
                          n_batches: int = 15, lam2: float = 0.005,
                          seed: int = 0, noniid: bool = True):
    """Multinomial logistic regression with an intercept: one node's
    ``{"W": (p, C), "b": (C,)}``, its gradient by ``jax.grad``.  The
    port's is ``chip_smoke.register_logreg_bias``'s, written out by hand
    (the card's phase 10 (i) runs it at full width)."""
    A, Y = jsynthetic.make_logreg_data(
        n_nodes=n_nodes, n_per_node=n_per_node, n_features=n_features,
        n_classes=n_classes, n_batches=n_batches, seed=seed, noniid=noniid)

    def loss_batch(X, batch):
        logp = jax.nn.log_softmax(batch["A"] @ X["W"] + X["b"], axis=-1)
        ce = -jnp.mean(jnp.sum(batch["Y"] * logp, axis=-1))
        return ce + lam2 * (jnp.sum(X["W"] ** 2) + jnp.sum(X["b"] ** 2))

    dtype = jnp.float64 if jax.config.x64_enabled else jnp.float32
    prob = JProblem(jax.grad(loss_batch),
                    {"A": jnp.asarray(A), "Y": jnp.asarray(Y)},
                    A.shape[0], A.shape[1], loss_batch)
    return prob, {"W": jnp.zeros((n_nodes, n_features, n_classes), dtype),
                  "b": jnp.zeros((n_nodes, n_classes), dtype)}


@pytest.fixture(autouse=True, scope="module")
def _logreg_bias_and_one_thread():
    """``logreg_bias`` in both registries for this module only (the
    port's as ``chip_smoke.py`` registers it for phase 10 (i)); small
    operations on one intra-op thread (see test_torch_baselines)."""
    jregistry.register_problem(PROBLEM)(reference_logreg_bias)
    chip_smoke.register_logreg_bias(torch)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jregistry._REGISTRIES["problem"].pop(PROBLEM)
    tregistry._REGISTRIES["problem"].pop(PROBLEM)


# --- specs and comparisons ----------------------------------------------------

def _oracle(name="full"):
    return {"name": name, "problem": PROBLEM, "problem_params": dict(TINY)}


def _algo(name, **over):
    """An algorithm spec dict with the fields its factory takes."""
    d = {"name": name, "eta": 0.05}
    d.update({"prox_lead": {"gamma": 0.5}, "lead": {"gamma": 0.5},
              "choco": {"params": {"gamma_c": 0.2}},
              "lessbit": {"alpha": 0.5, "params": {"theta": 0.2}}
              }.get(name, {}))
    d.update(over)
    return d


def _prox(algo):
    return NO_PROX if algo in ("lead", "choco", "lessbit") else L1


def _dense(algo="prox_lead", oracle="full", **over):
    return tiny_dict(**{"algorithm": _algo(algo), "prox": _prox(algo),
                        "oracle": _oracle(oracle), **over})


def _netsim(algo, faults, steps=5, oracle="full", **over):
    schedule = "alternating" if faults else "static"
    return tiny_dict(name="ntiny", steps=steps, seed=2, fault_seed=3,
                     algorithm=_algo(algo), prox=_prox(algo),
                     oracle=_oracle(oracle),
                     topology={"graph": "ring", "schedule": schedule},
                     faults=faults, execution={"engine": "netsim"}, **over)


def _runner(base, axes, batch="vmap", dtype=F64):
    ss = tapi.SweepSpec.from_dict(sweep_dict(base, axes))
    return tsweep.SweepRunner(ss.points(), batch=batch, device="cpu",
                              dtype=dtype)


def _objective(problem):
    return lambda X: problem.full_loss(X) + 1e-3 * sum(
        leaf.abs().sum() for leaf in ttree.leaves(X))


def state_pairs(port, ref, path="state"):
    """(path, port tensor, reference array) for every tensor of a port
    state, found at the same field, key or index of the reference's."""
    if port is None or isinstance(port, int):
        return []
    if isinstance(port, tuple) and hasattr(port, "_fields"):
        return [p for f in port._fields
                for p in state_pairs(getattr(port, f), getattr(ref, f),
                                     f"{path}.{f}")]
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), path
        return [p for k in sorted(port)
                for p in state_pairs(port[k], ref[k], f"{path}/{k}")]
    if isinstance(port, (list, tuple)):
        return [p for i, (a, b) in enumerate(zip(port, ref))
                for p in state_pairs(a, b, f"{path}[{i}]")]
    return [(path, port, np.asarray(ref))]


def assert_state_close(port, ref, rtol, atol, what=""):
    pairs = state_pairs(port, ref)
    assert any(p.endswith(".X/b") for p, _, _ in pairs), what
    for path, a, b in pairs:
        assert tuple(a.shape) == b.shape, (what, path)
        np.testing.assert_allclose(a.numpy(), b.astype(np.float64),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {path}")
    assert port.k == int(ref.k), what


def assert_close_to_serial(runner, final, res=None, rtol=VMAP_RTOL,
                           atol=VMAP_ATOL, **run_kw):
    """Every point of the stacked ``final`` (and a netsim ``res``'s
    records) against ``api.build(point).run()``, leaf by leaf of the
    tree."""
    dtype = ttree.leaves(runner.X0)[0].dtype
    for i, p in enumerate(runner.points):
        serial, traj = tapi.build(p, device="cpu", dtype=dtype).run(
            **run_kw)
        got = runner.point_state(final, i)
        want = {path: np.asarray(t)
                for path, t, _ in state_pairs(serial, serial)}
        pairs = state_pairs(got, got)
        assert [q for q, _, _ in pairs] == list(want), p.name
        for path, a, _ in pairs:
            np.testing.assert_allclose(a.numpy(), want[path], rtol=rtol,
                                       atol=atol, err_msg=f"{p.name} {path}")
        assert got.k == serial.k, p.name
        if res is not None and "bits" in res.metrics:
            assert res.metrics["bits"].dtype == np.int64
            np.testing.assert_array_equal(res.metrics["bits"][i], traj.bits)
            np.testing.assert_allclose(res.metrics["consensus"][i],
                                       traj.consensus, rtol=rtol,
                                       atol=1e-14, err_msg=p.name)
            np.testing.assert_allclose(res.metrics["objective"][i],
                                       traj.objective, rtol=rtol,
                                       atol=atol, err_msg=p.name)


# --- core.comm.coef -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_coef_takes_a_point_operand_at_each_leaf_rank(rank, dtype):
    """A (P,) f64 operand against a stacked leaf of rank 1, 2 or 3 scales
    point p as the host float of point p scales its slice, bit for bit;
    a host float and a 0-d tensor pass as before."""
    g = torch.Generator().manual_seed(rank)
    P = 3
    leaf = torch.randn((P, 4, 5)[:rank], generator=g, dtype=F64).to(dtype)
    vals = [0.05, 1.0 / 3.0, 0.7]
    op = torch.tensor(vals, dtype=F64)
    c = coef(op, leaf)
    assert c.shape == (P,) + (1,) * (rank - 1) and c.dtype == dtype
    got = c * leaf
    for i, v in enumerate(vals):
        assert torch.equal(got[i], v * leaf[i])
    assert coef(0.25, leaf) == 0.25
    zero_d = torch.tensor(0.3, dtype=F64)
    assert torch.equal(coef(zero_d, leaf), zero_d.to(dtype))
    assert coef(zero_d, leaf).dim() == 0


# --- the serial runners, against the reference ------------------------------------

# block 2: both leaves' last axis (C = 3) in a whole and a ragged block
SERIAL_DENSE = {
    "prox-lead-sgd-qinf": _dense(
        "prox_lead", "sgd", steps=6,
        compressor={"name": "qinf", "params": {"bits": 2, "block": 2}}),
    "dgd-full": _dense("dgd", "full", steps=6),
}


@pytest.mark.parametrize("case", sorted(SERIAL_DENSE))
def test_serial_dense_run_on_a_tree_matches_the_reference(case):
    """``api.build(spec).run()`` on the dense engine, the reference's draws
    (oracle indices, one QInf noise a leaf) replayed: every state tensor
    within C2's bar."""
    d = SERIAL_DENSE[case]
    jspec = japi.ExperimentSpec.from_dict(d)
    _, states, draws = tbase.reference_run(jspec, jspec.steps)
    runner = tapi.build(tapi.ExperimentSpec.from_dict(d), device="cpu",
                        dtype=F64)
    assert runner.device == torch.device("cpu")
    rd = ReplayDraws([a for step in draws for a in step], "cpu")
    st, _ = runner.run(draws=rd)
    assert not rd.pending
    assert_state_close(st, states[-1], STEP_RTOL, STEP_ATOL, case)
    assert runner.bits_per_step() > 0


@pytest.mark.parametrize("algo", ["prox_lead", "lessbit"])
def test_serial_netsim_run_on_a_tree_matches_the_reference(algo):
    """``api.build(spec).run()`` on the netsim engine under straggler,
    linkdrop and noise faults with 2-bit QInf, both draw streams of the
    reference replayed: the state within C2's bar, consensus and objective
    to 1e-10, bits equal as int64."""
    d = _netsim(algo, _faults("all"), steps=6, oracle="sgd",
                compressor={"name": "qinf", "params": {"bits": 2,
                                                       "block": 2}})
    jspec = japi.ExperimentSpec.from_dict(d)
    runner_j = japi.build(jspec)
    final_j, traj_j = runner_j.run(objective_fn=runner_j.problem.full_loss)
    # the algorithm's draws from simulate()'s keys, as
    # test_torch_netsim._ref_netsim_run takes them, without a second run
    keys = jax.random.split(jax.random.key(jspec.seed), jspec.steps + 1)
    adraws = [tbase.init_draws(runner_j.algo, keys[0])] + [
        tbase.step_draws(runner_j.algo, runner_j.X0, k) for k in keys[1:]]
    runner = tapi.build(tapi.ExperimentSpec.from_dict(d), device="cpu",
                        dtype=F64)
    # Prox-LEAD's init mixes (round 0) and its steps are rounds 1..steps;
    # LessBit mixes first in its step from round 0
    rounds = ([None] + list(range(1, jspec.steps + 1)) if algo == "prox_lead"
              else list(range(jspec.steps)))
    fd = ReplayDraws(tnetsim._ref_fault_stream(runner_j, jspec, rounds),
                     "cpu")
    rd = ReplayDraws([a for step in adraws for a in step], "cpu")
    st, traj = runner.run(draws=rd, fault_draws=fd,
                          objective_fn=runner.problem.full_loss)
    assert not rd.pending and not fd.pending
    assert_state_close(st, final_j, STEP_RTOL, STEP_ATOL, algo)
    np.testing.assert_allclose(traj.consensus, traj_j.consensus, rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_allclose(traj.objective, traj_j.objective, rtol=1e-10)
    assert traj.bits.dtype == np.int64
    np.testing.assert_array_equal(traj.bits, traj_j.bits.astype(np.int64))
    assert (traj.meta["bits_per_edge_per_round"]
            == traj_j.meta["bits_per_edge_per_round"])


# --- the stacked tree grid against the reference's vmap mode --------------------

REFERENCE_GRIDS = {
    "dense-prox-lead": (_dense("prox_lead", compressor={"name": "identity"}),
                        [("algorithm.eta", (0.05, 0.03)),
                         ("algorithm.gamma", (0.5, 0.9))]),
    "netsim-lead-alternating": (
        tiny_dict(name="ntiny", steps=5, prox=NO_PROX,
                  algorithm=_algo("lead", alpha=0.5), oracle=_oracle(),
                  compressor={"name": "identity"},
                  topology={"graph": "ring", "schedule": "alternating"},
                  execution={"engine": "netsim"}),
        [("algorithm.eta", (0.05, 0.03))]),
    "choco-topk": (
        _dense("choco", compressor={"name": "topk", "params": {"frac": 0.3}}),
        [("algorithm.params.gamma_c", (0.2, 0.1))]),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_GRIDS))
def test_tree_vmap_matches_the_reference_vmap_mode(case):
    """Grids that draw nothing: both packages' stacked grids from one
    SweepSpec JSON, every tensor of every point within 1e-12; netsim bits
    a round equal as integers."""
    base, axes = REFERENCE_GRIDS[case]
    d = sweep_dict(base, axes)
    jrun = jsweep.SweepRunner(japi.SweepSpec.from_dict(d).points(),
                              batch="vmap")
    jfinal, jres = jrun.run()
    trun = tsweep.SweepRunner(tapi.SweepSpec.from_dict(d).points(),
                              batch="vmap", device="cpu", dtype=F64)
    tfinal, tres = trun.run()
    assert isinstance(trun.X0, dict)
    for i in range(trun.n_points):
        assert_state_close(trun.point_state(tfinal, i),
                           jrun.point_state(jfinal, i), VMAP_RTOL, VMAP_ATOL,
                           f"{case} point {i}")
    if case.startswith("netsim"):
        np.testing.assert_array_equal(tres.metrics["bits"],
                                      jres.metrics["bits"].astype(np.int64))
        np.testing.assert_allclose(tres.metrics["consensus"],
                                   jres.metrics["consensus"],
                                   rtol=VMAP_RTOL, atol=1e-14)


# --- the stacked tree grid against the port's serial runs ------------------------

ALGORITHMS = ("prox_lead", "lead", "nids", "dgd", "pg_extra",
              "nids_independent", "choco", "lessbit", "centralized")
QINF = {"name": "qinf", "params": {"bits": 2, "block": 3}}


@pytest.mark.parametrize("algo", ALGORITHMS)
def test_tree_vmap_each_algorithm_seed_by_eta(algo):
    """Every registered algorithm x seed x eta on SGD (a batch a node a
    step from each point's stream), 2-bit QInf where it compresses."""
    runner = _runner(_dense(algo, "sgd", steps=5, compressor=QINF),
                     [("seed", (0, 1)), ("algorithm.eta", (0.05, 0.03))])
    final, _ = runner.run()
    X = runner.point_state(final, 0).X
    assert set(X) == {"W", "b"} and X["b"].shape == (4, 3)
    assert final.X["W"].shape == (4, 4, 8, 3)
    assert final.X["b"].shape == (4, 4, 3)
    assert_close_to_serial(runner, final)


@pytest.mark.parametrize("oracle", ["full", "sgd", "lsvrg", "saga"])
def test_tree_vmap_each_oracle_by_bits(oracle):
    """Prox-LEAD on each oracle x seed x bits: B1 at each point's level
    count on both leaves (the bias leaf (P, n, C) and the weights
    (P, n, p, C))."""
    runner = _runner(_dense("prox_lead", oracle, steps=5, compressor=QINF),
                     [("seed", (0, 1)), ("compressor.bits", (2, 4))])
    final, _ = runner.run()
    assert isinstance(runner.stacked_algo().compressor,
                      tsweep.PointLevelsQInf)
    assert_close_to_serial(runner, final)


COMPRESSORS = {"qinf": QINF,
               "randk": {"name": "randk", "params": {"frac": 0.3}},
               "topk": {"name": "topk", "params": {"frac": 0.3}}}


@pytest.mark.parametrize("comp", sorted(COMPRESSORS))
@pytest.mark.parametrize("algo", ["choco", "lessbit"])
def test_tree_vmap_compressed_baselines(algo, comp):
    """Choco and LessBit x seed x their own params field, on L-SVRG: RandK
    and TopK select within each point's slice of each leaf."""
    field = "gamma_c" if algo == "choco" else "theta"
    runner = _runner(_dense(algo, "lsvrg", steps=5,
                            compressor=COMPRESSORS[comp]),
                     [("seed", (0, 1)),
                      (f"algorithm.params.{field}", (0.2, 0.1))])
    final, _ = runner.run()
    assert_close_to_serial(runner, final)


def _faults(name):
    faults = {"linkdrop": [{"name": "linkdrop", "params": {"rate": 0.3}}],
              "straggler": [{"name": "straggler", "params": {"rate": 0.3}}],
              "noise": [{"name": "noise", "params": {"sigma": 0.05}}],
              "static-clean": []}
    if name == "all":
        return (faults["straggler"] + faults["linkdrop"]
                + faults["noise"])
    return faults[name]


@pytest.mark.parametrize("fault", ["linkdrop", "straggler", "noise", "all",
                                   "static-clean"])
@pytest.mark.parametrize("algo", ["prox_lead", "lessbit", "dgd"])
def test_tree_vmap_netsim_under_faults(algo, fault):
    """The netsim engine x fault_seed x bits over the tree: every point's
    state within 1e-12 and its records -- bits as int64, consensus, and
    the objective of one point's tree -- those of its serial run."""
    runner = _runner(_netsim(algo, _faults(fault), compressor=QINF),
                     [("fault_seed", (3, 4)), ("compressor.bits", (2, 4))])
    obj = _objective(runner.problem)
    final, res = runner.run(objective_fn=obj)
    assert res.metrics["bits"].shape == (4, 5)
    assert_close_to_serial(runner, final, res, objective_fn=obj)


def test_tree_vmap_harmonic_eta_t0_axis():
    """A harmonic eta whose t0 varies: ``vt0 / (k + t0)`` a point, formed
    in f64 and taken at each leaf's rank."""
    base = _dense("prox_lead", "sgd", steps=5, compressor=QINF,
                  algorithm=_algo("prox_lead", eta={
                      "kind": "harmonic", "value": 0.05, "t0": 10.0}))
    runner = _runner(base, [("algorithm.eta.t0", (10.0, 40.0)),
                            ("seed", (0, 1))])
    assert "eta:vt0" in runner.plan.operands
    final, _ = runner.run()
    assert_close_to_serial(runner, final)


def test_tree_map_mode_is_each_serial_run_bit_for_bit():
    """Map mode over the tree: every point is its serial run exactly."""
    runner = _runner(_dense("prox_lead", "saga", steps=4, compressor=QINF),
                     [("seed", (0, 1)), ("compressor.bits", (2, 4))],
                     batch="map")
    final, _ = runner.run()
    assert_close_to_serial(runner, final, rtol=0, atol=0)


# --- teacher-forced: the stacked step against the map step ------------------------

TEACHER_FORCED = {
    "netsim-faults": (_netsim("prox_lead", _faults("all"),
                              oracle="sgd", compressor=QINF),
                      [("fault_seed", (3, 4)), ("compressor.bits", (2, 4))]),
    "lsvrg": (_dense("lessbit", "lsvrg", compressor=QINF),
              [("seed", (0, 1)), ("algorithm.params.theta", (0.2, 0.1))]),
    "randk": (_dense("lead", "saga", algorithm=_algo("lead", alpha=0.5),
                     compressor=COMPRESSORS["randk"]),
              [("seed", (0, 1, 2, 3))]),
}


@pytest.mark.parametrize("case", sorted(TEACHER_FORCED))
def test_tree_vmap_step_matches_map_step_from_recorded_draws(case):
    """From the same stacked tree state, one stacked step and one map
    step, each point's algorithm draws (and on netsim its fault draws)
    recorded in the stacked step and replayed in the map step."""
    vm = _runner(*TEACHER_FORCED[case])
    mp = vm.with_batch("map")
    P = vm.n_points
    frec = [RecordingDraws(GeneratorDraws(p.fault_seed, "cpu"))
            for p in vm.points]
    st = vm.init_state(fault_draws=StackedDraws(frec))
    frep = [ReplayDraws([t.clone() for t in r.record], "cpu") for r in frec]
    mp.init_state(fault_draws=StackedDraws(frep))
    for t in range(4):
        seen = [len(r.record) for r in frec]
        rec = [RecordingDraws(GeneratorDraws(100 * t + i, "cpu"))
               for i in range(P)]
        got = vm.step(st, StackedDraws(rec))
        for r, rp, n in zip(frec, frep, seen):
            rp.pending.extend(r.record[n:])
        replay = [ReplayDraws(r.record, "cpu") for r in rec]
        want = mp.step(st, StackedDraws(replay))
        assert all(not r.pending for r in replay + frep)
        pairs = state_pairs(got, want)
        assert any(p.endswith(".X/b") for p, _, _ in pairs)
        for path, a, b in pairs:
            np.testing.assert_allclose(a.numpy(), b, rtol=VMAP_RTOL,
                                       atol=VMAP_ATOL,
                                       err_msg=f"step {t} {path}")
        st = got


# --- dtypes -----------------------------------------------------------------------

def test_tree_vmap_in_f32_warns_and_stays_close():
    """f32 on the netsim engine under every fault: a warning, every leaf
    stays f32, each point within 1e-5 of its serial run, bits equal."""
    with pytest.warns(UserWarning, match="tolerance"):
        runner = _runner(_netsim("prox_lead", _faults("all"),
                                 compressor=QINF),
                         [("fault_seed", (3, 4)), ("seed", (2, 5))],
                         dtype=torch.float32)
    final, res = runner.run()
    assert all(t.dtype == torch.float32 for t in ttree.leaves(final.X))
    for i, p in enumerate(runner.points):
        serial, traj = tapi.build(p, device="cpu").run()
        got = runner.point_state(final, i).X
        for k in ("W", "b"):
            np.testing.assert_allclose(got[k].numpy(), serial.X[k].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(res.metrics["bits"][i], traj.bits)


def test_tree_vmap_refuses_leaves_of_mixed_dtypes():
    """A stacked grid takes one dtype: an iterate whose leaves mix f32 and
    f64 is refused (map mode still runs it point by point)."""
    base = _dense("prox_lead", compressor={"name": "identity"})
    points = tapi.SweepSpec.from_dict(
        sweep_dict(base, [("seed", (0, 1))])).points()
    template = tapi.build(points[0], device="cpu", dtype=F64)
    template.X0 = dict(template.X0, b=template.X0["b"].float())
    with pytest.raises(ValueError, match="mix dtypes"):
        tsweep.SweepRunner(points, batch="vmap", template=template)
    assert tsweep.SweepRunner(points, batch="map",
                              template=template).n_points == 2
