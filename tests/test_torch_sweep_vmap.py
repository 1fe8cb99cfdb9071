"""The stacked grid (``repro_torch.sweep``, ``batch='vmap'``) over the whole
scope of the reference's vmap mode: the netsim engine with its fault
streams, all nine algorithms, the four oracles, the four compressors and
``algorithm.params`` axes.

* Against the reference's ``SweepRunner(points, batch='vmap')`` (x64) on
  grids that draw nothing: rtol = atol = 1e-12, netsim bits equal as
  integers.
* Against the port's serial runs (``api.build(point).run()``) in f64:
  every point within rtol = atol = 1e-12, netsim bits equal as int64.
* One stacked step against the map step from the same stacked state, each
  point's algorithm (and fault) draws recorded in the one and replayed in
  the other.
* The pieces: a batched ``apply_edge_mask``, COMM's send mask at P == n,
  the stacked step record's bits against a host recount.

The tiny sizes of ``tests/test_torch_sweep.py`` (4 nodes, ``logreg2d``
8 x 3).
"""
import numpy as np
import pytest
import torch

from repro import sweep as jsweep
from repro_torch import api as tapi
from repro_torch import sweep as tsweep
from repro_torch.core.comm import CommState, Mixer, comm
from repro_torch.core.compression import make_compressor
from repro_torch.core.draws import (GeneratorDraws, RecordingDraws,
                                    ReplayDraws, StackedDraws)
from repro_torch.netsim import engine as netsim_engine
from repro_torch.netsim import faults as faults_mod
from tests.test_torch_baselines import assert_simple_close
from tests.test_torch_dense import assert_states_close
from tests.test_torch_sweep import (TINY, VMAP_ATOL, VMAP_RTOL, _leaves,
                                    both, sweep_dict, tiny_dict)

F64 = torch.float64
NO_PROX = {"name": "none"}
L1 = {"name": "l1", "params": {"lam": 1e-3}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small operations: one intra-op thread (see test_torch_baselines)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _oracle(name):
    return {"name": name, "problem": "logreg2d",
            "problem_params": dict(TINY)}


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


def _runner(base, axes, batch="vmap", dtype=F64):
    ss = tapi.SweepSpec.from_dict(sweep_dict(base, axes))
    return tsweep.SweepRunner(ss.points(), batch=batch, device="cpu",
                              dtype=dtype)


def assert_close_to_serial(runner, final, res=None, rtol=VMAP_RTOL,
                           atol=VMAP_ATOL, **run_kw):
    """Every point of the stacked ``final`` (and a netsim ``res``'s
    records) against ``api.build(point).run()``."""
    for i, p in enumerate(runner.points):
        serial, traj = tapi.build(p, device="cpu",
                                  dtype=runner.X0.dtype).run(**run_kw)
        got = runner.point_state(final, i)
        for a, b in zip(_leaves(got), _leaves(serial)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                                       atol=atol, err_msg=p.name)
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


# --- against the reference's vmap mode ---------------------------------------

REFERENCE_GRIDS = {
    "netsim-lead-alternating": (
        tiny_dict(name="ntiny", steps=5, prox=NO_PROX,
                  algorithm=_algo("lead", alpha=0.5),
                  compressor={"name": "identity"},
                  topology={"graph": "ring", "schedule": "alternating"},
                  execution={"engine": "netsim"}),
        [("algorithm.eta", (0.05, 0.03)), ("algorithm.gamma", (0.5, 0.9))]),
    "choco-topk": (
        tiny_dict(algorithm=_algo("choco"), prox=NO_PROX,
                  compressor={"name": "topk", "params": {"frac": 0.3}}),
        [("algorithm.params.gamma_c", (0.2, 0.1)),
         ("algorithm.eta", (0.05, 0.03))]),
    "lessbit-identity": (
        tiny_dict(algorithm=_algo("lessbit"), prox=NO_PROX,
                  compressor={"name": "identity"}),
        [("algorithm.params.theta", (0.2, 0.1))]),
    **{a: (tiny_dict(algorithm=_algo(a), compressor={"name": "identity"}),
           [("algorithm.eta", (0.05, 0.03))])
       for a in ("dgd", "pg_extra", "nids_independent", "centralized")},
}


@pytest.mark.parametrize("case", sorted(REFERENCE_GRIDS))
def test_vmap_matches_the_reference_vmap_mode(case):
    """Grids that draw nothing (the full oracle, identity or TopK, no
    faults): both packages' stacked grids from one SweepSpec JSON, every
    point within 1e-12; netsim bits per round equal as integers."""
    base, axes = REFERENCE_GRIDS[case]
    js, ts = both(sweep_dict(base, axes))
    jrun = jsweep.SweepRunner(js.points(), batch="vmap")
    jfinal, jres = jrun.run()
    trun = tsweep.SweepRunner(ts.points(), batch="vmap", device="cpu",
                              dtype=F64)
    tfinal, tres = trun.run()
    for i in range(trun.n_points):
        got, want = trun.point_state(tfinal, i), jrun.point_state(jfinal, i)
        if hasattr(got, "aux"):
            assert_simple_close(got, want, VMAP_RTOL, VMAP_ATOL)
        else:
            assert_states_close(got, want, VMAP_RTOL, VMAP_ATOL)
    if case.startswith("netsim"):
        np.testing.assert_array_equal(tres.metrics["bits"],
                                      jres.metrics["bits"].astype(np.int64))
        np.testing.assert_allclose(tres.metrics["consensus"],
                                   jres.metrics["consensus"],
                                   rtol=VMAP_RTOL, atol=1e-14)


# --- against the port's serial runs ------------------------------------------

BASELINES = ("dgd", "pg_extra", "nids_independent", "choco", "lessbit",
             "centralized")


@pytest.mark.parametrize("oracle", ["sgd", "lsvrg", "saga"])
@pytest.mark.parametrize("algo", BASELINES)
def test_vmap_baseline_on_each_stochastic_oracle(algo, oracle):
    """Every baseline x seed x eta, its inits serial (PG-EXTRA's and
    NIDS's take a first step), its steps stacked."""
    base = tiny_dict(algorithm=_algo(algo), prox=_prox(algo),
                     oracle=_oracle(oracle), steps=5)
    runner = _runner(base, [("seed", (0, 1)),
                            ("algorithm.eta", (0.05, 0.03))])
    final, _ = runner.run()
    assert _leaves(final)[0].shape[:2] == (4, 4)
    assert_close_to_serial(runner, final)


COMPRESSORS = {"qinf": {"name": "qinf", "params": {"bits": 2, "block": 3}},
               "randk": {"name": "randk", "params": {"frac": 0.3}},
               "topk": {"name": "topk", "params": {"frac": 0.3}}}


@pytest.mark.parametrize("comp", sorted(COMPRESSORS))
@pytest.mark.parametrize("algo", ["choco", "lessbit"])
def test_vmap_compressed_baselines(algo, comp):
    """Choco and LessBit x seed x their own params field, on L-SVRG (a
    coin and a choice a point a step, each from the point's stream)."""
    base = tiny_dict(algorithm=_algo(algo), prox=NO_PROX, steps=5,
                     compressor=COMPRESSORS[comp], oracle=_oracle("lsvrg"))
    field = "gamma_c" if algo == "choco" else "theta"
    runner = _runner(base, [("seed", (0, 1, 2)),
                            (f"algorithm.params.{field}", (0.2, 0.1))])
    final, _ = runner.run()
    assert_close_to_serial(runner, final)


FAULTS = {"linkdrop": [{"name": "linkdrop", "params": {"rate": 0.3}}],
          "straggler": [{"name": "straggler", "params": {"rate": 0.3}}],
          "noise": [{"name": "noise", "params": {"sigma": 0.05}}]}
FAULTS["all"] = FAULTS["straggler"] + FAULTS["linkdrop"] + FAULTS["noise"]
FAULTS["static-clean"] = []       # the incremental Hw recursion


def _netsim(algo, faults, steps=5, **over):
    schedule = "alternating" if faults else "static"
    return tiny_dict(name="ntiny", steps=steps, seed=2, fault_seed=3,
                     algorithm=_algo(algo), prox=_prox(algo),
                     topology={"graph": "ring", "schedule": schedule},
                     faults=faults, execution={"engine": "netsim"}, **over)


def _objective(problem):
    return lambda X: problem.full_loss(X) + 1e-3 * X.abs().sum()


@pytest.mark.parametrize("fault", ["linkdrop", "straggler", "noise", "all",
                                   "static-clean"])
@pytest.mark.parametrize("algo", ["prox_lead", "lessbit", "dgd"])
def test_vmap_netsim_under_faults(algo, fault):
    """The netsim engine x fault_seed x bits: every point's state within
    1e-12 and its records (bits as int64, consensus, objective) those of
    its serial run (on a static schedule without faults, Prox-LEAD keeps
    the incremental Hw recursion)."""
    runner = _runner(_netsim(algo, FAULTS[fault]),
                     [("fault_seed", (3, 4)), ("compressor.bits", (2, 4))])
    obj = _objective(runner.problem)
    final, res = runner.run(objective_fn=obj)
    assert res.metrics["bits"].shape == (4, 5)
    assert_close_to_serial(runner, final, res, objective_fn=obj)


# --- teacher-forced: the stacked step against the map step --------------------

TEACHER_FORCED = {
    "netsim-faults": (_netsim("prox_lead", FAULTS["all"],
                              oracle=_oracle("sgd")),
                      [("fault_seed", (3, 4)), ("compressor.bits", (2, 4))]),
    "lsvrg": (tiny_dict(algorithm=_algo("lessbit"), prox=NO_PROX,
                        oracle=_oracle("lsvrg")),
              [("seed", (0, 1)), ("algorithm.params.theta", (0.2, 0.1))]),
    "randk": (tiny_dict(algorithm=_algo("lead", alpha=0.5), prox=NO_PROX,
                        compressor=COMPRESSORS["randk"],
                        oracle=_oracle("saga")),
              [("seed", (0, 1, 2, 3))]),
}


@pytest.mark.parametrize("case", sorted(TEACHER_FORCED))
def test_vmap_step_matches_map_step_from_recorded_draws(case):
    """From the same stacked state, one stacked step and one map step,
    each point's algorithm draws (and on netsim its fault draws) recorded
    in the stacked step and replayed in the map step."""
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
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=VMAP_RTOL,
                                       atol=VMAP_ATOL, err_msg=f"step {t}")
        st = got
    if case == "netsim-faults":
        assert all(len(r.record) > 0 for r in frec)


@pytest.mark.parametrize("algo,axis", [
    ("prox_lead", ("seed", (2, 5))),
    ("lessbit", ("algorithm.params.theta", (0.2, 0.1)))])
def test_vmap_netsim_in_f32_warns_and_stays_close(algo, axis):
    """f32: every state leaf stays f32 (the per-point f64 operands are
    rounded once where they are used) and each point is within 1e-5 of
    its serial run, its bits equal."""
    with pytest.warns(UserWarning, match="tolerance"):
        runner = _runner(_netsim(algo, FAULTS["all"]),
                         [("fault_seed", (3, 4)), axis],
                         dtype=torch.float32)
    final, res = runner.run()
    assert all(t.dtype == torch.float32 for t in _leaves(final)
               if t.is_floating_point())
    for i, p in enumerate(runner.points):
        serial, traj = tapi.build(p, device="cpu").run()
        np.testing.assert_allclose(runner.point_state(final, i).X.numpy(),
                                   serial.X.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(res.metrics["bits"][i], traj.bits)


# --- the pieces ----------------------------------------------------------------

def _symmetric_masks(g, P, n):
    u = torch.rand((P, n, n), generator=g, dtype=F64)
    keep = (torch.triu(u, 1) > 0.4).to(torch.float32)
    keep = keep + keep.transpose(-2, -1)
    return keep + torch.eye(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_edge_mask_bit_equal_per_point(dtype):
    """A (P, n, n) stack of masks against one shared W (the netsim grid's
    case) and against a (P, n, n) W: each point bit-equal to the
    unbatched call."""
    g = torch.Generator().manual_seed(0)
    P, n = 5, 6
    W = torch.rand((n, n), generator=g, dtype=F64)
    W = ((W + W.T) / (2 * n)).to(dtype)
    W = W + torch.diag(1 - W.sum(1))
    masks = _symmetric_masks(g, P, n)
    got = faults_mod.apply_edge_mask(W, masks)
    assert got.shape == (P, n, n)
    Ws = W + torch.rand((P, 1, 1), generator=g, dtype=F64).to(dtype)
    got_s = faults_mod.apply_edge_mask(Ws, masks)
    for i in range(P):
        assert torch.equal(got[i], faults_mod.apply_edge_mask(W, masks[i]))
        assert torch.equal(got_s[i],
                           faults_mod.apply_edge_mask(Ws[i], masks[i]))


class _SendMixer(Mixer):
    """Identity gossip with a send mask: what COMM does with the mask is
    all that differs."""
    recompute_hw = True

    def __init__(self, send):
        self.send = send

    def send_mask(self, k=None):
        return self.send

    def comm_mix(self, h, q, k=None, leaf_idx=0):
        return h + q


def test_comm_send_mask_at_as_many_points_as_nodes():
    """A (P, n) send mask against (P, n, d) leaves with P == n: each point
    is its serial COMM with its own (n,) mask (a reshape to rank 4 would
    broadcast to (P, n, n, d) here)."""
    g = torch.Generator().manual_seed(1)
    P = n = 4
    Z, H, Hw = (torch.randn((P, n, 3), generator=g, dtype=F64)
                for _ in range(3))
    send = (torch.rand((P, n), generator=g) > 0.5).to(torch.float32)
    comp = make_compressor("identity")
    zh, zw, st = comm(Z, CommState(H, Hw), 0.5, comp, None,
                      _SendMixer(send))
    assert zh.shape == (P, n, 3) and st.H.shape == (P, n, 3)
    for i in range(P):
        wh, ww, ws = comm(Z[i], CommState(H[i], Hw[i]), 0.5, comp, None,
                          _SendMixer(send[i]))
        assert torch.equal(zh[i], wh) and torch.equal(zw[i], ww)
        assert torch.equal(st.H[i], ws.H) and torch.equal(st.Hw[i], ws.Hw)


@pytest.mark.parametrize("algo", ["prox_lead", "dgd"])
def test_stacked_step_record_bits_against_a_host_recount(algo):
    """The stacked record's bits, (P,) int64 a round, against a recount
    on the host from the masks the stacked mixer logged: the schedule's
    directed support, less the dropped links and the stragglers' sends
    (raw-iterate gossip: a straggler's links both ways), times each
    point's payload bits."""
    runner = _runner(_netsim(algo, FAULTS["all"]),
                     [("fault_seed", (3, 4, 5)), ("compressor.bits", (2, 4))])
    st = runner.init_state()
    stacked = runner.stacked_algo()
    stacked.mixer.mask_log = []
    sched = runner._template.schedule
    bpe = torch.tensor([2007, 3, 11, 5, 13, 17])
    step = netsim_engine.make_step_record(stacked, stacked.mixer, sched,
                                          device="cpu", bits_per_edge=bpe)
    draws = runner.point_draws()
    got = {}
    for _ in range(4):
        k = st.k
        st, (cons, obj, bits) = step(st, draws)
        assert bits.dtype == torch.int64 and bits.shape == (6,)
        assert cons.shape == (6,) and obj.shape == (6,)
        got[k] = bits.tolist()
    n = sched.n
    supp = (np.abs(sched.W_stack) > 1e-12) & ~np.eye(n, dtype=bool)
    drawn = {k: (e.numpy() > 0, s.numpy() > 0)
             for k, e, s in stacked.mixer.mask_log}
    assert sorted(drawn) == sorted(got)
    for k, bits in got.items():
        edge, send = drawn[k]
        for i in range(6):
            alive = supp[k % sched.T_cycle] & edge[i] & send[i][None, :]
            if algo == "dgd":
                alive &= send[i][:, None]
            assert bits[i] == int(alive.sum()) * int(bpe[i]), (k, i)
