"""The port's netsim engine against the JAX package.

* Schedules (``repro_torch.netsim.schedule``): the four kinds' (T, n, n)
  stacks equal the reference's exactly (the builders are the same numpy
  code), every W_k satisfies Assumption 1, ``joint_spectral_gap`` agrees to
  1e-12, and markov_drop at rate 0 is the static schedule.
* Faults with the reference's draws replayed: LinkDrop's and Straggler's
  masks equal the reference's (LinkDrop's (n, n) uniform is drawn in f64
  under the tests' x64, the straggler's Bernoulli replayed as its bool
  mask), ``apply_edge_mask`` to 1e-15, ``effective_C`` and
  ``mean_edge_survival`` equal.
* One step of Prox-LEAD, LEAD, NIDS, PG-EXTRA and Choco under a SimMixer
  (markov_drop schedule with straggler, link-drop and noise faults), each
  from the reference's state with the reference's algorithm and fault
  draws replayed, at C2's bar (rtol 1e-10, atol 1e-12), f64.  The
  reference derives a round's fault draws from keys,
  ``fold_in(fold_in(key(fault_seed), k), i)`` and ``fold_in(., 1 + leaf)``
  for noise; :func:`round_draws` builds them and hands them over in the
  port's call order (per round: each fault's mask in list order, then each
  leaf's noise).
* Both netsim goldens through both packages' ``api.build``, their 100
  steps with replayed draws: consensus and objective to rtol 1e-8, the
  bits equal as integers.
* The port's static, fault-free netsim engine equals its dense engine bit
  for bit; ``NeighborMixer.mix_stacked`` equals the reference's.
* A ``cuda`` test holds B4 at T = 2, S = 6 (the trainer's alternating
  ring/exponential schedule: five hops plus self, B4's vector variant) to its
  plain version.  A machine with a card but without JAX runs just that:

    python -m pytest --noconftest -m cuda tests/test_torch_netsim.py
"""
import json
import pathlib

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro import api as japi
    from repro import netsim as jnetsim
    from repro.core import comm as jcomm
    from repro.core import topology as jtopo
    from repro.netsim import faults as jfaults
    from repro.netsim import metrics as jmetrics
    from tests.test_torch_baselines import (init_draws, simple_arrays,
                                            step_draws)
    from tests.test_torch_dense import as_arrays
except ImportError:        # no JAX: only the cuda test can run
    jax = None

from repro_torch import api as tapi
from repro_torch import convert, registry
from repro_torch import netsim as tnetsim
from repro_torch.core import comm as tcomm
from repro_torch.core import topology as ttopo
from repro_torch.core.draws import GeneratorDraws, ReplayDraws
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import ref as tref
from repro_torch.netsim import faults as tfaults
from repro_torch.netsim import metrics as tmetrics

GOLDEN = pathlib.Path(__file__).parent / "golden_specs"
F64 = torch.float64
STEP_RTOL, STEP_ATOL = 1e-10, 1e-12       # the C2 bar
GOLDEN_RTOL = 1e-8

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small operations: one intra-op thread (see test_torch_baselines)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the reference's fault draws --------------------------------------------

def round_draws(faults, fault_seed, k, n, leaves):
    """What the reference's SimMixer derives for round ``k`` (None = 0)
    over ``n`` nodes, in the port's call order: each fault's mask draw in
    list order, then for each leaf (shape, dtype) each fault's noise."""
    base = jax.random.fold_in(jax.random.key(fault_seed),
                              jnp.int32(0 if k is None else k))
    keys = [jax.random.fold_in(base, i) for i in range(len(faults))]
    out = []
    for f, kk in zip(faults, keys):
        if isinstance(f, jfaults.LinkDrop):
            out.append(np.asarray(jax.random.uniform(kk, (n, n))))
        elif isinstance(f, jfaults.Straggler):
            out.append(np.asarray(jax.random.bernoulli(kk, f.rate, (n,))))
    for j, (shape, dtype) in enumerate(leaves):
        for f, kk in zip(faults, keys):
            if isinstance(f, jfaults.NoisyChannel):
                out.append(np.asarray(jax.random.uniform(
                    jax.random.fold_in(kk, 1 + j), shape, dtype, -1.0, 1.0)))
    return out


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


# --- schedules ----------------------------------------------------------------

SCHEDULES = [
    ("static", 8, {}), ("static", 5, {"base": "exponential"}),
    ("alternating", 8, {}), ("alternating", 8, {"with_": "star+torus2d"}),
    ("random_matching", 8, {"rounds": 16, "seed": 3}),
    ("random_matching", 7, {"rounds": 5}),
    ("markov_drop", 8, {"drop": 0.3, "sticky": 0.5, "rounds": 12}),
    ("markov_drop", 8, {"base": "exponential", "drop": 0.2, "seed": 4}),
]


@needs_jax
@pytest.mark.parametrize("name,n,kw", SCHEDULES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(SCHEDULES)])
def test_schedule_stacks_equal_reference(name, n, kw):
    js = jnetsim.make_schedule(name, n, **kw)
    ts = tnetsim.make_schedule(name, n, **kw)
    assert ts.name == js.name and ts.T_cycle == js.T_cycle
    np.testing.assert_array_equal(ts.W_stack, js.W_stack)
    ts.validate()                          # Assumption 1, every W_k
    assert abs(ts.joint_spectral_gap() - js.joint_spectral_gap()) <= 1e-12
    assert abs(ts.joint_spectral_gap(3) - js.joint_spectral_gap(3)) <= 1e-12
    np.testing.assert_array_equal(ts.mean_topology().W,
                                  js.mean_topology().W)


def test_markov_drop_rate0_is_static():
    topo = ttopo.ring(8)
    md = tnetsim.markov_drop_schedule(topo, drop=0.0, rounds=16)
    for t in range(md.T_cycle):
        np.testing.assert_array_equal(md.W_stack[t], topo.W)
    with pytest.raises(ValueError, match="drop must be"):
        tnetsim.markov_drop_schedule(topo, drop=1.0)


def test_registries_have_the_reference_schedules_and_faults():
    assert registry.names("schedule") == ("alternating", "markov_drop",
                                          "random_matching", "static")
    assert registry.names("fault") == ("linkdrop", "noise", "straggler")
    if jax is not None:
        from repro import registry as jreg
        for kind in ("schedule", "fault"):
            assert registry.names(kind) == jreg.names(kind)
            for n in registry.names(kind):
                assert registry.accepts(kind, n) == jreg.accepts(kind, n)


# --- faults ---------------------------------------------------------------------

@needs_jax
@pytest.mark.parametrize("n,seed,k", [(8, 0, 0), (8, 3, 17), (5, 1, 2)])
def test_fault_masks_equal_reference(n, seed, k):
    jf = (jfaults.LinkDrop(0.3), jfaults.Straggler(0.3))
    tf = (tfaults.make_fault("linkdrop:0.3"),
          tfaults.make_fault("straggler:0.3"))
    draws = ReplayDraws(round_draws(jf, seed, k, n, []), "cpu")
    assert draws.pending[0].dtype == np.float64    # x64: f64 uniforms
    base = jax.random.fold_in(jax.random.key(seed), jnp.int32(k))
    for i, (j, t) in enumerate(zip(jf, tf)):
        key = jax.random.fold_in(base, i)
        edge, send = t.masks(draws, n, "cpu")
        np.testing.assert_array_equal(edge.numpy(),
                                      np.asarray(j.edge_mask(key, n)))
        want_send = j.send_mask(key, n)
        assert (send is None) == (want_send is None)
        if send is not None:
            np.testing.assert_array_equal(send.numpy(), np.asarray(want_send))
    assert not draws.pending
    # wire noise has no mask and draws none
    assert tfaults.make_fault("noise").masks(draws, n, "cpu") == (None, None)


@needs_jax
@pytest.mark.parametrize("seed", [0, 5])
def test_apply_edge_mask_matches_reference(seed):
    rng = np.random.default_rng(seed)
    W = jnetsim.make_schedule("markov_drop", 8, drop=0.2, seed=seed).W_stack[1]
    u = rng.random((8, 8))
    mask = np.triu(u, 1)
    mask = ((mask + mask.T) >= 0.4).astype(np.float32)
    np.fill_diagonal(mask, 1.0)
    got = tfaults.apply_edge_mask(_t(W), torch.from_numpy(mask))
    want = np.asarray(jfaults.apply_edge_mask(jnp.asarray(W),
                                              jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-15)


@needs_jax
def test_effective_C_and_survival_equal_reference():
    specs = "straggler:0.05,linkdrop:0.1,noise:0.01"
    tf, jf = tfaults.make_faults(specs), jfaults.make_faults(specs)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert tfaults.effective_C(tf, 0.7, 7840) == \
        jfaults.effective_C(jf, 0.7, 7840)
    assert tfaults.mean_edge_survival(tf) == jfaults.mean_edge_survival(jf)
    assert tfaults.make_faults("") == ()
    with pytest.raises(ValueError, match="unknown fault"):
        tfaults.make_fault("gremlin:0.1")


def test_sim_mixer_draws_each_round_once():
    """Every reader of a round sees one draw: the masks of all faults at
    the round's first use, each (fault, leaf) noise once; an earlier round
    after a later one raises."""
    sched = tnetsim.make_schedule("static", 4)
    faults = tfaults.make_faults("linkdrop:0.5,noise:0.1")
    mixer = tnetsim.SimMixer(sched, faults, GeneratorDraws(0, "cpu"))
    mixer.mask_log = []
    X = (torch.randn(4, 3, dtype=F64),)
    a = mixer(X, 1)[0]
    b = mixer(X, 1)[0]
    assert torch.equal(a, b) and len(mixer.mask_log) == 1
    e1 = mixer.edge_mask_at(1, comm=True)
    assert torch.equal(e1, mixer.mask_log[0][1])
    mixer(X, 2)
    assert [k for k, _, _ in mixer.mask_log] == [1, 2]
    with pytest.raises(ValueError, match="increasing round order"):
        mixer(X, 1)


# --- mixers ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_static_sim_mixer_equals_dense_mixer(dtype):
    topo = ttopo.make_topology("ring", 8)
    mixer = tnetsim.SimMixer(tnetsim.static_schedule(topo), (),
                             GeneratorDraws(0, "cpu"))
    assert not mixer.recompute_hw
    X = {"a": torch.randn(8, 7, 5, dtype=dtype), "b": torch.randn(8, 3,
                                                                  dtype=dtype)}
    got, want = mixer(X, 5), tcomm.DenseMixer(topo.W)(X)
    for k in X:
        assert torch.equal(got[k], want[k])


@needs_jax
@pytest.mark.parametrize("sched", ["alternating", "random_matching"])
def test_neighbor_mixer_matches_reference(sched):
    s = tnetsim.make_schedule(sched, 8, rounds=4)
    tplan = ttopo.compile_plan(s.W_stack, name=s.name)
    jplan = jtopo.compile_plan(s.W_stack, name=s.name)
    tm, jm = tcomm.NeighborMixer(tplan), jcomm.NeighborMixer(jplan)
    assert tm.recompute_hw == jm.recompute_hw == (s.T_cycle > 1)
    X = np.random.default_rng(0).normal(size=(8, 6, 4))
    for k in range(s.T_cycle + 1):
        got = tm.mix_stacked((_t(X),), k)[0]
        want = np.asarray(jm.mix_stacked((jnp.asarray(X),), k)[0])
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)
        np.testing.assert_allclose(
            tm.comm_mix(_t(X), _t(X), k).numpy(),
            np.asarray(jm.comm_mix(jnp.asarray(X), jnp.asarray(X), k)),
            rtol=0, atol=1e-15)
    with pytest.raises(ValueError, match="round index"):
        tm.mix_stacked((_t(X),), None)
    # the plan's bit counts: every union pair every round, or the active
    for f in ("plan_bits_per_round", "plan_active_bits"):
        np.testing.assert_array_equal(getattr(tmetrics, f)(tplan, 1234),
                                      getattr(jmetrics, f)(jplan, 1234))


# --- one step under a SimMixer ----------------------------------------------------

PROBLEM = {"n_features": 16, "n_classes": 4, "n_per_node": 10,
           "n_batches": 5, "lam2": 0.01}
STEP_FAULTS = [{"name": "straggler", "params": {"rate": 0.3}},
               {"name": "linkdrop", "params": {"rate": 0.2}},
               {"name": "noise", "params": {"sigma": 0.05}}]
STEP_ALGOS = {
    "prox_lead": ({"eta": 0.3, "alpha": 0.5, "gamma": 0.5},
                  ("qinf", {"bits": 2, "block": 16}), "l1"),
    "lead": ({"eta": 0.3, "alpha": 0.5, "gamma": 0.5},
             ("qinf", {"bits": 2, "block": 16}), "none"),
    "nids": ({"eta": 0.3}, ("identity", {}), "none"),
    "pg_extra": ({"eta": 0.3}, ("identity", {}), "l1"),
    "choco": ({"eta": 0.3, "params": {"gamma_c": 0.3}},
              ("qinf", {"bits": 2, "block": 16}), "none"),
}


def step_spec(algo, faults=STEP_FAULTS, steps=4):
    a, (cname, cparams), prox = STEP_ALGOS[algo]
    return {
        "name": f"netsim-{algo}", "n_nodes": 8, "steps": steps, "seed": 2,
        "fault_seed": 7, "algorithm": dict(a, name=algo),
        "compressor": {"name": cname, "params": cparams},
        "topology": {"graph": "ring", "schedule": "markov_drop", "rounds": 3,
                     "schedule_params": {"drop": 0.3, "sticky": 0.2}},
        "faults": list(faults),
        "prox": ({"name": "l1", "params": {"lam": 0.01}} if prox == "l1"
                 else {"name": "none"}),
        "oracle": {"name": "full", "problem": "logreg",
                   "problem_params": PROBLEM},
        "execution": {"engine": "netsim"}}


def _ref_arrays(st):
    return as_arrays(st) if hasattr(st, "D") else simple_arrays(st)


def _port_state(arrays):
    if "D" in arrays:
        return convert.state_from_arrays(arrays, device="cpu", dtype=F64)
    return convert.simple_state_from_arrays(arrays, device="cpu", dtype=F64)


def _assert_close(port, ref, rtol, atol):
    got = (convert.state_to_arrays(port) if hasattr(port, "D")
           else convert.simple_state_to_arrays(port))
    want = _ref_arrays(ref)
    assert int(got["k"]) == int(want["k"])
    for key, a in got.items():
        if key in ("k", "oracle.kind"):
            continue
        ga = [a] if not isinstance(a, (tuple, list)) else list(a)
        wa = want[key]
        wa = [wa] if not isinstance(wa, (tuple, list)) else list(wa)
        assert len(ga) == len(wa), key
        for g, w in zip(ga, wa):
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), rtol=rtol,
                                       atol=atol, err_msg=key)


def _ref_netsim_run(jspec, steps):
    """The reference's NetsimRunner stepped by hand with simulate()'s keys:
    -> (runner, states, per-state algorithm draws)."""
    runner = japi.build(jspec)
    algo = runner.algo
    keys = jax.random.split(jax.random.key(jspec.seed), steps + 1)
    st = runner.init_state(keys[0])
    states, draws = [st], [init_draws(algo, keys[0])]
    for i in range(1, steps + 1):
        draws.append(step_draws(algo, runner.X0, keys[i]))
        st = runner.step(st, keys[i])
        states.append(st)
    return runner, states, draws


@needs_jax
@pytest.mark.parametrize("algo", sorted(STEP_ALGOS))
def test_one_step_under_sim_mixer_matches_reference(algo):
    d = step_spec(algo)
    jspec = japi.ExperimentSpec.from_dict(d)
    runner_j, states, adraws = _ref_netsim_run(jspec, 3)
    runner_t = tapi.build(tapi.ExperimentSpec.from_dict(d), device="cpu",
                          dtype=F64)
    assert runner_t.schedule.name == runner_j.schedule.name
    jf = runner_j.faults
    n = jspec.n_nodes
    leaves = [(x.shape, x.dtype) for x in
              jax.tree_util.tree_leaves(runner_j.X0)]
    # init: the algorithm's init draws, and round 0 if its init mixes
    init_mixes = algo in ("prox_lead", "lead", "nids", "pg_extra")
    fd = ReplayDraws(round_draws(jf, jspec.fault_seed, None, n, leaves)
                     if init_mixes else [], "cpu")
    rd = ReplayDraws(adraws[0], "cpu")
    got = runner_t.with_fault_draws(fd).init(runner_t.X0, rd)
    assert not rd.pending and not fd.pending
    _assert_close(got, states[0], STEP_RTOL, STEP_ATOL)
    for i in range(3):
        st = states[i]
        fd = ReplayDraws(round_draws(jf, jspec.fault_seed, int(st.k), n,
                                     leaves), "cpu")
        rd = ReplayDraws(adraws[i + 1], "cpu")
        got = runner_t.with_fault_draws(fd).step(
            _port_state(_ref_arrays(st)), rd)
        assert not rd.pending and not fd.pending, "the port drew less"
        _assert_close(got, states[i + 1], STEP_RTOL, STEP_ATOL)


def test_netsim_runner_steps_start_a_fresh_fault_stream():
    """``init_state`` starts the run's fault stream (seeded ``fault_seed``):
    two runs of ``init_state`` and ``step`` on one runner agree with each
    other and with ``run()`` bit for bit; ``step`` before ``init_state`` is
    refused."""
    spec = tapi.ExperimentSpec.load(GOLDEN / "netsim_matching_linkdrop_noise"
                                    ".json")
    runner = tapi.build(spec, device="cpu", dtype=F64)
    assert runner.faults
    with pytest.raises(RuntimeError, match="init_state"):
        runner.step(None, GeneratorDraws(spec.seed, "cpu"))

    def stepped(n):
        d = GeneratorDraws(spec.seed, "cpu")
        st = runner.init_state(d)
        for _ in range(n):
            st = runner.step(st, d)
        return st

    a, b = stepped(5), stepped(5)
    want, _ = runner.run(num_steps=5)
    assert torch.equal(a.X, b.X) and torch.equal(a.X, want.X)


# --- the goldens and the engine --------------------------------------------------

def _ref_fault_stream(jrunner, jspec, rounds):
    leaves = [(x.shape, x.dtype) for x in
              jax.tree_util.tree_leaves(jrunner.X0)]
    return [a for k in rounds for a in
            round_draws(jrunner.faults, jspec.fault_seed, k, jspec.n_nodes,
                        leaves)]


@needs_jax
@pytest.mark.parametrize("name", ["netsim_markov_straggler",
                                  "netsim_matching_linkdrop_noise"])
def test_netsim_golden_matches_reference(name):
    """100 steps through both packages' ``api.build``: consensus and
    objective to rtol 1e-8, bits equal as integers.  (The straggler golden
    -- LEAD with RandK at eta 0.05 -- diverges in both packages; they
    diverge together.)"""
    path = GOLDEN / f"{name}.json"
    jspec, tspec = japi.ExperimentSpec.load(path), tapi.ExperimentSpec.load(
        path)
    assert json.loads(tspec.to_json()) == json.loads(jspec.to_json())
    runner_j = japi.build(jspec)
    _, traj_j = runner_j.run(objective_fn=runner_j.problem.full_loss)
    _, states, adraws = _ref_netsim_run(jspec, jspec.steps)
    runner_t = tapi.build(tspec, device="cpu", dtype=F64)
    assert tspec.fault_seed == jspec.fault_seed
    # Prox-LEAD's init mixes (round 0), then rounds 1..steps
    fd = ReplayDraws(_ref_fault_stream(runner_j, jspec,
                                       [None] + list(range(1, jspec.steps
                                                           + 1))), "cpu")
    rd = ReplayDraws([a for step in adraws for a in step], "cpu")
    st, traj = runner_t.run(draws=rd, fault_draws=fd,
                            objective_fn=runner_t.problem.full_loss)
    assert not rd.pending and not fd.pending
    np.testing.assert_allclose(st.X.numpy(), np.asarray(states[-1].X),
                               rtol=GOLDEN_RTOL)
    np.testing.assert_allclose(traj.consensus, traj_j.consensus,
                               rtol=GOLDEN_RTOL)
    np.testing.assert_allclose(traj.objective, traj_j.objective,
                               rtol=GOLDEN_RTOL)
    assert traj.bits.dtype == np.int64
    np.testing.assert_array_equal(traj.bits, traj_j.bits.astype(np.int64))
    assert traj.meta["schedule"] == traj_j.meta["schedule"]
    assert traj.meta["bits_per_edge_per_round"] == \
        traj_j.meta["bits_per_edge_per_round"]
    assert abs(traj.meta["joint_spectral_gap"]
               - traj_j.meta["joint_spectral_gap"]) <= 1e-12
    rep = runner_t.last_report
    assert rep.engine == "netsim" and rep.scope == "system"
    assert rep.extra["bits_total"] == traj.total_bits == \
        int(traj_j.total_bits)
    summary = json.loads(traj.to_json(full=True))
    assert summary["total_bits_on_wire"] == traj.total_bits
    assert summary["trajectory"]["bits"] == traj.bits.tolist()


def test_static_netsim_engine_equals_dense_engine():
    """No schedule, no faults: the netsim engine keeps the incremental Hw
    recursion, so its run is the dense engine's bit for bit."""
    d = step_spec("prox_lead", faults=[], steps=12)
    d["topology"] = {"graph": "ring"}
    netsim = tapi.build(tapi.ExperimentSpec.from_dict(d), device="cpu")
    dense = tapi.build(tapi.ExperimentSpec.from_dict(
        dict(d, execution={"engine": "dense"})), device="cpu")
    st_n, traj = netsim.run()
    st_d, _ = dense.run()
    assert st_n.k == st_d.k == 13
    for a, b in ((st_n.X, st_d.X), (st_n.D, st_d.D),
                 (st_n.comm.H, st_d.comm.H), (st_n.comm.Hw, st_d.comm.Hw)):
        assert torch.equal(a, b)
    assert traj.consensus[-1] == float(
        tnetsim.consensus_error(st_d.X))
    # ring of 8: 16 directed edges a round, each the node's payload
    assert (traj.bits == 16 * tnetsim.payload_bits_per_node(
        netsim.algo.compressor, netsim.X0)).all()


def test_engines_refuse_what_they_do_not_run():
    d = step_spec("lead")
    with pytest.raises(ValueError, match="engine='netsim'"):
        tapi.build(tapi.ExperimentSpec.from_dict(
            dict(d, execution={"engine": "dense"})), device="cpu")
    with pytest.raises(ValueError, match="engine"):
        tapi.ExperimentSpec.from_dict(dict(d, execution={"engine": "warp"}))


def _mix_per_call(plan, leaf, k):
    """``NeighborMixer.mix_stacked`` as it was built before its tables were
    cached: every round's weights, gates and gather indices made from the
    plan's numpy arrays at each call."""
    t = 0 if plan.T == 1 else int(k) % plan.T
    acc = tcomm.acc_dtype(leaf.dtype)
    x = leaf.to(acc)
    bshape = (plan.n,) + (1,) * (leaf.dim() - 1)
    out = torch.as_tensor(plan.self_weights(np.float32)[t]).to(acc) \
        .reshape(bshape) * x
    for hop in plan.hops:
        gets = np.zeros(plan.n, np.int64)
        mask = np.zeros(plan.n, np.float32)
        for (s, d) in hop.pairs:
            gets[d] = s
            mask[d] = 1.0
        w = np.asarray(hop.weights, np.float32)[t]
        gate = torch.as_tensor(w).to(acc) * torch.as_tensor(mask).to(acc)
        out = out + gate.reshape(bshape) * x[torch.as_tensor(gets)]
    return out.to(leaf.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sched", ["alternating", "random_matching"])
def test_neighbor_mixer_cached_tables_change_nothing(sched, dtype):
    """The mixer builds its per-round tables once and indexes them by
    round: its output equals the per-call construction element for
    element at every round k = 0..T-1 of a scheduled plan (and k = T, the
    cycle's wrap), the tables built once per (dtype, device)."""
    s = tnetsim.make_schedule(sched, 8, rounds=4)
    plan = ttopo.compile_plan(s.W_stack, name=s.name)
    mixer = tcomm.NeighborMixer(plan)
    X = torch.as_tensor(np.random.default_rng(1).normal(size=(8, 6, 4)),
                        dtype=dtype)
    assert plan.T == s.T_cycle > 1
    for k in range(plan.T + 1):
        assert torch.equal(mixer.mix_stacked((X,), k)[0],
                           _mix_per_call(plan, X, k))
    assert list(mixer._cache) == [(tcomm.acc_dtype(dtype),
                                   torch.device("cpu"))]


@pytest.mark.cuda
def test_cuda_neighbor_mixer_moves_nothing_from_the_host():
    """On the card a mix after the first reads its tables from the device:
    no blocking host-to-device copy (``set_sync_debug_mode("error")``), and
    the result equals the plain CPU mix."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = tnetsim.make_schedule("alternating", 8)
    plan = ttopo.compile_plan(s.W_stack, name=s.name)
    mixer = tcomm.NeighborMixer(plan)
    X = torch.randn(8, 6, 4, dtype=torch.float64)
    Xc = X.cuda()
    mixer.mix_stacked((Xc,), 0)
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [mixer.mix_stacked((Xc,), k)[0] for k in range(plan.T)]
    finally:
        torch.cuda.set_sync_debug_mode(old)
    for k in range(plan.T):
        assert torch.equal(got[k].cpu(), mixer.mix_stacked((X,), k)[0])


# --- B4 at the alternating schedule's T = 2, S = 6 (card) --------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("bits", [2, 4])
def test_cuda_b4_two_rounds_six_senders_matches_plain(bits):
    """B4 with T = 2 rounds and S = 6 senders (self plus the five hops of
    the ring/exponential union on 8 nodes): the vector variant, which
    streams any number of senders; mix and qself equal the plain
    version's, one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(bits)
    N, S, T, R, B = 8, 6, 2, 203, 256
    x = torch.randn((N * S * R, B), generator=g, device="cuda") * 3
    u = torch.rand(x.shape, generator=g, device="cuda")
    pk, sk = tq.qinf_quantize_pack_blocks(x, u, bits)
    P, Sc = pk.view(N, S, R, -1), sk.reshape(N, S, R, 1)
    w = torch.rand((N, T, S), generator=g, device="cuda")
    before = tq.launch_counts()["qinf_unpack_dequant_mix_blocks"]
    mk, qk_ = tq.qinf_unpack_dequant_mix_blocks(P, Sc, w, bits)
    assert tq.uses_vector_variant("qinf_unpack_dequant_mix_blocks", P, mk,
                                  qk_)
    assert tq.launch_counts()["qinf_unpack_dequant_mix_blocks"] == before + 1
    mr, qr = tref.qinf_unpack_dequant_mix_blocks_ref(P, Sc, w, bits)
    assert mk.shape == (N, T, R, B)
    assert torch.equal(qk_, qr) and torch.equal(mk, mr)
