"""The port's baselines, sparsifiers and ``empirical_C`` against the JAX
package, and the biased-compressor guard.

* Baselines (``repro_torch.core.baselines``): for each of the six
  algorithms x {full, sgd, saga} oracles, for Choco-SGD and LessBit x
  {identity, 2-bit QInf, RandK, TopK} and for LessBit-LSVRG, on the
  paper's logistic regression cut to 64 features (640 parameters a node:
  two 256-blocks and a ragged one), 30 samples a node, f64:
  - teacher-forced: the reference's state at step k crosses to the port
    (``convert.simple_state_*``), the port takes one step with the
    reference's draws for that step, and the result is held against the
    reference's step k+1 at the C2 bar (rtol 1e-10, atol 1e-12): both
    packages do the same f64 arithmetic up to summation order;
  - free-running: 30 steps from one seed, the reference's draws replayed
    in the port's call order; X within rtol 1e-9 (per-step differences of
    ~1e-15 may compound; a flipped quantization code or a changed TopK
    selection would show as ~1e-2).
* The golden ``lessbit_dense_exponential`` spec through both packages'
  ``api.build``, its 100 steps with replayed draws.
* RandK / TopK: payloads, decompressions and ``payload_bits`` equal to the
  reference's (RandK from replayed indices; TopK on distinct magnitudes
  and with ties, which both packages give to the lower index), their
  ``effective_bits_per_iter``; ``empirical_C`` equal to the reference's
  under replayed noise.
* The card: ``cuda`` tests hold B1/B2 inside Choco and LessBit steps to
  the plain route, and ``empirical_C`` to one B1 and one B2 launch.  A
  machine with a card but without JAX runs just those:

    python -m pytest --noconftest -m cuda tests/test_torch_baselines.py
"""
import dataclasses
import functools
import json
import pathlib

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro import api as japi
    from repro.core import baselines as jB
    from repro.core import compression as jC
    from repro.core import prox_lead as jPL
    from repro.kernels import ops as jkops
    from repro.netsim import metrics as jmetrics
except ImportError:        # no JAX: only the cuda tests can run
    jax = None

from repro_torch import api as tapi
from repro_torch import convert, registry
from repro_torch.core import compression as tC
from repro_torch.core.draws import GeneratorDraws, RecordingDraws, ReplayDraws
from repro_torch.kernels import quantize as qk
from repro_torch.netsim import metrics as tmetrics

GOLDEN = pathlib.Path(__file__).parent / "golden_specs"
F64 = torch.float64
STEP_RTOL, STEP_ATOL = 1e-10, 1e-12       # the C2 bar
FREE_RTOL, FREE_ATOL = 1e-9, 1e-11
FREE_STEPS = 30
TF_STEPS = 4                              # teacher-forced steps a case

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's operations here are small: run them on one intra-op
    thread.  With several test processes on one machine, torch's default
    pool (a thread a core, spinning for threads that are not scheduled)
    made the 2,000-iteration ``solve_reference`` ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the reference's draws ----------------------------------------------------

def _np(arrays):
    return [np.asarray(a) for a in arrays]


def oracle_draws(oracle, key):
    """What the reference oracle's ``sample`` draws from ``key`` (JAX
    arrays; :func:`_np` turns a list of them into numpy)."""
    p = oracle.problem
    if oracle.name in ("sgd", "saga"):
        return [jax.random.randint(key, (p.n,), 0, p.m)]
    if oracle.name == "lsvrg":
        k_l, k_b = jax.random.split(key)
        return [jax.random.randint(k_l, (p.n,), 0, p.m),
                jax.random.bernoulli(k_b, oracle.p_update)]
    return []


def leaf_draws(comp, x, key):
    """What the reference compressor draws for one leaf ``x``."""
    if isinstance(comp, jC.QInf):
        shape = (x.shape if comp.use_pallas and x.ndim == 2
                 and x.shape[-1] == comp.block
                 else jkops.blockwise_lastdim(x, block=comp.block).shape)
        return [jax.random.uniform(key, shape, jnp.float32)]
    if isinstance(comp, jC.RandK):
        n = x.size
        k = max(1, int(round(comp.frac * n)))
        return [jax.random.choice(key, n, shape=(k,), replace=False)]
    return []                                   # TopK draws nothing


def tree_draws(comp, X, key):
    """The per-leaf draws of ``comm()`` / ``Compressor.tree_call`` (one key
    per leaf from ``split(key, n_leaf)``); Identity is skipped."""
    if isinstance(comp, jC.Identity):
        return []
    leaves = jax.tree_util.tree_leaves(X)
    out = []
    for x, k in zip(leaves, jax.random.split(key, len(leaves))):
        out += leaf_draws(comp, x, k)
    return out


def init_draws(algo, key):
    if isinstance(algo, (jPL.ProxLEAD, jB.PGExtra, jB.NIDSIndependent)):
        return _np(oracle_draws(algo.oracle, key))
    return []


def step_draws(algo, X, sub):
    """The draws of ``algo.step(state, sub)`` with iterates shaped like X."""
    if isinstance(algo, (jPL.ProxLEAD, jB.ChocoSGD, jB.LessBit)):
        k_g, k_c = jax.random.split(sub)
        return _np(oracle_draws(algo.oracle, k_g)
                   + tree_draws(algo.compressor, X, k_c))
    return _np(oracle_draws(algo.oracle, sub))


def run_keys(seed, steps):
    """DenseRunner.run's key discipline: (init key, [step keys])."""
    key = jax.random.key(seed)
    k0, key = jax.random.split(key)
    subs = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return k0, subs


def reference_run(jspec, steps):
    """-> (runner, [state_0 .. state_steps], [init draws, step draws ...])
    with the reference's jitted steps."""
    runner = japi.build(jspec)
    algo = runner.algo
    k0, subs = run_keys(jspec.seed, steps)
    st = algo.init(runner.X0, k0)
    states, draws = [st], [init_draws(algo, k0)]
    for sub in subs:
        draws.append(step_draws(algo, runner.X0, sub))
        st = runner.step(st, sub)
        states.append(st)
    return runner, states, draws


def simple_arrays(st):
    """A reference SimpleState as the arrays ``convert`` reads."""
    a = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    return {"X": a(st.X), "aux": a(st.aux),
            "oracle.kind": np.asarray(st.oracle.kind),
            "oracle.ref": a(st.oracle.ref),
            "oracle.ref_grad": a(st.oracle.ref_grad), "k": np.asarray(st.k)}


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def assert_simple_close(port_state, ref_state, rtol, atol):
    got = convert.simple_state_to_arrays(port_state)
    want = simple_arrays(ref_state)
    assert int(got["k"]) == int(want["k"])
    assert int(got["oracle.kind"]) == int(want["oracle.kind"])
    for key in ("X", "aux", "oracle.ref", "oracle.ref_grad"):
        g, w = _leaves(got[key]), _leaves(want[key])
        assert len(g) == len(w), key
        for a, b in zip(g, w):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=rtol, atol=atol, err_msg=key)


# --- the cases ----------------------------------------------------------------

PROBLEM = {"n_features": 64, "n_classes": 10, "n_per_node": 30,
           "n_batches": 15, "lam2": 0.005}
COMPRESSORS = {"identity": ("identity", {}),
               "qinf2": ("qinf", {"bits": 2, "block": 256}),
               "randk": ("randk", {"frac": 0.1}),
               "topk": ("topk", {"frac": 0.1})}
ETA = {"dgd": 0.5, "pg_extra": 0.25, "nids_independent": 0.5, "choco": 0.5,
       "lessbit": 0.5, "centralized": 0.5}
PARAMS = {"choco": {"gamma_c": 0.2}, "lessbit": {"theta": 0.2}}
COMPOSITE = ("dgd", "pg_extra", "nids_independent", "centralized")


def case_spec(algo, oracle, comp):
    name, cparams = COMPRESSORS[comp]
    return {
        "name": f"{algo}-{oracle}-{comp}", "n_nodes": 8, "steps": FREE_STEPS,
        "seed": 3,
        "algorithm": {"name": algo, "eta": ETA[algo], "alpha": 0.5,
                      "params": PARAMS.get(algo, {})},
        "compressor": {"name": name, "params": cparams},
        "topology": {"graph": "ring"},
        "prox": ({"name": "l1", "params": {"lam": 0.005}}
                 if algo in COMPOSITE else {"name": "none"}),
        "oracle": {"name": oracle, "problem": "logreg",
                   "problem_params": PROBLEM},
        "execution": {"engine": "dense"}}


CASES = sorted(
    {(a, o, "qinf2") for a in ETA for o in ("full", "sgd", "saga")}
    | {(a, "full", c) for a in ("choco", "lessbit") for c in COMPRESSORS}
    | {("lessbit", "lsvrg", "qinf2")})
IDS = ["-".join(c) for c in CASES]


@functools.lru_cache(maxsize=None)
def _reference(case, steps):
    jspec = japi.ExperimentSpec.from_dict(case_spec(*case))
    return reference_run(jspec, steps)


def _port_runner(case):
    return tapi.build(tapi.ExperimentSpec.from_dict(case_spec(*case)),
                      device="cpu", dtype=F64)


@needs_jax
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_teacher_forced_step_parity(case):
    runner_j, states, draws = _reference(case, FREE_STEPS)
    runner_t = _port_runner(case)
    assert runner_t.algo.name == runner_j.algo.name
    np.testing.assert_array_equal(runner_t.X0.numpy(),
                                  np.asarray(runner_j.X0))
    rd = ReplayDraws(draws[0], "cpu")
    assert_simple_close(runner_t.init_state(rd), states[0], STEP_RTOL,
                        STEP_ATOL)
    assert not rd.pending
    for k in range(TF_STEPS):
        port_in = convert.simple_state_from_arrays(
            simple_arrays(states[k]), device="cpu", dtype=F64)
        rd = ReplayDraws(draws[k + 1], "cpu")
        port_out = runner_t.step(port_in, rd)
        assert not rd.pending, "the port drew less than the reference"
        assert_simple_close(port_out, states[k + 1], STEP_RTOL, STEP_ATOL)


@needs_jax
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_free_running_trajectory(case):
    runner_j, states, draws = _reference(case, FREE_STEPS)
    runner_t = _port_runner(case)
    rd = ReplayDraws([a for step in draws for a in step], "cpu")
    st, _ = runner_t.run(num_steps=FREE_STEPS, draws=rd)
    assert not rd.pending
    assert st.k == int(states[-1].k)
    np.testing.assert_allclose(st.X.numpy(), np.asarray(states[-1].X),
                               rtol=FREE_RTOL, atol=FREE_ATOL)
    assert runner_t.bits_per_step() == runner_j.bits_per_step()
    assert runner_t.last_report.extra["algo"] == runner_j.algo.name


@needs_jax
def test_golden_lessbit_spec_matches_reference():
    """``tests/golden_specs/lessbit_dense_exponential.json`` (LessBit,
    2-bit QInf in blocks of 3, exponential graph of 8, logreg2d) builds in
    both packages and its 100 steps agree with replayed draws."""
    path = GOLDEN / "lessbit_dense_exponential.json"
    jspec = japi.ExperimentSpec.load(path)
    tspec = tapi.ExperimentSpec.load(path)
    assert json.loads(tspec.to_json()) == json.loads(jspec.to_json())
    runner_j = japi.build(jspec)
    ref_X, _ = runner_j.run()
    _, states, draws = reference_run(jspec, jspec.steps)
    np.testing.assert_array_equal(np.asarray(states[-1].X),
                                  np.asarray(ref_X.X))
    runner_t = tapi.build(tspec, device="cpu", dtype=F64)
    rd = ReplayDraws([a for step in draws for a in step], "cpu")
    st, _ = runner_t.run(draws=rd)
    assert not rd.pending and st.k == jspec.steps
    np.testing.assert_allclose(st.X.numpy(), np.asarray(ref_X.X),
                               rtol=FREE_RTOL, atol=FREE_ATOL)
    assert runner_t.bits_per_step() == runner_j.bits_per_step()
    assert runner_t.last_report.extra["algo"] == "lessbit" == \
        runner_j.last_report.extra["algo"]


def test_registries_name_the_reference_algorithms_and_compressors():
    names = ("centralized", "choco", "dgd", "lead", "lessbit", "nids",
             "nids_independent", "pg_extra", "prox_lead")
    assert registry.names("algorithm") == names
    assert registry.names("compressor") == ("identity", "qinf", "randk",
                                            "topk")
    if jax is not None:
        from repro import registry as jreg
        for kind in ("algorithm", "compressor"):
            assert registry.names(kind) == jreg.names(kind), kind
            for n in registry.names(kind):
                # use_pallas routes the reference's (R, block) tiles to its
                # Pallas kernel; the port sends every shape through B1
                assert set(registry._reg_for(kind, n).accepts) == \
                    set(jreg.accepts(kind, n)) - {"use_pallas"}, (kind, n)


def test_runner_for_and_bits_without_a_compressor():
    """``runner_for`` wraps a built baseline; an algorithm without a
    compressor is priced as f32, one without a mixer W as 0."""
    spec = tapi.ExperimentSpec.from_dict(case_spec("dgd", "full", "qinf2"))
    built = tapi.build(spec, device="cpu", dtype=F64)
    runner = tapi.runner_for(built.algo, built.X0)
    st, logs = runner.run(num_steps=3, log_every=1,
                          callback=lambda s, t: s.k)
    assert logs == [1, 2, 3] and runner.last_report.extra["algo"] == "dgd"
    assert runner.bits_per_step() == 2 * 640 * 32
    no_mixer = tapi.runner_for(dataclasses.replace(built.algo, mixer=None),
                               built.X0)
    assert no_mixer.bits_per_step() == 0.0


# --- the sparsifiers and empirical_C --------------------------------------------

def _distinct(shape, seed):
    """Values with pairwise distinct magnitudes (a permuted ramp)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    mags = (rng.permutation(n) + 1.0) / n
    return (mags * rng.choice([-1.0, 1.0], n)).reshape(shape)


@needs_jax
@pytest.mark.parametrize("shape", [(8, 7840), (7,), (3, 5, 4), (1,)])
@pytest.mark.parametrize("frac", [0.1, 0.5, 0.01])
def test_randk_matches_reference(shape, frac):
    x = np.random.default_rng(1).normal(size=shape)
    jc, tc = jC.RandK(frac=frac), tC.RandK(frac=frac)
    key = jax.random.key(7)
    jp = jc.compress(jnp.asarray(x), key)
    tp = tc.compress(torch.from_numpy(x),
                     ReplayDraws(_np(leaf_draws(jc, jnp.asarray(x), key)),
                                 "cpu"))
    np.testing.assert_array_equal(tp["idx"].numpy(), np.asarray(jp["idx"]))
    np.testing.assert_array_equal(tp["vals"].numpy(), np.asarray(jp["vals"]))
    np.testing.assert_array_equal(
        tc.decompress(tp, shape, F64).numpy(),
        np.asarray(jc.decompress(jp, shape, jnp.float64)))
    assert tc.payload_bits(shape) == jc.payload_bits(shape)
    assert tc.C == jc.C
    # GeneratorDraws: k distinct indices in range
    idx = tc.compress(torch.from_numpy(x), GeneratorDraws(0, "cpu"))["idx"]
    assert idx.numel() == len(np.unique(idx.numpy())) == \
        max(1, round(frac * x.size))
    assert int(idx.min()) >= 0 and int(idx.max()) < x.size


@needs_jax
@pytest.mark.parametrize("shape", [(8, 7840), (7,), (3, 5, 4)])
@pytest.mark.parametrize("frac", [0.1, 0.5])
def test_topk_matches_reference(shape, frac):
    x = _distinct(shape, 2)
    jc, tc = jC.TopK(frac=frac), tC.TopK(frac=frac)
    jp = jc.compress(jnp.asarray(x), None)
    rd = ReplayDraws([], "cpu")
    tp = tc.compress(torch.from_numpy(x), rd)             # draws nothing
    np.testing.assert_array_equal(tp["idx"].numpy(), np.asarray(jp["idx"]))
    np.testing.assert_array_equal(tp["vals"].numpy(), np.asarray(jp["vals"]))
    np.testing.assert_array_equal(
        tc.decompress(tp, shape, F64).numpy(),
        np.asarray(jc.decompress(jp, shape, jnp.float64)))
    assert tc.payload_bits(shape) == jc.payload_bits(shape)
    assert tc.C == jc.C


@needs_jax
def test_topk_ties_go_to_the_lower_index():
    """Exact ties at the cut happen on the paper's problem (784x10, LessBit
    + TopK, 30 samples a node: three equal magnitudes at the cut in step
    5; ROADMAP C6).  ``jax.lax.top_k`` keeps the lower index first; ``torch.topk``
    may order ties otherwise, so the port sorts stably: indices, values
    and decompressions equal with ties."""
    x = np.array([3.0, -1.0, 2.0, -2.0, 2.0, 0.5, -2.0, 1.0, 2.0, -2.0])
    jc, tc = jC.TopK(frac=0.5), tC.TopK(frac=0.5)   # k = 5: 3, then 2s
    jp = jc.compress(jnp.asarray(x), None)
    tp = tc.compress(torch.from_numpy(x), ReplayDraws([], "cpu"))
    np.testing.assert_array_equal(tp["idx"].numpy(), np.asarray(jp["idx"]))
    np.testing.assert_array_equal(tp["vals"].numpy(), np.asarray(jp["vals"]))
    np.testing.assert_array_equal(
        tc.decompress(tp, x.shape, F64).numpy(),
        np.asarray(jc.decompress(jp, x.shape, jnp.float64)))


@needs_jax
@pytest.mark.parametrize("name,kw", [("qinf", {"bits": 2, "block": 256}),
                                     ("qinf", {"bits": 4, "block": 64}),
                                     ("randk", {"frac": 0.25}),
                                     ("topk", {"frac": 0.25}),
                                     ("identity", {})])
def test_empirical_C_matches_reference(name, kw):
    """The port stacks QInf's trials on a leading axis (one compress call);
    the reference vmaps over split keys: the stacked noise is the
    reference's per-trial noise in trial order."""
    trials = 16
    x = np.random.default_rng(3).normal(size=(8, 300))
    jc = registry_j(name, **kw)
    tc = registry.make("compressor", name, **kw)
    key = jax.random.key(11)
    want = jC.empirical_C(jc, jnp.asarray(x), key, trials=trials)
    per_trial = [_np(leaf_draws(jc, jnp.asarray(x), k))
                 for k in jax.random.split(key, trials)]
    if tc.rowwise and per_trial[0]:
        arrays = [np.stack([d[0] for d in per_trial])]
    else:
        arrays = [a for d in per_trial for a in d]
    rd = ReplayDraws(arrays, "cpu")
    got = tC.empirical_C(tc, torch.from_numpy(x), rd, trials=trials)
    assert not rd.pending
    np.testing.assert_allclose(got, want, rtol=1e-12)
    if tc.rowwise:
        assert got <= tc.C + 1e-12


@needs_jax
@pytest.mark.parametrize("shape", [(8, 300), (16, 256)])
def test_qinf_eight_bits_matches_reference(shape):
    """The ablation's 8-bit QInf: the top code +128 does not fit int8 and
    saturates to +127 in the reference (its cast, on the jnp route and in
    the Pallas kernel alike); the port's B1 plain version does the same
    (ROADMAP C9).  Codes, scales and Q(x) equal."""
    from repro.kernels import quantize as jqk
    from repro.kernels import ref as jref
    x = np.random.default_rng(5).normal(size=shape)
    x[0, 3] = 10.0                                 # a +maxabs element
    x[1, 7] = -10.0                                # a -maxabs element
    jc, tc = jC.QInf(bits=8, block=256), tC.QInf(bits=8, block=256)
    key = jax.random.key(9)
    jp = jc.compress(jnp.asarray(x), key)
    u = _np(leaf_draws(jc, jnp.asarray(x), key))
    tp = tc.compress(torch.from_numpy(x), ReplayDraws(u, "cpu"))
    codes = tp["codes"].numpy()
    np.testing.assert_array_equal(codes.reshape(-1),
                                  np.asarray(jp["codes"]).reshape(-1))
    np.testing.assert_array_equal(tp["scales"].numpy().reshape(-1),
                                  np.asarray(jp["scales"]).reshape(-1))
    assert codes.max() == 127 and codes.min() == -128
    np.testing.assert_array_equal(
        tc(torch.from_numpy(x), ReplayDraws(u, "cpu")).numpy(),
        np.asarray(jc(jnp.asarray(x), key)))
    if shape[-1] == 256:               # the (R, block) call: Pallas kernel
        xr = x.astype(np.float32)
        ur = u[0].reshape(shape)
        got = qk.qinf_quantize_blocks(torch.from_numpy(xr),
                                      torch.from_numpy(np.array(ur)), 8)
        for want in (jref.qinf_quantize_blocks_ref(xr, ur, 8),
                     jqk.qinf_quantize_blocks(xr, ur, bits=8, block=256,
                                              interpret=True)):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def registry_j(name, **kw):
    return jC.make_compressor(name, **kw)


@needs_jax
@pytest.mark.parametrize("name,kw", [("identity", {}),
                                     ("qinf", {"bits": 2, "block": 256}),
                                     ("randk", {"frac": 0.1}),
                                     ("topk", {"frac": 0.1})])
@pytest.mark.parametrize("shape", [(7840,), (784, 10), (300,)])
def test_bits_accounting_matches_reference(name, kw, shape):
    jc, tc = registry_j(name, **kw), registry.make("compressor", name, **kw)
    X = torch.zeros((8,) + shape)
    assert tmetrics.payload_bits_per_node(tc, X) == \
        jmetrics.payload_bits_per_node(jc, jnp.zeros((8,) + shape))
    assert tmetrics.effective_bits_per_iter(tc, shape, 16) == \
        jmetrics.effective_bits_per_iter(jc, shape, 16)


@pytest.mark.parametrize("algo", ["prox_lead", "lead"])
def test_topk_guard(algo):
    """TopK violates Assumption 2: Prox-LEAD and LEAD refuse it unless
    ``allow_biased``, with the reference's message."""
    spec = tapi.ExperimentSpec.from_dict({
        **case_spec("choco", "full", "topk"),
        "algorithm": {"name": algo, "eta": 0.5}})
    with pytest.raises(ValueError, match="TopK is biased and violates "
                                         "Assumption 2"):
        tapi.build(spec, device="cpu")
    allowed = dataclasses.replace(spec, algorithm=dataclasses.replace(
        spec.algorithm, params={"allow_biased": True}))
    st, _ = tapi.build(allowed, device="cpu").run(num_steps=2)
    assert st.k == 3 and bool(torch.isfinite(st.X).all())
    # RandK is unbiased and needs no opt-in
    randk = dataclasses.replace(spec, compressor=tapi.CompressorSpec(
        "randk", {"frac": 0.2}))
    assert tapi.build(randk, device="cpu").algo.compressor.name == "randk"


def test_draws_choice_replay_and_record():
    gen = GeneratorDraws(0, "cpu")
    rec = RecordingDraws(gen)
    a = rec.choice(50, 7)
    assert a.dtype == torch.int64 and len(set(a.tolist())) == 7
    assert torch.equal(ReplayDraws(rec.record, "cpu").choice(50, 7), a)
    with pytest.raises(ValueError, match=r"the call wants \(6,\)"):
        ReplayDraws([a.numpy()], "cpu").choice(50, 6)
    with pytest.raises(ValueError, match="outside"):
        ReplayDraws([a.numpy()], "cpu").choice(int(a.max()), 7)


# --- the trainer's dense backend with RandK and TopK --------------------------------

TRAINER_TOL, TRAINER_MAX_OFF = 1e-5, 1e-3     # tests/test_torch_trainer.py's bars


def _trainer_arrays(st):
    a = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    p = st.plead
    return {"X": a(p.X), "D": a(p.D), "comm.H": a(p.comm.H),
            "comm.Hw": a(p.comm.Hw), "k": np.asarray(p.k),
            "step": np.asarray(st.step), "precond.m": np.int32(0),
            "precond.v": np.int32(0)}


def _rel_off(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float((np.abs(got - want) > tol * scale).mean())


@needs_jax
@pytest.mark.parametrize("comp", ["randk", "topk"])
def test_trainer_dense_backend_sparsifiers_match_reference(comp):
    """The golden ``trainer_dense_qinf2`` spec (vocabulary cut to 512) with
    RandK / TopK (frac 0.2; TopK with ``allow_biased``): 3 teacher-forced
    steps, the reference's
    per-leaf RandK indices replayed.  X, D, H, Hw within 1e-5 of each
    array's max on all but 0.1 % of elements (the model's gradients agree
    to f32 accuracy, C4)."""
    from repro_torch import tree
    spec = json.loads((GOLDEN / "trainer_dense_qinf2.json").read_text())
    spec["compressor"] = {"name": comp, "params": {"frac": 0.2}}
    spec["model"]["params"] = {"vocab": 512}
    if comp == "topk":
        spec["algorithm"]["params"] = {"allow_biased": True}
    jspec = japi.ExperimentSpec.from_json(json.dumps(spec))
    jrun = japi.build(jspec)
    jtr = jrun.trainer
    trun = tapi.build(tapi.ExperimentSpec.from_json(jspec.to_json()),
                      device="cpu")
    assert trun.trainer.compressor.name == comp
    assert trun.bits_per_step() == jrun.bits_per_step(
        jtr.init_state(jax.random.key(0)))
    data = jrun.default_data()
    step = jax.jit(jtr.train_step)
    st = jax.jit(jtr.init_state)(jax.random.key(0))
    X0 = st.plead.X
    draws_at = jax.jit(lambda s: tree_draws(
        jtr.compressor, X0, jax.random.fold_in(jax.random.key(jtr.tcfg.seed),
                                               s)))
    for k in range(3):
        batch = data.batch_at(k)
        rd = ReplayDraws(_np(draws_at(st.step)), "cpu")
        tb = {n: torch.from_numpy(np.array(v)) for n, v in batch.items()}
        got, _ = trun.step(convert.trainstate_from_arrays(
            _trainer_arrays(st), device="cpu"), tb, rd)
        assert not rd.pending
        st, _ = step(st, batch)
        want = _trainer_arrays(st)
        got = convert.trainstate_to_arrays(got)
        for name in ("X", "D", "comm.H", "comm.Hw"):
            for a, b in zip(tree.leaves(got[name]),
                            jax.tree_util.tree_leaves(want[name]),
                            strict=True):
                assert _rel_off(a, b, TRAINER_TOL) <= TRAINER_MAX_OFF, \
                    (k, name)


def test_trainer_sparsifier_guards():
    spec = json.loads((GOLDEN / "trainer_dense_qinf2.json").read_text())
    spec["compressor"] = {"name": "topk", "params": {"frac": 0.2}}
    with pytest.raises(ValueError, match="TopK is biased"):
        tapi.build(tapi.ExperimentSpec.from_dict(spec), device="cpu")
    spec["compressor"] = {"name": "randk", "params": {"frac": 0.2}}
    spec["execution"]["backend"] = "neighbor"
    with pytest.raises(ValueError, match="the sharded neighbor backend packs "
                                         "QInf payloads"):
        tapi.build(tapi.ExperimentSpec.from_dict(spec), device="cpu")


# --- the card -------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _leaf_tol(got, want):
    """Fraction of X off by more than 1e-4 x max|want|."""
    got, want = got.double().cpu(), want.double().cpu()
    return float(((got - want).abs() > 1e-4 * want.abs().max())
                 .float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["choco", "lessbit"])
def test_cuda_baseline_steps_launch_b1_b2_and_match_plain(algo):
    """Choco-SGD and LessBit with 2-bit QInf on the card: one B1 and one B2
    launch a step, and each step from the card's state agrees with one
    step of the plain CPU path under the same draws (X within 1e-4 of its
    max on all but 0.1 % of elements: f64 products sum in another order,
    and a code may flip where its argument sits on an f32 boundary)."""
    _card()
    spec = tapi.ExperimentSpec.from_dict(case_spec(algo, "full", "qinf2"))
    card = tapi.build(spec, dtype=F64)
    cpu = tapi.build(spec, device="cpu", dtype=F64)
    gen = GeneratorDraws(0, "cpu")
    st = card.init_state(gen)
    for _ in range(5):
        rec = RecordingDraws(gen)
        want = cpu.step(convert.simple_state_from_arrays(
            convert.simple_state_to_arrays(st), device="cpu", dtype=F64),
            rec)
        qk.reset_launch_counts()
        st = card.step(st, ReplayDraws(rec.record, "cuda"))
        counts = qk.launch_counts()
        assert counts["qinf_quantize_blocks"] == 1
        assert counts["qinf_dequantize_blocks"] == 1
        assert _leaf_tol(st.X, want.X) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_b1_eight_bits_matches_plain(dtype):
    """B1 at 8 bits (the ablation's top precision) on the paper's (8, 7840)
    leaf: codes (with +128 saturated to +127) and scales equal to the
    plain version's, through the leaf route."""
    _card()
    from repro_torch.kernels import ops as tops
    g = torch.Generator("cuda").manual_seed(8)
    x = torch.randn((8, 7840), dtype=dtype, device="cuda", generator=g)
    u = torch.rand(tops.blockwise_shape(x.shape, 256), device="cuda",
                   generator=g)
    ck, sk = tops.qinf_quantize_lastdim(x, u, bits=8, block=256)
    cp, sp = tops.qinf_quantize_lastdim(x.cpu(), u.cpu(), bits=8, block=256)
    assert torch.equal(ck.cpu(), cp) and torch.equal(sk.cpu(), sp)
    assert int(ck.max()) == 127


@pytest.mark.cuda
def test_cuda_empirical_C_is_one_launch_each():
    _card()
    comp = registry.make("compressor", "qinf", bits=2, block=256)
    x = torch.randn((8, 7840), dtype=F64, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    rec = RecordingDraws(GeneratorDraws(1, "cuda"))
    qk.reset_launch_counts()
    got = tC.empirical_C(comp, x, rec, trials=64)
    counts = qk.launch_counts()
    assert counts["qinf_quantize_blocks"] == 1
    assert counts["qinf_dequantize_blocks"] == 1
    want = tC.empirical_C(comp, x.cpu(),
                          ReplayDraws([u.cpu() for u in rec.record], "cpu"),
                          trials=64)
    assert got == pytest.approx(want, rel=1e-12)
    assert 0.0 < got <= comp.C
