"""The port's paper harness (``repro_torch.paper``) and theory helpers
against the JAX package and its ``benchmarks/`` scripts, on the CPU, f64.

* Theory: every function of ``repro_torch.core.theory`` equals the
  reference's over a grid of problem constants (the same float code).
* The harness at a small size (the paper's problem at 30 samples a node,
  60 steps): ``solve_reference`` (2,000 iterations) and ``estimate_L``
  against ``benchmarks.common``; each Fig. 1 and Fig. 2 row built by
  ``paper_cell`` through ``run_cell`` against the reference's serial run
  of the same spec (``repro.api.build(spec).run``) with its draws
  replayed: the logged suboptimality within rtol 1e-9 (per-step f64
  differences of ~1e-15 compound over 60 steps; a flipped 2-bit code
  would show as ~1e-3), ``bits_per_iter`` exactly equal.  The grids, the
  claim texts and the verdicts of ``validate`` equal the reference's.
* Table 3: the rows' measured rates, built as the reference's script builds
  them (``repro.core``) with the draws replayed, within rtol 1e-6 (see
  RATE_RTOL); the theorem rates exactly equal.
* The entry point: ``python -m repro_torch.paper`` refuses to run without
  a card unless ``--device cpu`` is given.
"""
import dataclasses
import functools
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jcm
from benchmarks import fig1_smooth as jfig1
from benchmarks import fig2_nonsmooth as jfig2
from benchmarks import table3_complexity as jtable3
from repro import api as japi
from repro.core import theory as jtheory
from repro_torch import api as tapi
from repro_torch.core import theory as ttheory
from repro_torch.core.draws import ReplayDraws
from repro_torch.paper import __main__ as paper_main
from repro_torch.paper import common as tcm
from repro_torch.paper import fig1_smooth as tfig1
from repro_torch.paper import fig2_nonsmooth as tfig2
from repro_torch.paper import table3_complexity as ttable3
from repro_torch.paper.problems import ridge_problem as t_ridge
from tests.problems import ridge_problem as j_ridge
from tests.test_torch_baselines import init_draws, run_keys, step_draws

SMALL = {"n_per_node": 30}
STEPS = 60
SOLVE_ITERS = 2000
SERIES_RTOL = 1e-9
# Table 3's C = 0 row converges fastest: after 400 steps X - X* is ~5e-9 a
# element while the two packages' per-step f64 differences have added up
# to ~2.5e-12 along the node average, which mixing does not contract;
# measured 1.2e-7 relative in rho (the other rows 5e-16)
RATE_RTOL = 1e-6


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


# --- theory -----------------------------------------------------------------------

CONSTANTS = list(itertools.product(
    (0.005, 0.1), (0.5, 4.0), (0.8, 1.5), (0.05, 0.3), (0.0, 0.5, 4.0),
    (1, 15)))


def _same(name, tp, jp, *args):
    """``theory.<name>`` gives the reference's value, or both refuse the
    constants (the reference asserts feasibility)."""
    try:
        want = getattr(jtheory, name)(jp, *args)
    except AssertionError:
        with pytest.raises(AssertionError):
            getattr(ttheory, name)(tp, *args)
        return None
    got = getattr(ttheory, name)(tp, *args)
    assert got == want, name
    return got


@pytest.mark.parametrize("mu,L,lmax,lmin,C,m", CONSTANTS)
def test_theory_matches_reference(mu, L, lmax, lmin, C, m):
    tp = ttheory.ProblemConstants(mu, L, lmax, lmin, C=C, m=m)
    jp = jtheory.ProblemConstants(mu, L, lmax, lmin, C=C, m=m)
    assert (tp.kappa_f, tp.kappa_g) == (jp.kappa_f, jp.kappa_g)
    assert ttheory.delta(0.3, C) == jtheory.delta(0.3, C)
    params = _same("theorem5_params", tp, jp)
    if params is not None:
        _same("theorem5_rate", tp, jp, *params)
    _same("theorem5_params", tp, jp, 0.5 / (2 * L))
    p8 = ttheory.theorem8_params(tp)
    assert p8 == jtheory.theorem8_params(jp)
    assert ttheory.theorem8_rate(tp, p8[-1]) == jtheory.theorem8_rate(
        jp, p8[-1])
    assert ttheory.theorem9_rate(tp) == jtheory.theorem9_rate(jp)
    for variant in ("full", "lsvrg", "saga"):
        assert ttheory.iteration_complexity(tp, 1e-6, variant) == \
            jtheory.iteration_complexity(jp, 1e-6, variant)
    with pytest.raises(ValueError):
        ttheory.iteration_complexity(tp, 1e-6, "sag")


def test_logreg_constants_match_reference():
    A = np.random.default_rng(0).normal(size=(8, 15, 10, 784))
    assert ttheory.logreg_constants(A, 0.005) == \
        jtheory.logreg_constants(A, 0.005)


# --- the harness at a small size ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _problems():
    jprob = jcm.flat_logreg(**SMALL)
    tprob = tcm.flat_logreg(device="cpu", **SMALL)
    return jprob, tprob


@functools.lru_cache(maxsize=None)
def _xstar(lam1):
    jprob, tprob = _problems()
    return (jcm.solve_reference(jprob, lam1=lam1, iters=SOLVE_ITERS),
            tcm.solve_reference(tprob, lam1=lam1, iters=SOLVE_ITERS))


@pytest.mark.parametrize("lam1", [0.0, 0.005])
def test_solve_reference_and_estimate_L_match(lam1):
    jprob, tprob = _problems()
    np.testing.assert_array_equal(tprob.data["A"].numpy(),
                                  np.asarray(jprob.data["A"]))
    want, got = _xstar(lam1)
    assert got.dtype == np.float64 and got.shape == (tcm.DIM,)
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())
    if lam1:
        assert ((got == 0) == (want == 0)).all()   # the same exact zeros
    assert tcm.estimate_L(tprob) == jcm.estimate_L(jprob)


def _small(spec):
    return dataclasses.replace(spec, oracle=dataclasses.replace(
        spec.oracle, problem_params=SMALL))


FIGS = {"fig1": (tfig1, jfig1, 0.0), "fig2": (tfig2, jfig2, tfig2.LAM1)}
#: (figure, row index) of every row; the labels need no data
ROWS = [(fig, i) for fig, (ft, _, _) in FIGS.items()
        for i in range(len(ft.cells(STEPS, 0.1, 0.05)))]


@functools.lru_cache(maxsize=None)
def _grids(fig):
    """(port rows, reference rows) at the small problem's 1/(2L), 1/(6L)."""
    ft, fj, _ = FIGS[fig]
    L = jcm.estimate_L(_problems()[0])
    eta, eta_s = 1.0 / (2 * L), 1.0 / (6 * L)
    return ft.cells(STEPS, eta, eta_s), fj.cells(STEPS, eta, eta_s)


@pytest.mark.parametrize("fig", sorted(FIGS))
def test_grids_are_the_reference_grids(fig):
    tc, jc = _grids(fig)
    assert len(tc) == len(jc) == {"fig1": 13, "fig2": 11}[fig]
    for (tl, ts), (jl, js) in zip(tc, jc, strict=True):
        assert tl == jl
        assert json.loads(ts.to_json()) == json.loads(js.to_json()), tl


@pytest.mark.parametrize("fig,i", ROWS, ids=[
    f"{fig}-{FIGS[fig][0].cells(STEPS, 0.1, 0.05)[i][0]}"
    for fig, i in ROWS])
def test_paper_row_matches_reference_serial_run(fig, i):
    tc, jc = _grids(fig)
    label, tspec = tc[i]
    jspec, tspec = _small(jc[i][1]), _small(tspec)
    xstar, _ = _xstar(FIGS[fig][2])
    runner = japi.build(jspec)
    Xs = jnp.broadcast_to(jnp.asarray(xstar), runner.X0.shape)

    def subopt(st, t=None):
        return float(jnp.sum((st.X - Xs) ** 2))

    st, want = runner.run(num_steps=STEPS, key=jspec.seed, log_every=25,
                          callback=subopt)
    want.append(subopt(st))           # the last step, as run_alg logs it
    k0, subs = run_keys(jspec.seed, STEPS)
    flat = init_draws(runner.algo, k0) + [
        a for sub in subs for a in step_draws(runner.algo, runner.X0, sub)]
    rd = ReplayDraws(flat, "cpu")
    got, wall = tcm.run_cell(label, tspec, xstar, STEPS, device="cpu",
                             draws=rd)
    assert not rd.pending and wall > 0
    assert len(got) == len(tcm._log_indices(STEPS, 25)) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=SERIES_RTOL)
    assert tcm._bits(tspec.compressor.build(), tspec.oracle.name) == \
        jcm._bits(jspec.compressor.build(), jspec.oracle.name)


@pytest.mark.parametrize("fig", ["fig1", "fig2"])
def test_validate_matches_reference(fig):
    """The same rows give the same claim texts, verdicts and details."""
    tmod, jmod = {"fig1": (tfig1, jfig1), "fig2": (tfig2, jfig2)}[fig]
    rng = np.random.default_rng(0)
    for trial in range(20):
        rows = []
        for label, _ in jmod.cells(STEPS, 0.1, 0.05):
            sub = list(10.0 ** rng.uniform(-12, 1, size=6))
            rows.append({"name": label, "final_subopt": sub[-1],
                         "subopt": sub,
                         "bits_per_iter": float(rng.choice([16864.0,
                                                            250880.0]))})
        assert tmod.validate(rows) == jmod.validate(rows)


def test_run_cells_averages_seeds():
    """seeds = 2: each row runs at seeds s and s + 1 and the curve is their
    mean; bits and gradient evaluations from the spec."""
    _, tprob = _problems()
    xstar = _xstar(0.0)[1]
    spec = _small(tcm.paper_cell("choco", eta=0.1, steps=10,
                                 compressor=tcm.Q2_SPEC,
                                 params={"gamma_c": 0.2}, seed=4))
    [r] = tcm.run_cells([("Choco (2bit)", spec)], xstar, 10, log_every=4,
                        seeds=2, device="cpu")
    a, _ = tcm.run_cell("x", spec, xstar, 10, log_every=4, device="cpu")
    b, _ = tcm.run_cell("x", dataclasses.replace(spec, seed=5), xstar, 10,
                        log_every=4, device="cpu")
    np.testing.assert_allclose(r.subopt, (np.array(a) + np.array(b)) / 2,
                               rtol=1e-12)
    row = r.row()
    assert row["iters"] == 10 and len(row["subopt"]) == 4     # 0, 4, 8, 9
    assert row["bits_per_iter"] == 31 * (256 * 2 + 32)
    assert row["grad_evals_per_iter"] == 15.0 and row["ms_per_step"] > 0


# --- Table 3 ------------------------------------------------------------------

def _reference_table3_measure(alg, X0, Xs, K, seed=0):
    """The reference script's ``measure`` (keys, jitted step), returning
    the draws it made in the port's call order."""
    k0, subs = run_keys(seed, K)
    st = alg.init(X0, k0)
    draws = init_draws(alg, k0)
    step = jax.jit(alg.step)
    s0 = float(jnp.sum((st.X - Xs) ** 2))
    for sub in subs:
        draws += step_draws(alg, X0, sub)
        st = step(st, sub)
    sK = float(jnp.sum((st.X - Xs) ** 2))
    return (max(sK, 1e-300) / s0) ** (1 / K), draws


def test_table3_rates_match_reference():
    from repro.core import compression as jC
    from repro.core import oracles as joracles
    from repro.core import prox_lead as jpl
    from repro.core import topology as jT
    from repro.core.comm import DenseMixer as JMixer
    jprob, xstar, mu, L, X0 = j_ridge()
    tprob, txstar, tmu, tL, tX0 = t_ridge()
    np.testing.assert_array_equal(txstar, xstar)
    assert (tmu, tL) == (mu, L)
    topo = jT.ring(jprob.n)
    mixer = JMixer(topo.W)
    Xs = jnp.broadcast_to(jnp.asarray(xstar), X0.shape)
    rows, tX0, tXs = ttable3.experiments(device="cpu")
    assert [r.steps for r in rows] == [400, 400, 1500, 1500]
    jalgs = []
    for Cq, bits in [(0.0, None), (0.5, 4)]:                 # as jtable3.run
        pc = jtheory.ProblemConstants(mu, L, topo.lambda_max,
                                      topo.lambda_min_pos, C=Cq, m=jprob.m)
        eta, alpha, gamma = jtheory.theorem5_params(pc)
        rho, _ = jtheory.theorem5_rate(pc, eta, alpha, gamma)
        comp = jC.Identity() if bits is None else jC.QInf(bits=bits, block=64)
        jalgs.append((jpl.lead(eta, alpha, gamma, comp, mixer,
                               joracles.FullGradient(jprob)), rho))
    for orc_name, thm in [("lsvrg", "thm8"), ("saga", "thm9")]:
        pc = jtheory.ProblemConstants(mu, L, topo.lambda_max,
                                      topo.lambda_min_pos, C=0.5, m=jprob.m)
        eta, alpha, gamma, p = jtheory.theorem8_params(pc)
        rho = (jtheory.theorem8_rate(pc, p) if thm == "thm8"
               else jtheory.theorem9_rate(pc))
        jalgs.append((jpl.lead(eta, alpha, gamma, jC.QInf(bits=4, block=64),
                               mixer, joracles.make_oracle(orc_name, jprob)),
                      rho))
    for row, (jalg, rho) in zip(rows, jalgs, strict=True):
        assert row.rho_theory == rho, row.name
        want, draws = _reference_table3_measure(jalg, X0, Xs, row.steps)
        rd = ReplayDraws(draws, "cpu")
        _, _, got = ttable3.measure(row.alg, tX0, tXs, row.steps, rd)
        assert not rd.pending
        np.testing.assert_allclose(got, want, rtol=RATE_RTOL,
                                   err_msg=row.name)
        assert got <= rho + 1e-3
    assert [r.name for r in rows] == ["Theorem5 (C=0.0)", "Theorem5 (C=0.5)",
                                      "THM8 (lsvrg)", "THM9 (saga)"]
    fake = [{"name": r.name, "rho_measured": 0.5, "rho_theory": r.rho_theory,
             "ok": bool(i % 2)} for i, r in enumerate(rows)]
    assert ttable3.validate(fake) == jtable3.validate(fake)


# --- the entry point -----------------------------------------------------------

def test_main_runs_table3_on_cpu(capsys, tmp_path):
    out = tmp_path / "paper.json"
    assert paper_main.main(["--only", "table3", "--device", "cpu",
                            "--json-out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "device: cpu, f64" in text and "4/4 claims validated" in text
    assert text.count("[PASS]") == 4
    saved = json.loads(out.read_text())
    assert saved["dtype"] == "float64" and len(saved["rows"]["table3"]) == 4


def test_main_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paper_main.main(["--only", "table3"])
    with pytest.raises(SystemExit):
        paper_main.main(["--only", "fig9", "--device", "cpu"])


def test_flat_logreg_is_the_registered_problem_in_f64():
    _, tprob = _problems()
    spec = _small(tcm.paper_cell("lead", eta=0.1, steps=1))
    runner = tapi.build(spec, device="cpu", dtype=tcm.DTYPE)
    assert runner.X0.dtype == torch.float64 and runner.X0.shape == (8, 7840)
    for k in ("A", "Y"):
        assert torch.equal(runner.problem.data[k], tprob.data[k])
