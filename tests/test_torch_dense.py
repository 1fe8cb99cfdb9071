"""The port's dense Prox-LEAD path against the JAX package, and alone.

* Teacher-forced per-step parity: the reference's state at step k crosses
  to the port (``repro_torch.convert``), the port takes one step with the
  draws the reference made for that step, and the result is held against
  the reference's step k+1.  Each step starts from the reference's state,
  so a rare last-ulp flip of a quantization code cannot compound.
* A short free-running trajectory: both packages run the golden spec from
  one seed, the reference's draws replayed into the port.
* The port alone: linear convergence to the exact optimum under 2-bit and
  1-bit QInf, as ``tests/test_prox_lead_convex.py`` claims for the
  reference.

f64 throughout (``conftest`` enables x64 for the reference).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels import ops as jkops
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import compression as tC
from repro_torch.core import oracles as toracles
from repro_torch.core import prox as tprox
from repro_torch.core import prox_lead as tpl
from repro_torch.core import topology as ttopo
from repro_torch.core.comm import DenseMixer
from repro_torch.core.draws import GeneratorDraws, ReplayDraws
from tests.problems import ridge_problem

GOLDEN = pathlib.Path(__file__).parent / "golden_specs"
F64 = torch.float64
# one step from the same state: both packages do the same f64 arithmetic up
# to summation order (BLAS vs XLA dots, jax.grad vs the closed form), and
# the f32 quantizer input rounds identically, so states agree to ~1e-15
STEP_RTOL, STEP_ATOL = 1e-10, 1e-12


# --- the reference's draws ------------------------------------------------------

def oracle_draws(oracle, key):
    """What the reference oracle's ``sample`` draws from ``key``."""
    p = oracle.problem
    if oracle.name in ("sgd", "saga"):
        return [np.asarray(jax.random.randint(key, (p.n,), 0, p.m))]
    if oracle.name == "lsvrg":
        k_l, k_b = jax.random.split(key)
        return [np.asarray(jax.random.randint(k_l, (p.n,), 0, p.m)),
                np.asarray(jax.random.bernoulli(k_b, oracle.p_update))]
    return []


def comm_draws(compressor, X, key):
    """The noise the reference's comm() draws for leaves shaped like X."""
    leaves = jax.tree_util.tree_leaves(X)
    if not hasattr(compressor, "block"):           # Identity draws nothing
        return []
    keys = jax.random.split(key, len(leaves))
    out = []
    for x, k in zip(leaves, keys):
        if x.ndim == 2 and x.shape[-1] == compressor.block:
            shape = x.shape                           # its Pallas route
        else:
            shape = jkops.blockwise_lastdim(x, block=compressor.block).shape
        out.append(np.asarray(jax.random.uniform(k, shape, jnp.float32)))
    return out


def step_draws(algo, state, sub):
    """ProxLEAD.step(state, sub) splits sub into (k_g, k_c)."""
    k_g, k_c = jax.random.split(sub)
    return oracle_draws(algo.oracle, k_g) + comm_draws(algo.compressor,
                                                       state.X, k_c)


def reference_run(spec, steps):
    """DenseRunner.run's key discipline, keeping every state and the draws
    of every step: -> (runner, [state_0 .. state_steps], [init draws,
    step-1 draws, ...])."""
    runner = japi.build(spec)
    algo = runner.algo
    key = jax.random.key(spec.seed)
    k0, key = jax.random.split(key)
    st = algo.init(runner.X0, k0)
    states, draws = [st], [oracle_draws(algo.oracle, k0)]
    for _ in range(steps):
        key, sub = jax.random.split(key)
        draws.append(step_draws(algo, st, sub))
        st = runner.step(st, sub)
        states.append(st)
    return runner, states, draws


def as_arrays(st):
    a = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"X": a(st.X), "D": a(st.D), "comm.H": a(st.comm.H),
            "comm.Hw": a(st.comm.Hw), "oracle.kind": np.asarray(st.oracle.kind),
            "oracle.ref": a(st.oracle.ref),
            "oracle.ref_grad": a(st.oracle.ref_grad), "k": np.asarray(st.k)}


def assert_states_close(port_state, ref_state, rtol, atol):
    got, want = convert.state_to_arrays(port_state), as_arrays(ref_state)
    for k in convert.KEYS:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=rtol, atol=atol, err_msg=k)


QUICKSTART = japi.ExperimentSpec(
    name="quickstart-small", n_nodes=8, steps=6,
    algorithm=japi.AlgorithmSpec("prox_lead", eta=japi.constant(0.05),
                                 alpha=japi.constant(0.5),
                                 gamma=japi.constant(1.0)),
    compressor=japi.CompressorSpec("qinf", {"bits": 2, "block": 256}),
    topology=japi.TopologySpec(graph="ring"),
    prox=japi.ProxSpec("l1", {"lam": 0.005}),
    oracle=japi.OracleSpec(name="saga", problem="logreg",
                           problem_params={"n_features": 784,
                                           "n_classes": 10, "n_per_node": 30,
                                           "n_batches": 15, "lam2": 0.005}))

CASES = {
    "golden-prox-lead-saga": (lambda: japi.ExperimentSpec.load(
        GOLDEN / "prox_lead_dense_ring_qinf2.json"), 12),
    "golden-lead-harmonic-sgd": (lambda: japi.ExperimentSpec.load(
        GOLDEN / "lead_diminishing_harmonic.json"), 6),
    "quickstart-784x10": (lambda: QUICKSTART, 5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_teacher_forced_step_parity(case):
    make, steps = CASES[case]
    jspec = make()
    runner_j, states, draws = reference_run(jspec, steps)
    runner_t = tapi.build(tapi.ExperimentSpec.from_json(jspec.to_json()),
                          device="cpu", dtype=F64)
    np.testing.assert_array_equal(runner_t.X0.numpy(),
                                  np.asarray(runner_j.X0))
    # init from X0 with the reference's init draw
    st0 = runner_t.init_state(ReplayDraws(draws[0], "cpu"))
    assert_states_close(st0, states[0], STEP_RTOL, STEP_ATOL)
    for k in range(steps):
        port_in = convert.state_from_arrays(as_arrays(states[k]),
                                            device="cpu", dtype=F64)
        rd = ReplayDraws(draws[k + 1], "cpu")
        port_out = runner_t.step(port_in, rd)
        assert not rd.pending, "the port drew less than the reference"
        assert port_out.k == int(states[k + 1].k)
        assert_states_close(port_out, states[k + 1], STEP_RTOL, STEP_ATOL)


def test_free_running_trajectory_golden():
    """30 steps of the golden spec in both packages from one seed, the
    reference's draws replayed in the port's call order: X after the run
    agrees to 1e-9 relative (per-step f64 differences of ~1e-15 may
    compound; a quantization code flip would show as ~1e-2)."""
    jspec = japi.ExperimentSpec.load(GOLDEN / "prox_lead_dense_ring_qinf2.json")
    _, states, draws = reference_run(jspec, 30)
    runner_t = tapi.build(tapi.ExperimentSpec.from_json(jspec.to_json()),
                          device="cpu", dtype=F64)
    flat = [a for step in draws for a in step]
    rd = ReplayDraws(flat, "cpu")
    st, _ = runner_t.run(num_steps=30, draws=rd)
    assert not rd.pending
    np.testing.assert_allclose(st.X.numpy(), np.asarray(states[-1].X),
                               rtol=1e-9, atol=1e-11)
    rep = runner_t.last_report
    assert rep.steps == 30 and rep.device == "cpu"
    assert rep.bits_per_step == japi.build(jspec).bits_per_step()


# --- the port alone -----------------------------------------------------------

@pytest.fixture(scope="module")
def ridge():
    prob, xstar, mu, L, _ = ridge_problem()
    A = torch.from_numpy(np.array(prob.data["A"]))
    b = torch.from_numpy(np.array(prob.data["b"]))
    lam2 = 0.1

    def grad_batches(X, batch):          # X (n, p); batch A (n, k, bs, p)
        r = batch["A"] @ X[:, None, :, None] - batch["b"][..., None]
        return (batch["A"].transpose(-1, -2) @ r)[..., 0] \
            / batch["A"].shape[-2] + lam2 * X[:, None]

    tprob = toracles.FiniteSumProblem(grad_batches, {"A": A, "b": b},
                                      prob.n, prob.m)
    return tprob, xstar, L, torch.zeros((prob.n, A.shape[-1]), dtype=F64)


def _run(alg, X0, steps, seed=0):
    draws = GeneratorDraws(seed, "cpu")
    st = alg.init(X0, draws)
    for _ in range(steps):
        st = alg.step(st, draws)
    return st


def _subopt(st, xstar):
    return float(((st.X - torch.from_numpy(np.asarray(xstar))) ** 2).sum())


@pytest.mark.parametrize("bits,alpha,gamma,steps,tol", [
    (2, 0.5, 0.5, 800, 1e-10), (1, 0.4, 0.3, 1500, 1e-8)])
def test_port_linear_convergence_qinf(ridge, bits, alpha, gamma, steps, tol):
    """LEAD with full gradients and b-bit QInf reaches the exact ridge
    optimum (the reference's claim, same step sizes and step counts)."""
    prob, xstar, L, X0 = ridge
    alg = tpl.lead(1 / (2 * L), alpha, gamma, tC.QInf(bits=bits, block=64),
                   DenseMixer(ttopo.ring(prob.n).W),
                   toracles.FullGradient(prob))
    st = _run(alg, X0, steps)
    assert _subopt(st, xstar) < tol
    cons = float(((st.X - st.X.mean(0)) ** 2).sum())
    assert cons < 1e-12


def test_port_prox_lead_lasso_2bit(ridge):
    """Composite case: Prox-LEAD with the L1 prox reaches the lasso
    optimum (computed here by centralized proximal gradient) and its exact
    zeros."""
    prob, _, L, X0 = ridge
    lam1, lam2 = 0.05, 0.1
    A = prob.data["A"].numpy()
    b = prob.data["b"].numpy()
    n, m, bs, p = A.shape
    AA = np.einsum("nmbp,nmbq->pq", A, A) / (m * bs) / n + lam2 * np.eye(p)
    Ab = np.einsum("nmbp,nmb->p", A, b) / (m * bs) / n
    x = np.zeros(p)
    for _ in range(20000):
        z = x - (AA @ x - Ab) / L
        x = np.sign(z) * np.maximum(np.abs(z) - lam1 / L, 0.0)
    alg = tpl.ProxLEAD(1 / (2 * L), 0.5, 0.5, tC.QInf(bits=2, block=64),
                       tprox.L1(lam=lam1), DenseMixer(ttopo.ring(n).W),
                       toracles.FullGradient(prob))
    st = _run(alg, X0, 2500)
    assert _subopt(st, x) < 1e-8
    assert int((st.X[0] == 0).sum()) == int((np.abs(x) < 1e-12).sum())
