"""The port's core modules against the JAX package on the same inputs:
topologies, payload accounting, proxes, COMM with replayed noise, and the
oracles with replayed indices and coins.

Inputs are numpy arrays made from a seed and handed to both packages; the
reference's random draws are recomputed with ``jax.random`` exactly as the
reference makes them and replayed into the port (``ReplayDraws``).  f64
throughout (``conftest`` enables x64): tolerances are stated per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import registry as jreg
from repro.core import comm as jcomm
from repro.core import compression as jC
from repro.core import oracles as joracles
from repro.core import prox as jprox
from repro.core import topology as jtopo
from repro.data import synthetic as _jsyn  # noqa: F401  (registers problems)
from repro.kernels import ops as jkops
from repro.netsim import metrics as jmetrics
from repro_torch import registry as treg
from repro_torch.core import comm as tcomm
from repro_torch.core import compression as tC
from repro_torch.core import oracles as toracles
from repro_torch.core import prox as tprox
from repro_torch.core import topology as ttopo
from repro_torch.core.draws import GeneratorDraws, ReplayDraws
from repro_torch.data import synthetic as _tsyn  # noqa: F401
from repro_torch.netsim import metrics as tmetrics

F64 = torch.float64


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


# --- topology ---------------------------------------------------------------

@pytest.mark.parametrize("name,n,kw", [
    ("ring", 1, {}), ("ring", 2, {}), ("ring", 3, {}), ("ring", 8, {}),
    ("ring", 8, {"self_weight": 0.5}), ("fully_connected", 5, {}),
    ("star", 6, {}), ("torus2d", 8, {}), ("torus2d", 9, {}),
    ("torus2d", 12, {"rows": 3}), ("exponential", 5, {}),
    ("exponential", 8, {}), ("expander", 8, {}),
    ("expander", 16, {"degree": 6})])
def test_topology_W_equal(name, n, kw):
    tj = jtopo.make_topology(name, n, **kw)
    tt = ttopo.make_topology(name, n, **kw)
    np.testing.assert_array_equal(tt.W, tj.W)
    assert tt.neighbors == tj.neighbors and tt.name == tj.name
    if n > 1:
        tt.validate()
        assert tt.kappa_g == tj.kappa_g


def test_registries_strict_and_mirrored():
    import repro_torch.netsim  # noqa: F401  (registers schedules, faults)
    from repro import netsim as _jnetsim  # noqa: F401
    for kind in ("compressor", "prox", "oracle", "topology", "schedule",
                 "fault", "algorithm", "problem", "engine"):
        assert set(treg.names(kind)) <= set(jreg.names(kind)), kind
    for kind in ("prox", "topology", "schedule", "fault"):
        assert set(treg.names(kind)) == set(jreg.names(kind)), kind
    with pytest.raises(ValueError, match="unknown compressor 'zip'"):
        treg.make("compressor", "zip")
    with pytest.raises(ValueError, match="does not accept"):
        treg.make("compressor", "qinf", bitz=2)
    with pytest.raises(ValueError, match="unknown registry kind"):
        treg.names("gremlin")


# --- compression accounting -------------------------------------------------

@pytest.mark.parametrize("shape,block,bits", [
    ((1024,), 256, 2), ((300,), 256, 2), ((3, 300), 256, 2),
    ((7, 13, 5), 8, 2), ((8, 256), 256, 2), ((784, 10), 256, 1),
    ((7840,), 256, 4), ((), 256, 2)])
def test_payload_bits_equal(shape, block, bits):
    pj = jC.QInf(bits=bits, block=block).payload_bits(shape)
    pt = tC.QInf(bits=bits, block=block).payload_bits(shape)
    assert isinstance(pt, int) and pt == pj
    assert tC.Identity().payload_bits(shape) == jC.Identity().payload_bits(
        shape)
    assert tC.QInf(bits=bits, block=block).C == jC.QInf(bits=bits,
                                                        block=block).C


def test_payload_bits_per_node_and_consensus():
    rng = np.random.default_rng(0)
    X = {"a": rng.normal(size=(8, 5, 3)), "b": rng.normal(size=(8, 300))}
    for jc, tc in ((jC.QInf(bits=2, block=4), tC.QInf(bits=2, block=4)),
                   (jC.Identity(), tC.Identity()), (None, None)):
        assert tmetrics.payload_bits_per_node(
            tc, {k: _t(v) for k, v in X.items()}) == \
            jmetrics.payload_bits_per_node(jc, X)
    np.testing.assert_allclose(
        float(tmetrics.consensus_error({k: _t(v) for k, v in X.items()})),
        float(jmetrics.consensus_error(X)), rtol=1e-13)


# --- prox ---------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("none", {}), ("l1", {"lam": 0.7}), ("l2sq", {"lam": 0.3}),
    ("elastic_net", {"lam1": 0.5, "lam2": 0.2}),
    ("group_lasso", {"lam": 0.9}), ("nonneg", {})])
def test_prox_parity(name, kw):
    """Closed forms, elementwise or rowwise: agree to 1e-14 relative."""
    x = np.random.default_rng(3).normal(size=(4, 6, 5))
    x[0, 0] = 0.0
    pj, pt = jprox.make_prox(name, **kw), tprox.make_prox(name, **kw)
    for eta in (0.05, 0.8):
        np.testing.assert_allclose(pt(_t(x), eta).numpy(),
                                   np.asarray(pj(jnp.asarray(x), eta)),
                                   rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(float(pt.value(_t(x))),
                               float(pj.value(jnp.asarray(x))), rtol=1e-14)
    tree = {"p": _t(x), "q": _t(x[0])}
    np.testing.assert_allclose(
        float(pt.tree_value(tree)),
        float(pj.tree_value({"p": jnp.asarray(x), "q": jnp.asarray(x[0])})),
        rtol=1e-14)


# --- COMM ---------------------------------------------------------------------

def reference_comm_draws(Z, H, compressor, key):
    """The noise the reference's comm() draws: one key per leaf from
    ``split(key, n_leaf)``, then ``uniform`` over the (R, block) tile for
    2-D leaves whose last dim is one block, else over the blocked shape."""
    leaves = jax.tree_util.tree_leaves(Z)
    hl = jax.tree_util.tree_leaves(H)
    keys = jax.random.split(key, len(leaves))
    out = []
    for z, h, k in zip(leaves, hl, keys):
        x = z - h
        if x.ndim == 2 and x.shape[-1] == compressor.block:
            shape = x.shape
        else:
            shape = jkops.blockwise_lastdim(x, block=compressor.block).shape
        out.append(np.asarray(jax.random.uniform(k, shape, jnp.float32)))
    return out


@pytest.mark.parametrize("cname", ["qinf", "identity"])
def test_comm_parity_replayed_noise(cname):
    """One COMM round on a 3-leaf tree (a 3-D leaf, a 2-D leaf of exactly
    one block -- the reference's Pallas route -- and a ragged 2-D leaf):
    Zhat, Zhat_w, H, Hw agree to 1e-13 relative (f64 mixing sums)."""
    rng = np.random.default_rng(1)
    shapes = {"a": (8, 5, 3), "b": (8, 3), "c": (8, 10)}
    Z = {k: rng.normal(size=s) for k, s in shapes.items()}
    H = {k: rng.normal(size=s) * 0.5 for k, s in shapes.items()}
    Hw = {k: rng.normal(size=s) * 0.5 for k, s in shapes.items()}
    W = jtopo.ring(8).W
    jc = jC.make_compressor(cname, **({"bits": 2, "block": 3}
                                      if cname == "qinf" else {}))
    tc = tC.make_compressor(cname, **({"bits": 2, "block": 3}
                                      if cname == "qinf" else {}))
    key = jax.random.key(7)
    jz = jax.tree_util.tree_map(jnp.asarray, Z)
    jh = jax.tree_util.tree_map(jnp.asarray, H)
    out_j = jcomm.comm(jz, jcomm.CommState(jh, jax.tree_util.tree_map(
        jnp.asarray, Hw)), 0.5, jc, key, jcomm.DenseMixer(W))
    draws = ReplayDraws(reference_comm_draws(jz, jh, jc, key)
                        if cname == "qinf" else [], "cpu")
    tt = lambda d: {k: _t(v) for k, v in d.items()}
    out_t = tcomm.comm(tt(Z), tcomm.CommState(tt(H), tt(Hw)), 0.5, tc,
                       draws, tcomm.DenseMixer(W))
    assert not draws.pending
    for a, b in zip(jax.tree_util.tree_leaves(out_j),
                    [l for part in (out_t[0], out_t[1], out_t[2].H,
                                    out_t[2].Hw) for l in
                     (part["a"], part["b"], part["c"])]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-13,
                                   atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_exact_stochastic_matches_reference(dtype):
    for W in (jtopo.ring(8).W, jtopo.exponential(6).W, jtopo.star(5).W):
        Wt = tcomm._exact_stochastic(W, dtype)
        Wj = np.asarray(jcomm._exact_stochastic(
            W, jnp.float64 if dtype == F64 else jnp.float32))
        np.testing.assert_array_equal(Wt, Wj)
        off = Wt - np.diag(np.diag(Wt))
        np.testing.assert_array_equal(off, off.T)
        np.testing.assert_array_equal(np.diag(Wt), (1.0 - off.sum(axis=1))
                                      .astype(Wt.dtype))


# --- oracles ------------------------------------------------------------------

PROBLEM = dict(n_features=8, n_classes=3, n_per_node=8, n_batches=2)


@pytest.fixture(scope="module")
def problems():
    pj, _ = jreg.make("problem", "logreg2d", n_nodes=8, **PROBLEM)
    pt, X0 = treg.make("problem", "logreg2d", n_nodes=8, device="cpu",
                       dtype=F64, **PROBLEM)
    X = np.random.default_rng(5).normal(size=tuple(X0.shape)) * 0.3
    return pj, pt, X


def test_problem_data_identical(problems):
    pj, pt, _ = problems
    for k in ("A", "Y"):
        np.testing.assert_array_equal(pt.data[k].numpy(),
                                      np.asarray(pj.data[k]))


def _close(t, j):
    # closed-form gradient vs jax.grad: agree to 1e-12 relative in f64
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                               atol=1e-14)


def test_full_and_sgd_oracles(problems):
    pj, pt, X = problems
    Gj, _ = joracles.FullGradient(pj).sample(jnp.asarray(X), None, None)
    Gt, _ = toracles.make_oracle("full", pt).sample(_t(X), None, None)
    _close(Gt, Gj)
    np.testing.assert_allclose(float(pt.full_loss(_t(X))),
                               float(pj.full_loss(jnp.asarray(X))),
                               rtol=1e-13)
    key = jax.random.key(3)
    Gj, _ = joracles.SGD(pj).sample(jnp.asarray(X), None, key)
    ls = np.asarray(jax.random.randint(key, (pj.n,), 0, pj.m))
    Gt, _ = toracles.make_oracle("sgd", pt).sample(
        _t(X), None, ReplayDraws([ls], "cpu"))
    _close(Gt, Gj)


@pytest.mark.parametrize("p_update", [0.0, 1.0])
def test_lsvrg_oracle(problems, p_update):
    pj, pt, X = problems
    X0 = np.zeros_like(X)
    oj = joracles.LSVRG(pj, prob_update=p_update)
    ot = toracles.make_oracle("lsvrg", pt, prob_update=p_update)
    sj, st = oj.init(jnp.asarray(X0)), ot.init(_t(X0))
    _close(st.ref_grad, sj.ref_grad)
    key = jax.random.key(11)
    Gj, sj2 = oj.sample(jnp.asarray(X), sj, key)
    k_l, k_b = jax.random.split(key)
    draws = [np.asarray(jax.random.randint(k_l, (pj.n,), 0, pj.m)),
             np.asarray(jax.random.bernoulli(k_b, p_update))]
    Gt, st2 = ot.sample(_t(X), st, ReplayDraws(draws, "cpu"))
    _close(Gt, Gj)
    _close(st2.ref, sj2.ref)
    _close(st2.ref_grad, sj2.ref_grad)


def test_saga_oracle(problems):
    pj, pt, X = problems
    oj, ot = joracles.SAGA(pj), toracles.make_oracle("saga", pt)
    sj, st = oj.init(jnp.asarray(X * 0.5)), ot.init(_t(X * 0.5))
    _close(st.ref, sj.ref)
    _close(st.ref_grad, sj.ref_grad)
    for seed in (0, 1, 2):
        key = jax.random.key(seed)
        Gj, sj = oj.sample(jnp.asarray(X), sj, key)
        ls = np.asarray(jax.random.randint(key, (pj.n,), 0, pj.m))
        Gt, st = ot.sample(_t(X), st, ReplayDraws([ls], "cpu"))
        _close(Gt, Gj)
        _close(st.ref, sj.ref)
        _close(st.ref_grad, sj.ref_grad)


# --- draw sources -------------------------------------------------------------

def test_replay_checks_each_pop():
    d = ReplayDraws([np.array([0, 1]), np.zeros((2, 3), np.float32)], "cpu")
    with pytest.raises(ValueError):
        d.randint(3, 4)                       # wrong length
    with pytest.raises(ValueError):
        d.uniform((4, 4))                     # wrong element count
    with pytest.raises(IndexError):
        d.bernoulli(0.5)                      # exhausted
    g = GeneratorDraws(0, "cpu")
    assert g.randint(8, 3).shape == (8,) and g.uniform((2, 5)).dtype == \
        torch.float32
    assert torch.equal(GeneratorDraws(4, "cpu").uniform((3,)),
                       GeneratorDraws(4, "cpu").uniform((3,)))
