"""The port's dense model and decentralized trainer against the JAX package,
and its two gossip backends against each other.

* Model: node-stacked ``forward`` + ``loss_fn`` and the gradient of the
  summed node losses against ``repro.models.transformer`` under
  ``jax.vmap``/``jax.grad`` (qwen3-1.7b reduced to 2 layers, d_model 64;
  the same weights carried across by ``repro_torch.convert``), f64 and
  f32.  Both packages compute RMSNorm statistics, RoPE and the attention
  scores in f32 even for an f64 model (and the reference then scales and
  softmaxes the scores in f64 under x64), so an f64 model agrees to f32
  accuracy: measured ~8e-7 relative to each array's largest entry, bound
  5e-6 (f64) and 1e-5 (f32).
* Trainer step, teacher-forced: the reference's dense backend
  (``DecentralizedTrainer.train_step``, golden ``trainer_dense_qinf2``)
  and the port's start every step from the reference's state (crossed by
  ``convert``), with the same batch arrays and the reference's noise
  replayed.  X, D, H and Hw agree within 1e-5 of each array's largest
  entry on all but 0.1 % of elements: the gradients agree to f32
  accuracy (above), and where a stochastic-rounding argument sits within
  that distance of an integer the 2-bit code flips by one level.
* Neighbor against dense, within the port: one step each from the same
  state with the same noise (the neighbor backend quantizes a leaf whose
  even last dim is below the block at its own width; the dense backend's
  noise is cut to that width, which leaves every code the same), on a
  ring of 4 and on the golden ``trainer_neighbor_bucketed_8x1`` graph
  (exponential, 8).  Only the mixing sum differs -- W Q as a contraction
  in the dense backend, the hop-by-hop sender-order sum of kernel B4 in
  the neighbor one -- so the states agree within 1e-5 of each array's
  largest entry, every element.  This holds the gossip to ``DenseMixer``
  semantics.
* Bits: ``bits_per_step`` equals the reference's exchange-plan hops x
  ``netsim.metrics.bucketed_payload_bits`` as an integer, for the golden
  neighbor spec and for the slice's full-width configuration (from
  parameter shapes alone, nothing allocated).
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.kernels import ops as jkops
from repro.models import transformer as JTR
from repro.netsim import metrics as jmetrics
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch import convert, tree
from repro_torch.core.draws import GeneratorDraws, RecordingDraws, ReplayDraws
from repro_torch.models import transformer as TTR

GOLDEN = pathlib.Path(__file__).parent / "golden_specs"
MODEL_TOL = {"float64": 5e-6, "float32": 1e-5}
STEP_TOL, STEP_MAX_OFF = 1e-5, 1e-3
BACKEND_TOL = 1e-5


def _rel_off(got, want, tol):
    """Fraction of elements off by more than tol x max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float((np.abs(got - want) > tol * scale).mean())


# --- the model ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_model_forward_loss_grad_match_reference(dtype):
    N = 3
    jcfg = dataclasses.replace(jconfigs.get("qwen3-1.7b").reduced(
        n_layers=2, d_model=64), dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tconfigs.get("qwen3-1.7b").reduced(
        n_layers=2, d_model=64), dtype=getattr(torch, dtype))
    rng = np.random.default_rng(0)
    p0 = jax.tree_util.tree_map(np.asarray,
                                JTR.init_params(jcfg, jax.random.key(0)))
    X = jax.tree_util.tree_map(lambda a: np.stack(
        [a + (0.05 * rng.normal(size=a.shape)).astype(a.dtype)
         for _ in range(N)]), p0)
    tok = rng.integers(0, 512, (N, 2, 16))
    lab = rng.integers(0, 512, (N, 2, 16))

    def node_loss(p, t, lb):
        logits = JTR.forward(jcfg, p, {"tokens": t})[0]
        return JTR.loss_fn(jcfg, logits, lb), logits

    @jax.jit
    def reference(Xs):
        def total(Xs_):
            losses, logits = jax.vmap(node_loss)(Xs_, tok, lab)
            return jnp.sum(losses), (losses, logits)
        return jax.grad(total, has_aux=True)(Xs)

    jgrad, (jloss, jlogits) = reference(X)

    xs, treedef = tree.flatten(convert.tree_to_torch(X, device="cpu"))
    xs = [x.requires_grad_(True) for x in xs]
    logits, _, aux = TTR.forward(tcfg, tree.unflatten(treedef, xs),
                                 {"tokens": torch.from_numpy(tok)})
    loss = TTR.loss_fn(tcfg, logits, torch.from_numpy(lab))
    grads = torch.autograd.grad(loss.sum(), xs)
    tol = MODEL_TOL[dtype]
    assert logits.dtype == getattr(torch, dtype) and aux == 0.0
    assert _rel_off(logits.detach(), jlogits, tol) == 0.0
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               rtol=tol)
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrad), strict=True):
        assert _rel_off(g, jg, tol) == 0.0


def test_other_families_name_their_slice():
    with pytest.raises(NotImplementedError, match="slice"):
        tconfigs.get("mixtral-8x7b")
    cfg = dataclasses.replace(tconfigs.get("qwen3-1.7b"), family="moe")
    with pytest.raises(NotImplementedError, match="slice"):
        TTR.param_template(cfg)
    assert set(tconfigs.ARCH_IDS) == set(jconfigs.ARCH_IDS)
    for arch in ("qwen3-1.7b", "qwen2-7b", "yi-9b", "phi4-mini-3.8b"):
        t, j = tconfigs.get(arch), jconfigs.get(arch)
        for f in dataclasses.fields(TTR.ModelConfig):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), (arch, f)
        assert t.param_count() == j.param_count()


# --- the trainer step -------------------------------------------------------------

def _jax_state_arrays(st):
    a = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    p = st.plead
    m, v = (st.precond if isinstance(st.precond, tuple)
            else (np.int32(0), np.int32(0)))
    return {"X": a(p.X), "D": a(p.D), "comm.H": a(p.comm.H),
            "comm.Hw": a(p.comm.Hw), "k": np.asarray(p.k),
            "step": np.asarray(st.step), "precond.m": a(m),
            "precond.v": a(v)}


def _dense_draws(trainer, X):
    """step -> the noise the reference's dense backend draws at that step
    (the comm() key split over leaves, each QInf draw at its blocked
    shape), compiled once."""
    leaves = jax.tree_util.tree_leaves(X)
    block = trainer.compressor.block
    shapes = [x.shape if x.ndim == 2 and x.shape[-1] == block
              else jkops.blockwise_lastdim(x, block=block).shape
              for x in leaves]

    @jax.jit
    def draw(step):
        key = jax.random.fold_in(jax.random.key(trainer.tcfg.seed), step)
        return [jax.random.uniform(k, s, jnp.float32) for k, s in
                zip(jax.random.split(key, len(shapes)), shapes)]

    return lambda step: [np.asarray(u) for u in draw(step)]


@pytest.mark.parametrize("precondition", ["none", "adam"])
def test_teacher_forced_step_matches_reference_dense_backend(precondition):
    spec = json.loads((GOLDEN / "trainer_dense_qinf2.json").read_text())
    spec["execution"]["params"] = {"precondition": precondition}
    jspec = japi.ExperimentSpec.from_json(json.dumps(spec))
    jrun = japi.build(jspec)
    jtr = jrun.trainer
    tspec = tapi.ExperimentSpec.from_json(jspec.to_json())
    trun = tapi.build(tspec, device="cpu")
    data = jrun.default_data()
    batch_at = jax.jit(data.batch_at)
    step = jax.jit(jtr.train_step)
    st = jax.jit(jtr.init_state)(jax.random.key(0))
    draws_at = _dense_draws(jtr, st.plead.X)
    worst = 0.0
    for k in range(3):
        batch = batch_at(k)
        arrays = _jax_state_arrays(st)
        draws = ReplayDraws(draws_at(st.step), "cpu")
        tb = {n: torch.from_numpy(np.array(v)) for n, v in batch.items()}
        got, metrics = trun.step(convert.trainstate_from_arrays(
            arrays, device="cpu"), tb, draws)
        assert not draws.pending
        st, jm = step(st, batch)
        want = _jax_state_arrays(st)
        got = convert.trainstate_to_arrays(got)
        assert int(got["k"]) == int(want["k"]) and got["step"] == k + 1
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jm["loss"]), rtol=1e-5)
        names = ("X", "D", "comm.H", "comm.Hw") + (
            ("precond.m", "precond.v") if precondition == "adam" else ())
        for name in names:
            for a, b in zip(tree.leaves(got[name]),
                            jax.tree_util.tree_leaves(want[name]),
                            strict=True):
                off = _rel_off(a, b, STEP_TOL)
                worst = max(worst, off)
                assert off <= STEP_MAX_OFF, (k, name, off)
    assert worst <= STEP_MAX_OFF


def _neighbor_noise_from_dense(dense_draws, trainer, X):
    """Cut the dense backend's per-leaf noise (N, ..., nb, block) to the
    neighbor backend's quantization widths."""
    out = []
    for u, x in zip(dense_draws, tree.leaves(X)):
        blk = trainer._quant_block((1,) + tuple(x.shape[1:]))
        out.append(u if blk == u.shape[-1] else u[..., :blk].contiguous())
    return out


@pytest.mark.parametrize("graph,n", [("ring", 4), ("exponential", 8)])
def test_neighbor_backend_matches_dense_backend(graph, n):
    spec = tapi.ExperimentSpec.load(
        GOLDEN / "trainer_neighbor_bucketed_8x1.json")
    spec = dataclasses.replace(
        spec, n_nodes=n, topology=dataclasses.replace(spec.topology,
                                                      graph=graph))
    neighbor = tapi.build(spec, device="cpu")
    dense = tapi.build(dataclasses.replace(
        spec, execution=dataclasses.replace(spec.execution,
                                            backend="dense")), device="cpu")
    data = neighbor.default_data()
    gen = GeneratorDraws(3, "cpu")
    st = dense.init_state()
    for k in range(3):
        batch = data.batch_at(k)
        arrays = convert.trainstate_to_arrays(st)
        rec = RecordingDraws(gen)
        st, _ = dense.step(st, batch, rec)
        nd = ReplayDraws(_neighbor_noise_from_dense(
            rec.record, neighbor.trainer, st.plead.X), "cpu")
        got, _ = neighbor.step(convert.trainstate_from_arrays(
            arrays, device="cpu"), batch, nd)
        assert not nd.pending
        got, want = (convert.trainstate_to_arrays(s) for s in (got, st))
        for name in ("X", "D", "comm.H", "comm.Hw"):
            for a, b in zip(tree.leaves(got[name]), tree.leaves(want[name]),
                            strict=True):
                assert _rel_off(a, b, BACKEND_TOL) == 0.0, (k, name)


# --- bits on the wire --------------------------------------------------------------

def _jax_bits(jspec):
    tr = japi.build(jspec).trainer
    leaves = jax.tree_util.tree_leaves(tr.abstract_state().plead.X)
    return len(tr.plan.hops) * jmetrics.bucketed_payload_bits(tr, leaves)


def test_bits_per_step_golden_neighbor_spec():
    jspec = japi.ExperimentSpec.load(
        GOLDEN / "trainer_neighbor_bucketed_8x1.json")
    with pytest.warns(UserWarning):              # meshless on one device
        want = _jax_bits(jspec)
    run = tapi.build(tapi.ExperimentSpec.from_json(jspec.to_json()),
                     device="cpu")
    got = run.bits_per_step()
    assert isinstance(want, int) and got == want
    assert got == run.bits_per_step(run.init_state())


def test_bits_per_step_full_width_slice_config():
    """qwen3-1.7b at its published widths, 2 of 28 layers, vocab/8, ring of
    8, 2-bit: from abstract shapes only (nothing is allocated)."""
    kw = dict(name="slice", n_nodes=8, steps=1,
              topology={"graph": "ring"},
              compressor={"name": "qinf", "params": {"bits": 2}},
              model={"arch": "qwen3-1.7b", "full": True,
                     "local_batch": 2, "seq_len": 512,
                     "params": {"n_layers": 2, "vocab": 18992}},
              execution={"engine": "sharded", "backend": "neighbor"})
    want = _jax_bits(japi.ExperimentSpec.from_dict(kw))
    run = tapi.build(tapi.ExperimentSpec.from_dict(kw), device="cpu")
    assert run.bits_per_step() == want == 2 * 739_683_712
    layout = run.trainer.tcfg and tapi.netsim_metrics.bucketed_payload_bits(
        run.trainer, [torch.empty((8,) + tuple(p.shape), device="meta")
                      for p in tree.leaves(TTR.abstract_params(
                          run.trainer.mcfg))])
    assert layout == 739_683_712
