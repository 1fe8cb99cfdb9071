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
* Schedules and faults, teacher-forced against the reference's *dense*
  backend (ROADMAP C1: the reference's sharded output is off for
  time-varying plans; its dense semantics are the bar):
  - the port's neighbor backend under ``schedule='alternating'`` (ring <->
    exponential on 8 nodes, T = 2 Hw slots, 5 union hops) against the
    reference's dense backend on the same schedule, which recomputes
    W_k (H + Q); the port's Hw slots enter as W_t H of the reference's H
    (``NeighborMixer``) and leave equal to W_t H of the reference's next
    H.  C4's tolerances (1e-5 of each array's max, all but 0.1 %);
  - the port's dense backend with ``drop_rate`` (LinkDrop faults) against
    the reference's, the reference's masks replayed; same tolerances.
* C10: QInf above 7 bits on the neighbor backend is refused when the
  config is built.
* Bits: ``bits_per_step`` equals the reference's exchange-plan hops x
  ``netsim.metrics.bucketed_payload_bits`` as an integer, for the golden
  neighbor spec and for the slice's full-width configuration (from
  parameter shapes alone, nothing allocated), on the ring and on the
  alternating schedule's 5-hop union.
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
from repro.netsim import faults as jfaults
from repro.netsim import metrics as jmetrics
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch import convert, tree
from repro_torch.core.comm import NeighborMixer
from repro_torch.core.draws import GeneratorDraws, RecordingDraws, ReplayDraws
from repro_torch.models import transformer as TTR
from repro_torch.netsim import SimMixer

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
    """Every architecture id builds, field for field the reference's
    configuration (the families that once named a later slice included),
    with the reference's parameter count; no family is refused."""
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in tconfigs.ARCH_IDS:
        t, j = tconfigs.get(arch), jconfigs.get(arch)
        for f in dataclasses.fields(TTR.ModelConfig):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), (arch, f)
        assert t.param_count() == j.param_count()
        r = t.reduced()
        assert r.param_count() == j.reduced().param_count()
        assert tree.leaves(TTR.abstract_params(r))
    with pytest.raises(ValueError, match="unknown model family"):
        TTR.param_template(dataclasses.replace(tconfigs.get("qwen3-1.7b"),
                                               family="cnn"))
    with pytest.raises(ValueError, match="unknown arch"):
        tconfigs.get("gpt-2")


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


# --- schedules and faults ------------------------------------------------------

def _scenario_spec(**topology):
    spec = json.loads((GOLDEN / "trainer_dense_qinf2.json").read_text())
    spec["n_nodes"] = 8
    spec["topology"].update(topology)
    return spec


def _assert_step_close(got, want, names, k):
    for name in names:
        for a, b in zip(tree.leaves(got[name]),
                        jax.tree_util.tree_leaves(want[name]), strict=True):
            off = _rel_off(a, b, STEP_TOL)
            assert off <= STEP_MAX_OFF, (k, name, off)


def test_neighbor_backend_alternating_matches_reference_dense_backend():
    """T = 2: the port's neighbor backend (5 union hops, Hw slots per
    round, kernel B4's two-round mix) against the reference's dense
    backend on the same ring <-> exponential schedule."""
    d = _scenario_spec(schedule="alternating")
    jspec = japi.ExperimentSpec.from_json(json.dumps(d))
    jrun = japi.build(jspec)
    jtr = jrun.trainer
    d["execution"]["backend"] = "neighbor"
    trun = tapi.build(tapi.ExperimentSpec.from_json(json.dumps(d)),
                      device="cpu")
    tr = trun.trainer
    assert tr.plan.T == 2 and len(tr.plan.hops) == 5 and tr.hw_slots == 2
    assert trun.bits_per_step() == 5 * tapi.netsim_metrics.\
        bucketed_payload_bits(tr, tree.leaves(
            tr.init_state().plead.X))
    mix = NeighborMixer(tr.plan)
    data = jrun.default_data()
    batch_at = jax.jit(data.batch_at)
    step = jax.jit(jtr.train_step)
    st = jax.jit(jtr.init_state)(jax.random.key(0))
    draws_at = _dense_draws(jtr, st.plead.X)

    def slots(H):
        """Hw slot t = W_t H, the plan's weights, in f32."""
        return tree.tree_map(lambda h: torch.stack(
            [mix.mix_stacked((h,), t)[0] for t in range(2)], 1), H)

    for k in range(3):
        batch = batch_at(k)
        arrays = _jax_state_arrays(st)
        port = convert.trainstate_from_arrays(arrays, device="cpu")
        port = port._replace(plead=port.plead._replace(
            comm=port.plead.comm._replace(Hw=slots(port.plead.comm.H))))
        draws = ReplayDraws(_neighbor_noise_from_dense(
            [torch.from_numpy(np.array(u)) for u in draws_at(st.step)], tr,
            port.plead.X), "cpu")
        tb = {n: torch.from_numpy(np.array(v)) for n, v in batch.items()}
        got, metrics = trun.step(port, tb, draws)
        assert not draws.pending
        st, jm = step(st, batch)
        want = _jax_state_arrays(st)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jm["loss"]), rtol=1e-5)
        hw = tree.leaves(got.plead.comm.Hw)
        assert all(h.shape[1] == 2 for h in hw)
        got_a = convert.trainstate_to_arrays(got)
        assert int(got_a["k"]) == int(want["k"])
        _assert_step_close(got_a, want, ("X", "D", "comm.H"), k)
        # the slots track W_t H of the reference's new H
        want_hw = slots(convert.tree_to_torch(want["comm.H"], device="cpu"))
        for a, b in zip(hw, tree.leaves(want_hw), strict=True):
            assert _rel_off(a, b, STEP_TOL) <= STEP_MAX_OFF, k


def test_dense_backend_drop_rate_matches_reference():
    """The dense backend with ``drop_rate``: a SimMixer with LinkDrop
    faults, the reference's per-round masks replayed (one (n, n) f64
    uniform a round, ``fold_in(fold_in(key(fault_seed), k), 0)``)."""
    d = _scenario_spec()
    d["execution"]["params"] = {"drop_rate": 0.3}
    d["fault_seed"] = 5
    jspec = japi.ExperimentSpec.from_json(json.dumps(d))
    jrun = japi.build(jspec)
    jtr = jrun.trainer
    trun = tapi.build(tapi.ExperimentSpec.from_json(json.dumps(d)),
                      device="cpu")
    tr = trun.trainer
    assert isinstance(tr.mixer, SimMixer) and tr.mixer.recompute_hw
    assert tr.tcfg.drop_rate == 0.3 and tr.tcfg.fault_seed == 5
    data = jrun.default_data()
    batch_at = jax.jit(data.batch_at)
    step = jax.jit(jtr.train_step)
    st = jax.jit(jtr.init_state)(jax.random.key(0))
    draws_at = _dense_draws(jtr, st.plead.X)
    for k in range(3):
        batch = batch_at(k)
        arrays = _jax_state_arrays(st)
        fkey = jax.random.fold_in(jax.random.fold_in(
            jax.random.key(5), jnp.int32(int(st.plead.k))), 0)
        fd = ReplayDraws([np.asarray(jax.random.uniform(fkey, (8, 8)))],
                         "cpu")
        tr.start_fault_stream(fd)
        mixer = tr.mixer
        draws = ReplayDraws(draws_at(st.step), "cpu")
        tb = {n: torch.from_numpy(np.array(v)) for n, v in batch.items()}
        got, _ = trun.step(convert.trainstate_from_arrays(
            arrays, device="cpu"), tb, draws)
        assert not draws.pending and not fd.pending
        # the round's mask is the reference's
        np.testing.assert_array_equal(
            mixer.edge_mask_at(int(st.plead.k), comm=True).numpy(),
            np.asarray(jfaults.LinkDrop(0.3).edge_mask(fkey, 8)))
        st, _ = step(st, batch)
        _assert_step_close(convert.trainstate_to_arrays(got),
                           _jax_state_arrays(st),
                           ("X", "D", "comm.H", "comm.Hw"), k)


def test_dense_backend_drop_rate_reruns_from_a_fresh_state():
    """Each fresh state starts the dense backend's fault stream afresh
    (seeded ``fault_seed``): two ``run()`` calls on one ``drop_rate`` runner
    give the same X, bit for bit, and a third seeded elsewhere does not."""
    d = _scenario_spec()
    d["execution"]["params"] = {"drop_rate": 0.3}
    d["fault_seed"] = 5
    d["steps"] = 3
    trun = tapi.build(tapi.ExperimentSpec.from_json(json.dumps(d)),
                      device="cpu")
    first, _ = trun.run()
    second, _ = trun.run()
    for a, b in zip(tree.leaves(first.plead.X), tree.leaves(second.plead.X),
                    strict=True):
        assert torch.equal(a, b)
    assert first.plead.k == second.plead.k == 4
    d["fault_seed"] = 6
    other, _ = tapi.build(tapi.ExperimentSpec.from_json(json.dumps(d)),
                          device="cpu").run()
    assert not all(torch.equal(a, b) for a, b in zip(
        tree.leaves(first.plead.X), tree.leaves(other.plead.X)))


def test_neighbor_backend_refuses_8_bit_qinf_at_build():
    """C10: the golden neighbor spec at ``compressor.bits = 8`` is refused
    when its TrainerConfig is built, naming C10 and the reference's wrap;
    7 bits builds, and so does 8 bits on the dense backend."""
    d = json.loads((GOLDEN / "trainer_neighbor_bucketed_8x1.json").read_text())
    d["compressor"]["params"]["bits"] = 8
    spec = tapi.ExperimentSpec.from_json(json.dumps(d))
    with pytest.raises(ValueError, match="C10") as err:
        tapi.trainer_config_from_spec(spec)
    assert "wraps" in str(err.value) and "quantize.py:106-110" in str(
        err.value)
    with pytest.raises(ValueError, match="C10"):
        tapi.build(spec, device="cpu")
    for wire_mode in ("bucketed", "per_leaf"):
        with pytest.raises(ValueError, match="C10"):
            tapi.build(dataclasses.replace(spec, execution=dataclasses.replace(
                spec.execution, wire_mode=wire_mode)), device="cpu")
    d["compressor"]["params"]["bits"] = 7
    tapi.build(tapi.ExperimentSpec.from_json(json.dumps(d)), device="cpu")
    d["compressor"]["params"]["bits"] = 8
    d["execution"]["backend"] = "dense"
    tapi.build(tapi.ExperimentSpec.from_json(json.dumps(d)), device="cpu")


def test_neighbor_backend_refuses_drop_rate_and_trainer_state_slots_convert():
    d = json.loads((GOLDEN / "trainer_neighbor_bucketed_8x1.json").read_text())
    d["execution"]["params"] = {"drop_rate": 0.1}
    with pytest.raises(ValueError, match="backend='dense'"):
        tapi.build(tapi.ExperimentSpec.from_json(json.dumps(d)),
                   device="cpu")
    d["execution"]["params"] = {}
    d["topology"]["schedule"] = "alternating"
    run = tapi.build(tapi.ExperimentSpec.from_json(json.dumps(d)),
                     device="cpu")
    st = run.init_state()
    arrays = convert.trainstate_to_arrays(st)
    assert all(a.shape[1] == 2 for a in
               jax.tree_util.tree_leaves(arrays["comm.Hw"]))
    back = convert.trainstate_from_arrays(arrays, device="cpu")
    for a, b in zip(tree.leaves(back.plead.comm.Hw),
                    tree.leaves(st.plead.comm.Hw), strict=True):
        assert torch.equal(a, b)


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


def _full_width_slice_spec(schedule):
    return dict(name="slice", n_nodes=8, steps=1,
                topology={"graph": "ring", "schedule": schedule},
                compressor={"name": "qinf", "params": {"bits": 2}},
                model={"arch": "qwen3-1.7b", "full": True,
                       "local_batch": 2, "seq_len": 512,
                       "params": {"n_layers": 2, "vocab": 18992}},
                execution={"engine": "sharded", "backend": "neighbor"})


def test_bits_per_step_full_width_slice_config():
    """qwen3-1.7b at its published widths, 2 of 28 layers, vocab/8, ring of
    8, 2-bit: from abstract shapes only (nothing is allocated)."""
    kw = _full_width_slice_spec("static")
    want = _jax_bits(japi.ExperimentSpec.from_dict(kw))
    run = tapi.build(tapi.ExperimentSpec.from_dict(kw), device="cpu")
    assert run.bits_per_step() == want == 2 * 739_683_712
    layout = run.trainer.tcfg and tapi.netsim_metrics.bucketed_payload_bits(
        run.trainer, [torch.empty((8,) + tuple(p.shape), device="meta")
                      for p in tree.leaves(TTR.abstract_params(
                          run.trainer.mcfg))])
    assert layout == 739_683_712


def test_bits_per_step_full_width_alternating_schedule():
    """The same configuration under the ring <-> exponential schedule: its
    plan's 5 union hops each carry the payload every round
    (``plan_bits_per_round``), as in the reference."""
    kw = _full_width_slice_spec("alternating")
    want = _jax_bits(japi.ExperimentSpec.from_dict(kw))
    run = tapi.build(tapi.ExperimentSpec.from_dict(kw), device="cpu")
    assert run.trainer.plan.T == 2
    assert run.bits_per_step() == want == 5 * 739_683_712
    assert run.bits_per_step() == tapi.netsim_metrics.plan_bits_per_round(
        run.trainer.plan, 739_683_712) // 8
