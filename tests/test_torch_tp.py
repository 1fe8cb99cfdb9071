"""A tensor-parallel node (``repro_torch.models.tp``) against the JAX package
and against the port's whole-node run, on the CPU.

* Model, train mode, at reduced widths under ``StackedTP(M)``, M in {2,
  4}, f64 and f32: the reference's weights (``JTR.init_params``, each leaf
  perturbed per node) carried over and cut into rank-rows by
  ``convert.model_params_to_rank_rows``; the configurations cover the
  dense family with ``qk_norm`` (6 query / 2 KV heads: at M = 4 a rank's
  48 query columns cut its heads, so q, k and v are gathered; at M = 2
  heads are whole and aligned), with QKV biases (4 / 1 heads: whole query
  heads, the one KV head split, only k and v gathered) and without either
  (2 / 1 heads: the query heads split in parts at M = 4); MoE with a
  shared expert (deepseek's wiring); the vlm (gated cross-attention to
  the vision tokens, 1 KV head); encdec (whisper: biases, LayerNorm,
  learned positions, vocab-parallel position table, cross-attention to
  the encoder).
  - The logits (gathered over the ranks) equal the port's whole-node
    forward within 1e-10 x max |logits| in f64 and 1e-5 in f32 (f32's for
    MoE, whose router and experts run in f32), the loss (f32 in both
    packages whatever the model dtype) within 1e-6 relative; against the
    reference's ``forward`` / ``loss_fn`` on the same unsharded weights
    within the model tests' bars (``MODEL_TOL``: 5e-6
    f64, 1e-5 f32, f32's for MoE).  The issue's 1e-10 cannot hold against
    the reference: both packages compute norm statistics, RoPE and the
    softmax in f32 even for an f64 model, in different orders, and the
    whole-node port already agrees with the reference only to ~8e-7
    (``tests/test_torch_trainer.py``).
  - Every leaf's gradient (the sum of node losses + 0.01 aux), joined
    over the shards, matches ``jax.grad`` of the reference within C4's
    bars (5e-6 f64, 1e-5 f32; a key bias, whose gradient is zero up to
    rounding, at the tree's largest gradient); every replicated leaf's
    gradient is bit-equal across the model ranks.
* A teacher-forced trainer step at (4, 2) on the golden
  ``trainer_neighbor_alternating_4x2`` spec, ``StackedTP(2)`` against the
  port's whole-node step from the same state and draws (the same calls to
  one generator), 3 steps: X, D, H and the Hw slots within C4's step bar
  (1e-5 of each array's largest entry on all but 0.1 % of elements); the
  loss within 1e-6 and the consensus (a replicated leaf counted once)
  within 1e-5 relative; 3 x 459,072 bits a step a node; the contract audit of a
  step: 6 u8 ``pp`` calls, 86,076 B a model shard, no f64, no host read.
* Refused at build: a tp seam of M model ranks on a mesh of another
  model axis (RWKV-6 and the RG-LRU, and caches, run tensor-parallel:
  ``tests/test_torch_tp_recurrent.py``, ``tests/test_torch_tp_decode.py``;
  the per-leaf wire, identity compression and the dense backend:
  ``tests/test_torch_tp_whole_leaf.py``).
* The seam's own operators: ``StackedTP``'s sum, max, gather and the
  gather's backward, ``scatter_last`` (the rank's slice forward, the
  gradient gathered whole on every rank backward, recorded as
  ``"all-gather-grad"``), ``rank_rows`` / ``join_rank_rows`` round trips.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import sharding as jsh
from repro.models import transformer as JTR
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch import convert, tree
from repro_torch.core.draws import GeneratorDraws
from repro_torch.models import sharding as tsh
from repro_torch.models import transformer as TTR
from repro_torch.models.tp import StackedTP, head_geometry
from tests.test_torch_models import F32_ISLANDS, MODEL_TOL, _extras, _params
from tests.test_torch_trainer import STEP_MAX_OFF, STEP_TOL, _rel_off

GOLDEN_4X2 = pathlib.Path(__file__).parent / "golden_specs" / \
    "trainer_neighbor_alternating_4x2.json"
B, T = 2, 12
#: forward against the port's whole-node run
WHOLE_TOL = {"float64": 1e-10, "float32": 1e-5}
#: the loss is an f32 quantity in both packages whatever the model dtype
#: (``loss_fn`` casts the logits to f32): the vocab-parallel max + log of
#: summed exponentials and ``torch.logsumexp`` agree to f32 rounding
LOSS_TOL = 1e-6
#: (arch, overrides of .reduced()): the families and head splits
CONFIGS = {
    "dense-qknorm-6q2kv": ("qwen3-1.7b", {"n_heads": 6, "n_kv_heads": 2}),
    "dense-qkvbias-4q1kv": ("qwen2-7b", {"n_heads": 4, "n_kv_heads": 1}),
    "dense-2q1kv": ("phi4-mini-3.8b", {"n_heads": 2, "n_kv_heads": 1}),
    "moe-shared": ("deepseek-moe-16b", {}),
    "vlm": ("llama-3.2-vision-90b", {}),
    "encdec": ("whisper-large-v3", {}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(key, dtype):
    arch, kw = CONFIGS[key]
    j = dataclasses.replace(jconfigs.get(arch).reduced(),
                            dtype=getattr(jnp, dtype), **kw)
    t = dataclasses.replace(tconfigs.get(arch).reduced(),
                            dtype=getattr(torch, dtype), **kw)
    return j, t


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def test_the_configurations_split_heads_as_named():
    """Which head path each configuration takes at M = 2 and 4."""
    want = {("dense-qknorm-6q2kv", 2): "aligned",
            ("dense-qknorm-6q2kv", 4): "q, k, v gathered",
            ("dense-qkvbias-4q1kv", 2): "k, v gathered",
            ("dense-qkvbias-4q1kv", 4): "k, v gathered",
            ("dense-2q1kv", 2): "k, v gathered",
            ("dense-2q1kv", 4): "q, k, v gathered"}
    for (key, M), path in want.items():
        _, cfg = _cfgs(key, "float32")
        H, KV = cfg.n_heads, cfg.n_kv_heads
        whole, Hn, h0 = head_geometry(H, cfg.hd, M)
        got = ("aligned" if H % M == 0 and KV % M == 0
               else "k, v gathered" if whole else "q, k, v gathered")
        assert got == path, (key, M)
        assert Hn <= -(-H // M) + 1
    # the production widths: only deepseek-moe-16b is head-aligned at 16
    for arch, whole_q in (("qwen3-1.7b", True), ("yi-9b", True),
                          ("mixtral-8x7b", True),
                          ("llama-3.2-vision-90b", True),
                          ("phi4-mini-3.8b", False), ("qwen2-7b", False),
                          ("whisper-large-v3", False)):
        c = tconfigs.get(arch)
        assert head_geometry(c.n_heads, c.hd, 16)[0] == whole_q, arch
        assert c.n_kv_heads % 16 != 0, arch
    c = tconfigs.get("deepseek-moe-16b")
    assert c.n_heads % 16 == 0 and c.n_kv_heads % 16 == 0


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("key", list(CONFIGS))
def test_tp_forward_and_grads_match_reference_and_whole_node(key, M, dtype):
    N = 2
    jcfg, tcfg = _cfgs(key, dtype)
    rng = np.random.default_rng(0)
    X = _params(jcfg, rng, n=N)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (N, B, T)),
             **_extras(jcfg, rng, (N, B), dtype)}
    labels = rng.integers(0, jcfg.vocab, (N, B, T))

    def node_loss(p, b, lb):
        logits, _, aux = JTR.forward(jcfg, p, b)
        return JTR.loss_fn(jcfg, logits, lb) + 0.01 * aux, (logits, aux)

    @jax.jit
    def reference(Xs):
        def total(Xs_):
            losses, out = jax.vmap(node_loss)(Xs_, batch, labels)
            return jnp.sum(losses), (losses, out)
        return jax.grad(total, has_aux=True)(Xs)

    jgrad, (jloss, (jlogits, _)) = reference(X)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tl = torch.from_numpy(labels)

    # the port's whole node
    whole, treedef = tree.flatten(convert.tree_to_torch(X, device="cpu"))
    logits_w, _, aux_w = TTR.forward(tcfg, tree.unflatten(treedef, whole),
                                     tb)
    loss_w = TTR.loss_fn(tcfg, logits_w, tl) + 0.01 * aux_w

    # the same weights as rank-rows under StackedTP(M)
    tp = StackedTP(M)
    rows = tree.leaves(convert.model_params_to_rank_rows(
        X, M, device="cpu", node_stacked=True))
    rows = [r.requires_grad_(True) for r in rows]
    logits, cache, aux = TTR.forward(tcfg, tree.unflatten(treedef, rows),
                                     tp.node_rows(tb), tp=tp)
    assert cache is None and logits.shape[-1] == tcfg.padded_vocab // M
    loss = (TTR.loss_fn(tcfg, logits, tp.node_rows(tl), tp=tp)
            + 0.01 * aux)
    grads = torch.autograd.grad(loss.sum(), rows, allow_unused=True)
    full = tp.first_of_node(tp.gather_last(logits.detach()))
    node_loss_tp = tp.first_of_node(loss.detach())

    tol = MODEL_TOL["float32" if jcfg.family in F32_ISLANDS else dtype]
    wtol = WHOLE_TOL[dtype]
    if jcfg.family in F32_ISLANDS:
        wtol = WHOLE_TOL["float32"]   # the router and experts run in f32
    assert _rel_err(full, logits_w.detach()) <= wtol
    np.testing.assert_allclose(node_loss_tp.numpy(),
                               loss_w.detach().numpy(),
                               rtol=max(wtol, LOSS_TOL))
    assert _rel_err(full, jlogits) <= tol
    np.testing.assert_allclose(node_loss_tp.numpy(), np.asarray(jloss),
                               rtol=tol)

    specs = tree.leaves(tsh.param_specs(tree.unflatten(
        treedef, [w[0] for w in whole])))
    jgs = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrad)]
    top = max(float(np.abs(jg).max()) for jg in jgs)
    for g, jg, sp in zip(grads, jgs, specs, strict=True):
        if g is None:
            assert not jg.any()
            continue
        v = g.unflatten(0, (N, M))
        if tsh.model_dim(sp) is None:       # replicated: the same bits
            assert all(torch.equal(v[:, 0], v[:, m]) for m in range(M))
        joined = tsh.join_rank_rows(g, sp, M).numpy().astype(np.float64)
        scale = float(np.abs(jg).max())
        if scale <= 1e-6 * top:             # zero up to rounding
            scale = top
        assert float(np.abs(joined - jg).max()) <= tol * scale


def test_tp_specs_are_the_references():
    """The rank-row cut uses the reference's partition specs, leaf for
    leaf (``param_specs`` of the unstacked tree)."""
    for key in CONFIGS:
        jcfg, tcfg = _cfgs(key, "float32")
        jspecs = jax.tree_util.tree_leaves(
            jsh.param_specs(JTR.abstract_params(jcfg)),
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        tspecs = tree.leaves(tsh.param_specs(TTR.abstract_params(tcfg)))
        assert [tuple(s) for s in jspecs] == [tuple(s) for s in tspecs]


# --- the trainer --------------------------------------------------------------

def _tp_state_from(tr, whole_state):
    """A StackedTP trainer's state cut from a whole-node state (copies)."""
    from repro_torch.core.comm import CommState
    from repro_torch.core.prox_lead import ProxLEADState
    from repro_torch.optim.decentralized import TrainState
    p = whole_state.plead
    cl = lambda t: tree.tree_map(torch.clone, t)           # noqa: E731
    hw_lead = 1 if tr.hw_slots is None else 2
    return TrainState(ProxLEADState(
        tr.to_rank_rows(cl(p.X)), tr.to_rank_rows(cl(p.D)),
        CommState(tr.to_rank_rows(cl(p.comm.H)),
                  tr.to_rank_rows(cl(p.comm.Hw), hw_lead)),
        p.oracle, p.k), whole_state.step, None)


def test_teacher_forced_tp_step_matches_the_whole_node_step():
    from repro_torch.check import contracts
    from repro_torch.obs.record import RecordingPP
    spec = tapi.ExperimentSpec.load(GOLDEN_4X2)
    whole = tapi.build_trainer_runner(spec, device="cpu")
    run = tapi.build_trainer_runner(spec, device="cpu", tp=StackedTP(2),
                                    pp=RecordingPP())
    tr = run.trainer
    assert (tr.tp.M, tr.wire_shards, tr.plan.T, len(tr.plan.hops)) == \
        (2, 2, 2, 3)
    assert run.bits_per_step() == whole.bits_per_step() == 3 * 459_072
    data = whole.default_data()
    dw, dt = GeneratorDraws(5, "cpu"), GeneratorDraws(5, "cpu")
    sw = whole.init_state()
    for k in range(3):
        st = _tp_state_from(tr, sw)
        batch = data.batch_at(k)
        sw, mw = whole.step(sw, batch, dw)
        st, mt = run.step(st, batch, dt)
        got = tr.join_state(st)
        want = {"X": sw.plead.X, "D": sw.plead.D, "H": sw.plead.comm.H,
                "Hw": sw.plead.comm.Hw}
        for name in want:
            for a, b in zip(tree.leaves(got[name]), tree.leaves(want[name]),
                            strict=True):
                assert _rel_off(a, b, STEP_TOL) <= STEP_MAX_OFF, (k, name)
        np.testing.assert_allclose(float(mt["loss"]), float(mw["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(mt["consensus"]),
                                   float(mw["consensus"]), rtol=1e-5)
        assert run.bits_per_step(st) == 3 * 459_072
    # the contracts of a TP step
    leaves = [torch.empty(x.shape, dtype=x.dtype, device="meta")
              for x in tree.leaves(st.plead.X)]
    facts, after = contracts.trainer_step_facts(run, state=st, data=data,
                                                draws=dt)
    findings = contracts.audit_trainer(run, spec.name, facts, leaves)
    assert after is not None and findings
    assert all(ok is True for _, ok, _ in findings), findings
    assert len(facts.calls) == 6
    assert all(d == torch.uint8 for d, _ in facts.calls)
    assert sum(b for _, b in facts.calls) == 2 * 86_076


def test_replicated_leaves_stay_bit_equal_over_the_model_ranks():
    spec = tapi.ExperimentSpec.load(GOLDEN_4X2)
    run = tapi.build_trainer_runner(spec, device="cpu", tp=StackedTP(2))
    tr = run.trainer
    st = run.init_state()
    data, draws = run.default_data(), GeneratorDraws(3, "cpu")
    for k in range(2):
        st, _ = run.step(st, data.batch_at(k), draws)
    p = st.plead
    for name, t in (("X", p.X), ("D", p.D), ("H", p.comm.H),
                    ("Hw", p.comm.Hw)):
        for leaf, sp in zip(tree.leaves(t), tr.leaf_specs):
            if tsh.model_dim(sp) is None:
                v = leaf.unflatten(0, (-1, 2))
                assert torch.equal(v[:, 0], v[:, 1]), name


# --- refusals -------------------------------------------------------------------

def _spec_for(arch, mesh=(4, 2), **execution):
    d = json.loads(GOLDEN_4X2.read_text())
    d["model"]["arch"] = arch
    d["execution"]["mesh"] = list(mesh)
    d["execution"].update(execution)
    return tapi.ExperimentSpec.from_json(json.dumps(d))


def test_a_tp_seam_off_the_mesh_model_axis_is_refused():
    with pytest.raises(ValueError, match="model ranks on a mesh"):
        tapi.build_trainer_runner(_spec_for("qwen3-1.7b", mesh=(4, 4)),
                                  device="cpu", tp=StackedTP(2))


# --- the seam -------------------------------------------------------------------

def test_stacked_seam_operators():
    tp = StackedTP(3)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2 * 3, 4, 5, generator=g, dtype=torch.float64)
    v = x.unflatten(0, (2, 3))
    s = tp.reduce_out(x).unflatten(0, (2, 3))
    assert all(torch.equal(s[:, m], v.sum(1)) for m in range(3))
    mx = tp.all_max(x).unflatten(0, (2, 3))
    assert all(torch.equal(mx[:, m], v.amax(1)) for m in range(3))
    cat = tp.gather_last(x).unflatten(0, (2, 3))
    want = torch.cat([v[:, m] for m in range(3)], -1)
    assert all(torch.equal(cat[:, m], want) for m in range(3))
    # gather backward: the rank's own slice; gather_heads: summed first
    xr = x.clone().requires_grad_(True)
    up = torch.randn(6, 4, 15, generator=g, dtype=torch.float64)
    (gx,) = torch.autograd.grad((tp.gather_last(xr) * up).sum(), xr)
    uv = up.unflatten(0, (2, 3)).unflatten(-1, (3, 5))
    assert torch.equal(gx.unflatten(0, (2, 3)),
                       torch.stack([uv[:, m, :, m] for m in range(3)], 1))
    (gh,) = torch.autograd.grad((tp.gather_heads(xr) * up).sum(), xr)
    summed = uv.sum(1)
    assert torch.allclose(gh.unflatten(0, (2, 3)),
                          torch.stack([summed[:, :, m] for m in range(3)],
                                      1), rtol=1e-15, atol=0)
    # copy_in: identity forward, summed gradient backward
    (gc,) = torch.autograd.grad((tp.copy_in(xr) * x).sum(), xr)
    assert torch.equal(gc.unflatten(0, (2, 3))[:, 1], v.sum(1))


def test_scatter_last_slices_forward_and_gathers_backward():
    from repro_torch.models.tp import NO_TP
    from repro_torch.obs.record import recording_tp
    tp = StackedTP(3)
    g = torch.Generator().manual_seed(2)
    w = torch.randn(2, 5, 12, generator=g, dtype=torch.float64)
    x = tp.node_rows(w).requires_grad_(True)        # replicated over ranks
    with recording_tp(tp) as rec:
        own = tp.scatter_last(x)
        assert own.shape == (6, 5, 4)
        v = own.unflatten(0, (2, 3))
        for m in range(3):
            assert torch.equal(v[:, m], w[..., 4 * m:4 * (m + 1)])
        up = torch.randn(6, 5, 4, generator=g, dtype=torch.float64)
        (gx,) = torch.autograd.grad((own * up).sum(), x)
    assert rec.calls == [("all-gather-grad", torch.float64, 5 * 4 * 8)]
    whole = torch.cat([up.unflatten(0, (2, 3))[:, m] for m in range(3)], -1)
    gv = gx.unflatten(0, (2, 3))
    assert all(torch.equal(gv[:, m], whole) for m in range(3))
    assert NO_TP.scatter_last(w) is w


@pytest.mark.parametrize("spec,shape", [
    (tsh.P(None, None, "model"), (3, 8, 12)),
    (tsh.P(None, "model", None), (3, 12, 8)),
    (tsh.P("model", None), (24, 8)),
    (tsh.P(None, None), (3, 8))])
def test_rank_rows_round_trip(spec, shape):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2,) + shape, generator=g)
    rows = tsh.rank_rows(x, spec, 4)
    assert rows.shape[0] == 8
    assert tuple(rows.shape[1:]) == tsh.model_local_shape(shape, spec, 4)
    assert torch.equal(tsh.join_rank_rows(rows, spec, 4), x)
    for m in range(4):
        assert torch.equal(tsh.rank_rows(x, spec, 4, m),
                           rows.unflatten(0, (2, 4))[:, m])
    hw = torch.randn((2, 3) + shape, generator=g)     # Hw slots: lead 2
    assert torch.equal(tsh.join_rank_rows(
        tsh.rank_rows(hw, spec, 4, lead=2), spec, 4, lead=2), hw)
