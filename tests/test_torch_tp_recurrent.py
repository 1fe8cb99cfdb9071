"""RWKV-6 and the RG-LRU on a tensor-parallel node (``repro_torch.models.
tp``) against the JAX package and against the port's whole-node run, on
the CPU.

* Model, train mode, under ``StackedTP(M)``: rwkv6-7b ``.reduced()`` (8
  heads of 32, d_ff 512: M = 2 and 4 hold 4 and 2 whole heads) and
  recurrentgemma-9b ``.reduced()`` (W 256 in G = 16 gate blocks, 1 KV
  head: a rank applies its G / M blocks, its KV columns gathered), M in
  {2, 4}, f64 and f32; and the RG-LRU at ``lru_width`` 24 (G = 1: the
  rank's columns cut the one gate block, so y is gathered and the gates
  computed whole) at M = 2.  The reference's weights (each leaf perturbed
  per node) carried over and cut into rank-rows by
  ``convert.model_params_to_rank_rows``; 2 nodes, batch 2, 8 tokens, 2
  RWKV-6 layers (its WKV scan loops over the tokens).
  - The logits (gathered over the ranks) and the loss against the port's
    whole-node forward: within f32's 1e-5 x max |logits| (both families
    compute their recurrences in f32 whatever the model dtype) and 1e-6
    relative; against the reference's ``forward`` / ``loss_fn`` on the
    same unsharded weights within the model tests' bars (``MODEL_TOL``,
    f32's for these families).  RWKV-6's logits take ``SSM_LOGIT_TOL``
    against both (ROADMAP C17: the whole-node port's own logits leave the
    reference's by up to 2.5e-5 of max |logits| at 8 tokens over 8
    seeds, and the split's partial sums by 1.1e-5 in f32: its group norm
    amplifies f32 rounding, as C4 says of its gradients).
  - Every leaf's gradient (the sum of node losses), joined over the
    shards, against the whole-node gradient and ``jax.grad`` of the
    reference: within 1e-5 of the leaf's largest entry, RWKV-6's within
    ``SSM_GRAD_TOL`` (3e-4, C4: its group norm amplifies rounding).
    Every replicated leaf's gradient -- RWKV-6's ``w0``, ``u``, ``lnx``,
    ``lnx_b``, ``mu_*``, ``tm_a*``, ``wd*``; the RG-LRU's ``conv_w``,
    ``conv_b``, ``lam``, ``gate_*_b``, ``gate_*_w`` -- is bit-equal across
    a node's model ranks.
* ROADMAP C17's bar: the whole-node port's RWKV-6 logits against the
  reference's over seeds 0-7 (all within ``SSM_LOGIT_TOL``, some above
  the model tests' 1e-5).
* The rules: the leaves each family splits, with the reference's specs
  (first match wins: ``rwkv_wo`` falls under ``wo$``, its input rows;
  ``cm_wv`` under ``wv$``, its output columns).
* RWKV-6 at an M that would cut its heads is refused at build and in
  ``forward``, naming the shapes.
* A teacher-forced trainer step at (4, 2) for each family (the golden
  ``trainer_neighbor_alternating_4x2`` spec with the arch swapped, 8
  tokens), ``StackedTP(2)`` against the port's whole-node step from the
  same state and draws: X, D, H and the Hw slots within C4's step bar,
  the loss within 1e-6 and the consensus within 1e-5 relative, bits a
  step equal; replicated leaves of the state bit-equal over the model
  ranks.
"""
import dataclasses
import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JTR
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch import convert, tree
from repro_torch.core.draws import GeneratorDraws
from repro_torch.models import sharding as tsh
from repro_torch.models import transformer as TTR
from repro_torch.models.tp import StackedTP
from tests.test_torch_models import MODEL_TOL, SSM_GRAD_TOL, _params
from tests.test_torch_tp import _tp_state_from
from tests.test_torch_trainer import STEP_MAX_OFF, STEP_TOL, _rel_off

GOLDEN_4X2 = pathlib.Path(__file__).parent / "golden_specs" / \
    "trainer_neighbor_alternating_4x2.json"
N, B, T = 2, 2, 8
#: (arch, overrides of .reduced(), model ranks)
CONFIGS = {
    "rwkv6": ("rwkv6-7b", {}, (2, 4)),
    "rglru": ("recurrentgemma-9b", {}, (2, 4)),
    "rglru-g1": ("recurrentgemma-9b", {"lru_width": 24}, (2,)),
}
CASES = [(k, M) for k, (_, _, Ms) in CONFIGS.items() for M in Ms]
#: both families compute their recurrences in f32 whatever the model dtype
F32_TOL = MODEL_TOL["float32"]
#: RWKV-6's logits (ROADMAP C17): the whole-node port's agree with the
#: reference's to 0.6-2.5e-5 of max |logits| at N, B, T = 2, 2, 8 over
#: seeds 0-7, f32 and f64 alike, and the split's with the whole node's
#: to 1.1e-5 in f32 (M = 4)
SSM_LOGIT_TOL = 5e-5
LOSS_TOL = 1e-6
#: leaves each rank holds whole: (family, leaf name)
REPLICATED = {
    "ssm": ("w0", "u", "lnx", "lnx_b", "mu_x", "mu_rkvwg", "tm_a1", "tm_a2",
            "wd1", "wd2"),
    "hybrid": ("conv_w", "conv_b", "lam", "gate_x_b", "gate_a_b",
               "gate_x_w", "gate_a_w"),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(key, dtype):
    arch, kw, _ = CONFIGS[key]
    j = dataclasses.replace(jconfigs.get(arch).reduced(),
                            dtype=getattr(jnp, dtype), **kw)
    t = dataclasses.replace(tconfigs.get(arch).reduced(),
                            dtype=getattr(torch, dtype), **kw)
    return j, t


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


@functools.lru_cache(maxsize=None)
def _whole_runs(key, dtype):
    """The inputs, the reference's gradient, losses and logits, and the
    port's whole-node logits, loss and gradient of ``key`` in ``dtype``
    (one run for every M)."""
    jcfg, tcfg = _cfgs(key, dtype)
    rng = np.random.default_rng(0)
    X = _params(jcfg, rng, n=N)
    tokens = rng.integers(0, jcfg.vocab, (N, B, T))
    labels = rng.integers(0, jcfg.vocab, (N, B, T))

    @jax.jit
    def reference(Xs):
        def total(Xs_):
            def node_loss(p, tk, lb):
                logits = JTR.forward(jcfg, p, {"tokens": tk})[0]
                return JTR.loss_fn(jcfg, logits, lb), logits
            losses, logits = jax.vmap(node_loss)(Xs_, tokens, labels)
            return jnp.sum(losses), (losses, logits)
        return jax.grad(total, has_aux=True)(Xs)

    jgrad, (jloss, jlogits) = reference(X)
    tb, tl = {"tokens": torch.from_numpy(tokens)}, torch.from_numpy(labels)
    whole, treedef = tree.flatten(convert.tree_to_torch(X, device="cpu"))
    whole = [w.requires_grad_(True) for w in whole]
    logits_w = TTR.forward(tcfg, tree.unflatten(treedef, whole), tb)[0]
    loss_w = TTR.loss_fn(tcfg, logits_w, tl)
    grads_w = torch.autograd.grad(loss_w.sum(), whole, allow_unused=True)
    return (X, tb, tl, jgrad, jloss, jlogits, [w.detach() for w in whole],
            treedef, logits_w.detach(), loss_w.detach(), grads_w)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("key,M", CASES)
def test_recurrent_tp_forward_and_grads_match_reference_and_whole_node(
        key, M, dtype):
    _, tcfg = _cfgs(key, dtype)
    (X, tb, tl, jgrad, jloss, jlogits, whole, treedef, logits_w, loss_w,
     grads_w) = _whole_runs(key, dtype)

    # the same weights as rank-rows under StackedTP(M)
    tp = StackedTP(M)
    rows = tree.leaves(convert.model_params_to_rank_rows(
        X, M, device="cpu", node_stacked=True))
    rows = [r.requires_grad_(True) for r in rows]
    logits, cache, _ = TTR.forward(tcfg, tree.unflatten(treedef, rows),
                                   tp.node_rows(tb), tp=tp)
    assert cache is None and logits.shape[-1] == tcfg.padded_vocab // M
    loss = TTR.loss_fn(tcfg, logits, tp.node_rows(tl), tp=tp)
    grads = torch.autograd.grad(loss.sum(), rows, allow_unused=True)
    full = tp.first_of_node(tp.gather_last(logits.detach()))
    node_loss = tp.first_of_node(loss.detach())

    ltol = SSM_LOGIT_TOL if tcfg.family == "ssm" else F32_TOL
    assert _rel_err(full, logits_w) <= ltol
    np.testing.assert_allclose(node_loss.numpy(), loss_w.numpy(),
                               rtol=LOSS_TOL)
    assert _rel_err(full, jlogits) <= ltol
    np.testing.assert_allclose(node_loss.numpy(), np.asarray(jloss),
                               rtol=F32_TOL)

    gtol = SSM_GRAD_TOL if tcfg.family == "ssm" else F32_TOL
    paths = [p for p, _ in tree.flatten_with_paths(
        tree.unflatten(treedef, whole))]
    specs = tree.leaves(tsh.param_specs(tree.unflatten(
        treedef, [w[0] for w in whole])))
    jgs = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrad)]
    top = max(float(np.abs(jg).max()) for jg in jgs)
    replicated = set()
    for path, g, gw, jg, sp in zip(paths, grads, grads_w, jgs, specs,
                                   strict=True):
        if g is None:
            assert gw is None and not jg.any(), path
            continue
        if tsh.model_dim(sp) is None:       # replicated: the same bits
            v = g.unflatten(0, (N, M))
            assert all(torch.equal(v[:, 0], v[:, m]) for m in range(M)), \
                path
            replicated.add(path.rsplit("/", 1)[-1])
        joined = tsh.join_rank_rows(g, sp, M).numpy().astype(np.float64)
        scale = float(np.abs(jg).max())
        if scale <= 1e-6 * top:             # zero up to rounding
            scale = top
        assert float(np.abs(joined - jg).max()) <= gtol * scale, path
        assert float(np.abs(joined - gw.numpy()).max()) <= gtol * scale, \
            path
    assert set(REPLICATED[tcfg.family]) <= replicated


def test_whole_node_rwkv6_logits_stay_within_c17s_bar_over_seeds():
    """ROADMAP C17's measurement: the whole-node port's RWKV-6 logits
    against the reference's at N, B, T = 2, 2, 8, seeds 0-7, f64 and f32:
    all within SSM_LOGIT_TOL, and above the model tests' 1e-5 on some
    seed (the reason for the wider bar)."""
    worst = 0.0
    for dtype in ("float64", "float32"):
        jcfg, tcfg = _cfgs("rwkv6", dtype)
        fwd = jax.jit(jax.vmap(lambda p, tk: JTR.forward(
            jcfg, p, {"tokens": tk})[0]))
        for seed in range(8):
            rng = np.random.default_rng(seed)
            X = _params(jcfg, rng, n=N)
            tokens = rng.integers(0, jcfg.vocab, (N, B, T))
            got = TTR.forward(tcfg, convert.tree_to_torch(X, device="cpu"),
                              {"tokens": torch.from_numpy(tokens)})[0]
            err = _rel_err(got, fwd(X, tokens))
            assert err <= SSM_LOGIT_TOL, (dtype, seed)
            worst = max(worst, err)
    assert worst > F32_TOL


def test_the_recurrent_leaves_split_as_the_reference_rules_say():
    """Which leaves a rank holds a slice of, by the reference's specs
    (first match wins), and the paths each family takes."""
    from repro.models import sharding as jsh
    want = {
        "ssm": {"rwkv_wr": 2, "rwkv_wk": 2, "rwkv_wv": 2, "rwkv_wg": 2,
                "rwkv_wo": 1, "cm_wk": 2, "cm_wv": 2, "cm_wr": 2,
                "embed": 0, "lm_head": 1},
        "hybrid": {"rg_w_x": 2, "rg_w_gate": 2, "rg_w_out": 1, "wq": 2,
                   "wk": 2, "wv": 2, "wo": 1, "w_gate": 2, "w_up": 2,
                   "w_down": 1, "embed": 0, "lm_head": 1},
    }
    for key in ("rwkv6", "rglru"):
        jcfg, tcfg = _cfgs(key, "float32")
        tspecs = tree.flatten_with_paths(tsh.param_specs(
            TTR.abstract_params(tcfg)))
        jspecs = jax.tree_util.tree_leaves(
            jsh.param_specs(JTR.abstract_params(jcfg)),
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        assert [tuple(s) for _, s in tspecs] == [tuple(s) for s in jspecs]
        got = {}
        for path, sp in tspecs:
            d = tsh.model_dim(sp)
            if d is not None:
                got[path.rsplit("/", 1)[-1]] = d
        assert got == want[tcfg.family]
    # the RG-LRU's gates: G / M blocks a rank, or gathered where M does
    # not divide G
    from repro_torch.models import rglru
    for key, M, split in (("rglru", 2, True), ("rglru", 4, True),
                          ("rglru-g1", 2, False)):
        _, tcfg = _cfgs(key, "float32")
        G = TTR.abstract_params(tcfg)["rec_blocks"]["gate_x_w"].shape[1]
        assert (G % M == 0) == split and G == (16 if split else 1)
    assert rglru.GATE_BLOCKS == 16


def test_rwkv_heads_cut_by_the_model_ranks_are_refused():
    cfg = tconfigs.get("rwkv6-7b").reduced(d_model=64)     # 2 heads of 32
    with pytest.raises(ValueError, match="2 RWKV heads of 32"):
        TTR.forward(cfg, TTR.abstract_params(cfg), {"tokens": torch.zeros(
            (4, 1, 4), dtype=torch.int64)}, tp=StackedTP(4))
    with pytest.raises(ValueError, match="do not split into 4 model ranks"):
        TTR.init_cache(cfg, 1, 4, tp=StackedTP(4))
    with pytest.raises(ValueError, match="RWKV heads"):
        tapi.build_trainer_runner(_spec_for("rwkv6-7b", mesh=(2, 4)),
                                  device="cpu", tp=StackedTP(4))
    # production widths: 64 heads split at 16
    big = tconfigs.get("rwkv6-7b")
    assert (big.d_model // big.rwkv_head_size) % 16 == 0


# --- the trainer -------------------------------------------------------------

def _spec_for(arch, mesh=(4, 2)):
    d = json.loads(GOLDEN_4X2.read_text())
    d["model"]["arch"] = arch
    d["model"]["seq_len"] = T
    d["execution"]["mesh"] = list(mesh)
    return tapi.ExperimentSpec.from_json(json.dumps(d))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b"])
def test_teacher_forced_recurrent_tp_step_matches_the_whole_node_step(arch):
    spec = _spec_for(arch)
    whole = tapi.build_trainer_runner(spec, device="cpu")
    run = tapi.build_trainer_runner(spec, device="cpu", tp=StackedTP(2))
    tr = run.trainer
    assert tr.tp.M == tr.wire_shards == 2
    assert run.bits_per_step() == whole.bits_per_step()
    data = whole.default_data()
    dw, dt = GeneratorDraws(5, "cpu"), GeneratorDraws(5, "cpu")
    sw = whole.init_state()
    for k in range(2):
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
                                   rtol=LOSS_TOL)
        np.testing.assert_allclose(float(mt["consensus"]),
                                   float(mw["consensus"]), rtol=1e-5)
        assert run.bits_per_step(st) == whole.bits_per_step()
    p = st.plead
    for name, t in (("X", p.X), ("D", p.D), ("H", p.comm.H),
                    ("Hw", p.comm.Hw)):
        for leaf, sp in zip(tree.leaves(t), tr.leaf_specs):
            if tsh.model_dim(sp) is None:
                v = leaf.unflatten(0, (-1, 2))
                assert torch.equal(v[:, 0], v[:, 1]), name
