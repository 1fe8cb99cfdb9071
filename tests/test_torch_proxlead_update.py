"""Kernels B5/B6 (``repro_torch.kernels.proxlead``): the neighbor trainer's
Prox-LEAD update in two passes a leaf, against the eager update.

On the CPU the wrappers take the binding's checks and run their plain
twins, which ``DecentralizedTrainer._sharded_update`` also runs as its
eager update; they must equal the eager sequence the trainer ran before
the kernels bit for bit:

* the twins alone, case by case against that eager sequence (written out
  below as the trainer ran it, through the model-shard views of M = 1):
  T = 1, and T = 2 at t = 0 and t = 1; every prox with an elementwise form
  (none, l1, l2sq, elastic_net, nonneg); leaves of rank 1, 2 and 3, one
  whose q, W Q and diff rows are views into padded bucket-group tables
  (their own row and node strides), and an odd last axis;
* two ``train_step`` s of small trainers through the fused dispatch
  (bucketed on the ring, bucketed under ``alternating`` with 2 Hw slots,
  the per-leaf wire, identity compression) against the same trainers
  whose prox is an equal callable with no elementwise form: X, D, H and Hw
  equal bit for bit, and the twins ran once a leaf a step;
* the dispatch's bypasses: group lasso, a model-sharded wire (M = 2) and
  a prox callable without the form take the eager lines;
* on ``meta``, the dry run's route: one B5 and one B6 a leaf, and the
  update's peak of live bytes not above the eager update's;
* each prox's form equals its ``__call__`` bit for bit;
* ``cuda`` cases: the kernels against their twins on the card on both
  variants (the vector one on aligned views of whole 16-byte units, the
  scalar one on an odd last axis and on views one element off), with
  padded rows and with rows the launcher folds into one a node, and slot
  counts 1, 2 and 3; two teacher-forced updates of small trainers (the
  bucketed wire on the ring and under ``alternating``, the per-leaf
  wire, identity compression) against the eager ones; skipped without
  a card.

The file imports nothing of JAX, so the card runs its ``cuda`` cases with
``python -m pytest --noconftest -m cuda tests/test_torch_proxlead_update.py``.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch import api, tree
from repro_torch.core import prox as prox_mod
from repro_torch.core.draws import GeneratorDraws
from repro_torch.kernels import proxlead as kupd
from repro_torch.kernels import quantize as qk
from repro_torch.models import sharding

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden_specs"
ETA, ALPHA, GAMMA = 0.05, 0.3, 1.0

PROXES = {"none": prox_mod.NoneProx(), "l1": prox_mod.L1(lam=2.0),
          "l2sq": prox_mod.L2Sq(lam=0.7),
          "elastic_net": prox_mod.ElasticNet(lam1=2.0, lam2=0.7),
          "nonneg": prox_mod.NonNeg()}

# leaf shape per node, last-axis padding of the wire's rows (0: the views
# are the leaves themselves, contiguous)
LEAVES = {"rank1": ((40,), 0), "rank2": ((6, 16), 0),
          "rank3": ((3, 5, 8), 0), "padded": ((3, 5, 12), 4),
          "odd": ((7, 3), 5)}
SLOTS = [(1, 0), (2, 0), (2, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf(g, shape, scale=0.1):
    """Values around the l1 threshold (ETA x 2.0 = 0.1), with zeros and
    negative zeros."""
    x = torch.randn(shape, generator=g) * scale
    flat = x.view(-1)
    flat[::7] = 0.0
    flat[3::11] = -0.0
    return x


def _rows_view(g, N, shape, pad, slots=None, fill=True):
    """A leaf (N, [slots,] *shape) as a view into a bucket-group-like table:
    each node's rows a group of extra rows apart, each row ``pad``
    elements wider than the leaf's last axis (the block padding)."""
    D = shape[-1]
    L = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    lead = (N,) if slots is None else (N, slots)
    if pad == 0:
        buf = torch.empty(lead + tuple(shape))
        view = buf
    else:
        buf = torch.empty(lead + (L + 3, D + pad))
        view = buf[..., 2:2 + L, :D].view(lead + tuple(shape))
    if fill:
        view.copy_(_leaf(g, view.shape))
    return view


def _operands(case, slots, seed=0):
    shape, pad = LEAVES[case]
    g = torch.Generator().manual_seed(seed)
    N = 4
    x, gr, d, h = (_leaf(g, (N,) + shape) for _ in range(4))
    hw = _leaf(g, (N, slots) + shape)
    q = _rows_view(g, N, shape, pad)
    w = _rows_view(g, N, shape, pad, slots=slots)
    rows = _rows_view(g, N, shape, pad, fill=False)
    return x, gr, d, h, hw, q, w, rows


def _eager_update(x, gr, d, h, hw, q, w, rows, t, prox):
    """``_sharded_update``'s eager lines on one leaf at M = 1 (the shard
    views of a replicated spec, as the trainer's ``view``)."""
    sp, M, n = sharding.P(), 1, x.shape[0]
    view = lambda a, lead=1: sharding.shard_view(a, sp, model=M,  # noqa: E731
                                                 lead=lead)
    T = w.shape[1]
    z = x - ETA * gr - ETA * d
    rows.unflatten(0, (n, M)).copy_(view(z - h))
    zv, dv, hv = (view(a) for a in (z, d, h))
    qv = q.unflatten(0, (n, M))[:, :1]
    wv = w.unflatten(0, (n, M))[:, :1]
    zhat = qv.add_(hv)
    if T == 1:
        hwv = view(hw[:, 0])
        zhat_w = wv[:, :, 0].add_(hwv)
        hwv.mul_(1 - ALPHA).add_(ALPHA * zhat_w)
    else:
        hwv = view(hw, lead=2)
        zhat_w = hwv[:, :, t] + wv[:, :, t]
        hwv.add_(wv, alpha=ALPHA)
    hv.mul_(1 - ALPHA).add_(ALPHA * zhat)
    e = zhat.sub_(zhat_w)
    dv.add_(GAMMA / (2 * ETA) * e)
    zv.sub_(GAMMA / 2.0 * e)
    return prox(z, ETA)


def _fused_update(x, gr, d, h, hw, q, w, rows, t, prox):
    z, diff = kupd.head(x, gr, d, h, ETA, out=rows)
    assert diff is rows
    return kupd.tail(z, d, h, hw, q, w, t, eta=ETA, alpha=ALPHA,
                     gamma=GAMMA, prox=prox.elementwise(ETA))


def _same(a, b):
    """Bit for bit, the sign of a zero included."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


TWIN_CASES = [(leaf, T, t, p) for leaf in LEAVES for T, t in SLOTS
              for p in PROXES]


@pytest.mark.parametrize(
    "leaf,T,t,prox", TWIN_CASES,
    ids=[f"{a}-T{b}t{c}-{d}" for a, b, c, d in TWIN_CASES])
def test_twins_equal_the_eager_update(leaf, T, t, prox):
    """B5/B6's plain twins on one leaf: z's diff rows, X, D, H and every Hw
    slot bit for bit the eager update's, from the same operands."""
    p = PROXES[prox]
    want = _operands(leaf, T)
    got = [a.clone() if a.is_contiguous() else _restride(a)
           for a in want]
    x_want = _eager_update(*want, t, p)
    x_got = _fused_update(*got, t, p)
    for name, i in (("D", 2), ("H", 3), ("Hw", 4), ("diff", 7)):
        assert _same(got[i], want[i]), name
    assert _same(x_got, x_want)
    assert x_got.data_ptr() != want[0].data_ptr()


def _restride(a):
    """A copy of view ``a`` with ``a``'s strides and storage offset."""
    buf = a.new_empty(a.untyped_storage().nbytes() // a.element_size())
    out = buf.as_strided(a.shape, a.stride(), a.storage_offset())
    return out.copy_(a)


def test_restride_keeps_the_views_layout():
    a = _operands("padded", 2)[6]
    b = _restride(a)
    assert b.stride() == a.stride() and not b.is_contiguous()
    assert torch.equal(a, b)


@pytest.mark.parametrize("prox", list(PROXES))
def test_prox_forms_equal_their_calls(prox):
    """``Prox.elementwise(eta)(x)`` is ``Prox(x, eta)`` bit for bit; a
    stacked grid's tensor eta has no form."""
    p = PROXES[prox]
    x = _leaf(torch.Generator().manual_seed(1), (64, 33), scale=1.0)
    assert _same(p.elementwise(ETA)(x), p(x, ETA))
    assert p.elementwise(torch.full((3,), ETA, dtype=torch.float64)) is None


def test_group_lasso_and_the_base_prox_have_no_form():
    assert prox_mod.GroupLasso(lam=0.1).elementwise(ETA) is None
    assert prox_mod.Prox().elementwise(ETA) is None


def test_prox_args_carry_the_forms_constants():
    f = prox_mod.ElasticNet(lam1=2.0, lam2=0.7).elementwise(ETA)
    flags, thresh, div = kupd.prox_args(f)
    assert flags == kupd.PROX_FLAGS["soft"] | kupd.PROX_FLAGS["div"]
    assert (thresh, div) == (ETA * 2.0, 1.0 + ETA * 0.7)
    assert kupd.prox_args(prox_mod.NonNeg().elementwise(ETA)) == \
        (kupd.PROX_FLAGS["nonneg"], 0.0, 1.0)


def test_c_flags_match_the_wrapper():
    import re
    src = qk.SOURCES["proxlead_update"].read_text()
    for name, c in (("soft", "kSoft"), ("nonneg", "kNonneg"),
                    ("div", "kDiv")):
        assert int(re.search(rf"constexpr int {c} = (\d+);", src)[1]) == \
            kupd.PROX_FLAGS[name]


# --- the trainer's dispatch --------------------------------------------------

class _Opaque:
    """A prox callable equal to ``inner`` with no elementwise form: the
    trainer runs its eager update."""

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, x, eta):
        return self.inner(x, eta)


def _spec(wire, schedule="static", prox=("l1", {"lam": 0.02})):
    d = json.loads((GOLDEN / "trainer_neighbor_bucketed_8x1.json").read_text())
    d["topology"]["graph"] = "ring"
    d["topology"]["schedule"] = schedule
    d["prox"] = {"name": prox[0], "params": prox[1]}
    d["model"]["d_model"] = 32
    if wire == "per_leaf":
        d["execution"]["wire_mode"] = "per_leaf"
    elif wire == "identity":
        d["compressor"] = {"name": "identity", "params": {}}
    return api.ExperimentSpec.from_dict(d)


def _states(runner, steps, seed=0):
    data = runner.default_data()
    st = runner.init_state()
    draws = GeneratorDraws(seed, "cpu")
    for k in range(steps):
        st, _ = runner.step(st, data.batch_at(k), draws)
    p = st.plead
    return [tree.leaves(a) for a in (p.X, p.D, p.comm.H, p.comm.Hw)]


def _counting(monkeypatch):
    calls = {"head": 0, "tail": 0}
    for name in calls:
        plain = getattr(kupd, f"{name}_plain")

        def counted(*a, _plain=plain, _name=name, **kw):
            calls[_name] += 1
            return _plain(*a, **kw)
        monkeypatch.setattr(kupd, f"{name}_plain", counted)
    return calls


TRAINER_CASES = [("bucketed", "static"), ("bucketed", "alternating"),
                 ("per_leaf", "static"), ("identity", "static")]


@pytest.mark.parametrize("wire,schedule", TRAINER_CASES,
                         ids=[f"{w}-{s}" for w, s in TRAINER_CASES])
def test_fused_steps_equal_the_eager_steps(wire, schedule, monkeypatch):
    """Two steps through B5/B6's twins against two eager steps of the same
    trainer (its prox an equal callable with no form), same data and
    draws: X, D, H and every Hw slot bit for bit."""
    spec = _spec(wire, schedule)
    eager = api.build_trainer_runner(spec, device="cpu")
    eager.trainer.prox = _Opaque(eager.trainer.prox)
    assert eager.trainer._fused_prox(ETA) is None
    want = _states(eager, 2)
    fused = api.build_trainer_runner(spec, device="cpu")
    assert fused.trainer._fused_prox(ETA) is not None
    calls = _counting(monkeypatch)
    got = _states(fused, 2)
    n_leaves = len(got[0])
    assert calls == {"head": 2 * n_leaves, "tail": 2 * n_leaves}
    assert (fused.trainer.hw_slots == 2) == (schedule == "alternating")
    for name, a, b in zip("XDH", got, want):
        assert all(_same(u, v) for u, v in zip(a, b)), name
    assert all(_same(u, v) for u, v in zip(got[3], want[3])), "Hw"


def _eager_only(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the fused update ran")
    monkeypatch.setattr(kupd, "head", refuse)
    monkeypatch.setattr(kupd, "tail", refuse)


def test_group_lasso_trainer_takes_the_eager_path(monkeypatch):
    runner = api.build_trainer_runner(
        _spec("bucketed", prox=("group_lasso", {"lam": 0.02})), device="cpu")
    assert runner.trainer._fused_prox(ETA) is None
    _eager_only(monkeypatch)
    X = _states(runner, 1)[0]
    assert all(bool(torch.isfinite(x).all()) for x in X)


def test_model_sharded_wire_takes_the_eager_path(monkeypatch):
    """M = 2: the bucketed wire cuts each node's leaves into model shards,
    and the update runs on shard views."""
    d = json.loads((GOLDEN / "trainer_neighbor_alternating_4x2.json")
                   .read_text())
    d["prox"] = {"name": "l1", "params": {"lam": 0.02}}
    runner = api.build_trainer_runner(api.ExperimentSpec.from_dict(d),
                                      device="cpu")
    assert runner.trainer.wire_shards == 2
    assert runner.trainer._fused_prox(ETA) is None
    _eager_only(monkeypatch)
    X = _states(runner, 1)[0]
    assert all(bool(torch.isfinite(x).all()) for x in X)


def test_a_prox_callable_without_the_form_takes_the_eager_path(monkeypatch):
    runner = api.build_trainer_runner(_spec("bucketed"), device="cpu")
    runner.trainer.prox = lambda z, eta: z
    assert runner.trainer._fused_prox(ETA) is None
    _eager_only(monkeypatch)
    _states(runner, 1)


@pytest.mark.parametrize("schedule", ["static", "alternating"])
def test_fused_dry_update_launches_once_a_leaf_and_holds_no_more(schedule):
    """On ``meta`` (the dry run's route) the update counts one B5 and one
    B6 a leaf, and its peak of live bytes is not above the eager update's
    from the same state (the peak lies in the exchange): in particular no
    view of the diff rows keeps a bucket group's table alive through it."""
    from repro_torch import configs
    from repro_torch.core.draws import MetaDraws
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.obs.record import LiveBytes
    cfg = configs.get("qwen3-1.7b").reduced()
    mesh = mesh_mod.Mesh((8, 1))
    spec = dataclasses.replace(
        dryrun.train_spec(cfg, mesh),
        topology=api.TopologySpec(graph="ring", schedule=schedule),
        prox=api.ProxSpec("l1", {"lam": 1e-3}))
    peaks, calls = {}, {}
    for key in ("fused", "eager"):
        tr, _ = dryrun.meta_trainer(spec, mesh, cfg, "one process")
        if key == "eager":
            tr.prox = _Opaque(tr.prox)
        st = tr.abstract_state()
        G = [torch.empty_like(x) for x in tree.leaves(st.plead.X)]
        qk.reset_meta_calls()
        with LiveBytes((st, G)) as lb:
            tr._sharded_update(st.plead, G, MetaDraws())
        peaks[key], calls[key] = lb.peak, qk.meta_call_counts()
    n = len(tree.leaves(st.plead.X))
    assert calls["fused"][kupd.HEAD] == calls["fused"][kupd.TAIL] == n
    assert calls["eager"][kupd.HEAD] == calls["eager"][kupd.TAIL] == 0
    assert peaks["fused"] <= peaks["eager"]


# --- the wrappers' routes ----------------------------------------------------

def test_cpu_route_launches_nothing():
    qk.reset_launch_counts()
    qk.reset_meta_calls()
    ops = _operands("rank2", 1)
    _fused_update(*ops, 0, PROXES["l1"])
    assert qk.launch_counts()[kupd.HEAD] == qk.launch_counts()[kupd.TAIL] == 0
    assert qk.meta_call_counts()[kupd.HEAD] == 0


def test_node_rows_reads_views_as_the_binding_does():
    g = torch.Generator().manual_seed(0)
    v = _rows_view(g, 4, (3, 5, 12), 4)
    assert kupd.node_rows(v) == ([v.stride(0), 0, 16], 15, 12)
    w = _rows_view(g, 4, (3, 5, 12), 4, slots=2)
    assert kupd.node_rows(w, lead=2) == ([w.stride(0), w.stride(1), 16], 15,
                                         12)
    assert kupd.node_rows(torch.zeros(4, 7)) == ([7, 0, 7], 1, 7)
    assert kupd.node_rows(torch.zeros(4)) == ([1, 0, 1], 1, 1)
    assert kupd.node_rows(torch.zeros(4, 6, 8)[:, :, ::2]) is None
    assert kupd.node_rows(torch.zeros(4, 6, 8).transpose(1, 2)) is None


def test_unsupported_devices_raise():
    class Elsewhere(torch.Tensor):
        @property
        def device(self):
            return torch.device("xpu")
    x = torch.Tensor._make_subclass(Elsewhere, torch.zeros(2, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        kupd.head(x, x, x, x, ETA, out=torch.zeros(2, 4))


# --- on the card -------------------------------------------------------------

def _card_operands(shape, slots, offset, seed, pad=4):
    """Operands on the card: the state contiguous, q, w and the diff rows
    views into tables whose rows are ``pad`` wider than the leaf's (0: rows
    that follow one another, which the launcher folds into one a node),
    everything ``offset`` f32 into its buffer."""
    g = torch.Generator().manual_seed(seed)
    N, D = 8, shape[-1]
    L = int(np.prod(shape[:-1])) if len(shape) > 1 else 1

    def state(lead=(N,)):
        n = int(np.prod(lead + tuple(shape)))
        buf = _leaf(g, (n + offset,)).cuda()
        return buf[offset:].view(lead + tuple(shape))

    def rows(lead=(N,)):
        buf = _leaf(g, lead + (L + 2, D + pad + offset)).cuda()
        return buf[..., 1:1 + L, offset:offset + D].view(lead + tuple(shape))

    return (state(), state(), state(), state(), state((N, slots)), rows(),
            rows((N, slots)), rows())


CUDA_CASES = [((1024, 2048), 1, 0, 4), ((1024, 2048), 2, 0, 4),
              ((64, 256), 3, 0, 4), ((5, 7, 256), 2, 0, 4),
              ((4000,), 1, 0, 4), ((300, 3), 1, 0, 4), ((300, 3), 2, 0, 4),
              ((64, 256), 1, 1, 4), ((64, 256), 2, 1, 4),
              ((1024, 2048), 1, 0, 0), ((1024, 2048), 2, 0, 0),
              ((5, 7, 256), 3, 0, 0), ((300, 3), 1, 0, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,slots,offset,pad", CUDA_CASES, ids=str)
@pytest.mark.parametrize("prox", list(PROXES))
def test_cuda_kernels_match_their_twins(shape, slots, offset, pad, prox):
    """B5 and B6 on the card against their twins on the card, the same
    operands: z, the diff rows, X, D, H and every Hw slot bit for bit; each
    call on the variant its shape and alignment name, rows folded into one
    a node where no operand pads them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    p = PROXES[prox]
    form = p.elementwise(ETA)
    for t in range(slots):
        ops = _card_operands(shape, slots, offset, seed=slots * 10 + t,
                             pad=pad)
        plain = [a.clone() for a in ops]
        x, gr, d, h, hw, q, w, rows = ops
        before = qk.launch_counts()
        z, _ = kupd.head(x, gr, d, h, ETA, out=rows)
        vector = shape[-1] % 4 == 0 and offset == 0
        assert kupd.uses_vector_variant(kupd.HEAD, x, gr, d, h, z,
                                        rows) == vector
        assert kupd.uses_vector_variant(kupd.TAIL, z, d, h, hw, q,
                                        w) == vector
        X = kupd.tail(z, d, h, hw, q, w, t, eta=ETA, alpha=ALPHA,
                      gamma=GAMMA, prox=form)
        torch.cuda.synchronize()
        after = qk.launch_counts()
        assert after[kupd.HEAD] == before[kupd.HEAD] + 1
        assert after[kupd.TAIL] == before[kupd.TAIL] + 1
        px, pg, pd, ph, phw, pq, pw, prows = plain
        pz, pdiff = kupd.head_plain(px, pg, pd, ph, ETA)
        prows.copy_(pdiff)
        PX = form(kupd.tail_plain(pz, pd, ph, phw, pq, pw, t, eta=ETA,
                                  alpha=ALPHA, gamma=GAMMA))
        for name, a, b in (("diff", rows, prows), ("D", d, pd), ("H", h, ph),
                           ("Hw", hw, phw), ("X", X, PX)):
            assert _same(a, b), name
        assert X.data_ptr() == z.data_ptr()


def _clone_plead(p):
    c = lambda t: tree.tree_map(torch.clone, t)   # noqa: E731
    return p._replace(X=c(p.X), D=c(p.D),
                      comm=p.comm._replace(H=c(p.comm.H), Hw=c(p.comm.Hw)))


@pytest.mark.cuda
@pytest.mark.parametrize("wire,schedule", TRAINER_CASES,
                         ids=[f"{w}-{s}" for w, s in TRAINER_CASES])
def test_cuda_trainer_updates_equal_the_eager_updates(wire, schedule):
    """Two updates of a small trainer on the card (each wire: the bucketed
    one on the ring and under ``alternating``, whose qself and W Q are
    views into B4's group outputs; the per-leaf wire and identity
    compression, whose are leaf tensors), teacher-forced: the same state,
    gradient and draws through ``_sharded_update`` by B5/B6 and by the
    eager lines (its prox an equal callable with no form), X, D, H and
    every Hw slot bit for bit.  (A whole step does not repeat bit for bit
    on the card: the embedding's backward sums with atomics.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    runner = api.build_trainer_runner(_spec(wire, schedule), device="cuda")
    tr = runner.trainer
    st = runner.init_state()
    _, G = tr.loss_and_grad(st.plead.X, runner.default_data().batch_at(0))
    G = tree.leaves(G)
    outs = {}
    for key, prox in (("fused", tr.prox), ("eager", _Opaque(tr.prox))):
        tr.prox = prox
        plead = _clone_plead(st.plead)
        draws = GeneratorDraws(0, "cuda")
        qk.reset_launch_counts()
        for _ in range(2):
            plead = tr._sharded_update(plead, [g.clone() for g in G], draws)
        torch.cuda.synchronize()
        outs[key] = (qk.launch_counts(), [
            tree.leaves(a) for a in (plead.X, plead.D, plead.comm.H,
                                     plead.comm.Hw)])
    (fc, got), (ec, want) = outs["fused"], outs["eager"]
    n = len(got[0])
    assert fc[kupd.HEAD] == fc[kupd.TAIL] == 2 * n
    assert ec[kupd.HEAD] == ec[kupd.TAIL] == 0
    for name, a, b in zip(("X", "D", "H", "Hw"), got, want):
        assert all(_same(u, v) for u, v in zip(a, b)), name
