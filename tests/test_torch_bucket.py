"""The port's bucketed wire layout, wire buffers, exchange plans and
``WireExchange`` against the JAX package.

* ``compute_layout``: equal slots, groups, offsets and wire bits over the
  shape sets of ``tests/test_bucket.py``.
* ``pack_to_wire``: byte-identical u8 buffers from the same noise, with f32
  and bf16 scales; ``mix_from_wire`` and ``rows_to_leaf`` agree.
* ``compile_plan``: equal hops, pairs and weights.
* The exchange: the reference's ``WireExchange`` runs once per node under
  ``jax.vmap(..., axis_name="n")`` with ``pp = ppermute(x, "n", pairs)``
  (leaves keep a local node dim of 1, as under ``shard_map``); the port's
  node-stacked ``bucketed``, ``per_leaf`` and ``identity`` run with the
  same noise, replayed from the reference's per-node keys.  Codes, scales
  and qself are exact; the mixes agree within the bound that
  ``tests/test_torch_wire_kernels.py`` states.  The port's ``pp`` is called
  exactly twice per hop on u8 buffers whose per-node bytes are the layout's
  ``wire_bits / 8``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bucket as jbucket
from repro.core import topology as jtopo
from repro.kernels import ops as jkops
from repro.optim.wire import WireExchange as JWireExchange
from repro_torch.core import bucket as tbucket
from repro_torch.core import topology as ttopo
from repro_torch.core.draws import ReplayDraws
from repro_torch.kernels import ops as tops
from repro_torch.optim.wire import WireExchange, stacked_pp

SHAPE_SETS = [
    [(1, 64), (1, 4, 256), (1, 300)],                 # ragged last dim
    [(1, 8, 256), (1, 2, 2, 128), (1, 5), (1, 16)],   # mixed widths
    [(1, 1)],                                         # degenerate scalarish
    [(1, 257), (1, 3, 511)],                          # odd widths (padded)
]
_F32_EPS = float(torch.finfo(torch.float32).eps)


def _leaves(shapes, seed, n=1):
    """n-node-stacked leaves ((n,) + shape[1:]) from numpy."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n,) + tuple(s[1:])) * 2).astype(np.float32)
            for s in shapes]


def _noise(layout, n, seed):
    """Per leaf, the node-stacked blocked noise (n, ..., nb, block)."""
    rng = np.random.default_rng(seed)
    return [rng.random((n,) + sl.shape[1:-1] + (sl.nb, sl.block)
                       ).astype(np.float32) for sl in layout.slots]


def _assert_layouts_equal(lt, lj):
    assert (lt.codes_bytes, lt.scales_bytes, lt.scale_bytes, lt.bits,
            lt.wire_bits) == (lj.codes_bytes, lj.scales_bytes,
                              lj.scale_bytes, lj.bits, lj.wire_bits)
    for a, b in zip(lt.slots, lj.slots, strict=True):
        assert (a.index, a.shape, a.block, a.nb, a.rows, a.group,
                a.row_offset) == (b.index, b.shape, b.block, b.nb, b.rows,
                                  b.group, b.row_offset)
        assert tbucket.dtype_name(a.dtype) == b.dtype.name
    for a, b in zip(lt.groups, lj.groups, strict=True):
        assert (a.block, a.packed_width, a.rows, a.codes_offset,
                a.scales_offset, a.leaf_indices) == (
            b.block, b.packed_width, b.rows, b.codes_offset,
            b.scales_offset, b.leaf_indices)
        assert tbucket.dtype_name(a.dtype) == b.dtype.name


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("shapes", SHAPE_SETS)
def test_layout_matches_reference(shapes, bits):
    for dt_t, dt_j, sb in ((torch.float32, jnp.float32, 4),
                           (torch.bfloat16, jnp.bfloat16, 2)):
        lt = tbucket.compute_layout(shapes, [dt_t] * len(shapes), bits=bits,
                                    scale_bytes=sb)
        lj = jbucket.compute_layout(shapes, [dt_j] * len(shapes), bits=bits,
                                    scale_bytes=sb)
        _assert_layouts_equal(lt, lj)


@pytest.mark.parametrize("scales_bf16", [False, True])
@pytest.mark.parametrize("shapes", SHAPE_SETS)
def test_wire_buffers_and_mix_match_reference(shapes, scales_bf16):
    """pack_to_wire byte-identical; mix_from_wire (self + one received
    payload) exact in qself and within the bound in the mix;
    rows_to_leaf round-trips."""
    sb = 2 if scales_bf16 else 4
    leaves = _leaves(shapes, seed=len(shapes))
    lt = tbucket.compute_layout(shapes, [torch.float32] * len(shapes),
                                bits=2, scale_bytes=sb)
    lj = jbucket.compute_layout(shapes, [jnp.float32] * len(shapes),
                                bits=2, scale_bytes=sb)
    us = _noise(lt, 1, seed=7)
    xbs = [jkops.blockwise_lastdim(jnp.asarray(x), block=sl.block)
           for x, sl in zip(leaves, lj.slots)]
    cj, sj = jbucket.pack_to_wire(lj, xbs, [jnp.asarray(u) for u in us])
    rows = tbucket.RowTables.from_leaves(
        lt, [torch.from_numpy(x) for x in leaves])
    noise = tbucket.RowTables(lt, 1, "cpu", zero_pad=False)
    for j, u in enumerate(us):
        noise.block_view(j).copy_(torch.from_numpy(u))
    for j, x in enumerate(leaves):                 # rows_to_leaf round-trip
        sl = lt.slots[j]
        back = tbucket.rows_to_leaf(
            sl, rows.tables[sl.group][0, sl.row_offset:
                                      sl.row_offset + sl.rows])
        np.testing.assert_array_equal(back.numpy(), x)
        np.testing.assert_array_equal(rows.leaf_view(j).numpy(), x)
    ct, st = tbucket.pack_to_wire(lt, rows.tables, noise.tables)
    assert ct.dtype == st.dtype == torch.uint8
    np.testing.assert_array_equal(ct[0].numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st[0].numpy(), np.asarray(sj))
    # mix: self plus the same payload received once more, T = 2
    w = np.array([[0.25, 0.75], [1.0, -0.5]], np.float32)
    wqj, qsj = jbucket.mix_from_wire(lj, [(cj, sj)] * 2, jnp.asarray(w))
    wqt, qst = tbucket.mix_from_wire(lt, [(ct, st)] * 2,
                                     torch.from_numpy(w)[None])
    for j in range(len(shapes)):
        np.testing.assert_array_equal(qst[j].numpy(), np.asarray(qsj[j]))
        bound = 3 * _F32_EPS * np.einsum(
            "ts,...->t...", np.abs(w), np.abs(np.asarray(qsj[j][0])))
        assert np.all(np.abs(wqt[j][0].numpy() - np.asarray(wqj[j])[:, 0])
                      <= bound)


@pytest.mark.parametrize("name,n", [("ring", 8), ("exponential", 8),
                                    ("torus2d", 9), ("expander", 8),
                                    ("ring", 4), ("star", 5)])
def test_compile_plan_matches_reference(name, n):
    Wt = ttopo.make_topology(name, n).W
    np.testing.assert_array_equal(Wt, jtopo.make_topology(name, n).W)
    pt, pj = ttopo.compile_plan(Wt, name=name), jtopo.compile_plan(Wt,
                                                                   name=name)
    assert pt.T == pj.T and len(pt.hops) == len(pj.hops)
    for a, b in zip(pt.hops, pj.hops):
        assert a.pairs == b.pairs and a.shift == b.shift
        np.testing.assert_array_equal(a.weights, b.weights)
    np.testing.assert_array_equal(pt.self_weights(np.float32),
                                  pj.self_weights(np.float32))
    np.testing.assert_allclose(pt.as_matrices()[0], Wt, atol=1e-12)


# --- the exchange ---------------------------------------------------------------

class RecordingPP:
    """The one-card seam, recording what crosses it."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, pairs):
        self.calls.append((x.dtype, tuple(x.shape)))
        return stacked_pp(x, pairs)


def _reference_exchange(mode, diffs, n, wmat, hop_pairs, seed, bits=2):
    """The reference's WireExchange once per node under vmap + ppermute;
    returns (wq, qself, per-leaf node-stacked noise it drew)."""
    keys = [jax.random.split(jax.random.key(seed * 100 + j), n)
            for j in range(len(diffs))]
    wx = JWireExchange(bits=bits)

    def node(ds, ks, w):
        pp = lambda x, pairs: jax.lax.ppermute(x, "n", pairs)  # noqa: E731
        if mode == "identity":
            return wx.identity(ds, w, hop_pairs, pp)
        return getattr(wx, mode)(ds, ks, w, hop_pairs, pp)

    stacked = [jnp.asarray(d)[:, None] for d in diffs]   # local node dim 1
    wq, qs = jax.jit(jax.vmap(node, axis_name="n", in_axes=(0, 0, 2)))(
        stacked, keys, jnp.asarray(wmat))
    noise = []
    for d, ks in zip(stacked, keys):
        blk = jbucket.default_quant_block(d.shape[1:], 256)
        shape = jkops.blockwise_lastdim(d[0], block=blk).shape
        noise.append(np.stack([np.asarray(jax.random.uniform(
            k, shape, jnp.float32)) for k in ks]))
    return ([np.asarray(a)[:, :, 0] for a in wq],
            [np.asarray(a)[:, 0] for a in qs], noise)


_EXCHANGE_SHAPES = [(1, 64), (1, 4, 256), (1, 300), (1, 2, 128), (1, 5)]


@pytest.mark.parametrize("mode", ["bucketed", "per_leaf", "identity"])
@pytest.mark.parametrize("graph,n", [("ring", 4), ("exponential", 8)])
def test_exchange_matches_reference_under_vmap(mode, graph, n):
    plan = jtopo.compile_plan(jtopo.make_topology(graph, n).W)
    wmat = np.concatenate([plan.self_weights(np.float32)[None]]
                          + [h.weights[None] for h in plan.hops],
                          0).astype(np.float32)
    hop_pairs = [list(h.pairs) for h in plan.hops]
    diffs = _leaves(_EXCHANGE_SHAPES, seed=n, n=n)       # (n, ...) each
    wqj, qsj, noise = _reference_exchange(mode, diffs, n, wmat, hop_pairs,
                                          seed=n)
    pp = RecordingPP()
    wx = WireExchange(bits=2)
    td = [torch.from_numpy(d) for d in diffs]
    draws = ReplayDraws(noise, "cpu")
    layout = wx.layout(wx.local_shapes(td), [t.dtype for t in td])
    if mode == "identity":
        wqt, qst = wx.identity(td, torch.from_numpy(wmat), hop_pairs, pp)
    else:
        src = (tbucket.RowTables.from_leaves(layout, td)
               if mode == "bucketed" else td)
        wqt, qst = getattr(wx, mode)(src, draws, torch.from_numpy(wmat),
                                     hop_pairs, pp)
        assert not draws.pending
    S = 1 + len(hop_pairs)
    for j, d in enumerate(diffs):
        np.testing.assert_array_equal(qst[j].numpy(), qsj[j])
        assert wqt[j].shape == (n, 1) + d.shape[1:]
        # the bound, with every |Q_s| majorised by the largest |Q|
        mag = np.abs(wmat[:, 0, :]).sum(0).reshape((n,) + (1,) * (d.ndim - 1)
                                                   ) * np.abs(qsj[j]).max()
        assert np.all(np.abs(wqt[j][:, 0].numpy() - wqj[j][:, 0])
                      <= (S + 1) * _F32_EPS * mag)
    # the pp contract
    if mode == "bucketed":
        assert len(pp.calls) == 2 * len(hop_pairs)
        assert all(dt == torch.uint8 for dt, _ in pp.calls)
        per_node = sum(int(np.prod(shape[1:])) for _, shape in pp.calls)
        assert per_node == len(hop_pairs) * layout.wire_bits // 8
    elif mode == "per_leaf":
        assert len(pp.calls) == 2 * len(hop_pairs) * len(diffs)
        assert all(dt == torch.uint8 for dt, _ in pp.calls)
        per_node = sum(int(np.prod(shape[1:])) for _, shape in pp.calls)
        assert per_node == len(hop_pairs) * layout.wire_bits // 8


def test_bucketed_equals_per_leaf_in_the_port():
    """Within the port the two wire modes agree bit for bit (same codes,
    scales and sender-order sums), f32 and bf16 leaves, T = 3."""
    n, T, hops = 4, 3, 2
    wmat = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1 + hops, T, n)).astype(np.float32))
    hop_pairs = [[(i, (i + 1) % n) for i in range(n)],
                 [(i, (i - 1) % n) for i in range(n)]]
    for dtype in (torch.float32, torch.bfloat16):
        diffs = [torch.from_numpy(d).to(dtype)
                 for d in _leaves(_EXCHANGE_SHAPES, seed=3, n=n)]
        wx = WireExchange(bits=2)
        layout = wx.layout(wx.local_shapes(diffs), [d.dtype for d in diffs])
        noise = _noise(layout, n, seed=5)
        wb, qb = wx.bucketed(tbucket.RowTables.from_leaves(layout, diffs),
                             ReplayDraws(noise, "cpu"), wmat, hop_pairs)
        wp, qp = wx.per_leaf(diffs, ReplayDraws(noise, "cpu"), wmat,
                             hop_pairs)
        for a, b in zip(wb + qb, wp + qp):
            assert a.dtype == b.dtype == dtype and torch.equal(a, b)


def test_bucketed_frees_the_diff_and_noise_tables_before_the_mix(
        monkeypatch):
    """Once packed, the diff rows and the noise drawn into their tables
    are dropped: nothing of the exchange keeps a table alive while B4
    writes the mixes, which are the size of the tables again."""
    import weakref
    n, hops = 4, 2
    wmat = torch.full((1 + hops, 1, n), 1.0 / 3.0)
    hop_pairs = [[(i, (i + 1) % n) for i in range(n)],
                 [(i, (i - 1) % n) for i in range(n)]]
    diffs = [torch.from_numpy(d) for d in _leaves(_EXCHANGE_SHAPES, seed=3,
                                                  n=n)]
    wx = WireExchange(bits=2)
    layout = wx.layout(wx.local_shapes(diffs), [d.dtype for d in diffs])
    tables = []
    init = tbucket.RowTables.__init__

    def tracked(self, *a, **k):
        init(self, *a, **k)
        tables.extend(weakref.ref(t) for t in self.tables)

    mix = tbucket.mix_from_wire
    alive = []

    def checked_mix(*a, **k):
        alive.append(sum(r() is not None for r in tables))
        return mix(*a, **k)

    monkeypatch.setattr(tbucket.RowTables, "__init__", tracked)
    monkeypatch.setattr(tbucket, "mix_from_wire", checked_mix)
    rows = tbucket.RowTables.from_leaves(layout, diffs)
    wx.bucketed(rows, ReplayDraws(_noise(layout, n, seed=5), "cpu"), wmat,
                hop_pairs)
    assert len(tables) == 2 * len(layout.groups) and alive == [0]


def test_flat_pack_mode_matches_lastdim():
    """pack_mode='flat' ships the same codes in another byte order."""
    n = 3
    diffs = [torch.from_numpy(d)
             for d in _leaves(_EXCHANGE_SHAPES, seed=4, n=n)]
    wmat = torch.ones((2, 1, n)) / 2
    hop_pairs = [[(i, (i + 1) % n) for i in range(n)]]
    layout = WireExchange().layout(WireExchange.local_shapes(diffs),
                                   [d.dtype for d in diffs])
    noise = _noise(layout, n, seed=1)
    a = WireExchange(pack_mode="lastdim").per_leaf(
        diffs, ReplayDraws(noise, "cpu"), wmat, hop_pairs)
    b = WireExchange(pack_mode="flat").per_leaf(
        diffs, ReplayDraws(noise, "cpu"), wmat, hop_pairs)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 7])
def test_pack_codes_match_reference(bits):
    """The per-leaf wire packing (PAIRS order) and its flat variant."""
    lim = 2 ** (bits - 1)
    codes = np.random.default_rng(bits).integers(
        -lim, lim + 1, size=(3, 5, 16)).astype(np.int8)
    pj = jkops.pack_codes_lastdim(jnp.asarray(codes), bits=bits)
    pt = tops.pack_codes_lastdim(torch.from_numpy(codes), bits=bits)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(
        tops.unpack_codes_lastdim(pt, bits=bits).numpy(), codes)
    odd = codes.reshape(-1)[:77]
    fj = jkops.pack_codes(jnp.asarray(odd), bits=bits)
    ft = tops.pack_codes(torch.from_numpy(odd), bits=bits)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(
        tops.unpack_codes(ft, bits=bits, n=77).numpy(), odd)
