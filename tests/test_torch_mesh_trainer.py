"""The trainer on a model-sharded (N, M) mesh, against the JAX package.

The reference runs the golden ``trainer_neighbor_alternating_4x2`` spec on
8 devices, each node's model over M = 2 of them; the port holds a node's
two model shards in one process (``repro_torch.models.sharding``).

* (i) Identity compression at (4, 2): the per-leaf wire, partial-manual in
  the reference (whole leaves), teacher-forced against the reference's
  dense backend on the same 4-node alternating schedule (ROADMAP C1: the
  reference's dense semantics are the bar), 3 steps in f64, each step
  handed the reference's gradient of its state (the model's own parity is
  ``tests/test_torch_trainer.py``'s).  C4's tolerances: X, H and the Hw
  slots within 1e-5 of each array's largest entry on all but 0.1 % of
  elements; D within 1e-5 of its largest entry plus C4's mix bound
  carried into it, gamma / (2 eta) x (S + 1) eps_f32 sum_s |w_s| max |Q|,
  every element.  The wire mixes with f32 weights, as the reference's
  sharded backend does, and without compression error D's first step is
  -(gamma / 2) (I - W) G, a difference of nearly equal mixes: on the norm
  leaves (X = 1, G small) the f32 weights alone move it by more than 1e-5
  of its max on up to 18 % of the elements (measured), within the bound.
* (ii) QInf at (4, 2): the bucketed wire is full-manual, each model shard
  quantizing its model-local slice of every leaf.  The codes and scales
  buffers the port sends (recorded at the ``pp`` seam) equal, byte for
  byte, node by node and shard by shard, what the reference's
  ``repro.core.bucket.compute_layout`` / ``pack_to_wire`` pack from the
  same model-local slices (cut with the reference's ``param_specs`` and
  ``model_local_shape``) with the same noise.
* (iii) ``bits_per_step`` of the golden 4x2 spec and of the 8x1 one equal
  the reference's, computed in a subprocess on 8 fake CPU devices (its
  real meshes): 3 x 459,072 and 5 x 447,648; and the contract figure of
  86,076 B a model shard a step.
* (iv) Model-replicated leaves (norms) ride the wire M times with the same
  bytes, and their M mixed copies are bit-equal; the draw rule that keeps
  them so is what the reference's ``tests/test_dryrun_small.py::
  test_model_replicated_leaves_stay_consistent_under_qinf`` guards: a
  per-shard draw for them breaks it.
* (v) ``shard_aligned_blocks`` / ``tp_ways``: the trainer's quantization
  block equals the reference's ``_quant_block`` on every leaf as its
  quantizer sees it, at (8, 1) and at (4, 2), both wire modes; the spec
  knobs reach TrainerConfig and ``bits_per_step`` equals the reference's.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.core import bucket as jbucket
from repro.kernels import ops as jkops
from repro.models import sharding as jsh
from repro.models import transformer as JTR
from repro.optim import decentralized as jdec
from repro_torch import api as tapi
from repro_torch import convert, tree
from repro_torch.core import bucket as tbucket
from repro_torch.core.comm import NeighborMixer
from repro_torch.core.draws import GeneratorDraws, RecordingDraws, ReplayDraws
from repro_torch.models import sharding as tsh
from repro_torch.obs.record import RecordingPP
from repro_torch.optim.wire import WireExchange, stacked_pp
from tests.test_torch_trainer import (STEP_MAX_OFF, STEP_TOL,
                                      _assert_step_close, _jax_state_arrays,
                                      _rel_off)

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden_specs"
SPEC_4X2 = GOLDEN / "trainer_neighbor_alternating_4x2.json"
SPEC_8X1 = GOLDEN / "trainer_neighbor_bucketed_8x1.json"


def _spec_dict(path, **execution_params):
    d = json.loads(pathlib.Path(path).read_text())
    d["execution"]["params"] = dict(execution_params)
    return d


class _Capture:
    """A ``pp`` seam keeping what every call sent."""

    def __init__(self, inner):
        self.inner, self.sent = inner, []

    def __call__(self, x, pairs):
        self.sent.append(x.clone())
        return self.inner(x, pairs)


# --- (i) identity at (4, 2) --------------------------------------------------

def test_identity_at_4x2_matches_reference_dense_backend(monkeypatch):
    d = json.loads(SPEC_4X2.read_text())
    d["compressor"] = {"name": "identity", "params": {}}
    d["model"]["params"] = {"dtype": "float64"}
    jd = json.loads(json.dumps(d))
    jd["execution"].update(backend="dense", mesh=None)
    jrun = japi.build(japi.ExperimentSpec.from_json(json.dumps(jd)))
    jtr = jrun.trainer
    trun = tapi.build(tapi.ExperimentSpec.from_json(json.dumps(d)),
                      device="cpu")
    assert trun.trainer.mcfg.dtype == torch.float64
    tr = trun.trainer
    assert (tr.model_shards, tr.wire_shards, tr.plan.T) == (2, 1, 2)
    assert len(tr.plan.hops) == 3
    mix = NeighborMixer(tr.plan)
    data = jrun.default_data()
    batch_at = jax.jit(data.batch_at)
    step = jax.jit(jtr.train_step)
    grad = jax.jit(jtr.loss_and_grad)
    st = jax.jit(jtr.init_state)(jax.random.key(0))
    handed = []
    monkeypatch.setattr(tr, "loss_and_grad", lambda X, batch: handed.pop())
    S = 1 + len(tr.plan.hops)
    eps = float(np.finfo(np.float32).eps)
    wsum = float(tr._wmat.abs().sum(0).max())

    def slots(H):
        return tree.tree_map(lambda h: torch.stack(
            [mix.mix_stacked((h,), t)[0] for t in range(2)], 1), H)

    for k in range(3):
        batch = batch_at(k)
        port = convert.trainstate_from_arrays(_jax_state_arrays(st),
                                              device="cpu")
        port = port._replace(plead=port.plead._replace(
            comm=port.plead.comm._replace(Hw=slots(port.plead.comm.H))))
        tb = {n: torch.from_numpy(np.array(v)) for n, v in batch.items()}
        ce, G = grad(st.plead.X, batch)
        G = convert.tree_to_torch(jax.tree_util.tree_map(np.asarray, G),
                                  device="cpu")
        handed.append((torch.tensor(float(ce)), G))
        # the largest payload Q = Z - H = X - eta G - eta D - H of each leaf
        eta = tr.tcfg.eta
        qmax = [float((x - eta * g - eta * d_ - h).abs().max())
                for x, g, d_, h in zip(*(tree.leaves(t) for t in (
                    port.plead.X, G, port.plead.D, port.plead.comm.H)))]
        got, metrics = trun.step(port, tb, ReplayDraws([], "cpu"))
        assert not handed
        st, jm = step(st, batch)
        want = _jax_state_arrays(st)
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jm["loss"]), rtol=1e-5)
        got_a = convert.trainstate_to_arrays(got)
        _assert_step_close(got_a, want, ("X", "comm.H"), k)
        mix_bound = (tr.tcfg.gamma / (2 * eta) * (S + 1) * eps * wsum)
        for a, b, q in zip(tree.leaves(got_a["D"]),
                           jax.tree_util.tree_leaves(want["D"]), qmax,
                           strict=True):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= STEP_TOL * np.abs(b).max() \
                + mix_bound * q, k
        want_hw = slots(convert.tree_to_torch(want["comm.H"], device="cpu"))
        for a, b in zip(tree.leaves(got.plead.comm.Hw),
                        tree.leaves(want_hw), strict=True):
            assert _rel_off(a, b, STEP_TOL) <= STEP_MAX_OFF, k


# --- (ii) the QInf wire at (4, 2) --------------------------------------------

def _reference_trainer(**tcfg):
    cfg = jconfigs.get("qwen3-1.7b").reduced(n_layers=1, d_model=64)
    return jdec.DecentralizedTrainer(cfg, jdec.TrainerConfig(
        n_nodes=4, backend="neighbor", compressor="qinf", bits=2, eta=0.1,
        **tcfg))


@pytest.fixture(scope="module")
def qinf_step_4x2():
    """One recorded bucketed step of the golden 4x2 spec (its second, so D
    and H are nonzero): the diffs it quantized, its noise, its ``pp``
    calls."""
    spec = tapi.ExperimentSpec.load(SPEC_4X2)
    cap = _Capture(stacked_pp)
    run = tapi.build_trainer_runner(spec, device="cpu", pp=cap)
    tr = run.trainer
    data = run.default_data()
    st, _ = run.step(run.init_state(), data.batch_at(0),
                     GeneratorDraws(1, "cpu"))
    X, D, H = ([x.clone() for x in tree.leaves(t)]
               for t in (st.plead.X, st.plead.D, st.plead.comm.H))
    _, G = tr.loss_and_grad(st.plead.X, data.batch_at(1))
    eta = tr.tcfg.eta
    diffs = [x - eta * g - eta * d - h
             for x, g, d, h in zip(X, tree.leaves(G), D, H)]
    rec = RecordingDraws(GeneratorDraws(2, "cpu"))
    cap.sent.clear()
    run.step(st, data.batch_at(1), rec)
    return tr, diffs, rec.record, cap.sent


def test_qinf_wire_at_4x2_equals_reference_pack(qinf_step_4x2):
    tr, diffs, noise, sent = qinf_step_4x2
    M, hops = 2, len(tr.plan.hops)
    assert len(sent) == 2 * hops and all(x.dtype == torch.uint8
                                         for x in sent)
    cw, sw = sent[0], sent[1]
    jtr = _reference_trainer(schedule="alternating")
    ap = JTR.abstract_params(jtr.mcfg)
    jspecs = jax.tree_util.tree_leaves(jsh.param_specs(ap),
                                       is_leaf=lambda s: isinstance(s, jsh.P))
    layout = None
    for n in range(4):
        for m in range(M):
            xbs, us, shapes = [], [], []
            for j, (d, sp) in enumerate(zip(diffs, jspecs, strict=True)):
                a = d[n].numpy()
                local = jsh.model_local_shape(a.shape, sp, M)
                sharded = jsh.spec_mentions(sp, "model")
                if sharded:
                    dim = [i for i, e in enumerate(sp) if e == "model"][0]
                    a = np.split(a, M, axis=dim)[m]
                assert a.shape == local
                u = noise[j][n, m] if sharded else noise[j][n]
                shapes.append((1,) + local)
                blk = jtr._quant_block((1,) + local)
                xbs.append(jkops.blockwise_lastdim(jnp.asarray(a)[None],
                                                   block=blk))
                us.append(jnp.asarray(u.numpy())[None])
                assert us[-1].shape == xbs[-1].shape
            layout = jbucket.compute_layout(
                shapes, [d.dtype for d in xbs], bits=2,
                block_for=jtr._quant_block)
            codes, scales = jbucket.pack_to_wire(layout, xbs, us)
            bc, bs = layout.codes_bytes, layout.scales_bytes
            assert np.array_equal(
                cw[n, m * bc:(m + 1) * bc].numpy(), np.asarray(codes)), (n, m)
            assert np.array_equal(
                sw[n, m * bs:(m + 1) * bs].numpy(), np.asarray(scales)), (n, m)
    assert cw.shape == (4, M * layout.codes_bytes)
    assert 8 * (cw.shape[1] + sw.shape[1]) == 459_072


# --- (iii) bits against the reference's real meshes --------------------------

_BITS_CODE = """
import json
from repro import api
out = {}
for path, extra in json.loads(%r):
    d = json.load(open(path))
    d["execution"].update(extra)
    runner = api.build(api.ExperimentSpec.from_json(json.dumps(d)))
    assert runner.trainer.mesh is not None
    st = runner.trainer.abstract_state()
    out[path + json.dumps(extra, sort_keys=True)] = runner.bits_per_step(st)
print("BITS " + json.dumps(out))
"""

BITS_CASES = [
    (str(SPEC_4X2), {}),
    (str(SPEC_8X1), {}),
    (str(SPEC_4X2), {"params": {"shard_aligned_blocks": True, "tp_ways": 2}}),
    (str(SPEC_8X1), {"wire_mode": "per_leaf",
                     "params": {"shard_aligned_blocks": True, "tp_ways": 4}}),
    (str(SPEC_4X2), {"wire_mode": "per_leaf",
                     "params": {"shard_aligned_blocks": True, "tp_ways": 4}}),
]


def _key(path, extra):
    return path + json.dumps(extra, sort_keys=True)


@pytest.fixture(scope="module")
def reference_bits():
    """The reference's ``bits_per_step`` of BITS_CASES, each on its real
    mesh: a subprocess with 8 fake CPU devices (the pattern of
    ``tests/test_dryrun_small.py::_run_sub``)."""
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c",
                        _BITS_CODE % json.dumps(BITS_CASES)],
                       capture_output=True, text=True, env=env, timeout=300)
    line = [s for s in r.stdout.splitlines() if s.startswith("BITS ")]
    assert line, r.stdout + r.stderr[-2000:]
    return json.loads(line[0][5:])


def _port_runner(path, extra):
    d = json.loads(pathlib.Path(path).read_text())
    d["execution"].update(extra)
    return tapi.build(tapi.ExperimentSpec.from_json(json.dumps(d)),
                      device="cpu")


def test_bits_per_step_equals_the_reference_on_its_meshes(reference_bits):
    want = reference_bits
    run42 = _port_runner(str(SPEC_4X2), {})
    assert want[_key(str(SPEC_4X2), {})] == 3 * 459_072
    assert run42.bits_per_step() == 3 * 459_072
    assert run42.bits_per_step(run42.init_state()) == 3 * 459_072
    # the contract figure: 86,076 B a model shard a step
    assert run42.bits_per_step() / 8 / 2 == 86_076
    run81 = _port_runner(str(SPEC_8X1), {})
    assert want[_key(str(SPEC_8X1), {})] == run81.bits_per_step() \
        == 5 * 447_648
    # the 4x2 spec at (8, 1): 279,780 B a node a step
    at81 = dataclasses.replace(
        run42.spec, n_nodes=8, execution=dataclasses.replace(
            run42.spec.execution, mesh=(8, 1)))
    assert tapi.build(at81, device="cpu").bits_per_step() / 8 == 279_780


def test_4x2_pp_bytes_are_86076_a_model_shard(qinf_step_4x2):
    tr, _, _, sent = qinf_step_4x2
    rec = RecordingPP()
    for x in sent:
        rec(x, [])
    per_node = sum(b for _, b in rec.calls)
    assert per_node == 3 * 459_072 // 8 and per_node // 2 == 86_076
    from repro_torch.check import contracts as C
    found = C.audit_wire_calls(C.shard_calls(rec.calls, 2), hops=3,
                               per_edge_bits=459_072, model_shards=2)
    assert all(ok for _, ok, _ in found), found


# --- (iv) replicated leaves --------------------------------------------------

def test_replicated_leaves_ride_the_wire_identically(qinf_step_4x2):
    tr, _, _, sent = qinf_step_4x2
    cw, sw = sent[0], sent[1]
    layout = tr.wire_layout()
    M, n = 2, cw.shape[0]
    cwm = cw.view(n, M, -1)
    swm = sw.view(n, M, -1)
    sharded = tr.model_sharded_leaf
    assert not all(sharded) and any(sharded)
    for j, sl in enumerate(layout.slots):
        g = layout.groups[sl.group]
        c0 = g.codes_offset + sl.row_offset * g.packed_width
        c = cwm[:, :, c0:c0 + sl.rows * g.packed_width]
        s0 = g.scales_offset + sl.row_offset * layout.scale_bytes
        s = swm[:, :, s0:s0 + sl.rows * layout.scale_bytes]
        if sharded[j]:
            assert not torch.equal(c[:, 0], c[:, 1]), j
        else:
            assert torch.equal(c[:, 0], c[:, 1]), j
            assert torch.equal(s[:, 0], s[:, 1]), j


@pytest.mark.parametrize("per_shard_draws", [False, True])
def test_replicated_leaf_copies_stay_equal_only_under_the_draw_rule(
        per_shard_draws):
    """The exchange at N x M rows: every replicated leaf's M mixed copies
    (wq and qself) are bit-equal under the draw rule; drawing them per
    shard, as a sharded leaf draws, makes them diverge."""
    spec = tapi.ExperimentSpec.load(SPEC_4X2)
    tr = tapi.build(spec, device="cpu").trainer
    n, M = 4, 2
    layout = tr.wire_layout()
    rows = tbucket.RowTables(layout, n * M, "cpu")
    g = torch.Generator().manual_seed(5)
    params = tree.leaves(tapi.TR.abstract_params(tr.mcfg))
    for j, (p, sp) in enumerate(zip(params, tr.leaf_specs)):
        diff = torch.randn((n,) + tuple(p.shape), generator=g) * 0.01
        rows.leaf_view(j).unflatten(0, (n, M)).copy_(
            tsh.shard_view(diff, sp, M))
    sharded = tr.model_sharded_leaf
    flags = (True,) * len(sharded) if per_shard_draws else sharded
    wx = WireExchange(bits=2, block_for=tr._quant_block)
    wq, qs = wx.bucketed(rows, GeneratorDraws(7, "cpu"), tr._wmat,
                         [list(h.pairs) for h in tr.plan.hops],
                         sharded=flags)
    same = []
    for j, s in enumerate(sharded):
        if s:
            continue
        a, b = qs[j].unflatten(0, (n, M)).unbind(1)
        wa, wb = wq[j].unflatten(0, (n, M)).unbind(1)
        same.append(torch.equal(a, b) and torch.equal(wa, wb))
    assert same
    assert all(same) if not per_shard_draws else not any(same)


# --- (v) shard_aligned_blocks / tp_ways --------------------------------------

@pytest.mark.parametrize("wire_mode", ["bucketed", "per_leaf"])
@pytest.mark.parametrize("aligned,tp_ways", [(False, 16), (True, 16),
                                             (True, 2), (True, 4)])
def test_quant_block_equals_the_reference(aligned, tp_ways, wire_mode):
    jtr = _reference_trainer(wire_mode=wire_mode,
                             shard_aligned_blocks=aligned, tp_ways=tp_ways)
    for mesh in ((8, 1), (4, 2)):
        d = _spec_dict(SPEC_4X2, shard_aligned_blocks=aligned,
                       tp_ways=tp_ways)
        d["execution"].update(mesh=list(mesh), wire_mode=wire_mode)
        d["n_nodes"] = mesh[0]
        tr = tapi.build(tapi.ExperimentSpec.from_json(json.dumps(d)),
                        device="cpu").trainer
        assert (tr.tcfg.shard_aligned_blocks, tr.tcfg.tp_ways) == \
            (aligned, tp_ways)
        assert tr._partial_manual == jtr._partial_manual
        M = tr.wire_shards
        assert M == (mesh[1] if wire_mode == "bucketed" else 1)
        leaves = tree.leaves(tapi.TR.abstract_params(tr.mcfg))
        for p, sp in zip(leaves, tr.leaf_specs, strict=True):
            local = tsh.model_local_shape(tuple(p.shape), sp, M)
            seen = (1,) + local
            assert tr._quant_block(seen) == jtr._quant_block(seen), \
                (mesh, seen)
        layout = tr.wire_layout()
        assert [sl.block for sl in layout.slots] == [
            jtr._quant_block((1,) + tsh.model_local_shape(
                tuple(p.shape), sp, M))
            for p, sp in zip(leaves, tr.leaf_specs)]


@pytest.mark.parametrize("case", range(2, len(BITS_CASES)))
def test_block_knobs_bits_equal_the_reference(case, reference_bits):
    path, extra = BITS_CASES[case]
    run = _port_runner(path, extra)
    assert run.trainer.tcfg.shard_aligned_blocks is True
    assert run.bits_per_step() == reference_bits[_key(path, extra)]
    state, _ = run.run(num_steps=1)
    assert all(bool(torch.isfinite(x).all())
               for x in tree.leaves(state.plead.X))
