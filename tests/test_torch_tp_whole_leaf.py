"""Whole-leaf mixing on a split node: the per-leaf wire, identity
compression and the dense backend under ``StackedTP(2)`` and ``DistTP``.

The reference runs these partial-manual: a leaf is quantized whole with one
noise draw and GSPMD handles the model axis.  A rank-row gathers a
model-sharded leaf's diff over its node's model ranks (``TPSeam.whole``),
quantizes the whole leaf with the node's shared draw and keeps its own
slice; the per-leaf payloads hop to the same m of the neighbour node, and
the dense backend mixes each model rank's slices over the node axis.
Against the port's whole-node run at (4, 2), which
``tests/test_torch_mesh_trainer.py`` holds to the reference's dense
semantics (never the reference's sharded output, C1):

* the update alone, given the whole node's gradient and the same draws
  (under ``StackedTP`` the split node makes the whole-node run's very
  draw calls), 3 steps in f32: BIT FOR BIT the whole node's X, D, H, Hw.
  Cases: the golden ``trainer_neighbor_alternating_4x2`` spec with the
  per-leaf wire and with identity compression (3 hops, T = 2 Hw slots),
  the golden ``trainer_dense_qinf2`` spec at mesh (4, 2) (a static
  ``DenseMixer``) and with RandK (the whole node-stacked leaf
  compressed with one draw), and the alternating spec on the dense
  backend (W_k (H + Q) recomputed);
* a teacher-forced step, 3 steps, each from the whole-node state cut into
  rank-rows, with the same draws: X, D, H and Hw within C4's step bar
  (1e-5 of each array's largest entry on all but 0.1 % of elements), the
  loss within 1e-6 and the consensus within 1e-5 relative;
  ``bits_per_step`` equal to the whole node's.  The same cases, identity
  compression in f64 (C18: in f32 its D, a difference of the nodes'
  gradients, carries the split backward's f32 rounding, <= 6e-7 of the
  gradient's max, at up to 1.85e-5 of D's max on 0.39 % of elements at
  the first step; the update above is exact, so this is the split
  gradient alone);
* the per-leaf wire's ``pp`` bytes a hop against a host recount of each
  rank-row's own payload (a leaf cut along a leading dim or along whole
  blocks of its last dim moves its slice; a replicated leaf, or one whose
  model boundary cuts a block, moves whole);
* ``DistTP`` at world 2 on gloo (one node block of 2 model ranks), 3 steps
  replaying the ``StackedTP`` run's noise: every rank's state, stacked
  back into rank-rows, equals the ``StackedTP`` state BIT FOR BIT, and the
  metrics match within 1e-6 relative; RandK the same at world 4 (two node
  blocks: the diff gathered over the model ranks and then over the node
  axis, compressed with the draw every rank shares);
* a seeded ``DistTP`` rank's streams: its own differs from every other
  rank's, its node block's is its block's, and the one RandK and TopK
  draw from (``Draws.common``) is every rank's.
"""
import argparse
import datetime
import json
import math
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden_specs"
STEPS = 3
DEADLINE_S = 180
M = 2
CASES = ("per_leaf", "identity", "dense", "dense-alternating",
         "dense-randk")


def _spec(key):
    from repro_torch import api
    src = "trainer_dense_qinf2" if key in ("dense", "dense-randk") else \
        "trainer_neighbor_alternating_4x2"
    d = json.loads((GOLDEN / f"{src}.json").read_text())
    d["execution"]["mesh"] = [4, M]
    if key == "per_leaf":
        d["execution"]["wire_mode"] = "per_leaf"
    elif key.startswith("identity"):
        d["compressor"] = {"name": "identity", "params": {}}
        if key == "identity-f64":
            d["model"]["params"] = {"dtype": "float64"}
    elif key == "dense-alternating":
        d["execution"]["backend"] = "dense"
    elif key == "dense-randk":
        d["compressor"] = {"name": "randk", "params": {"frac": 0.2}}
    return api.ExperimentSpec.from_json(json.dumps(d))


def _state_rows(state):
    from repro_torch import tree
    p = state.plead
    return {name: [x.clone() for x in tree.leaves(t)] for name, t in (
        ("X", p.X), ("D", p.D), ("H", p.comm.H), ("Hw", p.comm.Hw))}


# --- the ranks ---------------------------------------------------------------

def _rank_case(args, rank, world):
    """The cases ``args.case`` (comma-separated) on this rank of a
    ``TPProcessMesh``: from the recorded initial node rows, replaying its
    node block's rows of the recorded (node-shared) noise, RandK's indices
    whole."""
    from repro_torch import api, tree
    from repro_torch.core.draws import ReplayDraws
    from repro_torch.launch.mesh import TPProcessMesh
    from repro_torch.models.tp import DistTP
    out = {}
    for key in args.case.split(","):
        rec = torch.load(pathlib.Path(args.dir) / f"{key}.pt")
        spec = _spec(key)
        pm = TPProcessMesh(api.spec_mesh(spec), rank=rank, world=world)
        run = api.build_trainer_runner(spec, device="cpu", process_mesh=pm)
        tr = run.trainer
        assert isinstance(tr.tp, DistTP) and tr.tp.m == pm.m
        treedef = tree.flatten(tr.abstract_state().plead.X)[1]
        state = tr.state_from_stacked(tree.unflatten(
            treedef, [pm.rows(x) for x in rec["X0"]]))
        draws = ReplayDraws([pm.rows(u) if u.is_floating_point() else u
                             for u in rec["noise"]], "cpu")
        data = run.default_data()
        metrics = []
        for t in range(STEPS):
            state, m = run.step(state, data.batch_at(t), draws)
            metrics.append([float(m["loss"]), float(m["consensus"])])
        assert not draws.pending
        out[key] = {"state": _state_rows(state), "metrics": metrics,
                    "m": pm.m}
    return out


def _worker(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--dir")
    ap.add_argument("--mode", default="trainer")
    ap.add_argument("--case", default="")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"file://{args.dir}/rendezvous",
        rank=args.rank, world_size=args.world,
        timeout=datetime.timedelta(seconds=DEADLINE_S))
    try:
        out = _rank_case(args, args.rank, args.world)
        torch.save(out, pathlib.Path(args.dir) / f"rank{args.rank}.pt")
    finally:
        dist.destroy_process_group()


# --- the tests ---------------------------------------------------------------

@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runs(key, **kw):
    from repro_torch import api
    from repro_torch.models.tp import StackedTP
    spec = _spec(key)
    return (api.build_trainer_runner(spec, device="cpu"),
            api.build_trainer_runner(spec, device="cpu", tp=StackedTP(M),
                                     **kw))


@pytest.mark.parametrize("key", ["per_leaf", "identity-f64", "dense",
                                 "dense-alternating", "dense-randk"])
def test_teacher_forced_split_step_matches_the_whole_node_step(key):
    import numpy as np

    from repro_torch import tree
    from repro_torch.core.draws import GeneratorDraws
    from tests.test_torch_tp import _tp_state_from
    from tests.test_torch_trainer import STEP_MAX_OFF, STEP_TOL, _rel_off
    whole, run = _runs(key)
    tr = run.trainer
    assert tr.tp.M == M and (tr.wire_shards == 1 or not tr.sharded)
    assert run.bits_per_step() == whole.bits_per_step()
    data = whole.default_data()
    dw, dt = GeneratorDraws(5, "cpu"), GeneratorDraws(5, "cpu")
    sw = whole.init_state()
    for k in range(STEPS):
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
        assert run.bits_per_step(st) == whole.bits_per_step(sw)


@pytest.mark.parametrize("key", CASES)
def test_split_update_from_the_whole_node_gradient_is_exact(key):
    """The update alone, f32, 3 steps: given the whole node's gradient
    (cut into rank-rows) and the same draws, the split node's new state
    is the whole node's BIT FOR BIT -- the gather, the whole-leaf
    quantization, the payload slices and the mixing add no rounding of
    their own; a whole step differs only by the split forward and
    backward (C4's and C16's bars)."""
    from repro_torch import tree
    from repro_torch.core.draws import GeneratorDraws
    from repro_torch.optim.decentralized import TrainState
    from tests.test_torch_tp import _tp_state_from
    whole, run = _runs(key)
    wt, tr = whole.trainer, run.trainer
    data = whole.default_data()
    sw = whole.init_state()
    for k in range(STEPS):
        st = _tp_state_from(tr, sw)
        _, G = wt.loss_and_grad(sw.plead.X, data.batch_at(k))
        Gs = tr.to_rank_rows(tree.tree_map(torch.clone, G))
        pw = _update(wt, sw.plead, G, GeneratorDraws(k, "cpu"))
        ps = _update(tr, st.plead, Gs, GeneratorDraws(k, "cpu"))
        got = tr.join_state(TrainState(ps, k + 1))
        for name, t in (("X", pw.X), ("D", pw.D), ("H", pw.comm.H),
                        ("Hw", pw.comm.Hw)):
            for a, b in zip(tree.leaves(got[name]), tree.leaves(t),
                            strict=True):
                assert torch.equal(a, b), (key, k, name)
        sw = TrainState(pw, k + 1)


def _update(tr, plead, G, draws):
    """Lines 6-10 of a train step, given its gradient."""
    from repro_torch import tree
    if tr.sharded:
        return tr._sharded_update(plead, tree.leaves(G), draws)
    return tr.alg.update(plead, G, draws)


def test_seeded_dist_tp_ranks_draw_own_node_and_common_streams():
    from repro_torch import api
    from repro_torch.launch.mesh import TPProcessMesh
    from repro_torch.models.tp import rank_draws
    spec = _spec("dense-randk")
    draws = []
    for rank in range(4):                   # 2 node blocks x M = 2
        pm = TPProcessMesh(api.spec_mesh(spec), rank=rank, world=4,
                           groups=False)
        tr = api.build_trainer_runner(spec, device="cpu",
                                      process_mesh=pm).trainer
        draws.append(rank_draws(tr.tp, spec.seed, "cpu", pm))
    own = [d.uniform((64,)) for d in draws]
    node = [d.shared().uniform((64,)) for d in draws]
    common = [d.common().choice(1000, 16) for d in draws]
    assert all(not torch.equal(own[a], own[b])
               for a in range(4) for b in range(a))
    assert torch.equal(node[0], node[1]) and torch.equal(node[2], node[3])
    assert not torch.equal(node[0], node[2])
    assert all(torch.equal(c, common[0]) for c in common)


def test_per_leaf_rank_rows_move_their_own_payload():
    """A hop's ``pp`` bytes on the per-leaf wire against a host recount
    of every rank-row's own payload: 2 calls a leaf (codes, scales); a
    node row carries its M rank-rows' payloads."""
    from repro_torch import tree
    from repro_torch.core.draws import GeneratorDraws
    from repro_torch.kernels.ref import wire_bits_per_element
    from repro_torch.models import sharding
    from repro_torch.models import transformer as TR
    from repro_torch.obs.record import RecordingPP
    from repro_torch.optim.wire import payload_spec
    whole, run = _runs("per_leaf", pp=RecordingPP())
    tr = run.trainer
    per_row, cuts = 0, {"lead": 0, "blocks": 0, "whole": 0}
    for p, sp in zip(tree.leaves(TR.abstract_params(tr.mcfg)),
                     tr.leaf_specs):
        shape = tuple(p.shape) or (1,)
        blk = tr._quant_block((1,) + shape)
        rows, nb = math.prod(shape[:-1]), -(-shape[-1] // blk)
        cut = payload_spec(sp, shape, blk, M)
        d = sharding.model_dim(sp)
        if cut is None:
            cuts["whole"] += 1
        elif d < len(shape) - 1:
            rows //= M
            cuts["lead"] += 1
        else:
            nb //= M
            cuts["blocks"] += 1
        per_row += rows * nb * (blk * wire_bits_per_element(tr.tcfg.bits)
                                // 8 + 4)
    assert min(cuts.values()) > 0, cuts      # every rule is exercised
    st = run.init_state()
    run.step(st, run.default_data().batch_at(0), GeneratorDraws(1, "cpu"))
    hops = len(tr.plan.hops)
    leaves = len(tr.leaf_specs)
    assert len(run.trainer.pp.calls) == 2 * hops * leaves
    assert all(dt == torch.uint8 for dt, _ in run.trainer.pp.calls)
    assert sum(b for _, b in run.trainer.pp.calls) == hops * M * per_row


@pytest.fixture(scope="module")
def stacked_and_ranks(tmp_path_factory):
    """Each case's StackedTP run (initial X and noise recorded; its final
    rank-row state and metrics) and the same on 2 DistTP ranks."""
    from repro_torch import tree
    from repro_torch.core.draws import GeneratorDraws, RecordingDraws
    from repro_torch.models import transformer as TR
    from tests.test_torch_tp_dist import launch
    d = tmp_path_factory.mktemp("whole_leaf")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    want = {}
    try:
        for key in CASES:
            _, run = _runs(key)
            tr = run.trainer
            gen = torch.Generator().manual_seed(0)
            X0 = tree.leaves(TR.stack_nodes(TR.init_params(tr.mcfg, gen,
                                                           "cpu"), 4))
            state = tr.state_from_stacked(tree.unflatten(
                tree.flatten(tr.abstract_state().plead.X)[1], X0))
            rec = RecordingDraws(GeneratorDraws(11, "cpu"))
            data = run.default_data()
            metrics = []
            for t in range(STEPS):
                state, m = run.step(state, data.batch_at(t), rec)
                metrics.append([float(m["loss"]), float(m["consensus"])])
            torch.save({"X0": X0, "noise": rec.record}, d / f"{key}.pt")
            want[key] = {"state": _state_rows(state), "metrics": metrics}
    finally:
        torch.set_num_threads(threads)
    blocks = d / "two_blocks"
    blocks.mkdir()
    (blocks / "dense-randk.pt").write_bytes(
        (d / "dense-randk.pt").read_bytes())
    return want, {M: launch(M, d, case=",".join(CASES), script=__file__),
                  2 * M: launch(2 * M, blocks, case="dense-randk",
                                script=__file__)}


def _held_to_stacked(want, ranks, key):
    """Rank (b, m)'s rows, stacked back into rank-rows ``n M + m``
    block by block, equal the StackedTP run's; the metrics within 1e-6."""
    w = want[key]
    assert [r[key]["m"] for r in ranks] == [r % M for r in range(len(ranks))]
    for name, leaves in w["state"].items():
        for j, leaf in enumerate(leaves):
            got = torch.cat([torch.stack(
                [r[key]["state"][name][j] for r in ranks[b:b + M]],
                1).flatten(0, 1) for b in range(0, len(ranks), M)])
            assert torch.equal(got, leaf), (key, name, j)
    for r in ranks:
        torch.testing.assert_close(
            torch.tensor(r[key]["metrics"], dtype=torch.float64),
            torch.tensor(w["metrics"], dtype=torch.float64),
            rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("key", CASES)
def test_dist_tp_equals_the_stacked_run(key, stacked_and_ranks):
    want, ranks = stacked_and_ranks
    _held_to_stacked(want, ranks[M], key)


def test_randk_over_two_node_blocks_equals_the_stacked_run(
        stacked_and_ranks):
    want, ranks = stacked_and_ranks
    _held_to_stacked(want, ranks[2 * M], "dense-randk")


if __name__ == "__main__":
    _worker(sys.argv[1:])
