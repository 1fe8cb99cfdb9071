"""The dense backend over several processes: ``DistAG`` on gloo, CPU tensors.

The node axis splits over the ranks of a ``torch.distributed`` group
(``repro_torch.launch.mesh.ProcessMesh``); a rank runs ``ProxLEAD.update``
on its node rows, its mixer (``repro_torch.core.comm.RowsMixer``) gathering
each leaf's Q over the node axis (``repro_torch.optim.wire.DistAG``, one
``all_gather_into_tensor`` a leaf) and keeping rows [lo, hi) of W_k Q.
Against the one-process run of the same spec:

* the golden ``trainer_dense_qinf2`` spec (4 nodes, ring, 2-bit QInf), and
  the same with ``drop_rate`` 0.3 (LinkDrop faults: every rank draws the
  whole mask from its own stream seeded ``fault_seed``), with
  ``schedule="alternating"`` (W_k (H + Q) gathered) and with RandK (the
  diff gathered and compressed whole with the draw every rank shares, the
  rank's rows kept), at world sizes 2 and 4, 3 steps from the same
  initial state: the one-process run records its noise, each rank replays
  its rows of the QInf noise and RandK's indices whole; the state gathered
  from the ranks (X, D, H, Hw) equals the one-process state BIT FOR BIT,
  and the all-reduced loss and consensus match within 1e-6 relative;
* one step on ranks from the reference's initial state with the
  reference's noise and batch, against the reference's dense
  ``DecentralizedTrainer.train_step`` on the CPU: C4's bar (1e-5 of each
  array's max on all but 0.1 % of elements), the bar the one-process
  port is held to (``tests/test_torch_trainer.py``);
* ``DistAG`` alone (every rank's rows gathered in node order) and rows
  [lo, hi) of W against rows of the whole product, bit for bit, in one
  piece and in column pieces;
* a seeded run's draws on ranks: two ranks quantize the same rows with
  different noise (each node block's own stream), and RandK's stream is
  every rank's.

Each world is one launch of W worker processes (this file run as a script)
through ``tests/test_torch_dist.py``'s launcher, joined with a deadline.
"""
import argparse
import datetime
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden_specs" / "trainer_dense_qinf2.json"
STEPS = 3
DEADLINE_S = 180
CASES = ("qinf", "drop", "alternating", "randk")


def _spec(key):
    from repro_torch import api
    d = json.loads(GOLDEN.read_text())
    if key == "drop":
        d["execution"]["params"] = {"drop_rate": 0.3}
        d["fault_seed"] = 5
    elif key == "alternating":
        d["topology"]["schedule"] = "alternating"
    elif key == "randk":
        d["compressor"] = {"name": "randk", "params": {"frac": 0.2}}
    return api.ExperimentSpec.from_json(json.dumps(d))


def _state_rows(state):
    from repro_torch import tree
    p = state.plead
    return {name: [x.clone() for x in tree.leaves(t)] for name, t in (
        ("X", p.X), ("D", p.D), ("H", p.comm.H), ("Hw", p.comm.Hw))}


# --- the ranks ---------------------------------------------------------------

def _rank_case(rec, key, pm, steps):
    """One case on this rank: from the recorded initial state's rows,
    replaying its rows of the recorded QInf noise (RandK's indices
    whole)."""
    from repro_torch import api, tree
    from repro_torch.core.comm import RowsMixer
    from repro_torch.core.draws import ReplayDraws
    from repro_torch.optim.wire import DistAG
    run = api.build_trainer_runner(_spec("qinf" if key == "ref" else key),
                                   device="cpu", process_mesh=pm)
    tr = run.trainer
    assert isinstance(tr.ag, DistAG) and isinstance(tr.alg.mixer, RowsMixer)
    treedef = tree.flatten(tr.abstract_state().plead.X)[1]
    state = tr.state_from_stacked(tree.unflatten(
        treedef, [pm.rows(x) for x in rec["X0"]]))
    draws = ReplayDraws([pm.rows(u) if u.is_floating_point() else u
                         for u in rec["noise"]], "cpu")
    data = run.default_data()
    metrics = []
    for t in range(steps):
        batch = rec["batch"] if key == "ref" else data.batch_at(t)
        state, m = run.step(state, batch, draws)
        metrics.append([float(m["loss"]), float(m["consensus"])])
    assert not draws.pending
    return {"state": _state_rows(state), "metrics": metrics, "lo": pm.lo}


def _rank_ag(pm):
    """DistAG against the whole tensor, in two dtypes."""
    from repro_torch.optim.wire import DistAG
    ag = DistAG(pm)
    n = pm.n_nodes
    for dtype in (torch.float32, torch.float64):
        x = torch.arange(n * 6, dtype=dtype).view(n, 2, 3)
        if not torch.equal(ag(pm.rows(x)), x):
            return False
    return True


def _worker(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--dir")
    ap.add_argument("--mode", default="trainer")
    ap.add_argument("--specs", nargs="*", default=[])
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh, ProcessMesh
    dist.init_process_group(
        "gloo", init_method=f"file://{args.dir}/rendezvous",
        rank=args.rank, world_size=args.world,
        timeout=datetime.timedelta(seconds=DEADLINE_S))
    try:
        pm = ProcessMesh(Mesh((_spec("qinf").n_nodes,), ("data",)),
                         rank=args.rank, world=args.world)
        out = {"ag": _rank_ag(pm)}
        for key in args.specs:
            rec = torch.load(pathlib.Path(args.dir) / f"{key}.pt")
            out[key] = _rank_case(rec, key, pm, 1 if key == "ref" else STEPS)
            dist.barrier()
        torch.save(out, pathlib.Path(args.dir) / f"rank{args.rank}.pt")
    finally:
        dist.destroy_process_group()


# --- the tests ---------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """Each case's one-process run (its initial X, the noise of its steps,
    recorded; its final state and metrics), and the reference's first
    dense step (its initial X, noise and batch; its state after it)."""
    from repro_torch import api, tree
    from repro_torch.core.draws import GeneratorDraws, RecordingDraws
    d = tmp_path_factory.mktemp("one_process")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for key in CASES:
            run = api.build(_spec(key), device="cpu")
            state = run.init_state()
            X0 = [x.clone() for x in tree.leaves(state.plead.X)]
            rec = RecordingDraws(GeneratorDraws(11, "cpu"))
            data = run.default_data()
            metrics = []
            for t in range(STEPS):
                state, m = run.step(state, data.batch_at(t), rec)
                metrics.append([float(m["loss"]), float(m["consensus"])])
            torch.save({"X0": X0, "noise": rec.record}, d / f"{key}.pt")
            out[key] = {"state": _state_rows(state), "metrics": metrics}
        out["ref"] = _reference_step(d)
    finally:
        torch.set_num_threads(threads)
    return d, out


def _reference_step(d):
    """The reference's first dense step of the golden spec from its
    initial state; its inputs saved for the ranks."""
    import jax

    from repro import api as japi
    from repro_torch import convert, tree
    from tests.test_torch_trainer import _dense_draws, _jax_state_arrays
    jrun = japi.build(japi.ExperimentSpec.from_json(GOLDEN.read_text()))
    jtr = jrun.trainer
    st = jax.jit(jtr.init_state)(jax.random.key(0))
    a0 = _jax_state_arrays(st)
    for name in ("D", "comm.H", "comm.Hw"):      # a fresh state's zeros
        assert all(not np.any(x) for x in jax.tree_util.tree_leaves(
            a0[name]))
    batch = jax.jit(jrun.default_data().batch_at)(0)
    noise = [torch.from_numpy(np.array(u))
             for u in _dense_draws(jtr, st.plead.X)(st.step)]
    X0 = tree.leaves(convert.tree_to_torch(a0["X"], device="cpu"))
    torch.save({"X0": X0, "noise": noise,
                "batch": {n: torch.from_numpy(np.array(v))
                          for n, v in batch.items()}}, d / "ref.pt")
    st, _ = jax.jit(jtr.train_step)(st, batch)
    return _jax_state_arrays(st)


def _copy_records(rec_dir, tmp_path, keys):
    for key in keys:
        (tmp_path / f"{key}.pt").write_bytes((rec_dir / f"{key}.pt")
                                             .read_bytes())


@pytest.mark.parametrize("world", [2, 4])
def test_dense_ranks_equal_the_one_process_run(world, one_process,
                                               tmp_path):
    from tests.test_torch_dist import launch
    rec_dir, want = one_process
    _copy_records(rec_dir, tmp_path, CASES)
    ranks = launch(world, tmp_path, specs=list(CASES), script=__file__)
    assert all(r["ag"] for r in ranks)
    for key in CASES:
        w = want[key]
        n_local = len(w["state"]["X"][0]) // world
        for name, leaves in w["state"].items():
            for j, leaf in enumerate(leaves):
                got = torch.cat([r[key]["state"][name][j] for r in ranks])
                assert torch.equal(got, leaf), (key, world, name, j)
        assert [r[key]["lo"] for r in ranks] == \
            [n_local * r for r in range(world)]
        for r in ranks:
            torch.testing.assert_close(
                torch.tensor(r[key]["metrics"], dtype=torch.float64),
                torch.tensor(w["metrics"], dtype=torch.float64),
                rtol=1e-6, atol=0.0)


def test_dense_ranks_step_matches_the_reference(one_process, tmp_path):
    """One step on 2 ranks from the reference's state, noise and batch,
    gathered, against the reference's dense step (C4's bar)."""
    import jax

    from tests.test_torch_trainer import STEP_MAX_OFF, STEP_TOL, _rel_off
    rec_dir, want = one_process
    _copy_records(rec_dir, tmp_path, ["ref"])
    from tests.test_torch_dist import launch
    ranks = launch(2, tmp_path, specs=["ref"], script=__file__)
    ref = want["ref"]
    for name, key in (("X", "X"), ("D", "D"), ("H", "comm.H"),
                      ("Hw", "comm.Hw")):
        for j, b in enumerate(jax.tree_util.tree_leaves(ref[key])):
            got = torch.cat([r["ref"]["state"][name][j] for r in ranks])
            assert _rel_off(got, b, STEP_TOL) <= STEP_MAX_OFF, (name, j)


@pytest.mark.parametrize("piece", [None, 1 << 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rows_mixer_keeps_rows_of_the_whole_product(dtype, piece,
                                                    monkeypatch):
    """What a rank's mixing rests on: ``RowsMixer`` gives rows [lo, hi) of
    W applied to the whole gathered leaf, bit for bit, for blocks of one
    row and more, and for the rank-rows of a split node (``per_node``
    2); with ``piece`` bytes of the product at a time too (column pieces,
    as a wide leaf is mixed).  (A product of W's rows alone is another
    computation: one row of an (8, 8) f32 W against 256 columns rounded
    otherwise here.)"""
    from repro_torch.core import comm
    from repro_torch.core.comm import DenseMixer, RowsMixer, mix_with
    if piece is not None:
        monkeypatch.setattr(comm, "MIX_PIECE_BYTES", piece)
    g = torch.Generator().manual_seed(0)
    W = torch.rand(8, 8, generator=g, dtype=dtype)
    inner = DenseMixer(W.numpy())
    Wx = inner.W_k(None, dtype, "cpu")
    for cols in (3, 256, 4099, 1 << 16):
        x = torch.randn(8, cols, generator=g, dtype=dtype)
        whole = mix_with(Wx, x)
        for lo, hi in ((0, 8), (0, 4), (4, 8), (2, 4), (7, 8)):
            rows = RowsMixer(inner, lambda _, x=x: x, lo, hi)
            assert torch.equal(rows.mix_leaf(x[lo:hi], 0), whole[lo:hi]), \
                (cols, lo, hi)
        x2 = torch.randn(8, 2, cols, generator=g, dtype=dtype)
        split = RowsMixer(inner, lambda t: t, 0, 8, per_node=2)
        want = torch.stack([mix_with(Wx, x2[:, m].contiguous())
                            for m in range(2)], 1)
        assert torch.equal(split.mix_leaf(x2.flatten(0, 1), 0),
                           want.flatten(0, 1))


def test_seeded_ranks_quantize_with_their_own_noise():
    """The draws of a seeded run on a ``ProcessMesh``
    (``TrainerRunner.run``'s default, ``models.tp.rank_draws``): two
    ranks given the same rows quantize them with different noise, each
    node block drawing from its own stream as the one-process run draws
    each node's noise apart; the stream RandK and TopK draw from
    (``Draws.common``) is every rank's."""
    from repro_torch import api
    from repro_torch.core.compression import QInf
    from repro_torch.launch.mesh import Mesh, ProcessMesh
    from repro_torch.models.tp import rank_draws
    spec = _spec("qinf")
    x = torch.randn(2, 3, 300, generator=torch.Generator().manual_seed(0))
    qs, common = [], []
    for rank in range(2):
        pm = ProcessMesh(Mesh((spec.n_nodes,), ("data",)), rank=rank,
                         world=2)
        tr = api.build_trainer_runner(spec, device="cpu",
                                      process_mesh=pm).trainer
        assert isinstance(tr.alg.compressor, QInf)
        d = rank_draws(tr.tp, spec.seed, "cpu", pm)
        assert d.shared() is d.own
        qs.append(tr.alg.compressor.q_leaf(x, d, 0))
        common.append(d.common().choice(1000, 16))
    assert not torch.equal(qs[0], qs[1])
    assert torch.equal(common[0], common[1])


if __name__ == "__main__":
    _worker(sys.argv[1:])
