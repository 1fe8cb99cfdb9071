"""A tensor-parallel node over processes: ``DistTP`` on gloo, CPU tensors.

Each node's M model ranks are M processes of a ``torch.distributed`` world
(``repro_torch.launch.mesh.TPProcessMesh``: rank ``b M + m`` holds model
rank m of node block b; its hops go over the node group of its m, its
collectives over the model group of its b).  Against the one-process run
of the same spec under ``StackedTP(M)`` (which
``tests/test_torch_tp.py`` holds to the whole-node run and the
reference):

* the golden ``trainer_neighbor_alternating_4x2`` spec (4 nodes x 2 model
  ranks, alternating schedule, 3 hops, T = 2 Hw slots; its 1 KV head
  split in halves, so k and v are gathered) at world 2 (1 node block x 2
  model ranks) and world 4 (2 x 2), f32, and the same spec at (4, 4) in
  f64 at world 4 (1 x 4: its 2 query heads cut in parts, q gathered too),
  3 steps from the same initial state: the one-process run records its
  noise, each rank replays its share (shard m's rows of a sharded leaf,
  its node rows of a replicated one, the wire's draw rule); the state
  the ranks hold (X, D, H, Hw), stacked back into rank-rows, equals the
  one-process state BIT FOR BIT at M = 2 and at M = 4 (``DistTP``'s sum
  is an all-to-all, the M parts added in rank order as ``StackedTP`` adds
  its stacked rows, and an all-gather; with gloo's own all-reduce the
  M = 4 run differed by 3.1e-9 of max |X| after 3 steps, the f64 model's
  f32 islands turning a last-bit difference into an f32 one, so 1e-12
  could not hold); every replicated leaf is
  bit-equal across the model ranks; the loss and consensus (all-reduced, a node's loss and a
  replicated leaf counted once) match within 1e-6 relative;
* a seeded run on ranks (each rank's own stream for its sharded leaves,
  its node block's for the replicated ones): the replicated copies stay
  bit-equal over the model ranks, every rank reports the same metrics;
* the harness: a rank that dies fails the launch at once instead of
  hanging it.

Each world is one launch of W worker processes (this file run as a
script), joined with a deadline, gloo rendezvous through a file in the
test's temporary directory.
"""
import argparse
import datetime
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPEC_4X2 = ROOT / "tests" / "golden_specs" / \
    "trainer_neighbor_alternating_4x2.json"
STEPS = 3
DEADLINE_S = 180
#: (key, mesh, model dtype): the golden spec, and at M = 4 in f64
CASES = {"4x2": ((4, 2), None), "4x4": ((4, 4), "float64")}


def _spec(key):
    from repro_torch import api
    d = json.loads(SPEC_4X2.read_text())
    mesh, dtype = CASES[key]
    d["execution"]["mesh"] = list(mesh)
    if dtype:
        d["model"]["params"] = {"dtype": dtype}
    return api.ExperimentSpec.from_json(json.dumps(d))


def _state_rows(state):
    from repro_torch import tree
    p = state.plead
    return {name: [x.clone() for x in tree.leaves(t)] for name, t in (
        ("X", p.X), ("D", p.D), ("H", p.comm.H), ("Hw", p.comm.Hw))}


# --- the ranks ---------------------------------------------------------------

def _rank_trainer(args, rank, world):
    """Rank ``rank``'s run of case ``args.case`` from the recorded initial
    node rows, replaying its share of the recorded noise."""
    from repro_torch import api, tree
    from repro_torch.core.draws import ReplayDraws
    from repro_torch.launch.mesh import TPProcessMesh
    from repro_torch.models import tp as tp_mod
    rec = torch.load(pathlib.Path(args.dir) / f"{args.case}.pt")
    spec = _spec(args.case)
    pm = TPProcessMesh(api.spec_mesh(spec), rank=rank, world=world)
    run = api.build_trainer_runner(spec, device="cpu", process_mesh=pm)
    tr = run.trainer
    assert isinstance(tr.tp, tp_mod.DistTP) and tr.tp.m == pm.m
    treedef = tree.flatten(tr.abstract_state().plead.X)[1]
    state = tr.state_from_stacked(tree.unflatten(
        treedef, [pm.rows(x) for x in rec["X0"]]))
    flags = tr.model_sharded_leaf
    shares = []
    for i, u in enumerate(rec["noise"]):
        rows = pm.rows(u)
        shares.append(rows[:, pm.m] if flags[i % len(flags)] else rows)
    draws = ReplayDraws(shares, "cpu")
    data = run.default_data()
    metrics = []
    for t in range(STEPS):
        state, m = run.step(state, data.batch_at(t), draws)
        metrics.append([float(m["loss"]), float(m["consensus"])])
    assert not draws.pending
    return {"state": _state_rows(state), "metrics": metrics,
            "b": pm.b, "m": pm.m}


def _rank_seeded(args, rank, world):
    """Rank ``rank``'s seeded run of the golden spec (``TrainerRunner.run``
    with its default draws: ``TPRankDraws``)."""
    from repro_torch import api
    from repro_torch.core.draws import TPRankDraws
    from repro_torch.launch.mesh import TPProcessMesh
    from repro_torch.models.tp import rank_draws
    spec = _spec("4x2")
    pm = TPProcessMesh(api.spec_mesh(spec), rank=rank, world=world)
    run = api.build_trainer_runner(spec, device="cpu", process_mesh=pm)
    assert isinstance(rank_draws(run.trainer.tp, 0, "cpu"), TPRankDraws)
    state, logs = run.run(num_steps=STEPS, log_every=1, callback=lambda st,
                          m, t: [float(m["loss"]), float(m["consensus"])])
    return {"state": _state_rows(state), "metrics": logs, "b": pm.b,
            "m": pm.m}


def _worker(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world", type=int)
    ap.add_argument("--dir")
    ap.add_argument("--mode", default="trainer")
    ap.add_argument("--case", default="4x2")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"file://{args.dir}/rendezvous",
        rank=args.rank, world_size=args.world,
        timeout=datetime.timedelta(seconds=DEADLINE_S))
    try:
        if args.mode == "die" and args.rank == 1:
            os._exit(3)          # a crash: the others wait in a collective
        run = _rank_seeded if args.mode == "seeded" else _rank_trainer
        out = run(args, args.rank, args.world)
        torch.save(out, pathlib.Path(args.dir) / f"rank{args.rank}.pt")
    finally:
        dist.destroy_process_group()


# --- the launcher ------------------------------------------------------------

def launch(world, tmp, case="4x2", mode="trainer", deadline=DEADLINE_S):
    """Run ``world`` ranks of this file; -> their outputs in rank order.
    Fails (killing every rank) as soon as one rank exits nonzero, or at
    the deadline."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    tmp = pathlib.Path(tmp)
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--world", str(world),
         "--dir", str(tmp), "--mode", mode, "--case", case],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    t_end = time.monotonic() + deadline
    try:
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                t_grace = time.monotonic() + 5
                while None in codes and time.monotonic() < t_grace:
                    time.sleep(0.05)
                    codes = [p.poll() for p in procs]
                raise RuntimeError("; ".join(
                    f"rank {r} exited {c}: "
                    f"{(tmp / f'rank{r}.log').read_text()[-1500:]}"
                    for r, c in enumerate(codes) if c not in (None, 0)))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > t_end:
                raise TimeoutError(f"ranks still running after {deadline} "
                                   f"s: {codes}")
            time.sleep(0.05)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


# --- the tests ---------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """Each case's one-process StackedTP run: its initial node rows, the
    noise of its steps (recorded), its final rank-row state and metrics."""
    from repro_torch import api, tree
    from repro_torch.core.draws import GeneratorDraws, RecordingDraws
    from repro_torch.models import transformer as TR
    from repro_torch.models.tp import StackedTP
    d = tmp_path_factory.mktemp("one_process")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for key in CASES:
            spec = _spec(key)
            M = spec.execution.mesh[1]
            run = api.build_trainer_runner(spec, device="cpu",
                                           tp=StackedTP(M))
            gen = torch.Generator().manual_seed(spec.seed)
            X0 = tree.leaves(TR.stack_nodes(TR.init_params(
                run.trainer.mcfg, gen, "cpu"), spec.n_nodes))
            state = run.trainer.state_from_stacked(tree.unflatten(
                tree.flatten(run.trainer.abstract_state().plead.X)[1], X0))
            rec = RecordingDraws(GeneratorDraws(11, "cpu"))
            data = run.default_data()
            metrics = []
            for t in range(STEPS):
                state, m = run.step(state, data.batch_at(t), rec)
                metrics.append([float(m["loss"]), float(m["consensus"])])
            torch.save({"X0": X0, "noise": rec.record}, d / f"{key}.pt")
            out[key] = {"state": _state_rows(state), "metrics": metrics,
                        "M": M, "specs": run.trainer.leaf_specs}
    finally:
        torch.set_num_threads(threads)
    return d, out


@pytest.mark.parametrize("case,world", [("4x2", 2), ("4x2", 4),
                                        ("4x4", 4)])
def test_ranks_equal_the_stacked_run(case, world, one_process, tmp_path):
    from repro_torch.models import sharding
    rec_dir, want = one_process
    (tmp_path / f"{case}.pt").write_bytes((rec_dir / f"{case}.pt")
                                          .read_bytes())
    ranks = launch(world, tmp_path, case=case)
    w = want[case]
    M = w["M"]
    assert [(r["b"], r["m"]) for r in ranks] == \
        [divmod(r, M) for r in range(world)]
    blocks = world // M
    for name, leaves in w["state"].items():
        for j, leaf in enumerate(leaves):
            per_block = [torch.stack([ranks[b * M + m]["state"][name][j]
                                      for m in range(M)], 1)
                         for b in range(blocks)]
            got = torch.cat(per_block).flatten(0, 1)   # rows n M + m
            assert torch.equal(got, leaf), (case, world, name, j)
            if sharding.model_dim(w["specs"][j]) is None:
                for b in range(blocks):
                    assert all(torch.equal(per_block[b][:, 0],
                                           per_block[b][:, m])
                               for m in range(M)), (case, name, j)
    for r in ranks:
        torch.testing.assert_close(
            torch.tensor(r["metrics"], dtype=torch.float64),
            torch.tensor(w["metrics"], dtype=torch.float64),
            rtol=1e-6, atol=0.0)


def test_seeded_ranks_keep_replicated_leaves_equal(tmp_path):
    """A seeded run on ranks (no replay): each rank draws its sharded
    leaves' noise from its own stream and its replicated leaves' from its
    node block's, so the replicated copies stay bit-equal over the model
    ranks, while the shards of a sharded leaf differ; every rank reports
    the same loss and consensus."""
    from repro_torch import api
    from repro_torch.models import sharding
    ranks = launch(4, tmp_path, mode="seeded")
    specs = api.build_trainer_runner(_spec("4x2"),
                                     device="cpu").trainer.leaf_specs
    for name in ("X", "D", "H", "Hw"):
        for j, sp in enumerate(specs):
            for b in range(2):
                a, c = (ranks[b * 2 + m]["state"][name][j] for m in (0, 1))
                if sharding.model_dim(sp) is None:
                    assert torch.equal(a, c), (name, j, b)
                elif name == "H":            # quantized differences
                    assert not torch.equal(a, c), (name, j, b)
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
    assert all(torch.isfinite(torch.tensor(r["metrics"])).all()
               for r in ranks)


def test_a_dead_rank_fails_the_launch_at_once(one_process, tmp_path):
    rec_dir, _ = one_process
    (tmp_path / "4x2.pt").write_bytes((rec_dir / "4x2.pt").read_bytes())
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited 3"):
        launch(2, tmp_path, mode="die", deadline=60)
    assert time.monotonic() - t0 < 60


if __name__ == "__main__":
    _worker(sys.argv[1:])
