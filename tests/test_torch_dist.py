"""The trainer over several processes: ``DistPP`` on gloo, CPU tensors.

The node axis splits over the ranks of a ``torch.distributed`` group
(``repro_torch.launch.mesh.ProcessMesh``: rank r holds nodes [r N / W,
(r + 1) N / W), all M model shards of each); the hops cross ranks through
``repro_torch.optim.wire.DistPP`` (``batch_isend_irecv``).  Against the
one-process run:

* the golden ``trainer_neighbor_bucketed_8x1`` (exponential graph, 5
  hops) and ``trainer_neighbor_alternating_4x2`` (2 model shards a node,
  alternating schedule, 3 hops) specs at world sizes 2 and 4, 3 steps
  from the same initial state: the one-process run records its noise,
  each rank replays its rows of it; the state gathered from the ranks
  (X, D, H, Hw) equals the one-process state bit for bit (measured: the
  node-stacked forward of a rank's nodes gives each node's gradient bit
  for bit, and the update is elementwise), and the all-reduced loss and
  consensus match within 1e-6 relative (their sums run in another order);
* ``DistPP`` alone: ``stacked_pp``'s result on every rank's rows, for
  pairs within a rank, across ranks, several to one peer, and a rank that
  receives nothing;
* the harness: every rank runs in its own process with a deadline; a rank
  that dies fails the test at once instead of hanging it.

Each world is one launch of W worker processes (this file run as a
script), joined with a deadline; gloo rendezvous through a file in the
test's temporary directory, so concurrent test workers never share a
port.  Workers pin torch to one thread, as the one-process run does.
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
GOLDEN = ROOT / "tests" / "golden_specs"
SPECS = {"8x1": GOLDEN / "trainer_neighbor_bucketed_8x1.json",
         "4x2": GOLDEN / "trainer_neighbor_alternating_4x2.json"}
STEPS = 3
DEADLINE_S = 180


# --- the ranks ---------------------------------------------------------------

def _state_rows(state):
    from repro_torch import tree
    p = state.plead
    return {name: [x.clone() for x in tree.leaves(t)] for name, t in (
        ("X", p.X), ("D", p.D), ("H", p.comm.H), ("Hw", p.comm.Hw))}


def _rank_trainer(args, rank, world):
    """Rank ``rank``'s runs of ``args.specs``: each from the recorded
    initial state's rows, replaying its rows of the recorded noise."""
    import torch.distributed as dist
    from repro_torch import api, tree
    from repro_torch.core.draws import ReplayDraws
    from repro_torch.launch.mesh import ProcessMesh
    out = {}
    for key in args.specs:
        rec = torch.load(pathlib.Path(args.dir) / f"{key}.pt")
        spec = api.ExperimentSpec.load(SPECS[key])
        pm = ProcessMesh(api.spec_mesh(spec), rank=rank, world=world)
        run = api.build_trainer_runner(spec, device="cpu", process_mesh=pm)
        tr = run.trainer
        assert tr.n_local == spec.n_nodes // world
        state = tr.state_from_stacked(tree.unflatten(
            tree.flatten(tr.init_state().plead.X)[1],
            [pm.rows(x) for x in rec["X0"]]))
        fresh = [x.clone() for x in tree.leaves(tr.init_state().plead.X)]
        assert all(torch.equal(a, b) for a, b in zip(
            fresh, tree.leaves(state.plead.X)))
        draws = ReplayDraws([pm.rows(u) for u in rec["noise"]], "cpu")
        data = run.default_data()
        metrics = []
        for t in range(STEPS):
            state, m = run.step(state, data.batch_at(t), draws)
            metrics.append([float(m["loss"]), float(m["consensus"])])
        assert not draws.pending
        out[key] = {"state": _state_rows(state), "metrics": metrics,
                    "lo": pm.lo}
        dist.barrier()
    return out


def _rank_pp(rank, world):
    """DistPP against stacked_pp on every pattern of pairs."""
    from repro_torch.launch.mesh import Mesh, ProcessMesh
    from repro_torch.optim.wire import DistPP, stacked_pp
    n = 2 * world
    pm = ProcessMesh(Mesh((n, 2)), rank=rank, world=world)
    pp = DistPP(pm)
    x = torch.arange(n * 6, dtype=torch.uint8).view(n, 6)
    cases = [[(i, (i + 1) % n) for i in range(n)],   # a ring, both ways
             [(i, (i - 1) % n) for i in range(n)],
             [(0, 1), (1, 0)],                       # within rank 0
             [(0, n - 2), (1, n - 1)],               # two to one peer
             [(n - 1, 0)],                           # the others: nothing
             []]
    for pairs in cases:
        got = pp(pm.rows(x), pairs)
        assert torch.equal(got, pm.rows(stacked_pp(x, pairs))), pairs
    return {"cases": len(cases)}


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
    dist.init_process_group(
        "gloo", init_method=f"file://{args.dir}/rendezvous",
        rank=args.rank, world_size=args.world,
        timeout=datetime.timedelta(seconds=DEADLINE_S))
    try:
        if args.mode == "die" and args.rank == 1:
            os._exit(3)               # a crash: the others wait in the pp
        if args.mode in ("pp", "die"):
            out = _rank_pp(args.rank, args.world)
        else:
            out = _rank_trainer(args, args.rank, args.world)
        torch.save(out, pathlib.Path(args.dir) / f"rank{args.rank}.pt")
    finally:
        dist.destroy_process_group()


# --- the launcher ------------------------------------------------------------

def launch(world, tmp, mode="trainer", specs=(), deadline=DEADLINE_S):
    """Run ``world`` ranks of this file; -> their outputs in rank order.
    Fails (killing every rank) as soon as one rank exits nonzero, or at
    the deadline."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    tmp = pathlib.Path(tmp)
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--world", str(world),
         "--dir", str(tmp), "--mode", mode, "--specs", *specs],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    t_end = time.monotonic() + deadline
    try:
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                # a rank failed: the others get a moment to fail or end
                # on their own (their codes name the fault), then die
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
    return [torch.load(pathlib.Path(tmp) / f"rank{r}.pt")
            for r in range(world)]


# --- the tests ---------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """Each spec's one-process run: its initial X, the noise of its steps
    (recorded), its final state and metrics."""
    from repro_torch import api, tree
    from repro_torch.core.draws import GeneratorDraws, RecordingDraws
    d = tmp_path_factory.mktemp("one_process")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for key, path in SPECS.items():
            run = api.build(api.ExperimentSpec.load(path), device="cpu")
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
    finally:
        torch.set_num_threads(threads)
    return d, out


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_equal_the_one_process_run(world, one_process, tmp_path):
    rec_dir, want = one_process
    for key in SPECS:
        (tmp_path / f"{key}.pt").write_bytes((rec_dir / f"{key}.pt")
                                             .read_bytes())
    ranks = launch(world, tmp_path, specs=list(SPECS))
    for key in SPECS:
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


def test_dist_pp_equals_stacked_pp(tmp_path):
    out = launch(3, tmp_path, mode="pp")
    assert [o["cases"] for o in out] == [6, 6, 6]


def test_a_dead_rank_fails_the_launch_at_once(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited 3"):
        launch(2, tmp_path, mode="die", deadline=60)
    assert time.monotonic() - t0 < 60


if __name__ == "__main__":
    _worker(sys.argv[1:])
