"""The readings that the correctness limits of a cell are set from.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 7,8,9 [--faults half_batch,no_exchange,no_prox] \
        [--out chiprun_out/readings.json]

For each of ``--seeds``: the program's checked steps against the
reference (the sound runs, whose widest gaps are a limit's lower
reading).  For each of ``--control-seeds``: the control, the reference
with TF32 products put in the program's place, against the float32
reference; and each fault of ``--faults`` planted in the program
(:func:`plant`).  The benchmark's own runs never run this; it needs no
measured window.  One JSON line a reading on standard output, and a
summary of each number at the end.
"""
import argparse
import json
import pathlib
import sys
import time
from typing import Sequence

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: faults planted in the program to see ``correct`` come out false
FAULTS = ("frozen", "half_batch", "no_exchange", "no_prox")


def plant(trainer, faults: Sequence[str]) -> None:
    """Break the program's timed path underneath a run: ``frozen`` a
    step returns its state unchanged; ``half_batch`` the loss is the mean
    over half of each node's batch; ``no_exchange`` nothing crosses the
    exchange between the nodes; ``no_prox`` the prox is left out of the
    update."""
    import torch
    unknown = set(faults) - set(FAULTS)
    if unknown:
        raise ValueError(f"unknown faults {sorted(unknown)}; have {FAULTS}")
    if "frozen" in faults:
        trainer._sharded_update = \
            lambda plead, G, draws: plead._replace(k=plead.k + 1)
    if "half_batch" in faults:
        whole = trainer.loss_and_grad

        def half(X, batch):
            return whole(X, {k: v[:, :v.shape[1] // 2]
                             for k, v in batch.items()})
        trainer.loss_and_grad = half
    if "no_exchange" in faults:
        trainer.pp = lambda x, pairs: torch.zeros_like(x)
    if "no_prox" in faults:
        trainer.prox = lambda z, eta: z


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="half_batch,no_exchange,no_prox")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import check, harness, traffic
    device = torch.device("cuda")
    cell = harness.open_cell(args.workload, traffic.benchmark())
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    faults = [f for f in args.faults.split(",") if f]
    rows = []

    def emit(kind, seed, found, t0, prog=None, ref=None):
        row = {"kind": kind, "seed": seed, **found,
               "seconds": time.perf_counter() - t0}
        if prog is not None:    # where the widest gaps lie
            for key in ("change_norms", "l1_norms"):
                node, leaf = check.worst(prog, ref, key)
                row[key + "_worst"] = [node, cell.paths[leaf]]
            row["state_parts"] = check.state_gaps(prog, ref)
            row["losses"] = [prog["losses"], ref["losses"]]
        rows.append(row)
        print(json.dumps(row), flush=True)

    def program(seed, planted=()):
        su = harness.set_up(cell, seed, device,
                            lambda tr: plant(tr, planted))
        X0, bank, readout = su.X0, su.bank, su.readout
        del su
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return X0, bank, readout

    for seed in seeds:
        t0 = time.perf_counter()
        X0, bank, readout = program(seed)
        ref = harness.reference_readout(cell, seed, X0, bank, device)
        emit("program", seed, check.gaps(readout, ref), t0, readout, ref)
    for seed in control:
        t0 = time.perf_counter()
        X0 = traffic.make_weights(cell.leaves, seed, device)
        bank = traffic.make_bank(cell.cell, cell.cfg, seed, device)
        ref = harness.reference_readout(cell, seed, X0, bank, device)
        tf32 = harness.reference_readout(cell, seed, X0, bank, device,
                                         precision="tf32")
        emit("control_tf32", seed, check.gaps(tf32, ref), t0, tf32, ref)
        del X0, bank
        for fault in faults:
            t0 = time.perf_counter()
            _, _, readout = program(seed, (fault,))
            emit(fault, seed, check.gaps(readout, ref), t0, readout, ref)
    summary = {}
    for kind in sorted({r["kind"] for r in rows}):
        rs = [r for r in rows if r["kind"] == kind]
        pick = max if kind == "program" else min
        summary[kind] = {n: pick(r[n] for r in rs) for n in check.NUMBERS}
    print(json.dumps({"cell": cell.name, "summary": summary}), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(
            {"cell": cell.name, "rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
