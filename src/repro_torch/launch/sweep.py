"""Grid-sweep CLI: expand a base experiment over ``--axis`` grids and
run the grid with the sweep engine (``repro_torch.sweep``).

  PYTHONPATH=src python -m repro_torch.launch.sweep \\
      --spec base.json --axis seed=0:16 --axis compressor.bits=2,4,8 \\
      --out sweep.json [--device cpu]

Without ``--spec`` the base experiment comes from the flags
``repro_torch.launch.simulate`` and ``train`` understand (``--algo``,
``--compressor``, ``--schedule``, ``--fault``, ...) through
``ExperimentSpec.from_flags``.  Axis syntax (``api.parse_axis``):

  --axis seed=0:16                 integer range, half-open
  --axis compressor.bits=2,4,8    value list
  --axis algorithm.eta=0.05,0.1   any constant/harmonic schedule field

A saved *sweep* file (``--spec`` with a ``base`` key) runs as it is, the
command line's axes appended; ``--print-spec`` prints the resolved
SweepSpec.  Engines: dense and netsim, from the base spec.  The grid runs
in map mode (every point bit for bit its serial run), in f64 as the
reference's x64 CLI, on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

import torch

from repro_torch import api
from repro_torch.netsim.metrics import consensus_error


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.sweep",
        description="grid sweeps over ExperimentSpec axes")
    ap.add_argument("--spec", default=None,
                    help="base ExperimentSpec JSON (or a saved SweepSpec "
                         "JSON, detected by its 'base' key)")
    ap.add_argument("--axis", action="append", default=[],
                    metavar="PATH=VALUES",
                    help="sweep axis (repeatable): seed=0:16, "
                         "compressor.bits=2,4,8, algorithm.eta=0.05,0.1")
    ap.add_argument("--name", default="sweep")
    ap.add_argument("--steps", type=int, default=None,
                    help="override base.steps")
    ap.add_argument("--out", default=None,
                    help="write per-point results JSON here")
    ap.add_argument("--print-spec", action="store_true",
                    help="print the resolved SweepSpec JSON and exit")
    ap.add_argument("--device", default=None,
                    help="default: the card (fails without one)")
    # the base experiment's flags (the same aliases as launch.simulate)
    ap.add_argument("--engine", default=None, help="dense|netsim")
    ap.add_argument("--algo", default="prox_lead")
    ap.add_argument("--compressor", default="qinf:2")
    ap.add_argument("--oracle", default="full")
    ap.add_argument("--schedule", default="static")
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--rounds", type=int, default=32)
    ap.add_argument("--fault", default="")
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--gamma", type=float, default=0.5)
    ap.add_argument("--l1", type=float, default=0.0)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    axes = tuple(api.parse_axis(a) for a in args.axis)
    if args.spec:
        text = pathlib.Path(args.spec).read_text()
        if "base" in json.loads(text):
            sweep_spec = api.SweepSpec.from_json(text)
            if axes:
                sweep_spec = dataclasses.replace(
                    sweep_spec, axes=sweep_spec.axes + axes)
        else:
            sweep_spec = api.SweepSpec(
                args.name, api.ExperimentSpec.from_json(text), axes)
    else:
        base = api.ExperimentSpec.from_flags(
            args, engine=args.engine or "dense")
        sweep_spec = api.SweepSpec(args.name, base, axes)
    if args.steps is not None:
        sweep_spec = dataclasses.replace(sweep_spec, base=dataclasses.replace(
            sweep_spec.base, steps=args.steps))
    if args.print_spec:
        print(sweep_spec.to_json())
        return 0

    runner = api.build(sweep_spec, device=args.device, dtype=torch.float64)
    print(f"sweep {sweep_spec.name!r}: {runner.n_points} points over "
          f"{[a.path for a in sweep_spec.axes]} "
          f"(engine={sweep_spec.base.execution.engine}, "
          f"steps={sweep_spec.base.steps}, "
          f"device={api.device_label(runner.device)}, f64)")
    t0 = time.perf_counter()
    if runner.engine == "netsim":
        final, res = runner.run()
    else:
        final, res = runner.run(metric_fn=lambda st: consensus_error(st.X))
    wall = time.perf_counter() - t0

    rows = []
    for i, p in enumerate(runner.points):
        row = {"name": p.name, "seed": p.seed}
        if runner.engine == "netsim":
            row["final_consensus"] = float(res.metrics["consensus"][i, -1])
            row["final_objective_gap"] = float(
                res.metrics["objective"][i, -1])
            row["total_mbits_on_wire"] = round(
                float(res.metrics["bits"][i].sum()) / 1e6, 3)
        else:
            row["final_consensus"] = float(res.metrics["metric"][i, -1])
        rows.append(row)
        print("  " + "  ".join(f"{k}={v}" for k, v in row.items()))
    print(f"{runner.n_points} points in {wall:.2f} s")

    if args.out:
        out = {"spec": sweep_spec.to_dict(), "points": rows, "wall_s": wall,
               "report": runner.last_report.to_dict()}
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1,
                                                     default=str))
        print("results written to", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
