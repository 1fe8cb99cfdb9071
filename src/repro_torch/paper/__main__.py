"""The paper harness: one module per table/figure, run in f64.

    python -m repro_torch.paper [--only fig1,fig2,table3,ablations]
                                [--steps 800] [--seeds 1] [--device cpu]
                                [--json-out results.json]

The port of ``benchmarks/run.py`` for the paper's suites.  Runs on the
card unless ``--device cpu`` is given (the port's plain path); prints a
CSV block per suite and every claim as PASS/FAIL; exits 1 if any claim
fails.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

from repro_torch import api
from repro_torch.paper import (ablations, fig1_smooth, fig2_nonsmooth,
                               table3_complexity)

SUITES = ("fig1", "fig2", "table3", "ablations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.paper")
    ap.add_argument("--only", default=",".join(SUITES),
                    help=f"comma-separated subset of {','.join(SUITES)}")
    ap.add_argument("--steps", type=int, default=800,
                    help="iterations of the fig1/fig2 rows (ablations run "
                         "at most 500)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="seeds a fig1/fig2 row runs at; curves averaged")
    ap.add_argument("--device", default=None,
                    help="default: the card (fails without one); 'cpu' "
                         "runs the port's plain path")
    ap.add_argument("--json-out", default=None,
                    help="write rows and claims to this JSON file")
    args = ap.parse_args(argv)
    chosen = args.only.split(",")
    bad = sorted(set(chosen) - set(SUITES))
    if bad:
        ap.error(f"unknown suites {bad}; have {list(SUITES)}")
    device = api.resolve_device(args.device)
    dt = torch.float64
    suites = {
        "fig1": ("Fig.1 smooth logistic regression",
                 lambda: fig1_smooth.run(args.steps, verbose=True,
                                         seeds=args.seeds, device=device,
                                         dtype=dt),
                 fig1_smooth.validate),
        "fig2": ("Fig.2 non-smooth logistic regression",
                 lambda: fig2_nonsmooth.run(args.steps, verbose=True,
                                            seeds=args.seeds, device=device,
                                            dtype=dt),
                 fig2_nonsmooth.validate),
        "table3": ("Table 2/3 rate-vs-theory",
                   lambda: table3_complexity.run(verbose=True, device=device,
                                                 dtype=dt),
                   table3_complexity.validate),
        "ablations": ("Ablations: bits sweep + topology/kappa_g sweep",
                      lambda: ablations.run(min(500, args.steps),
                                            verbose=True, device=device,
                                            dtype=dt),
                      ablations.validate),
    }
    print(f"device: {api.device_label(device)}, f64", flush=True)
    all_rows, all_checks = {}, []
    for key in chosen:
        title, runner, validator = suites[key]
        print(f"\n=== {title} ===", flush=True)
        t0 = time.perf_counter()
        rows = runner()
        all_rows[key] = rows
        all_checks.extend((key, *c) for c in validator(rows))
        print(f"--- {key}: {len(rows)} rows in "
              f"{time.perf_counter() - t0:.1f}s ---")
        cols = [c for c in rows[0] if c != "subopt"]
        print(",".join(cols))
        for r in rows:
            print(",".join(str(r.get(c, "")) for c in cols))

    print("\n=== PAPER-CLAIM VALIDATION ===")
    n_fail = 0
    for key, claim, ok, detail in all_checks:
        n_fail += not ok
        print(f"[{'PASS' if ok else 'FAIL'}] ({key}) {claim}   [{detail}]")
    print(f"\n{len(all_checks) - n_fail}/{len(all_checks)} claims validated")
    if args.json_out:
        out = pathlib.Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(
            {"device": api.device_label(device), "dtype": "float64",
             "rows": all_rows,
             "checks": [{"suite": k, "claim": c, "ok": bool(o),
                         "detail": str(d)} for k, c, o, d in all_checks]},
            indent=1, default=str))
        print("results written to", out)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
