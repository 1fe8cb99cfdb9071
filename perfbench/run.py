"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell
asks for.  Prints each number the check compared, with its limit, as the
last lines on standard error, and one JSON object as the last line of
standard output.  Exits non-zero, printing no result, without a CUDA
card, when the checkout lacks the program, or when the process holds
JAX or the JAX package once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _err(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import harness, traffic
    try:
        cell = harness.open_cell(args.workload, traffic.benchmark())
    except traffic.UnknownName as e:
        _err(str(e))
        return 2
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _err(f"cell {args.workload} needs {chips} CUDA card(s); "
             f"this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        result = harness.run(cell, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START,
                             device="cuda", err=_err)
    except harness.Refused as e:
        _err(f"refused: {e}")
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
