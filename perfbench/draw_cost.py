"""What the benchmark's draw source costs against the program's own.

    python3 perfbench/draw_cost.py --workload <cell> --seed <n> \
        [--seconds 8] [--turns 2]

The window draws its stochastic-rounding uniforms from
``perfbench/traffic.py::draws``: one generator a node and a draw, so that
the reference can draw the same numbers.  The program's runs draw from
``repro_torch.core.draws.GeneratorDraws``: one generator, one draw over a
leaf's whole buffer.  After one set-up this runs the cell's traced steps
and a timed window with each source in turn (bench, program, bench,
program, ...), and prints one JSON line each: ``wire_ms``, the device ms
a step of the draw kernels (``distribution`` in the kernel's name), the
device's busy share of the traced window, and ``tokens_per_s`` and
``step_ms_p90`` of the timed window.  The benchmark's own runs never run
this.
"""
import argparse
import json
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import harness, tracing, traffic
    from repro_torch.core.draws import GeneratorDraws
    device = torch.device("cuda")
    bench = traffic.benchmark()
    cell = harness.open_cell(args.workload, bench)
    wire = harness.metric_modules(cell, bench)["wire_ms"]
    draw_ms = types.SimpleNamespace(WRAPS=[], read=lambda ctx: 1e3 * sum(
        ctx.trace.kernels("distribution")) / ctx.trace.steps)
    readers = {"wire_ms": wire, "draw_ms": draw_ms}
    units = {"wire_ms": "ms", "draw_ms": "ms"}
    su = harness.set_up(cell, args.seed, device)
    tracing.warm(torch, device)
    sources = {"bench": su.draws,
               "program": GeneratorDraws(args.seed, device)}
    notes = []
    for turn in range(args.turns):
        for name, src in sources.items():
            su.draws = src
            metrics, busy, _, _ = harness.traced(su, cell, readers, units,
                                                 device, notes.append)
            timed, _ = harness.measure(su, cell, args.seconds, device,
                                       notes.append)
            print(json.dumps({
                "source": name, "turn": turn,
                **{k: v["value"] for k, v in {**metrics, **timed}.items()},
                "busy_pct": 100 * busy["busy_s"] / busy["window_s"]}),
                flush=True)
    print("\n".join(notes), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
