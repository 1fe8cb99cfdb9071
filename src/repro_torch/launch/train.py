"""Decentralized training CLI: the NN trainer (``repro_torch.optim.
decentralized``, any of the ten architectures) through ``api.build``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --nodes 8 --steps 200 --bits 2 --prox l1 --lam 1e-5 [--device cpu]

Reduced configs by default (``--layers``, ``--d-model``); ``--full`` keeps
the published widths.  Every flag is an alias for an ExperimentSpec field
(``repro_torch.api``): the CLI builds a spec (``--print-spec`` prints
it) and runs it on the sharded engine, on the card unless ``--device
cpu``.  ``--ckpt DIR`` saves the final state with the spec embedded, so
``repro_torch.api.load_checkpoint(DIR)`` rebuilds the experiment.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import api


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--local-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--compressor", default="qinf",
                    choices=["qinf", "identity", "randk", "topk"])
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--frac", type=float, default=0.1,
                    help="randk/topk kept fraction")
    ap.add_argument("--allow-biased", action="store_true",
                    help="opt in to biased compressors (topk violates "
                         "Assumption 2; ablations only)")
    ap.add_argument("--prox", default="none")
    ap.add_argument("--lam", type=float, default=1e-5)
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--backend", default="dense",
                    choices=["dense", "neighbor", "ring"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) model config")
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--report", default=None,
                    help="write the run's RunReport JSON here")
    ap.add_argument("--print-spec", action="store_true",
                    help="print the resolved ExperimentSpec JSON and exit")
    ap.add_argument("--device", default=None,
                    help="default: the card (fails without one)")
    args = ap.parse_args(argv)

    spec = api.ExperimentSpec.from_flags(args, engine="sharded")
    if args.print_spec:
        print(spec.to_json())
        return 0
    runner = api.build(spec, device=args.device)
    t0 = time.perf_counter()

    def log_cb(state, metrics, t):
        print(f"step {t:5d}  loss {float(metrics['loss']):.4f}  "
              f"consensus {float(metrics['consensus']):.3e}  "
              f"({(time.perf_counter() - t0) / (t + 1):.2f}s/step)")

    state, _ = runner.run(num_steps=args.steps, callback=log_cb,
                          log_every=max(1, args.log_every))
    # the communicated volume is the report's exact wire accounting, so
    # the CLI and the report cannot disagree
    rep = runner.last_report
    if rep.wire["bits_per_step"]:
        desc = (f"{args.compressor}, {args.bits}-bit"
                if args.compressor == "qinf" else args.compressor)
        print(f"done: {args.steps} steps; ~{rep.wire['bits_total'] / 8e9:.3f}"
              f" GB communicated/node ({desc}); wire fraction "
              f"{rep.timing['wire_fraction_of_step']:.1%} of "
              f"{rep.timing['mean_step_s']:.2f}s/step")
    else:
        print("done")
    if args.report:
        print("run report written to", rep.save(args.report))
    if args.ckpt:
        runner.save(args.ckpt, state, step=int(state.step))
        print("checkpoint saved to", args.ckpt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
