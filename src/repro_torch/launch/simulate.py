"""Scenario-simulation CLI: Prox-LEAD, LEAD and the baselines on a
synthetic logistic regression under time-varying topologies and injected
communication faults (``repro_torch.netsim``).

  PYTHONPATH=src python -m repro_torch.launch.simulate \\
      --schedule random_matching --fault linkdrop:0.1 \\
      --algo prox-lead --compressor qinf:2 --steps 200 [--device cpu]

Schedules: static | alternating | random_matching | markov_drop[:drop]
Faults (comma-separated): linkdrop:RATE | straggler:RATE | noise:SIGMA
Algos: prox-lead | lead | nids | dgd | pg-extra | choco | lessbit
Compressors: qinf:BITS | randk:FRAC | identity

Every flag is an alias for an ExperimentSpec field (``repro_torch.api``):
the CLI resolves the flags into a spec (``--print-spec`` prints it,
``--spec FILE`` replays one) and runs it on the netsim engine, in f64 (as
the reference's x64 CLI), on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.netsim import faults as faults_mod


def solve_reference(problem, shape, lam1: float, L: float, *, device,
                    dtype=torch.float64, iters: int = 4000) -> np.ndarray:
    """Centralized proximal gradient descent to high precision (small
    problems only), on ``device``."""
    n, eta = problem.n, 1.0 / L
    x = torch.zeros(shape, dtype=dtype, device=device)
    for _ in range(iters):
        z = x - eta * problem.full_grad(x.expand((n,) + shape)).mean(0)
        x = torch.sign(z) * torch.clamp_min(z.abs() - eta * lam1, 0.0)
    return x.cpu().numpy()


def spec_from_args(args) -> api.ExperimentSpec:
    """The CLI flags as an ExperimentSpec (netsim engine), with the
    reference CLI's per-algorithm defaults: gamma = 0.5 for
    (Prox-)LEAD, Choco's gossip step gamma_c = 0.2, eta = 1/(2L) for the
    strongly convex logreg instance."""
    L = 0.5 + 2 * args.lam2          # rows normalized: softmax Hessian bound
    spec = api.ExperimentSpec.from_flags(
        args, engine="netsim", name=f"simulate-{args.algo}",
        fault_seed=args.seed + 1)
    params = {"gamma_c": 0.2} if spec.algorithm.name == "choco" else {}
    algorithm = dataclasses.replace(
        spec.algorithm, eta=api.constant(1.0 / (2 * L)),
        gamma=api.constant(0.5), params=params)
    compressor = spec.compressor
    if compressor.name == "qinf" and args.classes < compressor.params.get(
            "block", 256):
        # blockwise quantization runs along the last axis; cap the block at
        # the iterate's last dim so the wire payload carries no padding
        compressor = api.CompressorSpec(
            "qinf", {**compressor.params, "block": int(args.classes)})
    return dataclasses.replace(spec, algorithm=algorithm,
                               compressor=compressor)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.simulate",
        description="netsim scenario simulation (time-varying topology + "
                    "fault injection)")
    ap.add_argument("--schedule", default="static",
                    help="static|alternating|random_matching|"
                         "markov_drop[:drop]")
    ap.add_argument("--topology", default="ring",
                    help="base topology for static/alternating/markov_drop")
    ap.add_argument("--rounds", type=int, default=32,
                    help="schedule cycle length T_cycle")
    ap.add_argument("--fault", default="",
                    help="comma-separated: linkdrop:R,straggler:R,noise:S")
    ap.add_argument("--algo", default="prox-lead")
    ap.add_argument("--compressor", default="qinf:2")
    ap.add_argument("--oracle", default="full",
                    choices=["full", "sgd", "lsvrg", "saga"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--features", type=int, default=50)
    ap.add_argument("--classes", type=int, default=5)
    ap.add_argument("--l1", type=float, default=0.0,
                    help="l1 weight (prox-applied, composite problem)")
    ap.add_argument("--lam2", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--print-spec", action="store_true",
                    help="print the resolved ExperimentSpec JSON and exit")
    ap.add_argument("--spec", default=None,
                    help="run a saved ExperimentSpec JSON file instead of "
                         "the flags (the spec wins on every field, the "
                         "lam2/l1 of the reference solve included)")
    ap.add_argument("--device", default=None,
                    help="default: the card (fails without one)")
    args = ap.parse_args(argv)

    spec = (api.ExperimentSpec.load(args.spec) if args.spec
            else spec_from_args(args))
    if spec.execution.engine != "netsim":
        raise SystemExit(
            f"simulate drives the netsim engine; spec {spec.name!r} has "
            f"engine={spec.execution.engine!r} (use "
            f"repro_torch.launch.train or repro_torch.api.build for it)")
    if args.print_spec:
        print(spec.to_json())
        return 0
    if spec.prox.name not in ("l1", "none"):
        raise SystemExit(
            f"simulate's closed-form reference solve handles l1/none "
            f"proxes; spec has {spec.prox.name!r}")
    device = api.resolve_device(args.device)
    runner = api.build(spec, device=device, dtype=torch.float64)

    # the reference solve follows the SPEC (the experiment), not the flag
    # defaults: a replayed --spec file carries its own lam2 and l1
    oracle_spec = api.default_oracle_spec(spec)
    lam2 = oracle_spec.problem_params.get("lam2", args.lam2)
    l1 = spec.prox.params.get("lam", 0.0) if spec.prox.name == "l1" else 0.0
    problem, n = runner.problem, spec.n_nodes
    shape = tuple(runner.X0.shape[1:])
    xstar = torch.as_tensor(solve_reference(
        problem, shape, l1, 0.5 + 2 * lam2, device=device), device=device)
    fstar = float(problem.full_loss(xstar.expand((n,) + shape))
                  + l1 * xstar.abs().sum())

    def objective_fn(X):
        # the gap at the node average: F(xbar) - F* >= 0 (per-node losses
        # can dip below the consensus-constrained optimum before consensus)
        xbar = X.mean(0)
        return (problem.full_loss(xbar.expand(X.shape))
                + l1 * xbar.abs().sum()) - fstar

    schedule = runner.schedule
    schedule.validate()
    compressor = getattr(runner.algo, "compressor", None)
    dim = int(np.prod(shape))
    C_eff = faults_mod.effective_C(runner.faults,
                                   getattr(compressor, "C", 0.0), dim)
    fault_desc = ",".join(f.name for f in runner.faults)
    print(f"schedule={schedule.name} T_cycle={schedule.T_cycle} "
          f"joint_spectral_gap={schedule.joint_spectral_gap():.4f}")
    print(f"faults=[{fault_desc or '-'}] mean_edge_survival="
          f"{faults_mod.mean_edge_survival(runner.faults):.3f} "
          f"effective_C={C_eff:.3g}")
    print(f"algo={spec.algorithm.name} compressor={spec.compressor.name}"
          f"{spec.compressor.params} oracle={oracle_spec.name} n={n} "
          f"dim={dim} steps={spec.steps} device="
          f"{api.device_label(device)}")

    t0 = time.perf_counter()
    _final, traj = runner.run(objective_fn=objective_fn)
    dt = time.perf_counter() - t0

    s = traj.summary()
    ideal = traj.bits / max(s["bits_per_edge_per_round"], 1) * 32 * dim
    saving = float(ideal.sum() / max(traj.total_bits, 1.0))
    q = traj.objective
    marks = [0, len(q) // 4, len(q) // 2, 3 * len(q) // 4, len(q) - 1]
    trace = "  ".join(f"k={i + 1}:{q[i]:.3e}" for i in marks)
    print(f"objective gap trace: {trace}")
    print(f"final objective gap {s['final_objective_gap']:.3e} | "
          f"consensus {s['final_consensus']:.3e} | "
          f"bits on wire {s['total_bits_on_wire']:.3e} "
          f"({saving:.1f}x saving vs f32) | {dt:.1f}s")
    if args.json_out:
        traj.to_json(args.json_out, full=True)
        print("trajectory written to", args.json_out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
