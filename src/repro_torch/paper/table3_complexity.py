"""Tables 2/3: measured linear rates against theory.

The port of ``benchmarks/table3_complexity.py``.  For LEAD variants on a
strongly convex ridge instance with known (mu, L, kappa_f, kappa_g, C), the
measured per-iteration contraction factor
rho_hat = (subopt_K / subopt_0)^(1/K) must not exceed the theorem envelope
rho (Theorems 5/8/9): practice is at least as fast as the worst case.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch import api, registry
from repro_torch.core import theory
from repro_torch.core import topology as topo_mod
from repro_torch.core.comm import DenseMixer
from repro_torch.core.draws import Draws, GeneratorDraws
from repro_torch.paper.problems import ridge_problem


class Row(NamedTuple):
    name: str
    alg: object
    steps: int
    rho_theory: float


def experiments(*, device=None, dtype: torch.dtype = torch.float64):
    """-> (rows, X0, X* stacked like X0): Theorem 5 at C = 0 (identity) and
    C = 0.5 (4-bit QInf, block 64), Theorems 8/9 (L-SVRG, SAGA, 4 bits),
    each LEAD at the theorem's parameters."""
    prob, xstar, mu, L, X0 = ridge_problem(
        device=api.resolve_device(device), dtype=dtype)
    topo = topo_mod.make_topology("ring", prob.n)
    mixer = DenseMixer(topo.W)
    q4 = lambda: registry.make("compressor", "qinf", bits=4,  # noqa: E731
                               block=64)

    def lead(eta, alpha, gamma, comp, oracle):
        return registry.make("algorithm", "lead", eta=eta, alpha=alpha,
                             gamma=gamma, compressor=comp, mixer=mixer,
                             oracle=registry.make("oracle", oracle,
                                                  problem=prob))

    rows: List[Row] = []
    for Cq, bits in [(0.0, None), (0.5, 4)]:
        pc = theory.ProblemConstants(mu, L, topo.lambda_max,
                                     topo.lambda_min_pos, C=Cq, m=prob.m)
        eta, alpha, gamma = theory.theorem5_params(pc)
        rho, _ = theory.theorem5_rate(pc, eta, alpha, gamma)
        comp = (registry.make("compressor", "identity") if bits is None
                else q4())
        rows.append(Row(f"Theorem5 (C={Cq})",
                        lead(eta, alpha, gamma, comp, "full"), 400, rho))
    for orc_name, thm in [("lsvrg", "thm8"), ("saga", "thm9")]:
        pc = theory.ProblemConstants(mu, L, topo.lambda_max,
                                     topo.lambda_min_pos, C=0.5, m=prob.m)
        eta, alpha, gamma, p = theory.theorem8_params(pc)
        rho = (theory.theorem8_rate(pc, p) if thm == "thm8"
               else theory.theorem9_rate(pc))
        rows.append(Row(f"{thm.upper()} ({orc_name})",
                        lead(eta, alpha, gamma, q4(), orc_name), 1500, rho))
    Xs = torch.as_tensor(xstar, dtype=dtype, device=X0.device).expand_as(X0)
    return rows, X0, Xs


def measure(alg, X0, Xs, steps: int, draws: Draws):
    """-> (subopt after init, subopt after ``steps`` steps, rho_hat)."""
    st = alg.init(X0, draws)
    s0 = float(((st.X - Xs) ** 2).sum())
    for _ in range(steps):
        st = alg.step(st, draws)
    sK = float(((st.X - Xs) ** 2).sum())
    return s0, sK, (max(sK, 1e-300) / s0) ** (1 / steps)


def run(verbose: bool = False, *, device=None,
        dtype: torch.dtype = torch.float64):
    rows, X0, Xs = experiments(device=device, dtype=dtype)
    out = []
    for r in rows:
        _, _, rho_hat = measure(r.alg, X0, Xs, r.steps,
                                GeneratorDraws(0, X0.device))
        out.append({"name": r.name, "rho_theory": r.rho_theory,
                    "rho_measured": rho_hat,
                    "ok": bool(rho_hat <= r.rho_theory + 1e-3)})
    if verbose:
        for r in out:
            print(f"  {r['name']:22s} rho_theory={r['rho_theory']:.5f} "
                  f"rho_measured={r['rho_measured']:.5f} ok={r['ok']}",
                  flush=True)
    return out


def validate(rows):
    return [(f"{r['name']}: measured rate within theorem envelope",
             bool(r["ok"]), (r["rho_measured"], r["rho_theory"]))
            for r in rows]
