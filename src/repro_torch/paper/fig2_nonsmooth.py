"""Fig. 2: NON-SMOOTH logistic regression (lambda1 = 0.005).

The port of ``benchmarks/fig2_nonsmooth.py``: the same rows, claims and
thresholds.  Prox-LEAD (2bit) matches Prox-LEAD (32bit) and the
uncompressed composite baselines (NIDS, PG-EXTRA/P2D2) per iteration, at
~14x fewer bits; the VR variants stay linear with compression + prox.
"""
from __future__ import annotations

import torch

from repro_torch.paper import common as cm
from repro_torch.paper.fig1_smooth import _tail_ratio

LAM1 = 0.005


def cells(num_steps: int, eta: float, eta_s: float):
    out = [
        ("Prox-DGD",
         cm.paper_cell("dgd", eta=eta, steps=num_steps, lam1=LAM1)),
        ("NIDS (32bit)",
         cm.paper_cell("nids_independent", eta=eta, steps=num_steps,
                       lam1=LAM1)),
        ("PG-EXTRA/P2D2 (32bit)",
         cm.paper_cell("pg_extra", eta=eta / 2, steps=num_steps,
                       lam1=LAM1)),
        ("Prox-LEAD (32bit)",
         cm.paper_cell("prox_lead", eta=eta, steps=num_steps, gamma=1.0,
                       lam1=LAM1)),
        ("Prox-LEAD (2bit)",
         cm.paper_cell("prox_lead", eta=eta, steps=num_steps, gamma=0.5,
                       compressor=cm.Q2_SPEC, lam1=LAM1)),
    ]
    for orc in ("sgd", "lsvrg", "saga"):
        tag = orc.upper()
        out.append((f"Prox-LEAD-{tag} (32bit)",
                    cm.paper_cell("prox_lead", eta=eta_s, steps=num_steps,
                                  gamma=1.0, oracle=orc, lam1=LAM1)))
        out.append((f"Prox-LEAD-{tag} (2bit)",
                    cm.paper_cell("prox_lead", eta=eta_s, steps=num_steps,
                                  gamma=0.5, compressor=cm.Q2_SPEC,
                                  oracle=orc, lam1=LAM1)))
    return out


def setup(num_steps: int, *, device=None, dtype: torch.dtype = cm.DTYPE):
    """-> (the grid, X*): the problem, its exact solution and 1/(2L)."""
    problem = cm.flat_logreg(device=device, dtype=dtype)
    xstar = cm.solve_reference(problem, lam1=LAM1)
    L = cm.estimate_L(problem)
    return cells(num_steps, 1.0 / (2 * L), 1.0 / (6 * L)), xstar


def run(num_steps: int = 800, verbose: bool = False, seeds: int = 1, *,
        device=None, dtype: torch.dtype = cm.DTYPE):
    grid, xstar = setup(num_steps, device=device, dtype=dtype)
    rows = cm.run_cells(grid, xstar, num_steps, seeds=seeds,
                        verbose=verbose, device=device, dtype=dtype)
    return [r.row() for r in rows]


def validate(rows):
    by = {r["name"]: r for r in rows}
    checks = []
    r0 = by["Prox-LEAD (2bit)"]
    checks.append(("Prox-LEAD(2bit) linear w/ prox (tail decay <0.5, <1e-4)",
                   _tail_ratio(r0) < 0.5 and r0["final_subopt"] < 1e-4,
                   (r0["final_subopt"], _tail_ratio(r0))))
    ratio = (by["Prox-LEAD (2bit)"]["final_subopt"]
             / max(by["Prox-LEAD (32bit)"]["final_subopt"], 1e-300))
    checks.append(("compression almost free (ratio < 1e3)", ratio < 1e3,
                   ratio))
    checks.append(("NIDS (uncompressed) parity baseline also converging",
                   _tail_ratio(by["NIDS (32bit)"]) < 0.5
                   and by["NIDS (32bit)"]["final_subopt"] < 1e-4,
                   by["NIDS (32bit)"]["final_subopt"]))
    for v in ("LSVRG", "SAGA"):
        r = by[f"Prox-LEAD-{v} (2bit)"]
        checks.append((f"Prox-LEAD-{v}(2bit) linear to exact (tail <0.7)",
                       _tail_ratio(r) < 0.7,
                       (r["final_subopt"], _tail_ratio(r))))
    saving = (by["Prox-LEAD (32bit)"]["bits_per_iter"]
              / by["Prox-LEAD (2bit)"]["bits_per_iter"])
    checks.append(("2bit payload saves >10x bits/iter", saving > 10, saving))
    return checks
