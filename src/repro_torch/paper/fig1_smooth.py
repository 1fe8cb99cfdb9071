"""Fig. 1: SMOOTH logistic regression (lambda1 = 0).

The port of ``benchmarks/fig1_smooth.py``: the same rows, claims and
thresholds.

(a/b) full gradient: DGD & Choco show convergence bias; NIDS / LessBit /
LEAD(32bit) / LEAD(2bit) converge linearly; LEAD(2bit) matches LEAD(32bit)
per iteration at ~14x fewer bits.
(c/d) stochastic: LEAD-{SGD,LSVRG,SAGA} 2bit match their 32bit twins; the
VR variants converge linearly to the exact solution.
"""
from __future__ import annotations

import torch

from repro_torch.paper import common as cm


def cells(num_steps: int, eta: float, eta_s: float):
    """The Fig.-1 grid as (label, spec) rows.  ``eta`` = 1/(2L) for full
    gradients, ``eta_s`` = 1/(6L) for the stochastic oracles (paper §5)."""
    out = [
        ("DGD", cm.paper_cell("dgd", eta=eta, steps=num_steps)),
        ("NIDS (32bit)",
         cm.paper_cell("nids_independent", eta=eta, steps=num_steps)),
        ("Choco (2bit)",
         cm.paper_cell("choco", eta=eta, steps=num_steps,
                       compressor=cm.Q2_SPEC, params={"gamma_c": 0.2})),
        ("LessBit (2bit)",
         cm.paper_cell("lessbit", eta=eta, steps=num_steps, alpha=0.5,
                       compressor=cm.Q2_SPEC, params={"theta": 0.2})),
        ("LEAD (32bit)",
         cm.paper_cell("lead", eta=eta, steps=num_steps, gamma=1.0)),
        ("LEAD (2bit)",
         cm.paper_cell("lead", eta=eta, steps=num_steps, gamma=0.5,
                       compressor=cm.Q2_SPEC)),
    ]
    for orc in ("sgd", "lsvrg", "saga"):
        tag = orc.upper()
        out.append((f"LEAD-{tag} (32bit)",
                    cm.paper_cell("lead", eta=eta_s, steps=num_steps,
                                  gamma=1.0, oracle=orc)))
        out.append((f"LEAD-{tag} (2bit)",
                    cm.paper_cell("lead", eta=eta_s, steps=num_steps,
                                  gamma=0.5, compressor=cm.Q2_SPEC,
                                  oracle=orc)))
    out.append(("LessBit-LSVRG (2bit)",
                cm.paper_cell("lessbit", eta=eta_s, steps=num_steps,
                              alpha=0.5, compressor=cm.Q2_SPEC,
                              oracle="lsvrg", params={"theta": 0.2})))
    return out


def setup(num_steps: int, *, device=None, dtype: torch.dtype = cm.DTYPE):
    """-> (the grid, X*): the problem, its exact solution and 1/(2L)."""
    problem = cm.flat_logreg(device=device, dtype=dtype)
    xstar = cm.solve_reference(problem, lam1=0.0)
    L = cm.estimate_L(problem)
    return cells(num_steps, 1.0 / (2 * L), 1.0 / (6 * L)), xstar


def run(num_steps: int = 800, verbose: bool = False, seeds: int = 1, *,
        device=None, dtype: torch.dtype = cm.DTYPE):
    grid, xstar = setup(num_steps, device=device, dtype=dtype)
    rows = cm.run_cells(grid, xstar, num_steps, seeds=seeds,
                        verbose=verbose, device=device, dtype=dtype)
    return [r.row() for r in rows]


def _tail_ratio(r):
    """Geometric-decay detector: subopt[-1] / subopt[-5] (log-spaced tail).
    Linear convergence -> well below 1; a plateau (bias / SGD noise) -> ~1."""
    s = r["subopt"]
    return s[-1] / max(s[max(0, len(s) - 5)], 1e-300)


def validate(rows):
    """Check the paper's Fig-1 claims.  Convergence claims are slope-based
    (geometric tail decay), matching how the paper's figures read: the
    absolute level at a fixed iteration budget depends on kappa_f (the paper
    runs ~4.5k iterations; the default harness runs 800)."""
    by = {r["name"]: r for r in rows}
    checks = []
    # 1) LEAD 2bit still converging geometrically at the end (no floor)
    checks.append(("LEAD(2bit) linear convergence (tail decay <0.3, <1e-6)",
                   _tail_ratio(by["LEAD (2bit)"]) < 0.3
                   and by["LEAD (2bit)"]["final_subopt"] < 1e-6,
                   (by["LEAD (2bit)"]["final_subopt"],
                    _tail_ratio(by["LEAD (2bit)"]))))
    # 2) compression for free: 2bit tracks 32bit
    ratio = (by["LEAD (2bit)"]["final_subopt"]
             / max(by["LEAD (32bit)"]["final_subopt"], 1e-300))
    checks.append(("LEAD 2bit matches 32bit (subopt ratio < 1e3)",
                   ratio < 1e3, ratio))
    # 3) DGD has convergence bias: plateaus at a high level
    checks.append(("DGD stalls at a biased point (plateau, >1e-7)",
                   by["DGD"]["final_subopt"] > 1e-7
                   and _tail_ratio(by["DGD"]) > 0.3,
                   (by["DGD"]["final_subopt"], _tail_ratio(by["DGD"]))))
    # 4) VR variants keep decaying geometrically (exact limit) w/ compression
    for v in ("LSVRG", "SAGA"):
        r = by[f"LEAD-{v} (2bit)"]
        checks.append((f"LEAD-{v}(2bit) linear to exact (tail decay <0.7)",
                       _tail_ratio(r) < 0.7, (r["final_subopt"],
                                              _tail_ratio(r))))
    # 5) SGD converges to a noise neighborhood (plateau ABOVE the VR level)
    checks.append(("LEAD-SGD(2bit) plateaus at noise neighborhood",
                   by["LEAD-SGD (2bit)"]["final_subopt"]
                   > 3 * by["LEAD-LSVRG (2bit)"]["final_subopt"]
                   and by["LEAD-SGD (2bit)"]["final_subopt"] < 5.0,
                   by["LEAD-SGD (2bit)"]["final_subopt"]))
    # 6) bits saving ~>10x
    saving = by["LEAD (32bit)"]["bits_per_iter"] / by["LEAD (2bit)"]["bits_per_iter"]
    checks.append(("2bit payload saves >10x bits/iter", saving > 10, saving))
    # 7) LEAD(2bit) beats LessBit(2bit) per iteration (extra gradient step)
    checks.append(("LEAD(2bit) <= LessBit(2bit) subopt",
                   by["LEAD (2bit)"]["final_subopt"]
                   <= by["LessBit (2bit)"]["final_subopt"] * 10,
                   (by["LEAD (2bit)"]["final_subopt"],
                    by["LessBit (2bit)"]["final_subopt"])))
    return checks
