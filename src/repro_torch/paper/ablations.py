"""Ablations beyond the paper's figures.

The port of ``benchmarks/ablations.py``: the same rows, claims and
thresholds.

1. bits sweep -- the paper claims Prox-LEAD "works with arbitrary
   compression precision": rate degrades gracefully as C grows (1..8
   bits), never diverges, and every precision converges linearly.
2. topology sweep -- Theorem 5's kappa_g dependence: measured contraction
   worsens monotonically with the network condition number
   (fully-connected < torus < ring < star ordering of kappa_g).
"""
from __future__ import annotations

import torch

from repro_torch import registry
from repro_torch.core import topology as topo_mod
from repro_torch.core.comm import DenseMixer
from repro_torch.paper import common as cm


def run(num_steps: int = 500, verbose: bool = False, *, device=None,
        dtype: torch.dtype = cm.DTYPE):
    problem = cm.flat_logreg(device=device, dtype=dtype)
    xstar = cm.solve_reference(problem, lam1=0.0, iters=20000)
    L = cm.estimate_L(problem)
    eta = 1.0 / (2 * L)
    X0 = torch.zeros((cm.N_NODES, cm.DIM), dtype=dtype,
                     device=problem.data["A"].device)
    full = registry.make("oracle", "full", problem=problem)

    def lead(alpha, gamma, q, mixer):
        return registry.make("algorithm", "lead", eta=eta, alpha=alpha,
                             gamma=gamma, compressor=q, mixer=mixer,
                             oracle=full)

    rows = []
    # --- bits sweep on the ring: gamma must shrink ~1/sqrt(C) (Theorem 5);
    # at 1 bit the defaults (0.5, 0.5) diverge, (0.2, 0.1) converges
    mixer = cm.make_mixer()
    for bits, alpha, gamma in ((1, 0.2, 0.1), (2, 0.5, 0.5), (4, 0.5, 0.5),
                               (8, 0.5, 0.5)):
        q = registry.make("compressor", "qinf", bits=bits, block=256)
        r = cm.run_alg(f"bits={bits}", lead(alpha, gamma, q, mixer), X0,
                       xstar, num_steps, compressor=q, verbose=verbose)
        rows.append({**r.row(), "kind": "bits"})

    # --- topology sweep at 2 bits -----------------------------------------
    for name, kw in (("fully_connected", {}), ("torus2d", {"rows": 2}),
                     ("ring", {}), ("star", {})):
        topo = topo_mod.make_topology(name, cm.N_NODES, **kw)
        r = cm.run_alg(f"topo={name}",
                       lead(0.5, 0.4, cm.q2(), DenseMixer(topo.W)), X0,
                       xstar, num_steps, compressor=cm.q2(), verbose=verbose)
        rows.append({**r.row(), "kind": "topo",
                     "kappa_g": round(topo.kappa_g, 2)})
    return rows


def validate(rows):
    checks = []
    bits_rows = {r["name"]: r for r in rows if r["kind"] == "bits"}
    # every precision converges (arbitrary compression precision)
    for nm, r in bits_rows.items():
        s = r["subopt"]
        tail = s[-1] / max(s[max(0, len(s) - 5)], 1e-300)
        checks.append((f"{nm}: linear convergence", tail < 0.5,
                       (r["final_subopt"], round(tail, 3))))
    # more bits -> no worse final subopt (monotone up to noise)
    finals = [bits_rows[f"bits={b}"]["final_subopt"] for b in (1, 2, 4, 8)]
    checks.append(("more bits never hurts (1 vs 8: ratio >= 0.3)",
                   finals[0] >= 0.3 * finals[-1], finals))
    topo_rows = [r for r in rows if r["kind"] == "topo"]
    topo_rows.sort(key=lambda r: r["kappa_g"])
    fins = [r["final_subopt"] for r in topo_rows]
    checks.append(("better-connected topology converges faster "
                   "(kappa_g-sorted subopts non-decreasing x10 slack)",
                   all(fins[i] <= 10 * fins[i + 1] + 1e-12
                       for i in range(len(fins) - 1)),
                   [(r["name"], r["kappa_g"], f"{r['final_subopt']:.1e}")
                    for r in topo_rows]))
    return checks
