"""Shared machinery of the paper's §5 logistic-regression comparisons.

The port of ``benchmarks/common.py``.  Paper setting: 8 machines on a ring
(mixing weight 1/3), MNIST-like non-iid (label-sorted) data, m = 15
mini-batches a node, lambda2 = 0.005 (+ lambda1 = 0.005 in the non-smooth
case), 2-bit blockwise (256) inf-norm quantization, alpha = 0.5 and
gamma = 1.0 for (Prox-)LEAD; f64.

Every figure row is a :func:`paper_cell` ``ExperimentSpec``.
:func:`run_cells` batches the rows as the reference does: rows that differ
only along the sweep axes share one ``repro_torch.sweep`` runner
(``group_points``, ``runner_for_points``) in map mode, which runs each row
bit for bit as ``api.build(spec).run()`` would; ``seeds > 1`` runs each
row once a seed and averages the suboptimality curves.  A run lands on the
card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import api
from repro_torch import sweep as sweep_mod
from repro_torch.core import topology as topo_mod
from repro_torch.core.comm import DenseMixer
from repro_torch.core.compression import Identity, make_compressor
from repro_torch.core.draws import Draws, GeneratorDraws

N_NODES = 8
P_FEAT, N_CLASSES = 784, 10
DIM = P_FEAT * N_CLASSES
LAM2 = 0.005
#: the harness runs in f64, as the reference's does (x64)
DTYPE = torch.float64

#: the paper's compressor (eq. 21): 2-bit, block 256
Q2_SPEC = api.CompressorSpec("qinf", {"bits": 2, "block": 256})
ID_SPEC = api.CompressorSpec("identity")


def flat_logreg(*, device=None, dtype: torch.dtype = DTYPE, **kw):
    """The paper's §5 problem over flattened (p*C,) parameters: the
    registered ``problem='logreg'`` every spec below names, on ``device``
    (default: the card)."""
    problem, _X0 = api.OracleSpec(
        name="full", problem="logreg", problem_params=kw).build_problem(
            N_NODES, api.resolve_device(device), dtype)
    return problem


def solve_reference(problem, lam1: float = 0.0, iters: int = 40000,
                    eta: float = 1.0) -> np.ndarray:
    """X* by a long centralized proximal gradient descent on the problem's
    device, in its dtype; returned as a numpy (DIM,) array."""
    A = problem.data["A"]
    x = torch.zeros((DIM,), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        z = x - eta * problem.full_grad(x.expand(problem.n, DIM)).mean(0)
        x = torch.sign(z) * torch.clamp_min(z.abs() - eta * lam1, 0.0)
    return x.cpu().numpy()


@dataclasses.dataclass
class RunResult:
    name: str
    subopt: List[float]        # ||X - X*||_F^2 at the logged iterations
    iters: int
    bits_per_iter: float       # per node per iteration (idealized accounting)
    grad_evals_per_iter: float
    wall_s: float              # init + iters steps, fenced, seeds summed
    seeds: int = 1

    def row(self):
        return {"name": self.name, "iters": self.iters,
                "final_subopt": self.subopt[-1],
                "bits_per_iter": self.bits_per_iter,
                "grad_evals_per_iter": self.grad_evals_per_iter,
                "wall_s": round(self.wall_s, 1),
                "ms_per_step": self.wall_s / (self.iters * self.seeds) * 1e3,
                "subopt": self.subopt}


def _bits(compressor, oracle_name: str = "full") -> float:
    if isinstance(compressor, Identity) or compressor is None:
        return DIM * 32.0
    return float(compressor.payload_bits((DIM,)))


_GEVALS = {"full": 15.0, "sgd": 1.0, "lsvrg": 2.0 + 15.0 / 15.0, "saga": 1.0}


def paper_cell(algo: str, *, eta: float, steps: int, alpha: float = 0.5,
               gamma: float = 1.0,
               compressor: api.CompressorSpec = ID_SPEC,
               oracle: str = "full", lam1: float = 0.0,
               params: Optional[dict] = None, seed: int = 0,
               name: str = "cell") -> api.ExperimentSpec:
    """One figure row as an ExperimentSpec in the paper's §5 setting
    (8-node ring, ``problem='logreg'``, dense engine)."""
    return api.ExperimentSpec(
        name=name, n_nodes=N_NODES, steps=steps, seed=seed,
        algorithm=api.AlgorithmSpec(
            algo, eta=api.constant(eta), alpha=api.constant(alpha),
            gamma=api.constant(gamma), params=dict(params or {})),
        compressor=compressor,
        topology=api.TopologySpec(graph="ring"),
        prox=(api.ProxSpec("l1", {"lam": lam1}) if lam1
              else api.ProxSpec("none")),
        oracle=api.OracleSpec(name=oracle, problem="logreg"),
        execution=api.ExecutionSpec(engine="dense"))


def _log_indices(num_steps: int, log_every: int) -> List[int]:
    """The logged iterations: every ``log_every``-th step plus the last."""
    idx = list(range(0, num_steps, log_every))
    if not idx or idx[-1] != num_steps - 1:
        idx.append(num_steps - 1)
    return idx


def _subopt_run(runner, xstar, num_steps: int, log_every: int,
                draws: Optional[Draws]) -> Tuple[List[float], float]:
    """Drive ``runner`` and log ||X - X*||^2 at :func:`_log_indices`
    -> (curve, fenced seconds of the run)."""
    X0 = runner.X0
    Xs = torch.tensor(np.asarray(xstar), dtype=X0.dtype,
                      device=X0.device).expand_as(X0)

    def subopt(st, t=None):
        return float(((st.X - Xs) ** 2).sum())

    state, curve = runner.run(num_steps=num_steps, draws=draws,
                              callback=subopt, log_every=log_every)
    if (num_steps - 1) % log_every != 0:
        curve.append(subopt(state))
    return curve, runner.last_report.total_s


def run_cell(label: str, spec: api.ExperimentSpec, xstar, num_steps: int,
             *, log_every: int = 25, device=None,
             dtype: torch.dtype = DTYPE,
             draws: Optional[Draws] = None) -> Tuple[List[float], float]:
    """One row at one seed through ``api.build(spec)`` -> (suboptimality at
    :func:`_log_indices`, seconds).  ``draws`` default: a generator seeded
    by ``spec.seed`` on the run's device."""
    spec = dataclasses.replace(spec, steps=num_steps,
                               name=label.replace(" ", "_"))
    runner = api.build(spec, device=device, dtype=dtype)
    return _subopt_run(runner, xstar, num_steps, log_every, draws)


def run_cells(cells: Sequence[Tuple[str, api.ExperimentSpec]], xstar,
              num_steps: int, *, log_every: int = 25, seeds: int = 1,
              verbose: bool = False, device=None,
              dtype: torch.dtype = DTYPE) -> List[RunResult]:
    """Run figure cells through the sweep engine, map mode: cells that
    share one structure (differing only along the sweep axes) share one
    runner, and each runs bit for bit as on its own; ``seeds > 1`` runs
    every cell at seeds ``seed .. seed + seeds - 1`` and averages its
    curve."""
    flat: List[api.ExperimentSpec] = []
    owner: List[int] = []
    for ci, (label, spec) in enumerate(cells):
        spec = dataclasses.replace(spec, steps=num_steps,
                                   name=label.replace(" ", "_"))
        for s in range(seeds):
            flat.append(dataclasses.replace(spec, seed=spec.seed + s))
            owner.append(ci)
    idx = _log_indices(num_steps, log_every)
    curve: List[Optional[List[float]]] = [None] * len(flat)
    wall = [0.0] * len(flat)
    groups = sweep_mod.group_points(flat)
    for g in groups:
        runner = sweep_mod.runner_for_points(
            [flat[i] for i in g], device=api.resolve_device(device),
            dtype=dtype)
        X0 = runner.X0
        Xs = torch.tensor(np.asarray(xstar), dtype=X0.dtype,
                          device=X0.device).expand_as(X0)
        _final, res = runner.run(
            metric_fn=lambda st: ((st.X - Xs) ** 2).sum(),
            metric_every=log_every)
        assert res.metrics["metric"].shape[1] == len(idx)
        for j, i in enumerate(g):
            curve[i] = [float(v) for v in res.metrics["metric"][j]]
            wall[i] = res.point_s[j]
    results = []
    for ci, (label, spec) in enumerate(cells):
        mine = [i for i in range(len(flat)) if owner[i] == ci]
        r = RunResult(label, [float(x) for x in np.mean(
                          [curve[i] for i in mine], axis=0)],
                      num_steps, _bits(spec.compressor.build(),
                                       spec.oracle.name),
                      _GEVALS.get(spec.oracle.name, 1.0),
                      sum(wall[i] for i in mine), seeds)
        results.append(r)
        if verbose:
            print(f"  {label:28s} final subopt {r.subopt[-1]:.3e}  "
                  f"({r.wall_s:.1f}s)", flush=True)
    if verbose:
        print(f"  [{len(groups)} sweep groups for {len(flat)} grid points]",
              flush=True)
    return results


def run_alg(name: str, alg, X0, xstar, num_steps: int, log_every: int = 25,
            seed: int = 0, compressor=None, oracle_name: str = "full",
            verbose: bool = False) -> RunResult:
    """Drive an already-built dense algorithm through the runner loop
    (``api.runner_for``) and record the :func:`run_cells` series."""
    runner = api.runner_for(alg, X0)
    sub, wall = _subopt_run(runner, xstar, num_steps, log_every,
                            GeneratorDraws(seed, X0.device))
    if verbose:
        print(f"  {name:28s} final subopt {sub[-1]:.3e}  ({wall:.1f}s)",
              flush=True)
    return RunResult(name, sub, num_steps, _bits(compressor, oracle_name),
                     _GEVALS.get(oracle_name, 1.0), wall)


def make_mixer() -> DenseMixer:
    return DenseMixer(topo_mod.make_topology("ring", N_NODES).W)


def q2():
    return make_compressor("qinf", bits=2, block=256)


def estimate_L(problem) -> float:
    A = problem.data["A"].cpu().numpy()
    sq = (A.reshape(-1, A.shape[-1]) ** 2).sum(1)
    return 0.5 * float(sq.max()) + 2 * LAM2  # softmax hessian bound + reg
