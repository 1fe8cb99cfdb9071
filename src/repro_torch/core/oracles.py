"""Stochastic gradient oracles (paper Table 1): full, SGD, L-SVRG, SAGA.

Finite-sum setting: node i holds m batches; f_i = (1/m) sum_j f_ij.  Where
the reference vmaps a per-node gradient, the port writes the node axis
out: a problem's ``grad_batches(X, batch)`` takes stacked iterates
(n, ...) and batches with leading axes (n, k, ...) and returns the k
per-batch gradients of every node, (n, k, ...).  Uniform sampling
p_ij = 1/m throughout, so

  L-SVRG: g_i = grad f_il(x_i) - grad f_il(xt_i) + grad f_i(xt_i),
          xt <- x with probability p (full gradient recomputed then)
  SAGA  : g_i = grad f_il(x_i) - T_il + mean_j T_ij,  T_il <- grad f_il(x_i)

Each ``sample`` takes its indices (and L-SVRG its coin) from the draw
source: ``randint(n, m)``, then ``bernoulli(p)`` for L-SVRG.

A stacked grid (``repro_torch.sweep``, ``batch='vmap'``) puts P points on
a leading axis of every iterate, (P, n, ...), and of the oracle state
(SAGA's table (P, n, m, ...)); :meth:`Oracle.over_points` gives the
oracle that samples them, its draw source handing out (P, n) indices
(``core.draws.StackedDraws``; L-SVRG's coin is then one per point).  The
problem's data stays shared: a point's sampled gradients are those of its
nodes, folded into one call of ``grad_batches`` with P x n node rows; a
full gradient is one call a point over the data (``full_grad``).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import registry
from repro_torch.core.draws import Draws
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class FiniteSumProblem:
    """n nodes x m local batches.

    grad_batches: (X (n, ...), batch with (n, k, ...) leaves) -> (n, k, ...)
    loss_batches: same arguments -> (n, k) losses (optional)
    data: tree of (n, m, ...) tensors
    """
    grad_batches: Callable
    data: Any
    n: int
    m: int
    loss_batches: Optional[Callable] = None

    def batches_at(self, ls: torch.Tensor):
        """Batch ``ls[..., i]`` of every node i, as (..., n, 1, ...)
        leaves (``ls`` (n,), or (P, n) for a stacked grid)."""
        idx = torch.arange(self.n, device=ls.device)
        return tree_map(lambda d: d[idx, ls].unsqueeze(ls.dim()), self.data)

    def _folded(self, X, batch, points: int):
        """``grad_batches`` of P stacked points as one call over P x n node
        rows: X (P, n, ...), batch (P x n, k, ...) -> (P, n, k, ...)."""
        Xf = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), X)
        return tree_map(lambda g: g.reshape((points, self.n)
                                            + tuple(g.shape[1:])),
                        self.grad_batches(Xf, batch))

    def sampled_grad(self, X, ls: torch.Tensor):
        """grad f_{i, ls[i]}(x_i) for every node: (n, ...); for ls (P, n)
        and X (P, n, ...) every point's, (P, n, ...)."""
        batch = self.batches_at(ls)
        if ls.dim() == 1:
            return tree_map(lambda g: g[:, 0], self.grad_batches(X, batch))
        flat = tree_map(lambda b: b.reshape((-1,) + tuple(b.shape[2:])),
                        batch)
        return tree_map(lambda g: g[:, :, 0],
                        self._folded(X, flat, ls.shape[0]))

    def full_grad(self, X, points: int = 0):
        """Deterministic gradient of every node: (n, ...); of every node of
        ``points`` stacked points when ``points`` > 0, (P, n, ...): one
        call a point over the shared data, each the serial call on the
        point's X (folding the points into one call would need the data
        P times over)."""
        if not points:
            return tree_map(lambda g: g.mean(1),
                            self.grad_batches(X, self.data))
        per_point = [self.full_grad(tree_map(lambda x: x[i], X))
                     for i in range(points)]
        return tree_map(lambda *gs: torch.stack(gs), *per_point)

    def full_loss(self, X) -> torch.Tensor:
        if self.loss_batches is None:
            raise ValueError("this problem has no loss_batches")
        return self.loss_batches(X, self.data).mean()


class OracleState(NamedTuple):
    kind: int              # 0 full/sgd, 1 L-SVRG, 2 SAGA (the reference's tags)
    ref: Any               # L-SVRG: xt (n, ...); SAGA: table (n, m, ...)
    ref_grad: Any          # L-SVRG: full grad at xt; SAGA: table mean (n, ...)


class Oracle:
    """Base: ``sample`` returns (G, new_state) with G stacked (n, ...)."""
    name = "full"
    #: stacked grid points this oracle samples (0: none; see the module
    #: docstring)
    points = 0

    def __init__(self, problem: FiniteSumProblem):
        self.problem = problem

    def over_points(self, points: int) -> "Oracle":
        """This oracle over ``points`` grid points stacked on a leading
        axis of the iterates and the oracle state."""
        other = copy.copy(self)
        other.points = int(points)
        return other

    def init(self, X0) -> OracleState:
        return OracleState(0, None, None)

    def sample(self, X, state: OracleState, draws: Draws):
        return self.problem.full_grad(X, self.points), state


@registry.register_oracle("full")
class FullGradient(Oracle):
    name = "full"


@registry.register_oracle("sgd")
class SGD(Oracle):
    """One uniformly sampled batch per node."""
    name = "sgd"

    def sample(self, X, state, draws):
        p = self.problem
        return p.sampled_grad(X, draws.randint(p.n, p.m)), state


@registry.register_oracle("lsvrg")
class LSVRG(Oracle):
    """Loopless SVRG (Kovalev et al. 2020), per paper Table 1."""
    name = "lsvrg"

    def __init__(self, problem, prob_update: Optional[float] = None):
        super().__init__(problem)
        self.p_update = (prob_update if prob_update is not None
                         else 1.0 / problem.m)

    def init(self, X0):
        return OracleState(1, X0, self.problem.full_grad(X0))

    def sample(self, X, state, draws):
        p = self.problem
        ls = draws.randint(p.n, p.m)
        omega = draws.bernoulli(self.p_update)
        g_new = p.sampled_grad(X, ls)
        g_old = p.sampled_grad(state.ref, ls)
        G = tree_map(lambda a, b, c: a - b + c, g_new, g_old, state.ref_grad)
        if self.points:
            # a stacked grid: omega is (P,), each point's refresh a select
            # (as the reference's vmapped lax.cond), so the full gradient
            # of every point is formed every step and nothing waits
            full = p.full_grad(X, self.points)

            def pick(new, old):
                hit = omega.reshape((-1,) + (1,) * (old.dim() - 1))
                return torch.where(hit, new, old)

            return G, OracleState(state.kind, tree_map(pick, X, state.ref),
                                  tree_map(pick, full, state.ref_grad))
        if bool(omega):    # a host sync on the card; L-SVRG is off the main path
            return G, OracleState(state.kind, X, p.full_grad(X))
        return G, state


@registry.register_oracle("saga")
class SAGA(Oracle):
    """SAGA with per-batch stored gradients (paper Table 1).

    ref      : gradient table (n, m, ...)
    ref_grad : running table mean (n, ...)
    """
    name = "saga"

    def init(self, X0):
        tab = self.problem.grad_batches(X0, self.problem.data)
        return OracleState(2, tab, tree_map(lambda t: t.mean(1), tab))

    def sample(self, X, state, draws):
        p = self.problem
        ls = draws.randint(p.n, p.m)
        idx = (torch.arange(p.n, device=ls.device), ls)
        if ls.dim() == 2:                  # a stacked grid: (P, n) indices
            idx = (torch.arange(ls.shape[0], device=ls.device)[:, None],
                   ) + idx
        g_new = p.sampled_grad(X, ls)
        g_old = tree_map(lambda t: t[idx], state.ref)
        G = tree_map(lambda a, o, mn: a - o + mn, g_new, g_old,
                     state.ref_grad)
        tab = tree_map(lambda t, gn: t.index_put(idx, gn), state.ref,
                       g_new)
        mean = tree_map(lambda mn, o, gn: mn + (gn - o) / p.m,
                        state.ref_grad, g_old, g_new)
        return G, OracleState(state.kind, tab, mean)


def make_oracle(name: str, problem: FiniteSumProblem, **kw) -> Oracle:
    """Build a registered oracle by name over ``problem``; strict kwargs."""
    return registry.make("oracle", name, problem=problem, **kw)
