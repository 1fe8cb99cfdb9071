"""Communication topologies and mixing matrices (paper Assumption 1).

The port's own copy of the numpy half of ``repro.core.topology``: a mixing
matrix W is symmetric, W1 = 1, w_ij = 0 for non-edges, and
-1 < lambda_n <= ... <= lambda_2 < lambda_1 = 1.  kappa_g is the network
condition number lambda_max(I-W) / lambda_min+(I-W).  ``compile_plan``
turns a static W into the hops of the neighbor-gossip backend.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch import registry


@dataclasses.dataclass(frozen=True)
class Topology:
    name: str
    W: np.ndarray                 # (n, n) mixing matrix
    neighbors: tuple              # tuple of tuples: j with w_ij != 0, j != i

    @property
    def n(self) -> int:
        return self.W.shape[0]

    def eigvals_I_minus_W(self) -> np.ndarray:
        return np.sort(np.linalg.eigvalsh(np.eye(self.n) - self.W))

    @property
    def lambda_max(self) -> float:
        """lambda_max(I - W)."""
        return float(self.eigvals_I_minus_W()[-1])

    @property
    def lambda_min_pos(self) -> float:
        """Smallest nonzero eigenvalue of I - W."""
        ev = self.eigvals_I_minus_W()
        pos = ev[ev > 1e-10]
        if pos.size == 0:
            raise ValueError("graph appears disconnected or W == I")
        return float(pos[0])

    @property
    def kappa_g(self) -> float:
        return self.lambda_max / self.lambda_min_pos

    def validate(self) -> None:
        """Check Assumption 1; raises on violation."""
        W = self.W
        n = self.n
        if not np.allclose(W, W.T, atol=1e-12):
            raise ValueError("W not symmetric")
        if not np.allclose(W @ np.ones(n), np.ones(n), atol=1e-10):
            raise ValueError("W 1 != 1")
        ev = np.sort(np.linalg.eigvalsh(W))
        if ev[0] <= -1 + 1e-12:
            raise ValueError(f"lambda_n(W) = {ev[0]} <= -1")
        if n > 1 and ev[-2] >= 1 - 1e-10:
            raise ValueError("lambda_2(W) >= 1: graph disconnected")


def _neighbors_from_W(W: np.ndarray) -> tuple:
    n = W.shape[0]
    return tuple(tuple(int(j) for j in range(n)
                       if j != i and abs(W[i, j]) > 1e-12)
                 for i in range(n))


def _metropolis(A: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings weights on the 0/1 adjacency ``A``."""
    n = A.shape[0]
    deg = A.sum(1)
    W = np.zeros_like(A)
    for i in range(n):
        for j in range(n):
            if A[i, j]:
                W[i, j] = 1.0 / (1 + max(deg[i], deg[j]))
        W[i, i] = 1.0 - W[i].sum()
    return W


def ring(n: int, self_weight: Optional[float] = None) -> Topology:
    """Ring with uniform weights.  Paper setup: n=8, weights 1/3."""
    if n == 1:
        return Topology("ring", np.ones((1, 1)), ((),))
    if n == 2:
        W = np.array([[0.5, 0.5], [0.5, 0.5]])
        return Topology("ring", W, _neighbors_from_W(W))
    w = (1.0 - self_weight) / 2.0 if self_weight is not None else 1.0 / 3.0
    sw = self_weight if self_weight is not None else 1.0 / 3.0
    W = np.zeros((n, n))
    for i in range(n):
        W[i, i] = sw
        W[i, (i + 1) % n] = w
        W[i, (i - 1) % n] = w
    return Topology("ring", W, _neighbors_from_W(W))


def fully_connected(n: int) -> Topology:
    W = np.full((n, n), 1.0 / n)
    return Topology("fully_connected", W, _neighbors_from_W(W))


def star(n: int) -> Topology:
    """Metropolis-Hastings weights on a star graph."""
    W = np.zeros((n, n))
    for leaf in range(1, n):
        w = 1.0 / n
        W[0, leaf] = W[leaf, 0] = w
        W[leaf, leaf] = 1.0 - w
    W[0, 0] = 1.0 - (n - 1) / n
    return Topology("star", W, _neighbors_from_W(W))


def torus2d(rows: int, cols: int) -> Topology:
    """2-D torus, Metropolis weights (degree 4 for rows,cols > 2)."""
    n = rows * cols
    A = np.zeros((n, n))

    def idx(r, c):
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            i = idx(r, c)
            for j in {idx(r + 1, c), idx(r - 1, c), idx(r, c + 1),
                      idx(r, c - 1)}:
                if j != i:
                    A[i, j] = 1.0
    W = _metropolis(A)
    return Topology("torus2d", W, _neighbors_from_W(W))


def exponential(n: int) -> Topology:
    """Exponential graph: node i connects to i +/- 2^j mod n."""
    if n <= 2:
        return ring(n)
    A = np.zeros((n, n))
    s = 1
    while s < n:                  # all offsets 2^j < n (i+2^j covers i-2^j)
        for i in range(n):
            j = (i + s) % n
            A[i, j] = A[j, i] = 1.0
        s *= 2
    W = _metropolis(A)
    return Topology("exponential", W, _neighbors_from_W(W))


def expander(n: int, degree: int = 4, seed: int = 0) -> Topology:
    """Circulant expander (shifts 1, 2, 4, ...) with Metropolis weights.
    ``seed`` is accepted for the reference's signature; the graph is
    deterministic."""
    A = np.zeros((n, n))
    shifts = [1]
    s = 2
    while len(shifts) < max(2, degree // 2) and s < n:
        shifts.append(s)
        s *= 2
    for i in range(n):
        for sh in shifts:
            j = (i + sh) % n
            A[i, j] = A[j, i] = 1.0
    W = _metropolis(A)
    return Topology("expander", W, _neighbors_from_W(W))


# ---------------------------------------------------------------------------
# Exchange plans: compile a (schedule of) mixing matrices into exchange hops
# for the neighbor-gossip backend (repro_torch.optim backend="neighbor").
#
# A Hop is one exchange round through the ``pp(x, pairs)`` seam (the
# semantics of a ppermute): a set of directed (src, dst) pairs in which
# every node appears at most once as a source and at most once as a
# destination, plus the weight each receiver
# applies to the payload it got — tabulated per schedule round, so one
# static set of hops serves a whole time-varying cycle (weights of an edge
# that is inactive at round t are 0; the payload still moves, which is what
# a real network would do absent per-round reconfiguration, and is what the
# bits-on-wire accounting reports).
#
# Compilation: circulant supports (ring, exponential graph, any
# shift-structured W) produce exactly one hop per nonzero offset; general
# sparse supports (2-D torus in row-major order, random matchings, stars)
# are decomposed by greedy bipartite edge coloring (<= 2*deg - 1 hops,
# typically deg or deg + 1).
# ---------------------------------------------------------------------------

_EDGE_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Hop:
    """One exchange round (one ``pp`` call per wire buffer) of a plan.

    ``pairs``    — directed (src, dst) index pairs, each node at most once
                   per side.
    ``weights``  — (T, n) array: the weight receiver ``dst`` applies at
                   schedule round ``t`` (0 when the edge is inactive that
                   round, or when ``dst`` receives nothing in this hop).
    ``shift``    — circulant offset when the hop is one (metadata).
    """
    pairs: tuple
    weights: "np.ndarray"
    shift: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Compiled gossip plan: W_k X == self-term + sum over hops of
    weighted exchanged payloads, for every round k of the cycle."""
    name: str
    n: int
    hops: tuple                     # tuple of Hop
    T_cycle: int = 1                # explicit: hops may be empty (W_k == I)

    @property
    def T(self) -> int:
        """Schedule cycle length (1 for a static topology)."""
        return self.T_cycle

    @property
    def pairs_per_round(self) -> int:
        """Directed payloads every round physically moves (union support)."""
        return sum(len(h.pairs) for h in self.hops)

    def active_pairs(self) -> np.ndarray:
        """(T,) directed payloads with nonzero mixing weight per round."""
        out = np.zeros(self.T, np.int64)
        for h in self.hops:
            w = np.asarray(h.weights)
            for (_, dst) in h.pairs:
                out += (np.abs(w[:, dst]) > _EDGE_EPS).astype(np.int64)
        return out

    def self_weights(self, dtype=np.float32) -> np.ndarray:
        """(T, n) diagonal weights, computed as 1 - sum(hop weights) in
        ``dtype`` so every row of the reconstructed W_k sums to 1 exactly
        in that dtype (same drift-avoidance as ``comm._exact_stochastic``).
        """
        total = np.zeros((self.T, self.n), np.dtype(dtype))
        for h in self.hops:
            total += np.asarray(h.weights, total.dtype)
        return (np.asarray(1.0, total.dtype) - total).astype(total.dtype)

    def as_matrices(self) -> np.ndarray:
        """Reconstruct the (T, n, n) mixing-matrix stack the plan encodes."""
        W = np.zeros((self.T, self.n, self.n))
        for h in self.hops:
            for (src, dst) in h.pairs:
                W[:, dst, src] += h.weights[:, dst]
        for t in range(self.T):
            np.fill_diagonal(W[t], 1.0 - W[t].sum(axis=1))
        return W

    def validate(self, W_stack: np.ndarray) -> None:
        R = self.as_matrices()
        Wk = np.asarray(W_stack)
        if Wk.ndim == 2:
            Wk = Wk[None]
        if R.shape != Wk.shape or not np.allclose(R, Wk, atol=1e-10):
            raise ValueError(
                f"plan {self.name!r} does not reconstruct its W stack "
                f"(max err {np.abs(R - Wk).max() if R.shape == Wk.shape else 'shape mismatch'})")


def _circulant_offsets(support: np.ndarray) -> Optional[list]:
    """Nonzero offsets s (node i linked to (i+s) % n) if the 0/1 support
    matrix is circulant, else None."""
    n = support.shape[0]
    offsets = [s for s in range(1, n) if support[0, s % n]]
    for s in range(1, n):
        want = support[0, s]
        for i in range(n):
            if support[i, (i + s) % n] != want:
                return None
    return offsets


def compile_plan(W_stack, name: str = "plan") -> ExchangePlan:
    """Compile a (n, n) mixing matrix or a (T, n, n) schedule stack into an
    ExchangePlan over the UNION support.  Validated on exit."""
    Wk = np.asarray(W_stack, np.float64)
    if Wk.ndim == 2:
        Wk = Wk[None]
    T, n, _ = Wk.shape
    support = (np.abs(Wk) > _EDGE_EPS).any(axis=0)
    np.fill_diagonal(support, False)
    if not np.array_equal(support, support.T):
        raise ValueError("mixing support must be symmetric (Assumption 1)")

    hops = []
    offsets = _circulant_offsets(support)
    if offsets is not None:
        for s in offsets:
            pairs = tuple((i, (i + s) % n) for i in range(n))
            w = np.stack([[Wk[t, d, (d - s) % n] for d in range(n)]
                          for t in range(T)])
            hops.append(Hop(pairs, w, shift=s))
    else:
        # greedy bipartite edge coloring of the directed union edges
        colors = []                      # [(srcs_used, dsts_used, pairs)]
        for dst in range(n):
            for src in range(n):
                if not support[dst, src]:
                    continue
                for srcs, dsts, pairs in colors:
                    if src not in srcs and dst not in dsts:
                        srcs.add(src), dsts.add(dst), pairs.append((src, dst))
                        break
                else:
                    colors.append(({src}, {dst}, [(src, dst)]))
        for _, _, pairs in colors:
            w = np.zeros((T, n))
            for (src, dst) in pairs:
                w[:, dst] = Wk[:, dst, src]
            hops.append(Hop(tuple(pairs), w))

    plan = ExchangePlan(name, n, tuple(hops), T_cycle=T)
    plan.validate(Wk)
    return plan


registry.register_topology("ring")(ring)
registry.register_topology("fully_connected")(fully_connected)
registry.register_topology("star")(star)
registry.register_topology("expander")(expander)
registry.register_topology("exponential")(exponential)


@registry.register_topology("torus2d")
def _torus2d_by_n(n: int, rows: Optional[int] = None) -> Topology:
    """torus2d keyed by node count (rows defaults to the square-ish split)."""
    rows = int(np.sqrt(n)) if rows is None else rows
    if n % rows:
        raise ValueError(f"torus2d: rows={rows} does not divide n={n}")
    return torus2d(rows, n // rows)


def make_topology(name: str, n: int, **kw) -> Topology:
    """Build a registered topology by name (strict)."""
    return registry.make("topology", name, n=n, **kw)
