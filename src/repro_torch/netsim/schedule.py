"""Time-varying mixing-matrix schedules (W_k per iteration).

The port of ``repro.netsim.schedule``.  A :class:`TopologySchedule` is a
finite cycle of mixing matrices, W_k = W_stack[k % T_cycle]; the stacks
are built in numpy by the reference's own code, so they equal the
reference's exactly.  Every W_k satisfies the paper's Assumption 1
(symmetric, doubly stochastic, lambda_n > -1); drops renormalize by moving
the dead edge's weight onto both endpoints' diagonal.

Schedules:

* ``static``          -- T=1, the DenseMixer path bit for bit.
* ``alternating``     -- cycle through a list of topologies (default
                        ring <-> exponential graph).
* ``random_matching`` -- each round activates a random (maximal) matching;
                        matched pairs average with weight 1/2.
* ``markov_drop``     -- each edge of a base topology is up/down via a
                        2-state Markov chain with stationary drop
                        probability ``drop`` and stickiness ``sticky``
                        (rate 0 -> exactly the static schedule).

``joint_spectral_gap`` is 1 - ||prod_k (W_k - J)||_2^{1/T} over a window,
the time-varying counterpart of 1 - |lambda_2(W)|.

:class:`ScheduledMixer` applies W_k in torch.  ``k`` is a host int, so
choosing W_k never waits for the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import registry
from repro_torch.core import topology as topo_mod
from repro_torch.core.comm import Mixer, _exact_stochastic, acc_dtype, mix_with


@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """A cycle of per-iteration mixing matrices, W_k = W_stack[k % T_cycle]."""
    name: str
    W_stack: np.ndarray          # (T_cycle, n, n)

    @property
    def n(self) -> int:
        return self.W_stack.shape[-1]

    @property
    def T_cycle(self) -> int:
        return self.W_stack.shape[0]

    def W_at(self, k: int) -> np.ndarray:
        return self.W_stack[k % self.T_cycle]

    # --- Assumption 1, per step -------------------------------------------
    def validate(self) -> None:
        """Every W_k must be symmetric, doubly stochastic, lambda_n > -1.

        Per-step connectivity is NOT required (a matching round is
        disconnected); joint connectivity over the cycle is what matters,
        checked via ``joint_spectral_gap() > 0``."""
        for t in range(self.T_cycle):
            W = self.W_stack[t]
            if not np.allclose(W, W.T, atol=1e-12):
                raise ValueError(f"W_{t} not symmetric")
            if not np.allclose(W @ np.ones(self.n), np.ones(self.n),
                               atol=1e-10):
                raise ValueError(f"W_{t} 1 != 1")
            ev = np.sort(np.linalg.eigvalsh(W))
            if ev[0] <= -1 + 1e-12:
                raise ValueError(f"lambda_n(W_{t}) = {ev[0]} <= -1")

    # --- spectrum over a window -------------------------------------------
    def joint_spectral_gap(self, window: Optional[int] = None) -> float:
        """1 - ||prod_{k<T} (W_k - J)||_2^{1/T},  J = 11^T/n.

        For doubly stochastic W_k the product telescopes to
        prod W_k - J, so this is the geometric-mean consensus contraction
        per step over the window (default: one full cycle).  Static W
        recovers 1 - |lambda_2(W)|.  A gap of 0 means the window does not
        jointly connect the network."""
        T = self.T_cycle if window is None else window
        J = np.full((self.n, self.n), 1.0 / self.n)
        P = np.eye(self.n) - J
        for k in range(T):
            P = (self.W_at(k) - J) @ P
        rho = float(np.linalg.norm(P, 2))
        return 1.0 - rho ** (1.0 / T)

    def mean_topology(self) -> topo_mod.Topology:
        """Cycle-averaged W_bar as a Topology (heuristic kappa_g carrier)."""
        Wbar = self.W_stack.mean(0)
        return topo_mod.Topology(f"{self.name}_mean", Wbar,
                                 topo_mod._neighbors_from_W(Wbar))


# ---------------------------------------------------------------------------
# builders (numpy, as the reference's)
# ---------------------------------------------------------------------------

def static_schedule(topo: topo_mod.Topology) -> TopologySchedule:
    return TopologySchedule("static", np.asarray(topo.W)[None].copy())


def alternating_schedule(topos: Sequence[topo_mod.Topology]
                         ) -> TopologySchedule:
    if not topos:
        raise ValueError("alternating schedule needs >= 1 topology")
    n = topos[0].n
    if any(t.n != n for t in topos):
        raise ValueError("all topologies must share n")
    stack = np.stack([np.asarray(t.W) for t in topos])
    name = "alternating(" + ",".join(t.name for t in topos) + ")"
    return TopologySchedule(name, stack)


def random_matching_schedule(n: int, rounds: int = 32,
                             seed: int = 0) -> TopologySchedule:
    """Each round: shuffle nodes, pair them up; matched pairs average with
    weight 1/2, the odd node out (n odd) keeps its value."""
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(rounds):
        perm = rng.permutation(n)
        W = np.eye(n)
        for a in range(0, n - 1, 2):
            i, j = int(perm[a]), int(perm[a + 1])
            W[i, i] = W[j, j] = 0.5
            W[i, j] = W[j, i] = 0.5
        mats.append(W)
    return TopologySchedule("random_matching", np.stack(mats))


def markov_drop_schedule(topo: topo_mod.Topology, drop: float = 0.1,
                         rounds: int = 64, seed: int = 0,
                         sticky: float = 0.0) -> TopologySchedule:
    """Each edge of ``topo`` is up/down via a 2-state Markov chain.

    Stationary P(down) = ``drop``; ``sticky`` in [0, 1) adds persistence
    (sticky=0 -> i.i.d. drops each round).  Dropped edges renormalize onto
    both endpoints' diagonal, so every W_k stays Assumption-1 compliant.
    drop=0 reproduces the static schedule exactly."""
    if not (0.0 <= drop < 1.0):
        raise ValueError(f"drop must be in [0, 1), got {drop}")
    if not (0.0 <= sticky < 1.0):
        raise ValueError(f"sticky must be in [0, 1), got {sticky}")
    rng = np.random.default_rng(seed)
    W0 = np.asarray(topo.W)
    n = topo.n
    edges = [(i, j) for i in range(n) for j in range(i + 1, n)
             if abs(W0[i, j]) > 1e-12]
    # P(down|down), P(down|up): stationary distribution is `drop` for any
    # sticky
    p_dd = sticky + (1.0 - sticky) * drop
    p_ud = (1.0 - sticky) * drop
    down = rng.random(len(edges)) < drop          # start at stationarity
    mats = []
    for _ in range(rounds):
        Wk = W0.copy()
        for e, (i, j) in enumerate(edges):
            if down[e]:
                w = Wk[i, j]
                Wk[i, j] = Wk[j, i] = 0.0
                Wk[i, i] += w
                Wk[j, j] += w
        mats.append(Wk)
        u = rng.random(len(edges))
        down = np.where(down, u < p_dd, u < p_ud)
    return TopologySchedule(f"markov_drop({drop:g},sticky={sticky:g})",
                            np.stack(mats))


@registry.register_schedule("static")
def _static_by_name(n: int, base: str = "ring") -> TopologySchedule:
    return static_schedule(topo_mod.make_topology(base, n))


@registry.register_schedule("alternating")
def _alternating_by_name(n: int, base: str = "ring",
                         with_: str = "exponential") -> TopologySchedule:
    topos = [topo_mod.make_topology(base, n)] + [
        topo_mod.make_topology(t, n) for t in with_.split("+")]
    return alternating_schedule(topos)


@registry.register_schedule("random_matching")
def _random_matching_by_name(n: int, rounds: int = 32,
                             seed: int = 0) -> TopologySchedule:
    return random_matching_schedule(n, rounds=rounds, seed=seed)


@registry.register_schedule("markov_drop")
def _markov_drop_by_name(n: int, base: str = "ring", rounds: int = 32,
                         seed: int = 0, drop: float = 0.1,
                         sticky: float = 0.0) -> TopologySchedule:
    return markov_drop_schedule(topo_mod.make_topology(base, n), drop=drop,
                                rounds=rounds, seed=seed, sticky=sticky)


def make_schedule(name: str, n: int, *, base: str = "ring", rounds: int = 32,
                  seed: int = 0, **kw) -> TopologySchedule:
    """Build a registered schedule by name; ``base`` names the underlying
    topology.  The shared context (base/rounds/seed) is offered to every
    factory and consumed by the ones that use it; explicit ``kw`` entries
    are strict."""
    ctx = registry.kwargs_subset("schedule", name,
                                 {"base": base, "rounds": rounds, "seed": seed})
    return registry.make("schedule", name, n=n, **ctx, **kw)


# ---------------------------------------------------------------------------
# mixing backend
# ---------------------------------------------------------------------------

class ScheduledMixer(Mixer):
    """Dense per-iteration mixing W_k X with W_k = stack[k % T_cycle].

    One (T, n, n) stack per (dtype, device), each slice cast by the same
    exact-stochastic correction DenseMixer applies, so a static schedule
    is bit for bit the DenseMixer path.  ``node_axis`` is 0, or 1 under a
    stacked grid's leading point axis (the schedule is shared)."""

    def __init__(self, schedule: TopologySchedule, node_axis: int = 0):
        self.schedule = schedule
        self.node_axis = node_axis
        self._stacks: Dict = {}     # (dtype, device) -> (T, n, n) tensor

    def materialized(self, dtype: torch.dtype, device) -> torch.Tensor:
        key = (dtype, torch.device(device))
        if key not in self._stacks:
            self._stacks[key] = torch.as_tensor(np.stack([
                _exact_stochastic(self.schedule.W_stack[t], dtype)
                for t in range(self.schedule.T_cycle)]), device=device)
        return self._stacks[key]

    def round_of(self, k) -> int:
        """k (None means round 0) -> index into the cycle."""
        return 0 if k is None else int(k) % self.schedule.T_cycle

    def W_k(self, k, dtype: torch.dtype, device) -> torch.Tensor:
        return self.materialized(dtype, device)[self.round_of(k)]

    def mix_leaf(self, leaf, k=None):
        return mix_with(self.W_k(k, acc_dtype(leaf.dtype), leaf.device), leaf,
                        self.node_axis)
