"""Prox-LEAD (paper Algorithm 1) and LEAD (Algorithm 3, r = 0).

State is stacked: every leaf has a leading node axis n.

    Z^{k+1} = X^k - eta G^k - eta D^k            (G^k from the SGO)
    Zhat, Zhat_w, comm_state  = COMM(Z^{k+1}, H^k, Hw^k, alpha)
    D^{k+1} = D^k + gamma/(2 eta) (Zhat - Zhat_w)
    V^{k+1} = Z^{k+1} - gamma/2   (Zhat - Zhat_w)
    X^{k+1} = prox_{eta R}(V^{k+1})

Random numbers come from a draw source (``core.draws``) in a fixed order:
``init`` makes the oracle's draws once; every ``step`` makes the oracle's
draws, then COMM draws one noise array per leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch import registry
from repro_torch.core.comm import (CommState, Mixer, coef, comm,
                                   init_comm_state)
from repro_torch.core.compression import Compressor, Identity, TopK
from repro_torch.core.draws import Draws
from repro_torch.core.oracles import Oracle, OracleState
from repro_torch.core.prox import NoneProx, Prox
from repro_torch.tree import tree_map


class ProxLEADState(NamedTuple):
    X: Any                  # stacked iterates (n, ...)
    D: Any                  # dual variable (n, ...)
    comm: CommState         # H, Hw
    oracle: OracleState
    k: int                  # iteration counter


@dataclasses.dataclass
class ProxLEAD:
    """Algorithm 1.  ``eta``/``alpha``/``gamma`` are floats or callables
    k -> float (the diminishing schedules of Theorem 7).  A biased
    compressor (TopK) is refused unless ``allow_biased``."""
    eta: Any
    alpha: Any
    gamma: Any
    compressor: Compressor
    prox: Prox
    mixer: Mixer
    oracle: Oracle
    allow_biased: bool = False

    def __post_init__(self):
        if isinstance(self.compressor, TopK) and not self.allow_biased:
            raise ValueError(
                "TopK is biased and violates Assumption 2; the paper's theory "
                "does not cover it. Pass allow_biased=True for ablations.")

    def _at(self, v, k):
        return v(k) if callable(v) else v

    def init(self, X0, draws: Draws, H1: Optional[Any] = None
             ) -> ProxLEADState:
        """Lines 1-3: Hw^1 = W H^1;  Z^1 = X^0 - eta grad;  X^1 = prox(Z^1).
        H^1 defaults to 0 (the paper's init)."""
        if H1 is None:
            H1 = tree_map(torch.zeros_like, X0)
        comm_state = init_comm_state(H1, self.mixer)
        ostate = self.oracle.init(X0)
        G0, ostate = self.oracle.sample(X0, ostate, draws)
        eta = self._at(self.eta, 0)
        Z1 = tree_map(lambda x, g: x - eta * g, X0, G0)
        X1 = self.prox.tree_call(Z1, eta)
        D1 = tree_map(torch.zeros_like, X0)
        return ProxLEADState(X1, D1, comm_state, ostate, 1)

    def step(self, state: ProxLEADState, draws: Draws) -> ProxLEADState:
        G, ostate = self.oracle.sample(state.X, state.oracle, draws)   # line 5
        return self.update(state._replace(oracle=ostate), G, draws)

    def update(self, state: ProxLEADState, G, draws: Draws) -> ProxLEADState:
        """Lines 6-10 given a gradient estimate G.  ``eta``, ``alpha`` and
        ``gamma`` may also be a stacked grid's per-point operands ((P,) f64
        tensors, or callables k -> such a tensor), the state's leaves then
        carrying a leading point axis (``repro_torch.sweep``): every
        coefficient is formed in f64 and rounded once to the dtype of the
        leaf it scales, at that leaf's rank (``comm.coef``), as a host
        float is."""
        eta = self._at(self.eta, state.k)
        alpha = self._at(self.alpha, state.k)
        gamma = self._at(self.gamma, state.k)

        def line6(x, g, d):
            eta_c = coef(eta, x)
            return x - eta_c * g - eta_c * d

        Z = tree_map(line6, state.X, G, state.D)                        # line 6
        Zhat, Zhat_w, cstate = comm(Z, state.comm, alpha, self.compressor,
                                    draws, self.mixer,
                                    step_idx=state.k)                   # line 7
        diff = tree_map(lambda a, b: a - b, Zhat, Zhat_w)
        c_d, c_v = gamma / (2 * eta), gamma / 2.0
        D = tree_map(lambda d, df: d + coef(c_d, d) * df,
                     state.D, diff)                                     # line 8
        V = tree_map(lambda z, df: z - coef(c_v, z) * df, Z, diff)      # line 9
        X = self.prox.tree_call(V, eta)                                 # line 10
        return ProxLEADState(X, D, cstate, state.oracle, state.k + 1)


def lead(eta, alpha, gamma, compressor, mixer, oracle,
         allow_biased: bool = False) -> ProxLEAD:
    """LEAD (Algorithm 3) == Prox-LEAD with R = 0."""
    # the R = 0 reduction is definitional, not a pluggable choice
    # repro: allow(registry-only-construction)
    return ProxLEAD(eta, alpha, gamma, compressor, NoneProx(), mixer, oracle,
                    allow_biased)


def nids(eta, mixer, oracle, prox: Optional[Prox] = None) -> ProxLEAD:
    """NIDS (Li-Shi-Yan 2019) == (Prox-)LEAD with C = 0, gamma = 1 (paper
    §4.3, Corollary 6)."""
    # C = 0 / R-optional are the reduction itself, not pluggable choices
    # repro: allow(registry-only-construction)
    return ProxLEAD(eta, 1.0, 1.0, Identity(), prox or NoneProx(), mixer,
                    oracle)


def diminishing_schedules(mu, L, C, lambda_max, kappa_f, kappa_g):
    """Theorem 7 schedules: eta^k, alpha^k, gamma^k."""
    B = 16.0 * (1 + C) ** 2 * kappa_g * kappa_f

    def eta(k):
        return (B / 2.0) / (k + B) / L

    def alpha(k):
        return eta(k) * mu / (1 + C)

    def gamma(k):
        return eta(k) * mu / (2 * (1 + C) ** 2 * lambda_max)

    return eta, alpha, gamma


# -- registered algorithm factories (api.AlgorithmSpec.name): each receives
# the subset of (eta, alpha, gamma, compressor, prox, mixer, oracle) it
# declares, plus AlgorithmSpec.params (strict).

@registry.register_algorithm("prox_lead")
def _prox_lead_factory(eta, alpha, gamma, compressor, prox, mixer, oracle,
                       allow_biased: bool = False) -> ProxLEAD:
    return ProxLEAD(eta, alpha, gamma, compressor, prox, mixer, oracle,
                    allow_biased)


@registry.register_algorithm("lead")
def _lead_factory(eta, alpha, gamma, compressor, mixer, oracle,
                  allow_biased: bool = False) -> ProxLEAD:
    return lead(eta, alpha, gamma, compressor, mixer, oracle, allow_biased)


@registry.register_algorithm("nids")
def _nids_factory(eta, mixer, oracle, prox=None) -> ProxLEAD:
    return nids(eta, mixer, oracle, prox)
