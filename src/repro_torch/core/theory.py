"""Convergence-theory helpers: feasible parameters and predicted rates.

The port's own copy of ``repro.core.theory`` (numpy only, verbatim):
the parameter choices and rate formulas of Theorems 1, 5, 7, 8, 9, so the
paper harness (``repro_torch.paper``) can hold measured contraction factors
against the paper's envelopes, and users get robust defaults.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProblemConstants:
    mu: float            # strong convexity
    L: float             # (expected) smoothness
    lambda_max: float    # lambda_max(I - W)
    lambda_min: float    # lambda_min+(I - W)
    C: float = 0.0       # compression constant (Assumption 2)
    m: int = 1           # batches per node (finite-sum)

    @property
    def kappa_f(self):
        return self.L / self.mu

    @property
    def kappa_g(self):
        return self.lambda_max / self.lambda_min


def delta(alpha: float, C: float) -> float:
    """Delta(alpha) = alpha - (1+C) alpha^2  (Lemma 4)."""
    return alpha - (1 + C) * alpha ** 2


def theorem5_params(pc: ProblemConstants, eta: float = None):
    """Feasible (eta, alpha, gamma) for the general stochastic setting."""
    eta = eta if eta is not None else 1.0 / (2 * pc.L)
    assert 0 < eta <= 1.0 / (2 * pc.L) + 1e-12
    if pc.C == 0:
        return eta, 1.0, 1.0  # Corollary 6
    alpha_hi = min(eta * pc.mu / math.sqrt(pc.C), 1.0 / (1 + pc.C))
    alpha = 0.5 * alpha_hi
    g1 = (2 * eta * pc.mu - 2 * math.sqrt(pc.C) * alpha) / (pc.lambda_max * eta * pc.mu)
    g2 = delta(alpha, pc.C) / (math.sqrt(pc.C) * pc.lambda_max)
    gamma = min(g1, g2)
    assert gamma > 0
    return eta, alpha, gamma


def theorem5_rate(pc: ProblemConstants, eta, alpha, gamma):
    """Contraction factor rho of Theorem 5 (per-iteration, on Phi)."""
    M = 1 - math.sqrt(pc.C) * alpha / (1 - gamma / 2 * pc.lambda_max)
    rho = max((1 - eta * pc.mu) / M,
              1 - gamma / 2 * pc.lambda_min,
              1 - alpha)
    assert 0 < rho < 1, (rho, M)
    return rho, M


def theorem8_params(pc: ProblemConstants):
    """LSVRG setting (eta, alpha, gamma, p)."""
    eta = 1.0 / (6 * pc.L)
    alpha = 1.0 / (12 * (1 + pc.C) * pc.kappa_f)
    if pc.C > 0:
        gamma = min(1.0 / (24 * math.sqrt(pc.C) * (1 + pc.C) * pc.lambda_max * pc.kappa_f),
                    1.0 / (24 * (1 + pc.C) * pc.lambda_max))
    else:
        gamma = 1.0 / (24 * pc.lambda_max)
    p = 1.0 / pc.m
    return eta, alpha, gamma, p


def theorem8_rate(pc: ProblemConstants, p: float):
    """1 - 1/max{...} from Theorem 8."""
    C, kf, kg = pc.C, pc.kappa_f, pc.kappa_g
    denom = max(48 * math.sqrt(C) * (1 + C) * kf * kg,
                12 * (1 + C) * kf,
                282 * kf / 23,
                48 * (1 + C) * kg,
                2 / p)
    return 1 - 1 / denom


def theorem9_rate(pc: ProblemConstants):
    """SAGA rate (Theorem 9): p is replaced by 1/m."""
    return theorem8_rate(pc, 1.0 / pc.m)


def iteration_complexity(pc: ProblemConstants, eps: float, variant: str = "full"):
    """Table 2 complexities, up to constants/logs (for reporting)."""
    C, kf, kg = pc.C, pc.kappa_f, pc.kappa_g
    log = math.log(1 / eps)
    if variant == "full":
        return ((1 + C) * (kf + kg) + math.sqrt(C) * (1 + C) * kf * kg) * log
    if variant == "lsvrg":
        return ((1 + C) * (kf + kg) + math.sqrt(C) * (1 + C) * kf * kg + pc.m) * log
    if variant == "saga":
        return ((1 + C) * (kf + kg) + math.sqrt(C) * (1 + C) * kf * kg + pc.m) * log
    raise ValueError(variant)


def logreg_constants(A_stacked: np.ndarray, lam2: float) -> tuple:
    """(mu, L) for l2-regularized multinomial logistic regression.

    L <= 0.5 * max_i ||a_i||^2 + lam2 (softmax Hessian bound), mu = lam2.
    A_stacked: (..., features) design rows.
    """
    sq = np.sum(A_stacked.reshape(-1, A_stacked.shape[-1]) ** 2, axis=1)
    L = 0.5 * float(sq.max()) + lam2
    return lam2, L
