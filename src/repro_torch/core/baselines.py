"""The decentralized algorithms the paper compares Prox-LEAD against (§5.1).

The port of ``repro.core.baselines``.  All run on stacked trees with a
leading node axis over a DenseMixer and share the oracles, so a comparison
isolates the algorithm:

  * (Prox-)DGD      -- Nedic-Ozdaglar / Yuan et al. 2016 (biased for a
                       constant step)
  * PG-EXTRA        -- Shi et al. 2015b (composite, no compression)
  * NIDS            -- Li-Shi-Yan 2019, written out on its own (the
                       registered ``nids`` is the Prox-LEAD reduction)
  * Choco-SGD       -- Koloskova et al. 2019 (compressed gossip, smooth)
  * LessBit-style   -- Kovalev et al. 2021a, Options B/C/D (compressed
                       primal-dual, one gradient step per iteration)
  * Centralized     -- prox-SGD on the node-averaged gradient

Random numbers come from a draw source (``core.draws``) in the reference's
order: ``init`` of PG-EXTRA and NIDS makes the oracle's draws once; every
``step`` makes the oracle's draws, then (Choco, LessBit) the compressor's
draws for each leaf.  Identity compression is skipped, not called.

Under a stacked grid (``repro_torch.sweep``, ``batch='vmap'``) every
state leaf carries a leading point axis, (P, n, ...), and ``eta``,
``gamma_c``, ``theta`` and ``alpha`` may be per-point (P,) f64 operands:
each coefficient is formed in f64 and rounded once to the leaf's dtype at
the leaf's rank (``core.comm.coef``), as a host float is.  The inits of
PG-EXTRA and NIDS take a first step and stay serial, point by point.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import registry
from repro_torch.core.comm import Mixer, coef
from repro_torch.core.compression import Compressor, Identity
from repro_torch.core.draws import Draws
from repro_torch.core.oracles import Oracle, OracleState
from repro_torch.core.prox import NoneProx, Prox
from repro_torch.tree import tree_map


class SimpleState(NamedTuple):
    X: Any
    aux: Any              # algorithm-specific: None, a tree or a tuple of trees
    oracle: OracleState
    k: int


def _compress(compressor: Compressor, tree, draws: Draws):
    """Q leaf by leaf (its draws in leaf order); Identity passes through."""
    if isinstance(compressor, Identity):
        return tree
    return tree_map(lambda leaf: compressor(leaf, draws), tree)


def _half_mix(mixer: Mixer, X, k):
    """(I + W_k) / 2 X."""
    return tree_map(lambda x, wx: 0.5 * (x + wx), X, mixer(X, k))


@dataclasses.dataclass
class Baseline:
    eta: float
    mixer: Mixer
    oracle: Oracle
    prox: Prox = dataclasses.field(default_factory=NoneProx)
    name: str = "base"

    def init(self, X0, draws: Draws) -> SimpleState:
        raise NotImplementedError

    def step(self, state: SimpleState, draws: Draws) -> SimpleState:
        raise NotImplementedError


@dataclasses.dataclass
class ProxDGD(Baseline):
    """x <- prox_{eta r}(W x - eta g)."""
    name: str = "dgd"

    def init(self, X0, draws):
        return SimpleState(X0, None, self.oracle.init(X0), 0)

    def step(self, state, draws):
        G, ostate = self.oracle.sample(state.X, state.oracle, draws)
        X = self.prox.tree_call(
            tree_map(lambda wx, g: wx - coef(self.eta, g) * g,
                     self.mixer(state.X, state.k), G), self.eta)
        return SimpleState(X, state.aux, ostate, state.k + 1)


@dataclasses.dataclass
class PGExtra(Baseline):
    """PG-EXTRA (Shi et al. 2015b):
        z^{k+1} = z^k + W x^k - (I+W)/2 x^{k-1} - eta (g^k - g^{k-1})
        x^{k+1} = prox_{eta r}(z^{k+1})
    aux = (z, x_prev, g_prev); ``init`` takes the first step (k = 1)."""
    name: str = "pg_extra"

    def init(self, X0, draws):
        ostate = self.oracle.init(X0)
        G0, ostate = self.oracle.sample(X0, ostate, draws)
        Z1 = tree_map(lambda wx, g: wx - self.eta * g, self.mixer(X0), G0)
        return SimpleState(self.prox.tree_call(Z1, self.eta), (Z1, X0, G0),
                           ostate, 1)

    def step(self, state, draws):
        Z, Xprev, Gprev = state.aux
        G, ostate = self.oracle.sample(state.X, state.oracle, draws)
        Znew = tree_map(
            lambda z, wx, hx, g, gp: z + wx - hx - coef(self.eta, g) * (
                g - gp),
            Z, self.mixer(state.X, state.k),
            _half_mix(self.mixer, Xprev, state.k), G, Gprev)
        return SimpleState(self.prox.tree_call(Znew, self.eta),
                           (Znew, state.X, G), ostate, state.k + 1)


@dataclasses.dataclass
class NIDSIndependent(Baseline):
    """NIDS from Li-Shi-Yan 2019 (composite form):
        y^{k+1} = 2 x^k - x^{k-1} - eta (g^k - g^{k-1})
        z^{k+1} = z^k - x^k + (I - (I-W)/2) y^{k+1}
        x^{k+1} = prox_{eta r}(z^{k+1})
    aux = (z, x_prev, g_prev); ``init`` takes the first step (k = 1)."""
    name: str = "nids"

    def init(self, X0, draws):
        ostate = self.oracle.init(X0)
        G0, ostate = self.oracle.sample(X0, ostate, draws)
        Z1 = tree_map(lambda x, g: x - self.eta * g, X0, G0)
        return SimpleState(self.prox.tree_call(Z1, self.eta), (Z1, X0, G0),
                           ostate, 1)

    def step(self, state, draws):
        Z, Xprev, Gprev = state.aux
        G, ostate = self.oracle.sample(state.X, state.oracle, draws)
        Y = tree_map(lambda x, xp, g, gp: 2 * x - xp - coef(self.eta, g) * (
            g - gp), state.X, Xprev, G, Gprev)
        Znew = tree_map(lambda z, x, my: z - x + my, Z, state.X,
                        _half_mix(self.mixer, Y, state.k))
        return SimpleState(self.prox.tree_call(Znew, self.eta),
                           (Znew, state.X, G), ostate, state.k + 1)


@dataclasses.dataclass
class ChocoSGD(Baseline):
    """Choco-SGD (Koloskova et al. 2019), smooth problems only:
        x+ = x - eta g
        q  = Q(x+ - xhat);  xhat <- xhat + q
        x  = x+ + gamma_c (W - I) xhat
    aux = xhat."""
    compressor: Compressor = dataclasses.field(default_factory=Identity)
    gamma_c: float = 0.1
    name: str = "choco"

    def init(self, X0, draws):
        return SimpleState(X0, tree_map(torch.zeros_like, X0),
                           self.oracle.init(X0), 0)

    def step(self, state, draws):
        G, ostate = self.oracle.sample(state.X, state.oracle, draws)
        Xp = tree_map(lambda x, g: x - coef(self.eta, g) * g, state.X, G)
        q = _compress(self.compressor,
                      tree_map(lambda a, b: a - b, Xp, state.aux), draws)
        xhat = tree_map(lambda h, qq: h + qq, state.aux, q)
        X = tree_map(
            lambda xp, wxh, xh: xp + coef(self.gamma_c, xh) * (wxh - xh),
            Xp, self.mixer(xhat, state.k), xhat)
        return SimpleState(X, xhat, ostate, state.k + 1)


@dataclasses.dataclass
class LessBit(Baseline):
    """LessBit-style compressed primal-dual (Kovalev et al. 2021a):
        x^{k+1} = x^k - eta (g^k + d^k)
        q = Q(x^{k+1} - h^k);  xhat = h^k + q;  h <- (1-alpha) h + alpha xhat
        d^{k+1} = d^k + theta/2 (I - W) xhat
    aux = (d, h).  The oracle selects the option (full -> B, sgd -> C,
    lsvrg -> D)."""
    compressor: Compressor = dataclasses.field(default_factory=Identity)
    theta: float = 0.2
    alpha: float = 0.5
    name: str = "lessbit"

    def init(self, X0, draws):
        zeros = lambda: tree_map(torch.zeros_like, X0)     # noqa: E731
        return SimpleState(X0, (zeros(), zeros()), self.oracle.init(X0), 0)

    def step(self, state, draws):
        d, h = state.aux
        G, ostate = self.oracle.sample(state.X, state.oracle, draws)
        X = tree_map(lambda x, g, dd: x - coef(self.eta, g) * (g + dd),
                     state.X, G, d)
        q = _compress(self.compressor, tree_map(lambda a, b: a - b, X, h),
                      draws)
        xhat = tree_map(lambda hh, qq: hh + qq, h, q)
        h = tree_map(lambda hh, xh: coef(1 - self.alpha, hh) * hh
                     + coef(self.alpha, xh) * xh, h, xhat)
        lap = tree_map(lambda xh, wxh: xh - wxh, xhat,
                       self.mixer(xhat, state.k))
        d = tree_map(lambda dd, l: dd + coef(self.theta / 2.0, l) * l, d,
                     lap)
        return SimpleState(X, (d, h), ostate, state.k + 1)


def _node_mean(t: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return t.mean(axis, keepdim=True).expand_as(t).contiguous()


@dataclasses.dataclass
class Centralized(Baseline):
    """Prox-SGD on the exact node-averaged gradient (an all-reduce), from
    the node mean of X0 replicated.  The node axis is the leading one, or
    the one behind a stacked grid's point axis (an oracle over points)."""
    name: str = "centralized"

    def init(self, X0, draws):
        Xbar = tree_map(_node_mean, X0)
        return SimpleState(Xbar, None, self.oracle.init(Xbar), 0)

    def step(self, state, draws):
        G, ostate = self.oracle.sample(state.X, state.oracle, draws)
        axis = 1 if self.oracle.points else 0
        X = self.prox.tree_call(
            tree_map(lambda x, g: x - coef(self.eta, g) * _node_mean(g, axis),
                     state.X, G), self.eta)
        return SimpleState(X, state.aux, ostate, state.k + 1)


# -- registered algorithm factories (api.AlgorithmSpec.name), the
# reference's names and keywords -------------------------------------------

@registry.register_algorithm("dgd")
def _dgd_factory(eta, mixer, oracle, prox=None) -> ProxDGD:
    return ProxDGD(eta=eta, mixer=mixer, oracle=oracle,
                   prox=prox or NoneProx())


@registry.register_algorithm("pg_extra")
def _pg_extra_factory(eta, mixer, oracle, prox=None) -> PGExtra:
    return PGExtra(eta=eta, mixer=mixer, oracle=oracle,
                   prox=prox or NoneProx())


@registry.register_algorithm("nids_independent")
def _nids_independent_factory(eta, mixer, oracle,
                              prox=None) -> NIDSIndependent:
    return NIDSIndependent(eta=eta, mixer=mixer, oracle=oracle,
                           prox=prox or NoneProx())


@registry.register_algorithm("choco")
def _choco_factory(eta, mixer, oracle, compressor=None,
                   gamma_c: float = 0.1) -> ChocoSGD:
    return ChocoSGD(eta=eta, mixer=mixer, oracle=oracle,
                    compressor=compressor or Identity(), gamma_c=gamma_c)


@registry.register_algorithm("lessbit")
def _lessbit_factory(eta, alpha, mixer, oracle, compressor=None,
                     theta: float = 0.2) -> LessBit:
    return LessBit(eta=eta, mixer=mixer, oracle=oracle,
                   compressor=compressor or Identity(), theta=theta,
                   alpha=alpha)


@registry.register_algorithm("centralized")
def _centralized_factory(eta, mixer, oracle, prox=None) -> Centralized:
    return Centralized(eta=eta, mixer=mixer, oracle=oracle,
                       prox=prox or NoneProx())
