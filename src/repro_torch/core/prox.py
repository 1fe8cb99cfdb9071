"""Proximal operators for the shared non-smooth component r(x).

prox_{eta r}(x) = argmin_z  r(z) + ||z - x||^2 / (2 eta).

Elementwise or rowwise closed forms, applied leafwise; ``value`` returns
r(x) as a 0-dim tensor for objective bookkeeping.  ``eta`` is a float, or
a stacked grid's per-point (P,) f64 operand: each step size product is
formed in f64 and rounded once to x's dtype at x's rank (``comm.coef``),
as a host float is; every closed form is elementwise or reduces the last
axis alone, so a leading point axis passes through.

``elementwise(eta)`` gives the prox at a Python-float step size as an
:class:`Elementwise` form -- what the fused Prox-LEAD update
(:mod:`repro_torch.kernels.proxlead`, kernel B6) applies in its pass --
or None: for a stacked grid's per-point ``eta`` and for a prox that
reduces (``group_lasso``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import registry
from repro_torch.core.comm import coef
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Elementwise:
    """prox_{eta r} as an elementwise map with its scalar constants:
    soft-threshold at ``thresh`` (when set), clamp at 0 (``nonneg``), then
    divide by ``div`` (when set).  The constants are Python floats formed
    as the eager prox forms them, so they round to f32 as its scalar
    operands do; calling the form runs those eager ops."""
    thresh: Optional[float] = None
    nonneg: bool = False
    div: Optional[float] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.thresh is not None:
            x = _soft(x, self.thresh)
        if self.nonneg:
            x = torch.clamp(x, min=0.0)
        if self.div is not None:
            x = x / self.div
        return x


class Prox:
    name: str = "none"

    def __call__(self, x: torch.Tensor, eta) -> torch.Tensor:
        raise NotImplementedError

    def elementwise(self, eta) -> Optional[Elementwise]:
        """The prox at step size ``eta`` as an :class:`Elementwise` form,
        equal to ``self(x, eta)`` bit for bit; None where it has none."""
        return None

    def value(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def tree_call(self, tree, eta):
        return tree_map(lambda l: self(l, eta), tree)

    def tree_value(self, tree) -> torch.Tensor:
        return sum(self.value(l) for l in leaves(tree))


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _soft(x: torch.Tensor, t) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(x.abs() - t, min=0.0)


@registry.register_prox("none")
@dataclasses.dataclass(frozen=True)
class NoneProx(Prox):
    """r = 0: prox is the identity (Prox-LEAD reduces to LEAD)."""
    name: str = "none"

    def __call__(self, x, eta):
        return x

    def elementwise(self, eta):
        return None if torch.is_tensor(eta) else Elementwise()

    def value(self, x):
        return _zero(x)


@registry.register_prox("l1")
@dataclasses.dataclass(frozen=True)
class L1(Prox):
    """r(x) = lam ||x||_1: soft-thresholding."""
    lam: float = 1e-3
    name: str = "l1"

    def __call__(self, x, eta):
        return _soft(x, coef(eta * self.lam, x))

    def elementwise(self, eta):
        return None if torch.is_tensor(eta) else Elementwise(
            thresh=eta * self.lam)

    def value(self, x):
        return self.lam * x.abs().sum()


@registry.register_prox("l2sq")
@dataclasses.dataclass(frozen=True)
class L2Sq(Prox):
    """r(x) = (lam/2) ||x||^2: shrinkage x / (1 + eta lam)."""
    lam: float = 1e-3
    name: str = "l2sq"

    def __call__(self, x, eta):
        return x / coef(1.0 + eta * self.lam, x)

    def elementwise(self, eta):
        return None if torch.is_tensor(eta) else Elementwise(
            div=1.0 + eta * self.lam)

    def value(self, x):
        return 0.5 * self.lam * (x ** 2).sum()


@registry.register_prox("elastic_net")
@dataclasses.dataclass(frozen=True)
class ElasticNet(Prox):
    """r(x) = lam1 ||x||_1 + (lam2/2)||x||^2."""
    lam1: float = 1e-3
    lam2: float = 1e-3
    name: str = "elastic_net"

    def __call__(self, x, eta):
        return (_soft(x, coef(eta * self.lam1, x))
                / coef(1.0 + eta * self.lam2, x))

    def elementwise(self, eta):
        return None if torch.is_tensor(eta) else Elementwise(
            thresh=eta * self.lam1, div=1.0 + eta * self.lam2)

    def value(self, x):
        return self.lam1 * x.abs().sum() + 0.5 * self.lam2 * (x ** 2).sum()


@registry.register_prox("group_lasso")
@dataclasses.dataclass(frozen=True)
class GroupLasso(Prox):
    """r(x) = lam * sum_g ||x_g||_2 with groups along the last axis."""
    lam: float = 1e-3
    name: str = "group_lasso"

    def __call__(self, x, eta):
        norms = torch.sqrt((x ** 2).sum(dim=-1, keepdim=True) + 1e-24)
        return x * torch.clamp(1.0 - coef(eta * self.lam, x) / norms,
                               min=0.0)

    def value(self, x):
        return self.lam * torch.sqrt((x ** 2).sum(dim=-1) + 1e-24).sum()


@registry.register_prox("nonneg")
@dataclasses.dataclass(frozen=True)
class NonNeg(Prox):
    """r = indicator of the nonnegative orthant: projection."""
    name: str = "nonneg"

    def __call__(self, x, eta):
        return torch.clamp(x, min=0.0)

    def elementwise(self, eta):
        return None if torch.is_tensor(eta) else Elementwise(nonneg=True)

    def value(self, x):
        return _zero(x)


def make_prox(name: Optional[str], **kw) -> Prox:
    """Build a registered prox by name (None -> NoneProx); strict kwargs."""
    return registry.make("prox", name or "none", **kw)
