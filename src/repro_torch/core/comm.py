"""The COMM procedure (paper, Algorithm 1 inset) over a dense mixing matrix.

COMM compresses the *difference* Z^{k+1} - H^k, so the compression error
vanishes as Z and H converge to the same point (implicit error
compensation):

    Q^k      = Q(Z^{k+1} - H^k)                      # compression
    Zhat     = H^k  + Q^k
    Zhat_w   = Hw^k + W Q^k                          # the ONLY communication
    H^{k+1}  = (1-alpha) H^k  + alpha Zhat
    Hw^{k+1} = (1-alpha) Hw^k + alpha Zhat_w

Leaves carry a leading node axis n.  ``DenseMixer`` applies W along it as
one (n, n) x (n, rest) product; the ring/neighbour gossip backends and the
time-varying (netsim) mixers of the reference arrive with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core.compression import Compressor, Identity
from repro_torch.core.draws import Draws
from repro_torch.tree import flatten, tree_map, unflatten


class CommState(NamedTuple):
    H: Any      # tree of (n, ...) leaves
    Hw: Any     # same structure: the running W H


class Mixer:
    """mix(X) computes W X along the leading node axis of every leaf."""

    def mix_leaf(self, leaf: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, X):
        return tree_map(self.mix_leaf, X)


def _exact_stochastic(W: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """Cast W to ``dtype`` with a diagonal correction so every row (and, by
    symmetry, column) sums to 1 *in that dtype*.

    This matters: the dual variable D integrates gamma/(2 eta) (I - W) Zhat
    every step, so a 1e-8 column-sum error (f32 rounding of e.g. 1/3)
    becomes a linear-in-k drift of mean(D) and hence of the consensus
    average -- a real bug in the reference's history, the same failure mode
    as gradient-tracking drift."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    Wd = np.asarray(W, np_dtype)
    Wd = (Wd + Wd.T) / 2
    np.fill_diagonal(Wd, 0.0)
    corr = 1.0 - Wd.sum(axis=1)
    return Wd + np.diag(corr.astype(Wd.dtype))


@dataclasses.dataclass(frozen=True)
class DenseMixer(Mixer):
    """W X as a contraction over the explicit leading node axis.  The
    accumulation dtype is f64 for f64 leaves and f32 otherwise; W is cast
    by :func:`_exact_stochastic` once per (dtype, device) and kept."""
    W: Any  # (n, n) array-like
    _cache: Dict[Any, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def _w(self, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        key = (dtype, device)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(
                _exact_stochastic(np.asarray(self.W), dtype), device=device)
        return self._cache[key]

    def mix_leaf(self, leaf: torch.Tensor) -> torch.Tensor:
        acc = torch.float64 if leaf.dtype == torch.float64 else torch.float32
        W = self._w(acc, leaf.device)
        return torch.tensordot(W, leaf.to(acc), dims=([1], [0])).to(leaf.dtype)


def comm(Z, state: CommState, alpha: float, compressor: Compressor,
         draws: Draws, mixer: Mixer):
    """One COMM round over trees Z, H, Hw of one structure.  Draws one
    noise array per leaf, in leaf order (none for Identity).

    Returns (Zhat, Zhat_w, new_state)."""
    leaves_Z, treedef = flatten(Z)
    leaves_H, _ = flatten(state.H)
    leaves_Hw, _ = flatten(state.Hw)
    zhat, zhat_w, newH, newHw = [], [], [], []
    for z, h, hw in zip(leaves_Z, leaves_H, leaves_Hw):
        diff = z - h
        q = diff if isinstance(compressor, Identity) else compressor(diff,
                                                                     draws)
        zh = h + q
        zw = hw + mixer.mix_leaf(q)
        zhat.append(zh)
        zhat_w.append(zw)
        newH.append((1 - alpha) * h + alpha * zh)
        newHw.append((1 - alpha) * hw + alpha * zw)
    unf = lambda ls: unflatten(treedef, ls)
    return unf(zhat), unf(zhat_w), CommState(unf(newH), unf(newHw))


def init_comm_state(H1, mixer: Mixer) -> CommState:
    """Line 1 of Algorithm 1: Hw^1 = W H^1 (one uncompressed warm-up mix)."""
    return CommState(H1, mixer(H1))
