"""The COMM procedure (paper, Algorithm 1 inset) and its mixing backends.

COMM compresses the *difference* Z^{k+1} - H^k, so the compression error
vanishes as Z and H converge to the same point (implicit error
compensation):

    Q^k      = Q(Z^{k+1} - H^k)                      # compression
    Zhat     = H^k  + Q^k
    Zhat_w   = Hw^k + W Q^k                          # the ONLY communication
    H^{k+1}  = (1-alpha) H^k  + alpha Zhat
    Hw^{k+1} = (1-alpha) Hw^k + alpha Zhat_w

Leaves carry a leading node axis n.  Every mixer takes the round index
``k`` (a host int, or None for round 0):

* ``DenseMixer`` -- one (n, n) x (n, rest) product with a static W; it
  ignores ``k``.
* ``NeighborMixer`` -- the dense meaning of a compiled
  :class:`~repro_torch.core.topology.ExchangePlan` (also a time-varying
  one, T > 1): hop by hop, a gather and a per-receiver, per-round weight.
  The neighbor-gossip trainer (``optim.decentralized``) moves the packed
  payloads of the same plan and is held to this.
* the time-varying and faulty mixers of ``repro_torch.netsim``
  (``ScheduledMixer``, ``SimMixer``).

A time-varying or faulty mixer sets ``recompute_hw``: the incremental
recursion Hw + W Q only tracks W H for a static W, so COMM recomputes
Zhat_w = W_k (H + Q) from the receiver-side H replicas instead
(``comm_mix``), and drops a straggler's Q everywhere (``send_mask``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.compression import Compressor, Identity
from repro_torch.core.draws import Draws
from repro_torch.tree import flatten, tree_map, unflatten


class CommState(NamedTuple):
    H: Any      # tree of (n, ...) leaves
    Hw: Any     # same structure: the running W H


class Mixer:
    """mix(X, k) computes W_k X along the leading node axis of every leaf.

    ``k`` is the round index (a host int; None means round 0).  Static
    backends ignore it."""

    #: True -> COMM uses comm_mix/send_mask instead of the Hw recursion
    recompute_hw: bool = False

    def mix_leaf(self, leaf: torch.Tensor, k=None) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, X, k=None):
        return tree_map(lambda leaf: self.mix_leaf(leaf, k), X)

    def send_mask(self, k=None) -> Optional[torch.Tensor]:
        """(n,) {0,1} mask of the nodes whose send succeeds this round, or
        None.  A failed sender's Q is dropped everywhere -- receivers AND
        its own H update -- so sender and replica state stay consistent."""
        return None

    def comm_mix(self, h: torch.Tensor, q: torch.Tensor, k=None,
                 leaf_idx: int = 0) -> torch.Tensor:
        """Zhat_w for one leaf: W_k applied to (h + q) through the faulty
        channel.  Only required when ``recompute_hw``."""
        raise NotImplementedError


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
    """W X as a contraction over the explicit node axis (``node_axis``: 0,
    or 1 under a stacked grid's leading point axis).  The accumulation
    dtype is f64 for f64 leaves and f32 otherwise; W is cast by
    :func:`_exact_stochastic` once per (dtype, device) and kept."""
    W: Any  # (n, n) array-like
    _cache: Dict[Any, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)
    node_axis: int = 0

    def _w(self, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        key = (dtype, device)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(
                _exact_stochastic(np.asarray(self.W), dtype), device=device)
        return self._cache[key]

    def W_k(self, k, dtype: torch.dtype, device) -> torch.Tensor:
        """W in ``dtype`` on ``device`` (static: ``k`` is ignored)."""
        return self._w(dtype, device)

    def mix_leaf(self, leaf: torch.Tensor, k=None) -> torch.Tensor:
        acc = acc_dtype(leaf.dtype)
        return mix_with(self._w(acc, leaf.device), leaf, self.node_axis)


class RowsMixer(Mixer):
    """A process's part of ``inner``'s mixing: rows [lo, hi) of W_k X,
    X the leaf gathered over the node axis (``gather``: the ``ag(x)``
    seam of :mod:`repro_torch.optim.wire`, this process's rows -> every
    node's), where a rank holds the node block [lo, hi).  The rank keeps
    its rows of each column piece of the whole product W_k X
    (:func:`mix_with` with ``rows``): the one-process run's products, bit
    for bit, at the cost of the whole product's FLOPs on every rank.  On
    a split node a leaf holds ``per_node`` rank-rows a node (``n M +
    m``): each model rank's rows mix on their own, so rank-row (n, m)
    takes row n of W_k against model rank m of every node.  ``inner``: a
    :class:`DenseMixer`, or a netsim ``ScheduledMixer``/``SimMixer``,
    whose round's draws (fault masks) every process makes whole, from its
    own copy of the stream.  Gathers one leaf at a time; its transient
    holds the gathered leaf, one piece of the product and the rank's
    rows."""

    def __init__(self, inner: Mixer, gather, lo: int, hi: int,
                 per_node: int = 1) -> None:
        self.inner, self.gather = inner, gather
        self.lo, self.hi, self.per_node = lo, hi, per_node

    @property
    def recompute_hw(self) -> bool:
        return self.inner.recompute_hw

    def _own(self, W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return mix_with(W, self.gather(x), rows=(self.lo, self.hi))

    def _rows(self, W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if self.per_node == 1:
            return self._own(W, x)
        v = x.unflatten(0, (x.shape[0] // self.per_node, self.per_node))
        return torch.stack([self._own(W, v[:, m].contiguous())
                            for m in range(self.per_node)], 1).flatten(0, 1)

    def mix_leaf(self, leaf, k=None):
        return self._rows(
            self.inner.W_k(k, acc_dtype(leaf.dtype), leaf.device), leaf)

    def send_mask(self, k=None):
        send = self.inner.send_mask(k)
        if send is None:
            return None
        return send[self.lo:self.hi].repeat_interleave(self.per_node)

    def comm_mix(self, h, q, k=None, leaf_idx=0):
        acc = acc_dtype(h.dtype)
        payload = self.inner.comm_payload(h, q, k, leaf_idx)
        return self._rows(self.inner.comm_W(k, acc, h.device),
                          payload).to(h.dtype)


def coef(v, like: torch.Tensor):
    """A step's scalar coefficient as ``like``'s arithmetic takes it: a
    Python float as it is; a stacked grid's per-point operand, a (P,) f64
    tensor whose compound arithmetic (``gamma / (2 eta)``, ``1 - alpha``)
    was done in f64 as the host does it in double, viewed at ``like``'s
    rank, (P, 1, ..., 1), and rounded once to ``like``'s dtype -- what a
    Python float scalar goes through in a product with ``like``.  Each
    leaf of a tree-valued iterate so takes the operand at its own rank.
    A 0-d tensor is only rounded."""
    if not torch.is_tensor(v):
        return v
    if v.dim():
        v = v.reshape((-1,) + (1,) * (like.dim() - 1))
    return v.to(like.dtype)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The mixing accumulation dtype: f64 for f64 leaves, f32 otherwise."""
    return torch.float64 if dtype == torch.float64 else torch.float32


#: a product along node axis 0 is made this many bytes of its result at a
#: time (column pieces of the leaf): a process that keeps some rows of it
#: holds one piece of the whole product, not a second whole leaf
MIX_PIECE_BYTES = 1 << 28


def mix_with(W: torch.Tensor, leaf: torch.Tensor, node_axis: int = 0,
             rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """W (n, n) applied along the node axis of ``leaf`` (the leading one,
    or the one after a stacked grid's point axis: one batched product for
    every point), in W's dtype, the result cast back to the leaf's.  Under
    a point axis W may also be (P, n, n), one matrix a point (a netsim
    grid's fault-masked W_k).

    Along node axis 0 the leaf's columns (its trailing dims flattened) are
    multiplied MIX_PIECE_BYTES of the result at a time, each piece by the
    whole W.  ``rows`` (lo, hi) keeps rows [lo, hi) of each piece: the
    same products as the whole result's, so they equal its rows bit for
    bit on any device (a product of W's rows alone is not the same
    computation: one row of an (8, 8) f32 W against 256 columns rounded
    otherwise on the CPU)."""
    if node_axis != 0:
        x = leaf.to(W.dtype)
        n, rest = x.shape[node_axis], math.prod(x.shape[node_axis + 1:])
        out = torch.matmul(W, x.reshape(-1, n, rest))
        return out.reshape(x.shape).to(leaf.dtype)
    n = leaf.shape[0]
    lo, hi = rows or (0, n)
    x = leaf.reshape(n, -1)
    cols = x.shape[1]
    piece = max(1, MIX_PIECE_BYTES // (n * W.element_size()))
    if (lo, hi) == (0, n) and cols <= piece:
        return (W @ x.to(W.dtype)).reshape(leaf.shape).to(leaf.dtype)
    out = torch.empty((hi - lo, cols), dtype=leaf.dtype, device=leaf.device)
    for c0 in range(0, cols, piece):
        c1 = min(c0 + piece, cols)
        out[:, c0:c1] = (W @ x[:, c0:c1].to(W.dtype))[lo:hi]
    return out.reshape((hi - lo,) + tuple(leaf.shape[1:]))


@dataclasses.dataclass(frozen=True)
class NeighborMixer(Mixer):
    """W_k X through a compiled ExchangePlan -- ring, exponential graph,
    torus, matchings, any static sparse topology or finite schedule cycle.

    The plan's *dense reference semantics* on stacked (n, ...) leaves: hop
    by hop a gather stands in for the exchange, gated by the receiver's
    weight for round ``k % T``.  The per-round weights, gates and gather
    indices are built on the device once per (dtype, device) and indexed
    by round, so a mix moves nothing from the host."""
    plan: Any                       # repro_torch.core.topology.ExchangePlan
    _cache: Dict[Any, Any] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def recompute_hw(self) -> bool:
        # time-varying plans invalidate the static incremental Hw
        # recursion; tell comm() to recompute Zhat_w = W_k (H + Q)
        return self.plan.T > 1

    def _round_idx(self, k) -> int:
        if self.plan.T == 1:
            return 0
        if k is None:
            raise ValueError(
                f"plan {self.plan.name!r} is time-varying (T="
                f"{self.plan.T}); pass the round index k -- silently using "
                "round 0 would mix with the wrong W_k")
        return int(k) % self.plan.T

    def _tables(self, acc: torch.dtype, device: torch.device):
        """(self weights (T, n), [(gate (T, n), gets (n,)) per hop]) in
        ``acc`` on ``device``, built once: a hop's gate is the receiver's
        weight times whether it receives on that hop."""
        key = (acc, device)
        if key not in self._cache:
            plan = self.plan
            w_self = torch.as_tensor(plan.self_weights(np.float32),
                                     device=device).to(acc)
            hops = []
            for hop in plan.hops:
                gets = np.zeros(plan.n, np.int64)
                mask = np.zeros(plan.n, np.float32)   # dst receives?
                for (s, d) in hop.pairs:
                    gets[d] = s
                    mask[d] = 1.0
                w = np.asarray(hop.weights, np.float32)
                gate = (torch.as_tensor(w, device=device).to(acc)
                        * torch.as_tensor(mask, device=device).to(acc))
                hops.append((gate, torch.as_tensor(gets, device=device)))
            self._cache[key] = (w_self, hops)
        return self._cache[key]

    def mix_leaf(self, leaf, k=None):
        return self.mix_stacked((leaf,), k)[0]

    def comm_mix(self, h, q, k=None, leaf_idx=0):
        return self.mix_stacked((h + q,), k)[0]

    def mix_stacked(self, X, k=None):
        """Apply the plan to stacked (n, ...) leaves."""
        t = self._round_idx(k)
        n = self.plan.n

        def mix_leaf(leaf):
            acc = acc_dtype(leaf.dtype)
            x = leaf.to(acc)
            w_self, hops = self._tables(acc, x.device)
            bshape = (n,) + (1,) * (leaf.dim() - 1)
            out = w_self[t].reshape(bshape) * x
            for gate, gets in hops:
                out = out + gate[t].reshape(bshape) * x[gets]
            return out.to(leaf.dtype)

        return tree_map(mix_leaf, X)


def comm(Z, state: CommState, alpha: float, compressor: Compressor,
         draws: Draws, mixer: Mixer, step_idx=None):
    """One COMM round over trees Z, H, Hw of one structure.  Draws one
    noise array per leaf, in leaf order (none for Identity).
    ``step_idx`` (the round k) goes to the mixer, so a time-varying one
    picks W_k; static mixers ignore it.  ``alpha`` is a float, or a
    stacked grid's per-point operand (:func:`coef`).

    Returns (Zhat, Zhat_w, new_state)."""
    leaves_Z, treedef = flatten(Z)
    leaves_H, _ = flatten(state.H)
    leaves_Hw, _ = flatten(state.Hw)
    recompute = mixer.recompute_hw
    send = mixer.send_mask(step_idx) if recompute else None
    zhat, zhat_w, newH, newHw = [], [], [], []
    for j, (z, h, hw) in enumerate(zip(leaves_Z, leaves_H, leaves_Hw)):
        diff = z - h
        q = (diff if isinstance(compressor, Identity)
             else compressor.q_leaf(diff, draws, j))
        if send is not None:
            # a straggler skipped its send: its Q is dropped everywhere
            # (wire AND its own H update), so the replicas stay consistent
            # and the miss folds into the next round's difference
            # (a stacked grid's send mask is (P, n) against (P, n, ...))
            q = q * send.to(q.dtype).reshape(
                send.shape + (1,) * (q.dim() - send.dim()))
        zh = h + q
        zw = (mixer.comm_mix(h, q, step_idx, j) if recompute
              else hw + mixer.mix_leaf(q, step_idx))
        zhat.append(zh)
        zhat_w.append(zw)
        keep, take = coef(1 - alpha, h), coef(alpha, h)
        newH.append(keep * h + take * zh)
        newHw.append(keep * hw + take * zw)
    unf = lambda ls: unflatten(treedef, ls)
    return unf(zhat), unf(zhat_w), CommState(unf(newH), unf(newHw))


def init_comm_state(H1, mixer: Mixer, step_idx=None) -> CommState:
    """Line 1 of Algorithm 1: Hw^1 = W H^1 (one uncompressed warm-up mix)."""
    return CommState(H1, mixer(H1, step_idx))
