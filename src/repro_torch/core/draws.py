"""The draw source: every random number the port's algorithms consume.

The JAX package threads PRNG keys; the port threads one *draw source*
whose calls are made in a fixed order (the oracle's draws, then the
compressor's draws for each compressed leaf, each step).  JAX's threefry
and torch's Philox never produce the same numbers from one seed, so
parity tests draw
with JAX and hand the arrays to :class:`ReplayDraws`, which pops them in
call order.  Runs use :class:`GeneratorDraws`, a ``torch.Generator`` on the
run's device; a dry run (``repro_torch.launch.dryrun``) uses
:class:`MetaDraws`, which hands out ``meta`` tensors of the asked shape
and dtype through the same ATen ops, and :func:`draws_on` picks one of
the two for a device.

    randint(n, high)     -> (n,) int64 in [0, high)  batch index per node
    bernoulli(p[, shape]) -> shape bool (default ())  L-SVRG refresh coin,
                                                      straggler masks
    uniform(shape)       -> shape float32 in [0, 1)  stochastic-rounding
                                                      noise
    choice(n, k)         -> (k,) int64 distinct, in [0, n)  RandK's indices

``uniform(shape, dtype=, low=, high=)`` draws in another dtype and on
[low, high): netsim's link-drop uniforms (f64) and wire noise (U[-1, 1)
in the leaf's accumulation dtype).  A replayed array keeps its values:
an f64 draw is not rounded through f32 on the way.
``uniform(shape, out=view)`` fills ``view`` (of ``shape`` and ``dtype``,
any strides) in place and returns it: the neighbor-gossip backend draws
each leaf's noise straight into its bucket group's row table.

``shared()`` is the source the model ranks of a tensor-parallel node
share for its model-replicated leaves (``repro_torch.optim.wire``), and
``common()`` the source every process of a run shares, from which RandK
and TopK draw on a leaf stacked over every node: each is the source
itself, except for :class:`TPRankDraws`.

:class:`StackedDraws` serves a stacked grid (``repro_torch.sweep``): P
sources, one a grid point, each point drawing from its own stream what
its serial run would draw, the P results stacked on a leading axis.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch


class Draws:
    """Interface; see the module docstring for the four calls."""

    def randint(self, n: int, high: int) -> torch.Tensor:
        raise NotImplementedError

    def bernoulli(self, p: float, shape: Sequence[int] = ()) -> torch.Tensor:
        raise NotImplementedError

    def uniform(self, shape: Sequence[int],
                out: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32, low: float = 0.0,
                high: float = 1.0) -> torch.Tensor:
        raise NotImplementedError

    def choice(self, n: int, k: int) -> torch.Tensor:
        raise NotImplementedError

    def shared(self) -> "Draws":
        """The source a node's model ranks share (itself)."""
        return self

    def common(self) -> "Draws":
        """The source every process of a run shares (itself)."""
        return self


def _check_out(out: torch.Tensor, shape, dtype) -> None:
    if tuple(out.shape) != tuple(int(s) for s in shape) or \
            out.dtype != dtype:
        raise ValueError(f"out must be {dtype} of shape {tuple(shape)}, "
                         f"got {out.dtype} {tuple(out.shape)}")


class GeneratorDraws(Draws):
    """Draws from a seeded ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int, device) -> None:
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def randint(self, n, high):
        return torch.randint(0, int(high), (int(n),), generator=self.gen,
                             device=self.device)

    def bernoulli(self, p, shape=()):
        return torch.rand(tuple(shape), generator=self.gen,
                          device=self.device) < p

    def uniform(self, shape, out=None, dtype=torch.float32, low=0.0,
                high=1.0):
        if out is None:
            out = torch.empty(tuple(shape), device=self.device, dtype=dtype)
        else:
            _check_out(out, shape, dtype)
        return out.uniform_(low, high, generator=self.gen)

    def choice(self, n, k):
        return torch.randperm(int(n), generator=self.gen,
                              device=self.device)[:int(k)]


class MetaDraws(Draws):
    """Draws on the ``meta`` device: the ATen ops of
    :class:`GeneratorDraws` without a generator (``torch.Generator``
    refuses ``meta``), so each call returns a ``meta`` tensor of the asked
    shape and dtype and a recorder counts what the card's call moves."""

    device = torch.device("meta")

    def randint(self, n, high):
        return torch.randint(0, int(high), (int(n),), device=self.device)

    def bernoulli(self, p, shape=()):
        return torch.rand(tuple(shape), device=self.device) < p

    def uniform(self, shape, out=None, dtype=torch.float32, low=0.0,
                high=1.0):
        if out is None:
            out = torch.empty(tuple(shape), device=self.device, dtype=dtype)
        else:
            _check_out(out, shape, dtype)
        return out.uniform_(low, high)

    def choice(self, n, k):
        return torch.randperm(int(n), device=self.device)[:int(k)]


def draws_on(seed: int, device) -> Draws:
    """A :class:`GeneratorDraws` seeded ``seed`` on ``device``, or
    :class:`MetaDraws` when ``device`` is ``meta``."""
    if torch.device(device).type == "meta":
        return MetaDraws()
    return GeneratorDraws(seed, device)


class ReplayDraws(Draws):
    """Pops pre-drawn arrays (numpy or torch) in call order onto ``device``.

    Each pop is checked against the call: ``randint`` wants shape ``(n,)``
    with values in range, ``choice`` shape ``(k,)`` with values in range,
    ``uniform`` wants as many elements as ``shape``
    (the reference may draw the same noise as ``(R, block)`` or
    ``(R, 1, block)``: threefry fills the flattened array either way).
    Running out of arrays, or a mismatch, raises."""

    def __init__(self, arrays: Sequence[Any], device) -> None:
        self.pending: List[Any] = list(arrays)
        self.device = torch.device(device)

    def _pop(self, what: str) -> torch.Tensor:
        if not self.pending:
            raise IndexError(f"replay exhausted at a {what} draw")
        a = self.pending.pop(0)
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.array(a))
        return torch.as_tensor(a).to(self.device)

    def randint(self, n, high):
        a = self._pop("randint").to(torch.int64)
        if tuple(a.shape) != (int(n),):
            raise ValueError(f"replayed randint has shape {tuple(a.shape)}, "
                             f"the call wants ({n},)")
        if a.numel() and (int(a.min()) < 0 or int(a.max()) >= high):
            raise ValueError(f"replayed randint outside [0, {high})")
        return a

    def bernoulli(self, p, shape=()):
        a = self._pop("bernoulli")
        shape = tuple(int(s) for s in shape)
        if a.numel() != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"replayed bernoulli has {a.numel()} elements, "
                             f"the call wants {shape}")
        return a.reshape(shape).to(torch.bool)

    def uniform(self, shape, out=None, dtype=torch.float32, low=0.0,
                high=1.0):
        a = self._pop("uniform").to(dtype)
        shape = tuple(int(s) for s in shape)
        if a.numel() != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"replayed uniform has shape {tuple(a.shape)}, "
                             f"the call wants {shape}")
        if out is None:
            return a.reshape(shape)
        _check_out(out, shape, dtype)
        return out.copy_(a.reshape(shape))

    def choice(self, n, k):
        a = self._pop("choice").to(torch.int64)
        if tuple(a.shape) != (int(k),):
            raise ValueError(f"replayed choice has shape {tuple(a.shape)}, "
                             f"the call wants ({k},)")
        if a.numel() and (int(a.min()) < 0 or int(a.max()) >= n):
            raise ValueError(f"replayed choice outside [0, {n})")
        return a


class RecordingDraws(Draws):
    """Passes every call through to ``inner`` and keeps what it returned,
    in order, so the same draws can be replayed elsewhere."""

    def __init__(self, inner: Draws) -> None:
        self.inner = inner
        self.device = inner.device
        self.record: List[torch.Tensor] = []

    def _keep(self, t):
        self.record.append(t)
        return t

    def randint(self, n, high):
        return self._keep(self.inner.randint(n, high))

    def bernoulli(self, p, shape=()):
        return self._keep(self.inner.bernoulli(p, shape))

    def uniform(self, shape, out=None, dtype=torch.float32, low=0.0,
                high=1.0):
        t = self.inner.uniform(shape, out=out, dtype=dtype, low=low,
                               high=high)
        # a copy: an ``out`` view may be overwritten after the call
        self.record.append(t.clone())
        return t

    def choice(self, n, k):
        return self._keep(self.inner.choice(n, k))


class StackedDraws(Draws):
    """The draws of P grid points stacked on a leading point axis, point i
    drawing from ``points[i]`` (its own stream, in point order):
    ``randint(n, high)`` -> (P, n); ``uniform(shape)`` with ``shape[0] ==
    P`` fills point i's slice of one (P, ...) buffer from its own source
    (``uniform(shape[1:], out=buf[i])``), so each point gets the values a
    draw of ``shape[1:]`` would give it alone; ``bernoulli(p, shape)`` ->
    (P, *shape); ``choice(n, k)`` -> (P, k).  Each call draws point 0's
    part first, so every point's own stream sees its serial sequence of
    calls."""

    def __init__(self, points: Sequence[Draws]) -> None:
        if not points:
            raise ValueError("StackedDraws needs at least one point")
        self.points = list(points)
        self.device = self.points[0].device

    def randint(self, n, high):
        return torch.stack([d.randint(n, high) for d in self.points])

    def uniform(self, shape, out=None, dtype=torch.float32, low=0.0,
                high=1.0):
        shape = tuple(int(s) for s in shape)
        if not shape or shape[0] != len(self.points):
            raise ValueError(f"a stacked uniform draw wants a leading axis "
                             f"of the {len(self.points)} points, got "
                             f"{shape}")
        if out is None:
            out = torch.empty(shape, device=self.device, dtype=dtype)
        else:
            _check_out(out, shape, dtype)
        for i, d in enumerate(self.points):
            d.uniform(shape[1:], out=out[i], dtype=dtype, low=low, high=high)
        return out

    def bernoulli(self, p, shape=()):
        return torch.stack([d.bernoulli(p, shape) for d in self.points])

    def choice(self, n, k):
        return torch.stack([d.choice(n, k) for d in self.points])


class TPRankDraws(Draws):
    """The draws of one rank of a seeded run split over processes: every
    call from ``own``, its stream per (node block, model rank) under
    ``repro_torch.models.tp.DistTP``, its node block's on a plain
    ``ProcessMesh``; :meth:`shared` is ``node``, the stream its block's
    model ranks share, from which the wire draws the model-replicated
    leaves' noise (``own`` itself where the block has one model rank);
    :meth:`common` is ``world``, the stream every rank shares (seeded
    alike on each), from which RandK and TopK draw on the leaf gathered
    over every node."""

    def __init__(self, own: Draws, node: Draws, world: Draws) -> None:
        self.own, self.node, self.world = own, node, world
        self.device = own.device

    def randint(self, n, high):
        return self.own.randint(n, high)

    def bernoulli(self, p, shape=()):
        return self.own.bernoulli(p, shape)

    def uniform(self, shape, out=None, dtype=torch.float32, low=0.0,
                high=1.0):
        return self.own.uniform(shape, out=out, dtype=dtype, low=low,
                                high=high)

    def choice(self, n, k):
        return self.own.choice(n, k)

    def shared(self) -> Draws:
        return self.node

    def common(self) -> Draws:
        return self.world
