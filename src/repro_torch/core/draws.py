"""The draw source: every random number the port's algorithms consume.

The JAX package threads PRNG keys; the port threads one *draw source*
whose calls are made in a fixed order (the oracle's draws, then the
compressor's draws for each compressed leaf, each step).  JAX's threefry
and torch's Philox never produce the same numbers from one seed, so
parity tests draw
with JAX and hand the arrays to :class:`ReplayDraws`, which pops them in
call order.  Runs use :class:`GeneratorDraws`, a ``torch.Generator`` on the
run's device.

    randint(n, high)  -> (n,) int64 in [0, high)   batch index per node
    bernoulli(p)      -> () bool                   L-SVRG reference refresh
    uniform(shape)    -> shape float32 in [0, 1)   stochastic-rounding noise
    choice(n, k)      -> (k,) int64 distinct, in [0, n)   RandK's indices

``uniform(shape, out=view)`` fills ``view`` (of ``shape``, f32, any
strides) in place and returns it: the neighbor-gossip backend draws each
leaf's noise straight into its bucket group's row table.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch


class Draws:
    """Interface; see the module docstring for the four calls."""

    def randint(self, n: int, high: int) -> torch.Tensor:
        raise NotImplementedError

    def bernoulli(self, p: float) -> torch.Tensor:
        raise NotImplementedError

    def uniform(self, shape: Sequence[int],
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def choice(self, n: int, k: int) -> torch.Tensor:
        raise NotImplementedError


def _check_out(out: torch.Tensor, shape) -> None:
    if tuple(out.shape) != tuple(int(s) for s in shape) or \
            out.dtype != torch.float32:
        raise ValueError(f"out must be f32 of shape {tuple(shape)}, got "
                         f"{out.dtype} {tuple(out.shape)}")


class GeneratorDraws(Draws):
    """Draws from a seeded ``torch.Generator`` on ``device``."""

    def __init__(self, seed: int, device) -> None:
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def randint(self, n, high):
        return torch.randint(0, int(high), (int(n),), generator=self.gen,
                             device=self.device)

    def bernoulli(self, p):
        return torch.rand((), generator=self.gen, device=self.device) < p

    def uniform(self, shape, out=None):
        if out is None:
            return torch.rand(tuple(shape), generator=self.gen,
                              device=self.device, dtype=torch.float32)
        _check_out(out, shape)
        return out.uniform_(0.0, 1.0, generator=self.gen)

    def choice(self, n, k):
        return torch.randperm(int(n), generator=self.gen,
                              device=self.device)[:int(k)]


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

    def bernoulli(self, p):
        a = self._pop("bernoulli")
        if a.numel() != 1:
            raise ValueError(f"replayed bernoulli has {a.numel()} elements")
        return a.reshape(()).to(torch.bool)

    def uniform(self, shape, out=None):
        a = self._pop("uniform").to(torch.float32)
        shape = tuple(int(s) for s in shape)
        if a.numel() != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"replayed uniform has shape {tuple(a.shape)}, "
                             f"the call wants {shape}")
        if out is None:
            return a.reshape(shape)
        _check_out(out, shape)
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
        self.record: List[torch.Tensor] = []

    def _keep(self, t):
        self.record.append(t)
        return t

    def randint(self, n, high):
        return self._keep(self.inner.randint(n, high))

    def bernoulli(self, p):
        return self._keep(self.inner.bernoulli(p))

    def uniform(self, shape, out=None):
        t = self.inner.uniform(shape, out=out)
        # a copy: an ``out`` view may be overwritten after the call
        self.record.append(t.clone())
        return t

    def choice(self, n, k):
        return self._keep(self.inner.choice(n, k))
