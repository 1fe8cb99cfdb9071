"""Compression operators: Identity, QInf and RandK (unbiased, paper
Assumption 2) and TopK (biased, an ablation baseline).

Every unbiased compressor Q satisfies E[Q(x)] = x and
E||Q(x) - x||^2 <= C ||x||^2.  ``compress`` returns the payload that would
go on the wire (int8 codes and one f32 scale per block for QInf, indices
and values for the sparsifiers), ``decompress`` the float estimate.
RandK and TopK act on the whole tensor, its leading node axis included,
as the reference's ``x.size`` does.

QInf blocks the LAST axis of any tensor (``kernels.ops``), draws its
stochastic-rounding noise from the draw source with the blocked shape, and
quantizes every block with kernel B1 (on the card) or its plain version
(on the CPU); ``decompress`` is kernel B2.  The reference reaches its
Pallas kernel only for (R, block) tensors and the same math in jnp
otherwise; here every shape goes through the kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import numpy as np
import torch

from repro_torch import registry
from repro_torch.core.draws import Draws
from repro_torch.kernels import ops as kops

Payload = Any


class Compressor:
    """Base API.  Stateless; randomness comes from the draw source."""

    #: Assumption-2 variance constant (worst case over x).
    C: float = 0.0
    name: str = "base"
    #: Q acts on every last-axis row on its own, so Q of a stack of
    #: tensors is the stack of their Qs (what ``empirical_C`` relies on)
    rowwise: ClassVar[bool] = False

    def compress(self, x: torch.Tensor, draws: Draws) -> Payload:
        raise NotImplementedError

    def decompress(self, payload: Payload, shape, dtype) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, x: torch.Tensor, draws: Draws) -> torch.Tensor:
        """Q(x): compress-then-decompress (the mathematical operator)."""
        return self.decompress(self.compress(x, draws), x.shape, x.dtype)

    def payload_bits(self, shape, dtype=torch.float32) -> int:
        """Exact number of wire bits for a tensor of ``shape``."""
        raise NotImplementedError


@registry.register_compressor("identity")
@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    """C = 0: no compression; draws nothing."""
    C: float = 0.0
    name: str = "identity"
    rowwise: ClassVar[bool] = True

    def compress(self, x, draws):
        return x

    def decompress(self, payload, shape, dtype):
        return payload

    def __call__(self, x, draws):
        return x

    def payload_bits(self, shape, dtype=torch.float32):
        return int(np.prod(shape, dtype=np.int64)) * dtype.itemsize * 8


@registry.register_compressor("qinf")
@dataclasses.dataclass(frozen=True)
class QInf(Compressor):
    """Paper eq. (21): unbiased b-bit quantization with inf-norm scaling,

        Q(x) = (||x||_inf 2^{-(b-1)} sign(x)) floor(2^{b-1}|x|/||x||_inf + u)

    applied to contiguous ``block``-wide blocks of the last axis; u ~ U[0,1)
    makes it unbiased."""
    bits: int = 2
    block: int = 256
    name: str = "qinf"
    rowwise: ClassVar[bool] = True

    @property
    def C(self) -> float:  # type: ignore[override]
        # each element errs by at most the scale ||x||_inf / 2^{b-1}, and
        # ||x||^2 >= ||x||_inf^2, so E||err||^2 <= (B / 4^{b-1}) ||x||^2
        return float(self.block) / (4.0 ** (self.bits - 1))

    def compress(self, x, draws):
        u = draws.uniform(kops.blockwise_shape(x.shape, self.block))
        codes, scales = kops.qinf_quantize_lastdim(
            x, u, bits=self.bits, block=self.block)
        return {"codes": codes, "scales": scales}

    def decompress(self, payload, shape, dtype):
        return kops.qinf_dequantize_lastdim(
            payload["codes"], payload["scales"], shape, dtype,
            block=self.block)

    def payload_bits(self, shape, dtype=torch.float32):
        # blocks count per last-dim row (what compress produces): b bits per
        # padded code plus one f32 scale per block
        shape = tuple(shape) or (1,)
        rows = int(np.prod(shape[:-1], dtype=np.int64)) if len(shape) > 1 \
            else 1
        nblocks = rows * -(-int(shape[-1]) // self.block)
        return nblocks * (self.block * self.bits + 32)


def _kept(frac: float, n: int) -> int:
    return max(1, int(round(frac * n)))


def _scatter(payload, shape, dtype) -> torch.Tensor:
    """A ``shape`` tensor of zeros with ``vals`` at the flat ``idx``."""
    n = int(np.prod(tuple(shape), dtype=np.int64))
    vals = payload["vals"]
    flat = torch.zeros((n,), dtype=dtype, device=vals.device)
    flat[payload["idx"]] = vals.to(dtype)
    return flat.reshape(tuple(shape))


@registry.register_compressor("randk")
@dataclasses.dataclass(frozen=True)
class RandK(Compressor):
    """Unbiased random-k sparsification: keep k = round(frac n) of the n
    coordinates (drawn with ``choice``), scaled by n / k."""
    frac: float = 0.1
    name: str = "randk"

    @property
    def C(self) -> float:  # type: ignore[override]
        return 1.0 / self.frac - 1.0

    def compress(self, x, draws):
        n = x.numel()
        k = _kept(self.frac, n)
        idx = draws.choice(n, k)
        return {"idx": idx, "vals": x.reshape(-1)[idx] * (n / k)}

    def decompress(self, payload, shape, dtype):
        return _scatter(payload, shape, dtype)

    def payload_bits(self, shape, dtype=torch.float32):
        # a value and a ceil(log2 n)-bit coordinate index per kept entry
        n = int(np.prod(tuple(shape), dtype=np.int64))
        idx_bits = max(1, int(np.ceil(np.log2(n)))) if n > 1 else 1
        return _kept(self.frac, n) * (32 + idx_bits)


@registry.register_compressor("topk")
@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Biased top-k by magnitude (not Assumption-2 compliant: Prox-LEAD and
    LEAD refuse it unless ``allow_biased=True``).  Draws nothing.  Of equal
    magnitudes the lower index is kept first, as ``jax.lax.top_k`` does in
    the reference: a stable descending sort, not ``torch.topk``, whose
    order among ties is unspecified (and differs)."""
    frac: float = 0.1
    name: str = "topk"

    @property
    def C(self) -> float:  # type: ignore[override]
        return 1.0 - self.frac  # contraction constant, NOT Assumption 2's C

    def compress(self, x, draws):
        flat = x.reshape(-1)
        order = torch.sort(flat.abs(), descending=True, stable=True).indices
        idx = order[:_kept(self.frac, flat.numel())]
        return {"idx": idx, "vals": flat[idx]}

    def decompress(self, payload, shape, dtype):
        return _scatter(payload, shape, dtype)

    def payload_bits(self, shape, dtype=torch.float32):
        n = int(np.prod(tuple(shape), dtype=np.int64))
        return _kept(self.frac, n) * (32 + 32)


def make_compressor(name: str, **kwargs) -> Compressor:
    """Build a registered compressor by name (strict)."""
    return registry.make("compressor", name, **kwargs)


def empirical_C(comp: Compressor, x: torch.Tensor, draws: Draws,
                trials: int = 64) -> float:
    """Monte-Carlo estimate of E||Q(x) - x||^2 / ||x||^2 over ``trials``
    draws.  A row-wise compressor (QInf) compresses the trials stacked on a
    leading axis in one call: one B1 and one B2 launch on the card; any
    other compressor is called once per trial, in trial order."""
    if comp.rowwise:
        xs = x.unsqueeze(0).expand((trials,) + tuple(x.shape)).contiguous()
        errs = ((comp(xs, draws) - xs) ** 2).reshape(trials, -1).sum(1)
    else:
        errs = torch.stack([((comp(x, draws) - x) ** 2).sum()
                            for _ in range(trials)])
    return float(errs.mean() / (x ** 2).sum())
