"""Unbiased compression operators (paper Assumption 2): Identity and QInf.

Every compressor Q satisfies E[Q(x)] = x and E||Q(x) - x||^2 <= C ||x||^2.
``compress`` returns the payload that would go on the wire (int8 codes and
one f32 scale per block for QInf), ``decompress`` the float estimate.

QInf blocks the LAST axis of any tensor (``kernels.ops``), draws its
stochastic-rounding noise from the draw source with the blocked shape, and
quantizes every block with kernel B1 (on the card) or its plain version
(on the CPU); ``decompress`` is kernel B2.  The reference reaches its
Pallas kernel only for (R, block) tensors and the same math in jnp
otherwise; here every shape goes through the kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any

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


def make_compressor(name: str, **kwargs) -> Compressor:
    """Build a registered compressor by name (strict)."""
    return registry.make("compressor", name, **kwargs)
