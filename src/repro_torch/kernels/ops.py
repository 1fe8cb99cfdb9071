"""Last-dim blockwise QInf over tensors of any rank, on top of B1/B2.

The port of the rank-generic half of ``repro.kernels.ops``: the last axis
is cut into ``block``-wide blocks (zero-padded), leading axes pass through,
and every block is one row of the (R, block) kernels in
:mod:`repro_torch.kernels.quantize`.  The noise ``u`` is an input, drawn by
the caller with the shape :func:`blockwise_shape` gives, exactly as the
reference draws it.  A CUDA tensor goes through the kernels; a CPU tensor
through their plain versions.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import quantize as qk


def blockwise_shape(shape: Sequence[int], block: int) -> Tuple[int, ...]:
    """(..., D) -> (..., ceil(D / block), block); a scalar counts as (1,)."""
    shape = tuple(int(s) for s in shape) or (1,)
    return shape[:-1] + (-(-shape[-1] // block), block)


def blockwise_lastdim(x: torch.Tensor, *, block: int) -> torch.Tensor:
    """(..., D) -> (..., nb, block) f32, zero-padded along the last axis."""
    if x.dim() == 0:
        x = x[None]
    pad = -x.shape[-1] % block
    xf = x.to(torch.float32)
    if pad:
        xf = F.pad(xf, (0, pad))
    return xf.reshape(blockwise_shape(x.shape, block))


def qinf_quantize_lastdim(x: torch.Tensor, u: torch.Tensor, *, bits: int = 2,
                          block: int = 256):
    """Blockwise quantize along the last axis with noise ``u`` of shape
    ``blockwise_shape(x.shape, block)``.  Returns (codes int8
    (..., nb, block), scales f32 (..., nb, 1))."""
    xb = blockwise_lastdim(x, block=block)
    if tuple(u.shape) != tuple(xb.shape):
        raise ValueError(f"noise shape {tuple(u.shape)} != blocked shape "
                         f"{tuple(xb.shape)}")
    codes, scales = qk.qinf_quantize_blocks(
        xb.reshape(-1, block), u.reshape(-1, block), bits)
    return (codes.reshape(xb.shape),
            scales.reshape(*xb.shape[:-1], 1))


def qinf_dequantize_lastdim(codes: torch.Tensor, scales: torch.Tensor, shape,
                            dtype, *, block: int = 256) -> torch.Tensor:
    """Inverse of :func:`qinf_quantize_lastdim` -> a ``shape`` tensor of
    ``dtype``; padded tail elements are dropped."""
    shape = tuple(int(s) for s in shape)
    direct = dtype in (torch.float32, torch.float64, torch.bfloat16)
    xb = qk.qinf_dequantize_blocks(
        codes.reshape(-1, block), scales.reshape(-1, 1),
        dtype if direct else torch.float32)
    D = shape[-1] if shape else 1
    flat = xb.reshape(*codes.shape[:-2], codes.shape[-2] * block)
    out = flat[..., :D].reshape(shape)
    return out if direct else out.to(dtype)
