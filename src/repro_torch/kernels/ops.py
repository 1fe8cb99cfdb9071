"""Last-dim blockwise QInf over tensors of any rank, wire packing, and the
fused wire ops, on top of kernels B1-B4.

The port of ``repro.kernels.ops``: the last axis is cut into
``block``-wide blocks (zero-padded), leading axes pass through, and every
block is one row of the (R, block) kernels in
:mod:`repro_torch.kernels.quantize`.  The noise ``u`` is an input, drawn by
the caller with the shape :func:`blockwise_shape` gives, exactly as the
reference draws it.  A CUDA tensor goes through the kernels; a CPU tensor
through their plain versions.  On the card the quantizer pads nothing:
kernel B1 takes the leaf as it lies and reads its ragged last block in
place, the padding counting as zeros.

``pack_codes_lastdim`` / ``pack_codes`` turn int8 sign-magnitude codes into
the uint8 wire format of the per-leaf wire path (offset codes
``c + 2^{b-1}``, two to a byte for b <= 3 in PAIRS order: byte k = code 2k
| code 2k+1 << 4).  The fused ops ``qinf_quantize_pack`` /
``qinf_unpack_dequant_mix`` (kernels B3/B4) pack in HALVES order instead;
both orders carry the same bytes per block.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import quantize as qk
from repro_torch.kernels import ref


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
                          block: int = 256,
                          levels: Optional[torch.Tensor] = None):
    """Blockwise quantize along the last axis with noise ``u`` of shape
    ``blockwise_shape(x.shape, block)``.  Returns (codes int8
    (..., nb, block), scales f32 (..., nb, 1)).  ``levels`` (P,) f32: a
    level count for each of P grid points stacked on x's leading axis, in
    place of ``bits`` (see ``quantize.qinf_quantize_blocks``).

    A CUDA ``x`` goes to kernel B1 unpadded and uncast (f32, f64 and bf16
    are read as they are; another dtype is first cast to f32, as the plain
    path does): one launch, no pad and no reshape on the card.  Its last
    axis must have unit stride and its leading axes collapse to one row
    stride (any contiguous tensor does); the binding raises otherwise.  A
    ``meta`` ``x`` takes the same route, dry."""
    if x.is_cuda or x.is_meta:
        if u.shape[-1:] != (block,) or u.dim() != max(x.dim(), 1) + 1:
            raise ValueError(f"noise shape {tuple(u.shape)} != blocked shape "
                             f"{blockwise_shape(x.shape, block)}")
        if x.dtype not in qk._DTYPE_TAG:
            x = x.float()
        return qk.qinf_quantize_blocks(x, u, bits, levels)
    xb = blockwise_lastdim(x, block=block)
    if tuple(u.shape) != tuple(xb.shape):
        raise ValueError(f"noise shape {tuple(u.shape)} != blocked shape "
                         f"{tuple(xb.shape)}")
    codes, scales = qk.qinf_quantize_blocks(
        xb.reshape(-1, block), u.reshape(-1, block), bits, levels)
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


# ---------------------------------------------------------------------------
# Wire packing (per-leaf wire path): int8 codes -> uint8 payload.
# ---------------------------------------------------------------------------

def pack_codes_lastdim(codes: torch.Tensor, *, bits: int) -> torch.Tensor:
    """(..., B) int8 -> (..., B/2) uint8 in PAIRS order for bits <= 3;
    offset bytes (..., B) otherwise.  B must be even for bits <= 3."""
    u = (codes.to(torch.int16) + 2 ** (bits - 1)).to(torch.uint8)
    if ref.wire_bits_per_element(bits) == 4:
        pairs = u.reshape(*u.shape[:-1], u.shape[-1] // 2, 2)
        return pairs[..., 0] | (pairs[..., 1] << 4)
    return u


def unpack_codes_lastdim(packed: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes_lastdim` -> int8 codes."""
    offset = 2 ** (bits - 1)
    if ref.wire_bits_per_element(bits) == 4:
        lo = (packed & 0x0F).to(torch.int16)
        hi = ((packed >> 4) & 0x0F).to(torch.int16)
        inter = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)
    else:
        inter = packed.to(torch.int16)
    return (inter - offset).to(torch.int8)


def pack_codes(codes: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Flat packing: every code of ``codes`` (flattened) into a 1-D uint8
    payload, PAIRS order for bits <= 3 (an odd count pads one zero nibble)."""
    flat = (codes.to(torch.int16) + 2 ** (bits - 1)).to(torch.uint8
                                                        ).reshape(-1)
    if ref.wire_bits_per_element(bits) == 4:
        if flat.numel() % 2:
            flat = F.pad(flat, (0, 1))
        pairs = flat.reshape(-1, 2)
        return pairs[:, 0] | (pairs[:, 1] << 4)
    return flat


def unpack_codes(packed: torch.Tensor, *, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: uint8 payload -> int8 codes of
    length ``n``."""
    offset = 2 ** (bits - 1)
    if ref.wire_bits_per_element(bits) == 4:
        lo = (packed & 0x0F).to(torch.int16)
        hi = ((packed >> 4) & 0x0F).to(torch.int16)
        inter = torch.stack([lo, hi], dim=-1).reshape(-1)[:n]
    else:
        inter = packed.to(torch.int16)[:n]
    return (inter - offset).to(torch.int8)


# ---------------------------------------------------------------------------
# Fused wire-path ops (bucketed gossip backend): kernels B3 and B4.
# ---------------------------------------------------------------------------

def qinf_quantize_pack(xrows: torch.Tensor, urows: torch.Tensor, *,
                       bits: int, block: int):
    """Fused quantize + wire-pack of (R, block) f32 rows for any R (no row
    padding: the card's kernel has no row tile).  Returns (packed u8
    (R, W), scales f32 (R, 1)), W = ``packed_width(block, bits)``."""
    if xrows.shape[-1] != block:
        raise ValueError(f"rows of width {xrows.shape[-1]} != block {block}")
    return qk.qinf_quantize_pack_blocks(xrows, urows, bits)


def qinf_unpack_dequant_mix(packed: torch.Tensor, scales: torch.Tensor,
                            w: torch.Tensor, *, bits: int, block: int,
                            out_dtype=torch.float32):
    """Fused unpack + dequantize + weighted mix across the (1 + hops)
    payloads of one bucket group, for every node: packed (N, S, R, W) u8,
    scales (N, S, R, 1) f32, w (N, T, S) -> (mix (N, T, R, block), qself
    (N, R, block)) in ``out_dtype``, node n mixing with its own weights."""
    if qk.packed_width(block, bits) != packed.shape[-1]:
        raise ValueError(f"payload width {packed.shape[-1]} != packed width "
                         f"of block {block} at {bits} bits")
    return qk.qinf_unpack_dequant_mix_blocks(packed, scales, w, bits,
                                             out_dtype)
