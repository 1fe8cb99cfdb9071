"""Plain PyTorch versions of every kernel function of the JAX package.

Op for op the math of ``repro.kernels.ref`` (and of the Pallas kernels it
validates): each product, quotient and sum is one IEEE f32 operation in the
reference's order, so codes and scales agree bit for bit given the same
``x`` and noise ``u``.  The CPU path of the port runs these; on the card
they are what each hand-written kernel is held against.
"""
from __future__ import annotations

import torch


def wire_bits_per_element(bits: int) -> int:
    """(b+1)-bit offset codes, rounded up to nibble/byte packing."""
    return 4 if bits + 1 <= 4 else 8


def levels_per_row(levels: torch.Tensor, rows: int) -> torch.Tensor:
    """A grid's (P,) level counts -> (rows, 1) f32, P equal runs of rows
    (run p at ``levels[p]``).  Each value must be 2^{b-1} for bits b in
    1..8, and P must divide ``rows``."""
    P = levels.numel()
    if levels.dim() != 1 or P < 1 or rows % P:
        raise ValueError(f"levels {tuple(levels.shape)} must be (P,) with P "
                         f"dividing the {rows} rows")
    if levels.dtype != torch.float32:
        raise TypeError(f"levels must be f32, got {levels.dtype}")
    ok = (levels >= 1) & (levels <= 128) & (torch.frexp(levels).mantissa
                                            == 0.5)
    if not bool(ok.all()):
        raise ValueError(f"levels {levels.tolist()} are not all powers of "
                         f"two in [1, 128] (2^(bits-1) for bits 1..8)")
    return levels.repeat_interleave(rows // P)[:, None]


def qinf_quantize_blocks_ref(xb: torch.Tensor, ub: torch.Tensor,
                             bits: int = 2, levels: torch.Tensor = None):
    """Quantize rows of ``xb`` (R, B): one quantization block per row.

    Paper eq. (21) with inf-norm scaling:
        code  = sign(x) * min(floor(2^{b-1} |x| / ||x||_inf + u), 2^{b-1})
        scale = ||x||_inf / 2^{b-1}

    Returns (codes int8 (R, B), scales f32 (R, 1)).  All-zero rows give
    scale 0 and codes 0.  ``ub`` is U[0,1) noise of the same shape.  At 8
    bits the code +128 saturates to +127 (the reference's int8 cast).
    ``levels`` (R, 1) f32 gives each row its own level count 2^{b-1} in
    place of ``bits`` (:func:`levels_per_row`): the same operations, the
    per-point B1 of a stacked grid."""
    xf = xb.to(torch.float32)
    if levels is None:
        levels = torch.tensor(float(2 ** (bits - 1)), dtype=torch.float32,
                              device=xf.device)
    maxabs = xf.abs().amax(dim=-1, keepdim=True)
    safe = torch.where(maxabs > 0, maxabs, torch.ones_like(maxabs))
    mag = torch.floor(levels * xf.abs() / safe + ub.to(torch.float32))
    mag = torch.minimum(mag, levels)       # guard u == 1.0 - eps
    codes = torch.clamp(torch.sign(xf) * mag, max=127.0).to(torch.int8)
    scales = maxabs / levels
    return codes, scales


def qinf_dequantize_blocks_ref(codes: torch.Tensor, scales: torch.Tensor,
                               out_dtype=torch.float32) -> torch.Tensor:
    """codes (R, B) * scales (R, 1), in f32, cast to ``out_dtype``."""
    return (codes.to(torch.float32) * scales.to(torch.float32)).to(out_dtype)


# ---------------------------------------------------------------------------
# Wire-path versions (HALVES packing: byte k of a block holds code k in the
# low nibble and code k + B/2 in the high nibble, for bits <= 3).
# ---------------------------------------------------------------------------

def pack_codes_halves_ref(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., B) int codes -> (..., B/2) uint8 for bits <= 3; plain offset
    bytes otherwise."""
    enc = codes.to(torch.int32) + 2 ** (bits - 1)
    if wire_bits_per_element(bits) == 4:
        half = enc.shape[-1] // 2
        return (enc[..., :half] | (enc[..., half:] << 4)).to(torch.uint8)
    return enc.to(torch.uint8)


def unpack_codes_halves_ref(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes_halves_ref` -> int8 codes (..., B)."""
    offset = 2 ** (bits - 1)
    p = packed.to(torch.int32)
    if wire_bits_per_element(bits) == 4:
        lo = (p & 0x0F) - offset
        hi = ((p >> 4) & 0x0F) - offset
        codes = torch.cat([lo, hi], dim=-1)
    else:
        codes = p - offset
    return codes.to(torch.int8)


def qinf_quantize_pack_blocks_ref(xb: torch.Tensor, ub: torch.Tensor,
                                  bits: int):
    """Quantize + wire-pack: (R, B) rows -> (packed uint8 (R, W), scales
    f32 (R, 1)) with W = B/2 for bits <= 3 else B."""
    codes, scales = qinf_quantize_blocks_ref(xb, ub, bits)
    return pack_codes_halves_ref(codes, bits), scales


def weighted_mix_ref(w: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """out[n, t] = sum_s w[n, t, s] * q[s, n] in f32, accumulated in sender
    order: out = w[:, :, 0] q[0], then out = out + w[:, :, s] q[s] for
    s = 1..S-1, each product and sum one rounded f32 operation (what kernel
    B4 computes).  ``w`` (N, T, S), ``q`` (S, N, ...) -> (N, T, ...)."""
    w = w.to(torch.float32)
    N, T, S = w.shape
    bshape = (N, T) + (1,) * (q.dim() - 2)
    out = None
    for s in range(S):
        term = w[:, :, s].reshape(bshape) * q[s].to(torch.float32)[:, None]
        out = term if out is None else out + term
    return out


def qinf_unpack_dequant_mix_blocks_ref(packed: torch.Tensor,
                                       scales: torch.Tensor,
                                       w: torch.Tensor, bits: int,
                                       out_dtype=torch.float32):
    """Unpack + dequantize + weighted mix across senders, per node.

    ``packed`` (N, S, R, W) uint8 (sender 0 is self), ``scales``
    (N, S, R, 1) f32, ``w`` (N, T, S).  Returns (mix (N, T, R, B), qself
    (N, R, B)) in ``out_dtype``; each Q_s rounds through ``out_dtype``
    before the f32 accumulation.  One sender is decoded at a time, so the
    plain version never holds all S dequantized payloads."""
    w = w.to(torch.float32)
    N, T, S = w.shape
    mix = qself = None
    for s in range(S):
        q = (unpack_codes_halves_ref(packed[:, s], bits).to(torch.float32)
             * scales[:, s].to(torch.float32))
        q = q.to(out_dtype).to(torch.float32)               # (N, R, B)
        if s == 0:
            qself = q.to(out_dtype)
        term = w[:, :, s, None, None] * q[:, None]
        mix = term if mix is None else mix + term
        del q, term
    return mix.to(out_dtype), qself
