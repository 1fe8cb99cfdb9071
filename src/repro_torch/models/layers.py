"""Shared model primitives: RMSNorm and LayerNorm, RoPE and sinusoidal
positions, GQA attention (causal, sliding-window, cross, a KV cache's valid
length, query chunking), SwiGLU and GELU MLPs, the KV-cache ring writes.

The port of ``repro.models.layers``: plain torch ops (the reference's
attention is plain jnp too, not a Pallas kernel), the same f32 islands
(norm statistics, RoPE, attention scores and softmax) and the same
layouts.  Tensors carry any leading dims -- the trainer's node dim
included: activations are (..., T, H, hd) or (..., T, D), and weights that
carry the node dim are broadcast by the caller.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
Q_CHUNK = 1024


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale in f32, cast back to x's dtype;
    ``scale`` broadcasts against x."""
    xf = x.to(F32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(F32)).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * scale + bias in f32 with the
    POPULATION variance (``jnp.var``), cast back to x's dtype."""
    xf = x.to(F32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale.to(F32)
            + bias.to(F32)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions (...,) -> (cos, sin) of shape (..., head_dim // 2), f32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                        device=positions.device) / head_dim))
    ang = positions.to(F32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate x (..., T, H, hd) by cos/sin (T, hd // 2).  The head dim is
    split into HALVES (x1 = first hd/2, x2 = second), not interleaved
    pairs, as the reference does."""
    xf = x.to(F32)
    x1, x2 = xf.chunk(2, dim=-1)
    cos, sin = cos[:, None, :], sin[:, None, :]       # over the heads
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(seq_len: int, dim: int, offset: int = 0) -> torch.Tensor:
    """(seq_len, dim) f32 sin/cos table (sin on even, cos on odd columns),
    computed in numpy as the reference computes it."""
    pos = np.arange(offset, offset + seq_len)[:, None]
    div = np.exp(-np.log(10000.0) * np.arange(0, dim, 2) / dim)
    pe = np.zeros((seq_len, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe)


@functools.lru_cache(maxsize=8)
def sinusoidal_pos_on(seq_len: int, dim: int, device: torch.device,
                      dtype: torch.dtype) -> torch.Tensor:
    """:func:`sinusoidal_pos` on ``device`` in ``dtype``, built once per
    (seq_len, dim, device, dtype): a forward uploads nothing from the host
    (a blocking copy that would stall the card's queue every step)."""
    return sinusoidal_pos(seq_len, dim).to(device=device, dtype=dtype)


def _mask(T: int, S: int, *, causal: bool, window: Optional[int],
          q_offset: int, kv_len: Optional[int], device) -> torch.Tensor:
    """(T, S) bool: True where query t (absolute position q_offset + t)
    may attend key s; keys at or past ``kv_len`` are never valid."""
    qpos = torch.arange(T, device=device)[:, None] + q_offset
    kpos = torch.arange(S, device=device)[None, :]
    ok = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    if kv_len is not None:
        ok &= kpos < kv_len
    return ok


def _attend(q, k, v, scale, ok):
    *lead, T, H, hd = q.shape
    KV = k.shape[-2]
    qg = q.reshape(*lead, T, KV, H // KV, hd)
    scores = torch.einsum("...tkgh,...skh->...kgts", qg, k).to(F32) * scale
    scores = scores.masked_fill(~ok, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("...kgts,...skh->...tkgh", probs, v)
    return out.reshape(*lead, T, H, hd)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, kv_len: Optional[int] = None,
              q_chunk: int = Q_CHUNK,
              softmax_scale: Optional[float] = None) -> torch.Tensor:
    """GQA dot-product attention in plain ops: q (..., T, H, hd), k and v
    (..., S, KV, hd) with H = KV * G -> (..., T, H, hd).  Scores and the
    softmax are f32; the probabilities return to q's dtype before the
    value product.  ``kv_len``: the number of valid cache entries (decode
    against a pre-allocated cache).  Queries go in chunks of ``q_chunk``
    (or, when T is not a multiple, the largest divisor of T that fits), so
    one (chunk x S) score tensor is live at a time."""
    T, hd = q.shape[-3], q.shape[-1]
    S = k.shape[-3]
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / math.sqrt(hd))

    def block(lo: int, n: int):
        ok = _mask(n, S, causal=causal, window=window, q_offset=q_offset + lo,
                   kv_len=kv_len, device=q.device)
        return _attend(q[..., lo:lo + n, :, :], k, v, scale, ok)

    if T <= q_chunk:
        return block(0, T)
    if T % q_chunk:
        q_chunk = max(d for d in range(1, q_chunk + 1) if T % d == 0)
        if q_chunk == 1:
            return block(0, T)
    return torch.cat([block(lo, q_chunk) for lo in range(0, T, q_chunk)],
                     dim=-3)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """Node-stacked SwiGLU: x (N, B, T, D), weights (N, D, F) / (N, F, D);
    each projection is one batched product over the N nodes."""
    g = torch.einsum("nbtd,ndf->nbtf", x, w_gate.to(x.dtype))
    u = torch.einsum("nbtd,ndf->nbtf", x, w_up.to(x.dtype))
    return torch.einsum("nbtf,nfd->nbtd", F.silu(g) * u, w_down.to(x.dtype))


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """Node-stacked GELU MLP with biases (whisper): the TANH approximation
    of GELU, which ``jax.nn.gelu`` computes by default."""
    h = (torch.einsum("nbtd,ndf->nbtf", x, w_in.to(x.dtype))
         + b_in.to(x.dtype)[:, None, None])
    h = F.gelu(h, approximate="tanh")
    return (torch.einsum("nbtf,nfd->nbtd", h, w_out.to(x.dtype))
            + b_out.to(x.dtype)[:, None, None])


def cache_write(cache: torch.Tensor, new: torch.Tensor, first_pos: int
                ) -> torch.Tensor:
    """A copy of ``cache`` (..., S_c, KV, hd) with ``new`` (..., t, KV, hd)
    written at the ring slots of absolute positions first_pos ..
    first_pos + t - 1, i.e. slot ``p % S_c``; of a run longer than the ring
    only the last S_c positions are kept.  For t <= S_c starting at 0 this
    is the reference's ``cache_update`` at 0; past the ring it is what
    decode's ``pos % S_c`` writes expect (ROADMAP C11)."""
    S_c, t = cache.shape[-3], new.shape[-3]
    keep = min(t, S_c)
    pos = torch.arange(first_pos + t - keep, first_pos + t,
                       device=cache.device)
    return cache.index_copy(cache.dim() - 3, pos % S_c,
                            new[..., t - keep:, :, :].to(cache.dtype))
