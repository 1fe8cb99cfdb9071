"""Shared model primitives for the dense family: RMSNorm, RoPE, GQA
attention, SwiGLU.

The port of the dense half of ``repro.models.layers``: plain torch ops (the
reference's attention is plain jnp too, not a Pallas kernel), the same f32
islands (norm statistics, RoPE, attention scores and softmax) and the same
layouts.  Tensors carry any leading dims -- the trainer's node dim
included: activations are (..., T, H, hd) or (..., T, D), and weights that
carry the node dim are broadcast by the caller.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

F32 = torch.float32


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale in f32, cast back to x's dtype;
    ``scale`` broadcasts against x."""
    xf = x.to(F32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(F32)).to(x.dtype)


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


def _mask(T: int, S: int, *, causal: bool, window: Optional[int],
          q_offset: int, device) -> torch.Tensor:
    """(T, S) bool: True where query t (absolute position q_offset + t)
    may attend key s."""
    qpos = torch.arange(T, device=device)[:, None] + q_offset
    kpos = torch.arange(S, device=device)[None, :]
    ok = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return ok


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0,
              softmax_scale: Optional[float] = None) -> torch.Tensor:
    """GQA dot-product attention in plain ops: q (..., T, H, hd), k and v
    (..., S, KV, hd) with H = KV * G -> (..., T, H, hd).  Scores and the
    softmax are f32; the probabilities return to q's dtype before the
    value product."""
    *lead, T, H, hd = q.shape
    S, KV = k.shape[-3], k.shape[-2]
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / math.sqrt(hd))
    qg = q.reshape(*lead, T, KV, H // KV, hd)
    scores = torch.einsum("...tkgh,...skh->...kgts", qg, k).to(F32) * scale
    ok = _mask(T, S, causal=causal, window=window, q_offset=q_offset,
               device=q.device)
    scores = scores.masked_fill(~ok, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("...kgts,...skh->...tkgh", probs, v)
    return out.reshape(*lead, T, H, hd)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """Node-stacked SwiGLU: x (N, B, T, D), weights (N, D, F) / (N, F, D);
    each projection is one batched product over the N nodes."""
    g = torch.einsum("nbtd,ndf->nbtf", x, w_gate.to(x.dtype))
    u = torch.einsum("nbtd,ndf->nbtf", x, w_up.to(x.dtype))
    return torch.einsum("nbtf,nfd->nbtd", F.silu(g) * u, w_down.to(x.dtype))
