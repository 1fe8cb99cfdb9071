"""Plain PyTorch layers the reference models share.

Written from the published descriptions, one node at a time, with no
kernel, cache or batching of the program: activations are (B, T, D), a
node's parameters carry no node dim.  Every matrix product goes through
a :class:`Precision`, so the same model runs in float32 (TF32 off) and,
as the benchmark's control, with TF32 operands.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to the nearest TF32 value (10 mantissa bits,
    ties away from zero, as the tensor cores' operand conversion)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(F32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32 and f32 accumulation, in
    the forward and in both products of the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        return (torch.matmul(rg, rb.transpose(-1, -2)),
                torch.matmul(ra.transpose(-1, -2), rg))


class Precision:
    """How the reference multiplies matrices: ``"f32"`` (TF32 off) or
    ``"tf32"`` (the control)."""

    def __init__(self, name: str = "f32") -> None:
        if name not in ("f32", "tf32"):
            raise ValueError(f"unknown precision {name!r}; have f32, tf32")
        self.name = name

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., m, k) @ b (..., k, n); both operands have the same
        leading dims, or b is a (k, n) matrix and a is flattened to 2-D
        around it."""
        if b.dim() == 2 and a.dim() > 2:
            lead = a.shape[:-1]
            return self.mm(a.reshape(-1, a.shape[-1]), b).reshape(
                *lead, b.shape[-1])
        if self.name == "tf32":
            return _TF32MatMul.apply(a, b)
        return torch.matmul(a, b)


def linear(prec: Precision, x, w, b=None):
    out = prec.mm(x, w)
    return out if b is None else out + b


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    """x / sqrt(mean(x^2) + eps) * scale (Zhang and Sennrich, 2019)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * scale + bias, population variance
    (Ba et al., 2016)."""
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions (Su et al., 2021) on x (B, T, H, hd), positions 0
    .. T-1, the head dim split in halves (the GPT-NeoX / Llama layout):
    pair (i, i + hd/2) rotates by angle p / theta^(2i / hd)."""
    T, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32,
                                        device=x.device) / hd))
    ang = torch.arange(T, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def sinusoids(length: int, dim: int, device) -> torch.Tensor:
    """(length, dim) positions of Vaswani et al. (2017): sin on the even
    columns, cos on the odd, frequencies 10000^(-2i / dim)."""
    pos = np.arange(length)[:, None]
    div = np.exp(-np.log(10000.0) * np.arange(0, dim, 2) / dim)
    pe = np.zeros((length, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(pe).to(device)


def attention(prec: Precision, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled dot-product attention: q (B, T, H, hd), k and v (B, S, KV,
    hd), query head h reading KV head h // (H / KV) -> (B, T, H hd)."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, ., hd)
    scores = prec.mm(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        mask = torch.ones(T, S, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(mask, float("-inf"))
    out = prec.mm(torch.softmax(scores, -1), vh)          # (B, H, T, hd)
    return out.transpose(1, 2).reshape(B, T, H * hd)


def swiglu(prec: Precision, x, w_gate, w_up, w_down):
    """SiLU(x W_gate) * (x W_up) W_down (Shazeer, 2020)."""
    return prec.mm(F.silu(prec.mm(x, w_gate)) * prec.mm(x, w_up), w_down)


def gelu_mlp(prec: Precision, x, w_in, b_in, w_out, b_out,
             approximate: str = "tanh"):
    """GELU(x W_in + b_in) W_out + b_out."""
    h = F.gelu(linear(prec, x, w_in, b_in), approximate=approximate)
    return linear(prec, h, w_out, b_out)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean next-token cross entropy over every position."""
    lse = torch.logsumexp(logits, -1)
    picked = logits.gather(-1, labels[..., None])[..., 0]
    return (lse - picked).mean()


def padded(n: int, to: int) -> int:
    return -(-n // to) * to


def normal_leaf(shape, fan: Optional[int] = None):
    """A leaf drawn N(0, 1 / fan), fan the input width (the second-last
    dim, or the last for a vector or a table of embeddings)."""
    if fan is None:
        fan = shape[-2] if len(shape) >= 2 else shape[-1]
    return {"shape": tuple(int(s) for s in shape), "kind": "normal",
            "fan": int(fan)}


def ones_leaf(shape):
    return {"shape": tuple(int(s) for s in shape), "kind": "ones"}


def zeros_leaf(shape):
    return {"shape": tuple(int(s) for s in shape), "kind": "zeros"}
