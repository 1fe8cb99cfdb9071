"""The dense decoder family (llama-style: GQA, RoPE, SwiGLU; the qk_norm
and qkv-bias variants cover qwen3, qwen2, phi4 and yi) in train mode.

The port of the dense half of ``repro.models.transformer``.  Parameters
are a nested dict in the reference's layout (layers stacked on a leading L
dim), so the sorted-key leaf order of :mod:`repro_torch.tree` is the
reference's ``tree_flatten`` order -- the order that fixes the bucket
layout and the per-leaf noise draws.

The trainer holds N node replicas stacked on a leading node dim, so every
entry point here takes node-stacked parameters ((N, ...) leaves) and
batches ((N, B, T) tokens) and writes the node dim out: each projection is
one batched product over the N nodes (``einsum("nbtd,ndk->nbtk")``).  The
layer stack is a Python loop over the L dim.  The other families (moe,
vlm, encdec, ssm, hybrid) and decoding with caches raise naming the slice
that brings them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.models import layers as L

F32 = torch.float32

#: families of the reference that a later slice of the port brings
LATER_FAMILIES = {
    fam: "slice 5b (ROADMAP A15: the moe, vlm, encdec, ssm and hybrid "
         "families, decode and serving)"
    for fam in ("moe", "vlm", "encdec", "ssm", "hybrid")}


def refuse_family(family: str) -> None:
    if family in LATER_FAMILIES:
        raise NotImplementedError(
            f"model family {family!r} is not ported yet; it arrives with "
            f"{LATER_FAMILIES[family]}")
    if family != "dense":
        raise ValueError(f"unknown model family {family!r}")


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Field for field the reference's ModelConfig; only the dense family
    builds here."""
    name: str
    family: str                  # dense | moe | vlm | encdec | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0
    rope_theta: float = 1e4
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    cross_attn_every: int = 0
    n_vision_tokens: int = 1601
    n_enc_layers: int = 0
    max_source_positions: int = 1500
    max_target_positions: int = 448
    decode_cache_cap: Optional[int] = None
    block_pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    conv_width: int = 4
    local_window: int = 2048
    rwkv_head_size: int = 64
    norm: str = "rmsnorm"
    act: str = "swiglu"
    dtype: Any = torch.float32
    citation: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // 256) * 256

    def reduced(self, n_layers=2, d_model=256, n_experts=4) -> "ModelConfig":
        """Smoke-test variant: same family/wiring, tiny dims (the
        reference's rule)."""
        hd = 32
        heads = max(2, d_model // 64)
        kv = max(1, min(self.n_kv_heads, heads) * heads // self.n_heads) \
            if self.n_heads else 1
        kw: Dict[str, Any] = dict(
            name=self.name + "-smoke", n_layers=n_layers, d_model=d_model,
            n_heads=heads, n_kv_heads=max(1, kv), head_dim=hd,
            d_ff=d_model * 2, vocab=512)
        if self.family == "moe":
            kw.update(n_experts=min(n_experts, self.n_experts),
                      top_k=min(self.top_k, 2),
                      n_shared_experts=min(self.n_shared_experts, 1))
        if self.family == "vlm":
            kw.update(cross_attn_every=2, n_vision_tokens=8)
        if self.family == "encdec":
            kw.update(n_enc_layers=n_layers, max_source_positions=64,
                      max_target_positions=64)
        if self.family == "hybrid":
            kw.update(n_layers=max(n_layers, 3),
                      block_pattern=("rec", "rec", "attn"),
                      lru_width=d_model, local_window=16)
        if self.family == "ssm":
            kw.update(rwkv_head_size=32)
        if self.sliding_window is not None:
            kw.update(sliding_window=16)
        return dataclasses.replace(self, **{k: v for k, v in kw.items()
                                            if hasattr(self, k)})

    def param_count(self) -> int:
        return sum(int(np.prod(t.shape)) for t in
                   tree.leaves(param_template(self)))


# ---------------------------------------------------------------------------
# Parameter templates (shared by abstract/init)
# ---------------------------------------------------------------------------

class ParamT:
    __slots__ = ("shape", "kind", "fan")

    def __init__(self, shape, kind="normal", fan=None):
        self.shape = tuple(int(s) for s in shape)
        self.kind = kind
        self.fan = fan or (self.shape[-2] if len(self.shape) >= 2
                           else self.shape[-1])


def _attn_template(cfg: ModelConfig, Ls: int) -> Dict[str, ParamT]:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t: Dict[str, ParamT] = {
        "ln1": ParamT((Ls, D), "ones"),
        "wq": ParamT((Ls, D, H * hd)),
        "wk": ParamT((Ls, D, KV * hd)),
        "wv": ParamT((Ls, D, KV * hd)),
        "wo": ParamT((Ls, H * hd, D), fan=H * hd),
    }
    if cfg.qkv_bias:
        t.update({"wq_b": ParamT((Ls, H * hd), "zeros"),
                  "wk_b": ParamT((Ls, KV * hd), "zeros"),
                  "wv_b": ParamT((Ls, KV * hd), "zeros"),
                  "wo_b": ParamT((Ls, D), "zeros")})
    if cfg.qk_norm:
        t.update({"q_norm": ParamT((Ls, hd), "ones"),
                  "k_norm": ParamT((Ls, hd), "ones")})
    return t


def _mlp_template(cfg: ModelConfig, Ls: int) -> Dict[str, ParamT]:
    D, F = cfg.d_model, cfg.d_ff
    return {"ln2": ParamT((Ls, D), "ones"),
            "w_gate": ParamT((Ls, D, F)), "w_up": ParamT((Ls, D, F)),
            "w_down": ParamT((Ls, F, D), fan=F)}


def param_template(cfg: ModelConfig):
    refuse_family(cfg.family)
    if cfg.norm != "rmsnorm" or cfg.act != "swiglu":
        raise ValueError(f"the dense family runs rmsnorm + swiglu, got "
                         f"{cfg.norm} + {cfg.act}")
    Vp, D = cfg.padded_vocab, cfg.d_model
    blk = _attn_template(cfg, cfg.n_layers)
    blk.update(_mlp_template(cfg, cfg.n_layers))
    return {"embed": ParamT((Vp, D), fan=D),
            "final_norm": ParamT((D,), "ones"),
            "lm_head": ParamT((D, Vp)),
            "blocks": blk}


def abstract_params(cfg: ModelConfig):
    """The parameter tree as ``meta`` tensors: shapes and dtypes, no
    memory."""
    return tree.tree_map(
        lambda t: torch.empty(t.shape, dtype=cfg.dtype, device="meta"),
        param_template(cfg))


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Ones, zeros, or N(0, 1/fan) normals drawn from ``generator`` (on its
    device unless ``device`` is given) in leaf order, cast to cfg.dtype."""
    device = torch.device(device) if device is not None else \
        generator.device

    def one(t: ParamT):
        if t.kind == "ones":
            return torch.ones(t.shape, dtype=cfg.dtype, device=device)
        if t.kind == "zeros":
            return torch.zeros(t.shape, dtype=cfg.dtype, device=device)
        std = 1.0 / math.sqrt(t.fan)
        return (torch.randn(t.shape, generator=generator, dtype=F32,
                            device=device) * std).to(cfg.dtype)

    return tree.tree_map(one, param_template(cfg))


# ---------------------------------------------------------------------------
# Blocks (node-stacked: x (N, B, T, D), parameters (N, ...))
# ---------------------------------------------------------------------------

def _bc(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A node-stacked parameter (N, *tail) viewed to broadcast against
    x (N, ..., *tail)."""
    return p.reshape((p.shape[0],) + (1,) * (x.dim() - p.dim())
                     + tuple(p.shape[1:]))


def _proj(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = torch.einsum("nbtd,ndk->nbtk", x, w.to(x.dtype))
    if b is not None:
        out = out + _bc(b.to(x.dtype), out)
    return out


def attn_block(cfg: ModelConfig, p, x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """One causal self-attention sub-block (pre-norm; the caller adds the
    residual): q_norm and k_norm (qk_norm configs) before RoPE."""
    N, B, T, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xn = L.rmsnorm(x, _bc(p["ln1"], x))
    q = _proj(xn, p["wq"], p.get("wq_b")).reshape(N, B, T, H, hd)
    k = _proj(xn, p["wk"], p.get("wk_b")).reshape(N, B, T, KV, hd)
    v = _proj(xn, p["wv"], p.get("wv_b")).reshape(N, B, T, KV, hd)
    if "q_norm" in p:
        q = L.rmsnorm(q, _bc(p["q_norm"], q))
    if "k_norm" in p:
        k = L.rmsnorm(k, _bc(p["k_norm"], k))
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    out = L.attention(q, k, v, causal=True, window=cfg.sliding_window)
    return _proj(out.reshape(N, B, T, H * hd), p["wo"], p.get("wo_b"))


def mlp_block(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    xn = L.rmsnorm(x, _bc(p["ln2"], x))
    return L.swiglu(xn, p["w_gate"], p["w_up"], p["w_down"])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """tokens (N, B, T) -> (N, B, T, D): node n looks up its own table."""
    emb = params["embed"].to(cfg.dtype)
    node = torch.arange(emb.shape[0], device=tokens.device)[:, None, None]
    return emb[node, tokens]


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    xn = L.rmsnorm(x, _bc(params["final_norm"], x))
    return torch.einsum("nbtd,ndv->nbtv", xn, params["lm_head"].to(x.dtype))


def forward(cfg: ModelConfig, params, batch, *, mode: str = "train"):
    """Node-stacked forward -> (logits (N, B, T, Vp), cache (None),
    aux loss (0.0)), the reference's return triple."""
    refuse_family(cfg.family)
    if mode != "train":
        raise NotImplementedError(
            f"mode {mode!r} (KV caches, decoding) is not ported yet; it "
            f"arrives with {LATER_FAMILIES['moe']}")
    tokens = batch["tokens"]
    T = tokens.shape[-1]
    x = embed_tokens(cfg, params, tokens)
    cos, sin = L.rope_freqs(cfg.hd, cfg.rope_theta,
                            torch.arange(T, device=tokens.device))
    blocks = params["blocks"]
    for layer in range(cfg.n_layers):
        p = {name: leaf[:, layer] for name, leaf in blocks.items()}
        x = x + attn_block(cfg, p, x, cos, sin)
        x = x + mlp_block(cfg, p, x)
    return lm_logits(cfg, params, x), None, 0.0


def loss_fn(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor
            ) -> torch.Tensor:
    """Mean next-token cross entropy per node: logits (N, B, T, V), labels
    (N, B, T) -> (N,).  logsumexp minus the label's logit, in f32."""
    lf = logits.to(F32)
    lse = torch.logsumexp(lf, dim=-1)
    correct = lf.gather(-1, labels[..., None].to(torch.int64))[..., 0]
    return (lse - correct).reshape(lf.shape[0], -1).mean(dim=1)
