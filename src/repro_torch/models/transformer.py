"""Model zoo: config, parameters, and forwards for the six families.

The port of ``repro.models.transformer``.  Families:

  dense  -- llama-style decoder (GQA, RoPE, SwiGLU; the qk_norm, qkv-bias
            and sliding-window variants cover qwen3, qwen2, phi4 and yi)
  moe    -- the dense skeleton with MoE FF layers (mixtral, deepseek-moe;
            :mod:`repro_torch.models.moe`).  By default every layer is
            MoE with the capacity path, as the reference; DeepSeekMoE's
            published layout is ``first_k_dense`` leading dense SwiGLU
            layers of width ``dense_d_ff`` (the ``dense_blocks`` group),
            then MoE layers on the expert-share path (``moe_dropless``:
            ``n_experts_held`` experts from ``expert_offset`` of the
            router's ``n_experts``, DeepSeekMoE's gates and sequence-wise
            balance loss, weighted by the trainer's ``aux_weight``)
  vlm    -- the dense skeleton with a gated cross-attention layer every
            ``cross_attn_every``-th layer (llama-3.2-vision); vision
            embeddings arrive pre-projected (the encoder is a stub)
  encdec -- whisper: encoder (full attention, sinusoidal positions) and
            decoder (causal self + cross attention, learned positions);
            the conv/mel frontend is a stub, frames arrive as embeddings
  ssm    -- rwkv6 (:mod:`repro_torch.models.rwkv6`)
  hybrid -- recurrentgemma (:mod:`repro_torch.models.rglru`)

Parameters are a nested dict in the reference's layout (layers stacked on
a leading L dim), so the sorted-key leaf order of :mod:`repro_torch.tree`
is the reference's ``tree_flatten`` order -- the order that fixes the
bucket layout and the per-leaf noise draws.

Every entry point takes NODE-STACKED parameters ((N, ...) leaves), batches
((N, B, T) tokens) and caches ((N, ...) leaves) and writes the node dim
out: each projection is one batched product over the N nodes
(``einsum("nbtd,ndk->nbtk")``).  The trainer stacks its N replicas;
serving is a stack of one node.  The layer stack is a Python loop over the
L dim.

Modes: ``train`` (no cache), ``prefill`` (a teacher-forced pass that also
fills a pre-allocated cache) and ``decode`` (one token against the cache
at absolute position ``pos``).  A self-attention cache is a ring of S_c
slots (S_c = the sliding window where there is one); position p lives in
slot p % S_c, in prefill as in decode (ROADMAP C11: the reference's
prefill stores the last S_c keys at slots 0..S_c-1 instead, which decode's
ring writes agree with only when T <= S_c or T % S_c == 0).

Tensor parallelism.  Every entry point takes a ``tp`` seam
(``repro_torch.models.tp``; default ``NO_TP``, M = 1).  At M > 1 the
leading dim holds rank-rows, each a node's model shard (sharded leaves
model-local, replicated leaves whole), and the products split: attention
on a rank's heads (``wq``/``wk``/``wv`` and their biases column-parallel,
``wo`` row-parallel, ``wo_b`` added once after ``reduce_out``), the MLPs
and MoE experts column- then row-parallel, the embeddings vocab-parallel
(a masked local lookup, then ``reduce_out``), ``lm_logits``
column-parallel over the vocabulary, and :func:`loss_fn` a vocab-parallel
cross entropy; RWKV-6 and the RG-LRU split as their modules say.  The
norms and the residual stream stay replicated; ``copy_in`` sits after
each norm, at the inputs of the column-parallel products.  The rules
shard the flattened ``H hd`` and ``KV hd`` columns, not whole heads:
where a rank's columns cut a head, q, k and v are gathered to whole heads
(RoPE pairs (i, i + hd/2), ``q_norm``/``k_norm`` and the scores need a
whole head) and the rank computes the heads its ``wo`` rows read, then
keeps its columns; where its query heads are whole but its KV columns are
not (K < M), only k and v are gathered.  A rank keeps the KV heads its
query heads read (:func:`_head_plan`), and so does its cache in modes
``prefill`` and ``decode`` (:func:`init_cache` with ``tp``;
``repro_torch.convert.cache_to_rank_rows`` cuts a whole node's): one
KV slot per block of its query heads that read one KV head, so where its
heads straddle KV groups a rank holds more than KV / M heads (Megatron
replicates KV heads where K < M too).  A decode's logits are a rank's
(..., Vp / M) columns (``tp.gather_last`` joins them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import tp as tp_mod
from repro_torch.models.tp import NO_TP

F32 = torch.float32
FAMILIES = ("dense", "moe", "vlm", "encdec", "ssm", "hybrid")
MODES = ("train", "prefill", "decode")


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Field for field the reference's ModelConfig."""
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
    # the port's own MoE options (none in the reference; the defaults are
    # its layout): leading dense layers and their width (0: d_ff), the
    # experts held (0: all n_experts) from expert_offset, and the dropless
    # expert-share path with DeepSeekMoE's gates and balance loss
    first_k_dense: int = 0
    dense_d_ff: int = 0
    n_experts_held: int = 0
    expert_offset: int = 0
    moe_dropless: bool = False
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
    def held_experts(self) -> int:
        return self.n_experts_held or self.n_experts

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // 256) * 256

    @property
    def sub_quadratic(self) -> bool:
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

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

    def param_count(self, active_only: bool = False) -> int:
        """Parameters of one replica; ``active_only`` counts a routed
        expert's weights at top_k / n_experts (the reference's rule)."""
        total = 0
        for path, t in _iter_template(param_template(self)):
            n = int(np.prod(t.shape))
            if active_only and "experts_" in path and self.n_experts:
                n = int(n * (self.top_k / self.n_experts))
            total += n
        return total


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


def _iter_template(tpl, prefix=""):
    if isinstance(tpl, dict):
        for k, v in tpl.items():
            yield from _iter_template(v, prefix + "/" + k)
    else:
        yield prefix, tpl


def _attn_template(cfg: ModelConfig, Ls: int, biases: bool = False
                   ) -> Dict[str, ParamT]:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t: Dict[str, ParamT] = {
        "ln1": ParamT((Ls, D), "ones"),
        "wq": ParamT((Ls, D, H * hd)),
        "wk": ParamT((Ls, D, KV * hd)),
        "wv": ParamT((Ls, D, KV * hd)),
        "wo": ParamT((Ls, H * hd, D), fan=H * hd),
    }
    if biases or cfg.qkv_bias:
        t.update({"wq_b": ParamT((Ls, H * hd), "zeros"),
                  "wk_b": ParamT((Ls, KV * hd), "zeros"),
                  "wv_b": ParamT((Ls, KV * hd), "zeros"),
                  "wo_b": ParamT((Ls, D), "zeros")})
    if cfg.qk_norm:
        t.update({"q_norm": ParamT((Ls, hd), "ones"),
                  "k_norm": ParamT((Ls, hd), "ones")})
    return t


def _mlp_template(cfg: ModelConfig, Ls: int, gelu: bool = False,
                  d_ff: int = 0) -> Dict[str, ParamT]:
    D, F = cfg.d_model, d_ff or cfg.d_ff
    t = {"ln2": ParamT((Ls, D), "ones")}
    if gelu:
        t.update({"w_in": ParamT((Ls, D, F)),
                  "w_in_b": ParamT((Ls, F), "zeros"),
                  "w_out": ParamT((Ls, F, D), fan=F),
                  "w_out_b": ParamT((Ls, D), "zeros")})
    else:
        t.update({"w_gate": ParamT((Ls, D, F)), "w_up": ParamT((Ls, D, F)),
                  "w_down": ParamT((Ls, F, D), fan=F)})
    return t


def _moe_template(cfg: ModelConfig, Ls: int) -> Dict[str, ParamT]:
    D, F, E, Eh = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.held_experts
    if not 0 <= cfg.expert_offset <= E - Eh:
        raise ValueError(f"held experts [{cfg.expert_offset}, "
                         f"{cfg.expert_offset + Eh}) lie outside the "
                         f"router's {E}")
    t = {"ln2": ParamT((Ls, D), "ones"),
         "router": ParamT((Ls, D, E)),
         "experts_gate": ParamT((Ls, Eh, D, F)),
         "experts_up": ParamT((Ls, Eh, D, F)),
         "experts_down": ParamT((Ls, Eh, F, D), fan=F)}
    if cfg.n_shared_experts:
        Fs = F * cfg.n_shared_experts
        t.update({"shared_gate": ParamT((Ls, D, Fs)),
                  "shared_up": ParamT((Ls, D, Fs)),
                  "shared_down": ParamT((Ls, Fs, D), fan=Fs)})
    return t


def param_template(cfg: ModelConfig):
    if cfg.family == "ssm":
        from repro_torch.models import rwkv6
        return rwkv6.template(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models import rglru
        return rglru.template(cfg)

    Vp, D = cfg.padded_vocab, cfg.d_model
    tpl: Dict[str, Any] = {
        "embed": ParamT((Vp, D), fan=D),
        "final_norm": ParamT((D,), "ones"),
        "lm_head": ParamT((D, Vp)),
    }
    if cfg.norm == "layernorm":
        tpl["final_norm_b"] = ParamT((D,), "zeros")

    if cfg.family == "dense":
        blk = _attn_template(cfg, cfg.n_layers)
        blk.update(_mlp_template(cfg, cfg.n_layers, gelu=cfg.act == "gelu"))
        tpl["blocks"] = blk
    elif cfg.family == "moe":
        k = cfg.first_k_dense
        blk = _attn_template(cfg, cfg.n_layers - k)
        blk.update(_moe_template(cfg, cfg.n_layers - k))
        tpl["blocks"] = blk
        if k:
            dense = _attn_template(cfg, k)
            dense.update(_mlp_template(cfg, k, d_ff=cfg.dense_d_ff))
            tpl["dense_blocks"] = dense
    elif cfg.family == "vlm":
        k = cfg.cross_attn_every
        if cfg.n_layers % k:
            raise ValueError(f"vlm: n_layers {cfg.n_layers} is not a "
                             f"multiple of cross_attn_every {k}")
        n_cross = cfg.n_layers // k
        n_self = cfg.n_layers - n_cross
        blk = _attn_template(cfg, n_self)
        blk.update(_mlp_template(cfg, n_self))
        tpl["blocks"] = blk
        xb = _attn_template(cfg, n_cross)
        xb.update(_mlp_template(cfg, n_cross))
        xb.update({"q_norm": ParamT((n_cross, cfg.hd), "ones"),
                   "k_norm": ParamT((n_cross, cfg.hd), "ones"),
                   "gate_attn": ParamT((n_cross,), "zeros"),
                   "gate_mlp": ParamT((n_cross,), "zeros")})
        tpl["xblocks"] = xb
    elif cfg.family == "encdec":
        enc = _attn_template(cfg, cfg.n_enc_layers, biases=True)
        enc.update(_mlp_template(cfg, cfg.n_enc_layers, gelu=True))
        tpl["enc_blocks"] = enc
        tpl["enc_final_norm"] = ParamT((D,), "ones")
        tpl["enc_final_norm_b"] = ParamT((D,), "zeros")
        dec = _attn_template(cfg, cfg.n_layers, biases=True)
        dec.update({f"x_{k}": v for k, v in
                    _attn_template(cfg, cfg.n_layers, biases=True).items()})
        dec.update(_mlp_template(cfg, cfg.n_layers, gelu=True))
        tpl["dec_blocks"] = dec
        tpl["pos_embed"] = ParamT((cfg.max_target_positions, D), fan=D)
    else:
        raise ValueError(f"unknown model family {cfg.family!r}; have "
                         f"{FAMILIES}")
    return tpl


def abstract_params(cfg: ModelConfig):
    """The parameter tree as ``meta`` tensors: shapes and dtypes, no
    memory."""
    return tree.tree_map(
        lambda t: torch.empty(t.shape, dtype=cfg.dtype, device="meta"),
        param_template(cfg))


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Ones, zeros, or N(0, 1/fan) normals drawn from ``generator`` (on its
    device unless ``device`` is given) in leaf order, cast to cfg.dtype.
    One replica, no node dim (``stack_nodes`` adds it)."""
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


def stack_nodes(params, n_nodes: int = 1):
    """One replica's tree -> a node-stacked tree of ``n_nodes`` copies (a
    view without copying for one node: serving's stack)."""
    if n_nodes == 1:
        return tree.tree_map(lambda p: p[None], params)
    return tree.tree_map(
        lambda p: p[None].repeat((n_nodes,) + (1,) * p.dim()), params)


# ---------------------------------------------------------------------------
# Blocks (node-stacked: x (N, B, T, D), parameters (N, ...))
# ---------------------------------------------------------------------------

def _bc(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A node-stacked parameter (N, *tail) viewed to broadcast against
    x (N, ..., *tail)."""
    return p.reshape((p.shape[0],) + (1,) * (x.dim() - p.dim())
                     + tuple(p.shape[1:]))


def _proj(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None, tp=NO_TP) -> torch.Tensor:
    """x @ w (+ b), one batched product over the leading dim.  Given a
    ``tp`` seam the product is row-parallel: w is a rank's input rows, the
    partial products are summed by ``reduce_out`` and the (replicated)
    bias added once after.  A column-parallel product (w, b a rank's
    output columns, x a ``copy_in`` input) needs no seam."""
    out = tp.reduce_out(torch.einsum("nbtd,ndk->nbtk", x, w.to(x.dtype)))
    if b is not None:
        out = out + _bc(b.to(x.dtype), out)
    return out


def _norm(cfg: ModelConfig, x: torch.Tensor, scale: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return L.layernorm(x, _bc(scale, x), _bc(
            bias if bias is not None else torch.zeros_like(scale), x))
    return L.rmsnorm(x, _bc(scale, x))


def _layer(stack: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer i of a node-stacked layer stack ((N, L, ...) leaves)."""
    return {name: leaf[:, i] for name, leaf in stack.items()}


def _stack_layers(caches):
    """Per-layer caches ((N, ...) leaves) -> one (N, L, ...) stack."""
    return {name: torch.stack([c[name] for c in caches], dim=1)
            for name in caches[0]}


def attn_block(cfg: ModelConfig, p, x: torch.Tensor, *, mode: str,
               causal: bool = True, rope: bool = True,
               window: Optional[int] = None, cache=None,
               pos: Optional[int] = None, kv_src: Optional[torch.Tensor] = None,
               cross: bool = False, prefix: str = "", tp=NO_TP):
    """One attention sub-block (pre-norm; the caller adds the residual).

    ``cross``: k/v come from ``kv_src`` (train/prefill; prefill returns them
    as the cache) or from the cache (decode).  Self-attention writes k/v at
    ring slot ``p % S_c`` of the cache (prefill: every kept position;
    decode: ``pos``) and decode masks with the valid length
    ``min(pos + 1, S_c)``, which subsumes causality and the window.
    Under a ``tp`` seam (mode ``train`` at M > 1) a rank computes its
    heads (:func:`_head_plan`), ``kv_src`` a replicated source the caller
    has put through ``copy_in``.  Returns (attn_out, new_cache)."""
    g = lambda name: p.get(prefix + name)                    # noqa: E731
    N, B, T, _ = x.shape
    hd = cfg.hd
    q_heads, kv_heads, cols = _head_plan(cfg, tp, N, x.device)

    xn = tp.copy_in(_norm(cfg, x, g("ln1"), g("ln1_b")))
    q = _heads(tp, _proj(xn, g("wq"), g("wq_b")), cfg.n_heads, hd, q_heads)
    if g("q_norm") is not None:
        q = L.rmsnorm(q, _bc(tp.copy_in(g("q_norm")), q))

    new_cache = cache
    kv_len = None
    causal_eff = causal

    def kv(src):
        k = _heads(tp, _proj(src, g("wk"), g("wk_b")), cfg.n_kv_heads, hd,
                   kv_heads)
        v = _heads(tp, _proj(src, g("wv"), g("wv_b")), cfg.n_kv_heads, hd,
                   kv_heads)
        if g("k_norm") is not None:
            k = L.rmsnorm(k, _bc(tp.copy_in(g("k_norm")), k))
        return k, v

    if cross:
        causal_eff = False
        if mode == "decode":
            k, v = cache["k"], cache["v"]          # precomputed at prefill
        else:
            k, v = kv(kv_src)
            if mode == "prefill":
                new_cache = {"k": k.to(cfg.dtype), "v": v.to(cfg.dtype)}
    else:
        k, v = kv(xn)
        if rope:
            positions = (torch.arange(pos, pos + 1, device=x.device)
                         if mode == "decode"
                         else torch.arange(T, device=x.device))
            cos, sin = L.rope_freqs(hd, cfg.rope_theta, positions)
            q = L.apply_rope(q, cos, sin)
            k = L.apply_rope(k, cos, sin)
        if mode == "decode":
            S_c = cache["k"].shape[-3]
            k = L.cache_write(cache["k"], k, pos)
            v = L.cache_write(cache["v"], v, pos)
            new_cache = {"k": k, "v": v}
            kv_len = min(pos + 1, S_c)
            causal_eff = False  # the valid length subsumes causality
            window = None       # the ring only ever holds the window
        elif mode == "prefill":
            new_cache = {"k": L.cache_write(cache["k"], k, 0),
                         "v": L.cache_write(cache["v"], v, 0)}

    out = L.attention(q, k, v, causal=causal_eff, window=window,
                      kv_len=kv_len).reshape(N, B, T, -1)
    if cols is not None:             # the rank's columns of its heads
        out = out.gather(-1, cols[:, None, None, :].expand(
            N, B, T, cols.shape[1]))
    return _proj(out, g("wo"), g("wo_b"), tp), new_cache


def _head_plan(cfg: ModelConfig, tp, R: int, device):
    """Which heads each of R rank-rows computes -> (q_heads, kv_heads,
    cols).  All None where a rank's columns of q and of k, v are whole
    heads (M = 1 included): a plain reshape.  Otherwise kv_heads (R, Kn)
    are the KV heads a rank-row's query heads read, gathered to whole
    heads, g query heads a KV slot (:func:`repro_torch.models.tp.
    kv_group`: the rank's heads in blocks of g that each read one KV
    head); where its query columns cut heads too, q_heads (R, Hn) are the
    heads its ``wo`` rows read (at most ceil(H / M) + 1,
    :func:`repro_torch.models.tp.head_geometry`) and cols (R, H hd / M)
    its columns of their output, else both None (q reshaped)."""
    H, KV, hd, M = cfg.n_heads, cfg.n_kv_heads, cfg.hd, tp.M
    if H % M == 0 and KV % M == 0:
        return None, None, None
    m = tp.model_index(R, device)
    whole, Hn, _ = tp_mod.head_geometry(H, hd, M)
    g = tp_mod.kv_group(H, KV, hd, M)
    ar = torch.arange(Hn, device=device)
    if whole:                        # K < M: only k and v are gathered
        return None, ((m[:, None] * Hn + ar) // (H // KV))[:, ::g], None
    cq = H * hd // M                 # the columns cut heads
    h0 = m * cq // hd
    heads = (h0[:, None] + ar).clamp(max=H - 1)
    cols = (m * cq - h0 * hd)[:, None] + torch.arange(cq, device=device)
    return heads, (heads // (H // KV))[:, ::g], cols


def kv_heads_per_rank(cfg: ModelConfig, model: int) -> int:
    """KV heads a rank's attention and cache hold (:func:`_head_plan`)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if model == 1 or (H % model == 0 and KV % model == 0):
        return KV // model
    return (tp_mod.head_geometry(H, hd, model)[1]
            // tp_mod.kv_group(H, KV, hd, model))


def _heads(tp, t: torch.Tensor, n_heads: int, hd: int,
           take: Optional[torch.Tensor]) -> torch.Tensor:
    """A rank's projected columns t (R, B, S, n_heads hd / M) -> heads (R,
    B, S, h, hd): the plain reshape where ``take`` is None, else gathered
    over the ranks to whole heads and each rank-row's heads ``take`` (R,
    h)."""
    R, B, S, _ = t.shape
    if take is None:
        return t.reshape(R, B, S, -1, hd)
    x = tp.gather_heads(t).reshape(R, B, S, n_heads, hd)
    idx = take[:, None, None, :, None].expand(R, B, S, take.shape[1], hd)
    return x.gather(3, idx)


def mlp_block(cfg: ModelConfig, p, x: torch.Tensor, prefix: str = "",
              tp=NO_TP):
    """The FF sub-block -> (out, aux): aux is each node's MoE load-balance
    loss ((N,) f32) in an MoE layer, else 0.0.  Under a ``tp`` seam the
    products split over the model ranks (``copy_in`` after the norm)."""
    g = lambda name: p.get(prefix + name)                    # noqa: E731
    xn = _norm(cfg, x, g("ln2"), g("ln2_b"))
    if cfg.family == "moe" and g("router") is not None:
        shared = None
        if cfg.n_shared_experts:
            shared = (g("shared_gate"), g("shared_up"), g("shared_down"))
        return moe_mod.moe_mlp(
            xn, g("router"), g("experts_gate"), g("experts_up"),
            g("experts_down"), top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, shared=shared, tp=tp,
            first_expert=cfg.expert_offset, dropless=cfg.moe_dropless)
    xn = tp.copy_in(xn)
    if g("w_in") is not None:
        return L.gelu_mlp(xn, g("w_in"), g("w_in_b"), g("w_out"),
                          g("w_out_b"), tp=tp), 0.0
    return L.swiglu(xn, g("w_gate"), g("w_up"), g("w_down"), tp=tp), 0.0


def run_stack(cfg: ModelConfig, stack, x: torch.Tensor, *, mode: str,
              causal: bool = True, window: Optional[int] = None, cache=None,
              pos: Optional[int] = None, tp=NO_TP):
    """The layers of a self-attention stack in order -> (x, new cache
    stack or None, summed aux)."""
    use_rope = cfg.norm != "layernorm"   # whisper (layernorm) has no RoPE
    n = next(iter(stack.values())).shape[1]
    aux_sum, new = 0.0, []
    for i in range(n):
        p = _layer(stack, i)
        a, nc = attn_block(cfg, p, x, mode=mode, causal=causal,
                           rope=use_rope, window=window,
                           cache=None if cache is None else _layer(cache, i),
                           pos=pos, tp=tp)
        x = x + a
        m, aux = mlp_block(cfg, p, x, tp=tp)
        x = x + m
        aux_sum = aux_sum + aux
        new.append(nc)
    if cache is not None:
        cache = _stack_layers(new) if new else cache
    return x, cache, aux_sum


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------

def _local_lookup(table: torch.Tensor, idx: torch.Tensor, tp
                  ) -> torch.Tensor:
    """A vocab-parallel lookup: table (R, V / M, D) a rank's rows, idx (R,
    ...) global rows -> (R, ..., D), the rows this rank holds and zeros
    elsewhere (``reduce_out`` of it is the whole lookup)."""
    R, Vl = table.shape[0], table.shape[1]
    lead = (R,) + (1,) * (idx.dim() - 1)
    local = idx - (tp.model_index(R, idx.device) * Vl).view(lead)
    ok = (local >= 0) & (local < Vl)
    row = torch.arange(R, device=idx.device).view(lead)
    e = table[row, local.clamp(0, Vl - 1)]
    return torch.where(ok[..., None], e, torch.zeros((), dtype=e.dtype,
                                                     device=e.device))


def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor,
                 tp=NO_TP) -> torch.Tensor:
    """tokens (N, B, T) -> (N, B, T, D): node n looks up its own table
    (under a ``tp`` seam vocab-parallel: a masked local lookup, then
    ``reduce_out``)."""
    emb = params["embed"].to(cfg.dtype)
    if tp.M > 1:
        return tp.reduce_out(_local_lookup(emb, tokens, tp))
    node = torch.arange(emb.shape[0], device=tokens.device)[:, None, None]
    return emb[node, tokens]


def lm_logits(cfg: ModelConfig, params, x: torch.Tensor, tp=NO_TP
              ) -> torch.Tensor:
    """The final norm and the LM head; under a ``tp`` seam column-parallel
    over the (padded) vocabulary: a rank's (..., Vp / M) logits."""
    xn = tp.copy_in(_norm(cfg, x, params["final_norm"],
                          params.get("final_norm_b")))
    return torch.einsum("nbtd,ndv->nbtv", xn, params["lm_head"].to(x.dtype))


def forward(cfg: ModelConfig, params, batch, *, mode: str = "train",
            cache=None, pos: Optional[int] = None, tp=NO_TP):
    """Family dispatch on node-stacked inputs.  Returns (logits (N, B, T,
    Vp), new cache (None without one), aux loss: (N,) for an MoE model,
    else 0.0).  Under a ``tp`` seam of M > 1 the inputs are rank-rows
    (a cache :func:`init_cache`'s with the same seam) and the logits a
    rank's (..., Vp / M)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; have {MODES}")
    if mode != "train" and cache is None:
        raise ValueError(f"mode {mode!r} needs a cache (init_cache)")
    if mode == "decode" and pos is None:
        raise ValueError("mode 'decode' needs the absolute position pos")
    if cfg.family == "ssm":
        from repro_torch.models import rwkv6
        return rwkv6.forward(cfg, params, batch, mode=mode, cache=cache,
                             pos=pos, tp=tp)
    if cfg.family == "hybrid":
        from repro_torch.models import rglru
        return rglru.forward(cfg, params, batch, mode=mode, cache=cache,
                             pos=pos, tp=tp)
    if cfg.family == "encdec":
        return _forward_encdec(cfg, params, batch, mode=mode, cache=cache,
                               pos=pos, tp=tp)
    if cfg.family == "vlm":
        return _forward_vlm(cfg, params, batch, mode=mode, cache=cache,
                            pos=pos, tp=tp)
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"unknown model family {cfg.family!r}; have "
                         f"{FAMILIES}")
    return _forward_decoder(cfg, params, batch, mode=mode, cache=cache,
                            pos=pos, tp=tp)


def _forward_decoder(cfg, params, batch, *, mode, cache, pos, tp=NO_TP):
    """The decoder: the leading ``dense_blocks`` where the model has
    them, then ``blocks``."""
    x = embed_tokens(cfg, params, batch["tokens"], tp)
    new_cache, aux = {}, 0.0
    for group in ("dense_blocks", "blocks"):
        if group not in params:
            continue
        x, c, a = run_stack(
            cfg, params[group], x, mode=mode, causal=True,
            window=cfg.sliding_window,
            cache=None if cache is None else cache[group], pos=pos, tp=tp)
        new_cache[group], aux = c, aux + a
    logits = lm_logits(cfg, params, x, tp)
    return logits, (None if cache is None else new_cache), aux


def _forward_vlm(cfg, params, batch, *, mode, cache, pos, tp=NO_TP):
    """(k - 1) self layers, then one gated cross layer, per super-block."""
    k = cfg.cross_attn_every
    n_super = cfg.n_layers // k
    x = embed_tokens(cfg, params, batch["tokens"], tp)
    vision = batch.get("vision")   # (N, B, n_vis, D); None in decode (cached)
    if vision is not None:
        vision = tp.copy_in(vision.to(x.dtype))
    aux_sum, new_self, new_cross = 0.0, [], []
    for s in range(n_super):
        idx = slice(s * (k - 1), (s + 1) * (k - 1))
        ps = {n: a[:, idx] for n, a in params["blocks"].items()}
        cs = (None if cache is None
              else {n: a[:, idx] for n, a in cache["self"].items()})
        x, cs_new, aux = run_stack(cfg, ps, x, mode=mode, causal=True,
                                   cache=cs, pos=pos, tp=tp)
        px = _layer(params["xblocks"], s)
        a, cx_new = attn_block(
            cfg, px, x, mode=mode, rope=False,
            cache=None if cache is None else _layer(cache["cross"], s),
            pos=pos, kv_src=vision, cross=True, tp=tp)
        x = x + _bc(torch.tanh(px["gate_attn"]).to(x.dtype), x) * a
        m, aux2 = mlp_block(cfg, px, x, tp=tp)
        x = x + _bc(torch.tanh(px["gate_mlp"]).to(x.dtype), x) * m
        aux_sum = aux_sum + aux + aux2
        new_self.append(cs_new)
        new_cross.append(cx_new)
    new_cache = None
    if cache is not None:
        new_cache = {"self": {n: torch.cat([c[n] for c in new_self], dim=1)
                              for n in cache["self"]},
                     "cross": _stack_layers(new_cross)}
    return lm_logits(cfg, params, x, tp), new_cache, aux_sum


def _forward_encdec(cfg, params, batch, *, mode, cache, pos, tp=NO_TP):
    """Encoder over the frame embeddings (sinusoidal positions, full
    attention), then the decoder: learned positions CLAMPED at
    max_target_positions - 1 (the reference's rule: positions past the
    table reuse its last row), causal self attention, cross attention to
    the encoder output (cached at prefill)."""
    enc_out = None
    if mode != "decode":
        frames = batch["frames"].to(cfg.dtype)     # (N, B, S_enc, D) stub
        pe = L.sinusoidal_pos_on(frames.shape[2], cfg.d_model,
                                 frames.device, cfg.dtype)
        h, _, _ = run_stack(cfg, params["enc_blocks"], frames + pe,
                            mode="train", causal=False, tp=tp)
        # one copy_in for every decoder layer's cross k/v
        enc_out = tp.copy_in(_norm(cfg, h, params["enc_final_norm"],
                                   params.get("enc_final_norm_b")))

    tokens = batch["tokens"]
    T = tokens.shape[-1]
    x = embed_tokens(cfg, params, tokens, tp)
    pos_embed = params["pos_embed"].to(x.dtype)
    last = cfg.max_target_positions - 1
    idx = (torch.arange(pos, pos + 1, device=x.device) if mode == "decode"
           else torch.arange(T, device=x.device)).clamp(max=last)
    if tp.M > 1:                     # vocab-parallel rows of the table
        x = x + tp.reduce_out(_local_lookup(
            pos_embed, idx.expand(x.shape[0], idx.shape[0]), tp))[:, None]
    else:
        x = x + pos_embed[:, idx][:, None]

    aux_sum, new_self, new_cross = 0.0, [], []
    for i in range(cfg.n_layers):
        p = _layer(params["dec_blocks"], i)
        c_self = None if cache is None else _layer(cache["self"], i)
        c_cross = None if cache is None else _layer(cache["cross"], i)
        a, nc_self = attn_block(cfg, p, x, mode=mode, causal=True,
                                rope=False, cache=c_self, pos=pos, tp=tp)
        x = x + a
        xa, nc_cross = attn_block(cfg, p, x, mode=mode, rope=False,
                                  cache=c_cross, pos=pos, kv_src=enc_out,
                                  cross=True, prefix="x_", tp=tp)
        x = x + xa
        m, aux = mlp_block(cfg, p, x, tp=tp)
        x = x + m
        aux_sum = aux_sum + aux
        new_self.append(nc_self)
        new_cross.append(nc_cross)
    new_cache = None
    if cache is not None:
        new_cache = {"self": _stack_layers(new_self),
                     "cross": _stack_layers(new_cross)}
    return lm_logits(cfg, params, x, tp), new_cache, aux_sum


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, B: int, S: int, *, n_nodes: int = 1,
               device=None, abstract: bool = False, tp=NO_TP):
    """Pre-allocated decode cache for seq_len S, zeros of cfg.dtype with a
    leading node dim (``abstract``: ``meta`` tensors, nothing
    allocated).  The cross-attention entries are placeholders that prefill
    replaces with the encoder's / the vision tokens' k and v.  Under a
    ``tp`` seam of M > 1 the leading dim holds the process's rank-rows of
    its ``n_nodes`` nodes, each a rank's cache: the KV heads its query
    heads read (:func:`kv_heads_per_rank`), RWKV-6's wkv state of its
    heads, the RG-LRU's W / M columns; the token shifts whole."""
    dev = "meta" if abstract else device
    rows = n_nodes * tp.rows_per_node

    def mk(shape):
        return torch.zeros((rows,) + tuple(shape), dtype=cfg.dtype,
                           device=dev)

    KV, hd = kv_heads_per_rank(cfg, tp.M), cfg.hd
    if cfg.family == "ssm":
        from repro_torch.models import rwkv6
        return rwkv6.init_cache(cfg, B, mk, tp.M)
    if cfg.family == "hybrid":
        from repro_torch.models import rglru
        return rglru.init_cache(cfg, B, S, mk, tp.M, KV)
    Seff = S if cfg.sliding_window is None else min(S, cfg.sliding_window)
    if cfg.decode_cache_cap is not None:
        Seff = min(Seff, cfg.decode_cache_cap)

    def kv(n, s):
        return {"k": mk((n, B, s, KV, hd)), "v": mk((n, B, s, KV, hd))}

    if cfg.family == "moe" and cfg.first_k_dense:
        return {"blocks": kv(cfg.n_layers - cfg.first_k_dense, Seff),
                "dense_blocks": kv(cfg.first_k_dense, Seff)}
    if cfg.family in ("dense", "moe"):
        return {"blocks": kv(cfg.n_layers, Seff)}
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.cross_attn_every
        return {"self": kv(cfg.n_layers - n_cross, Seff),
                "cross": kv(n_cross, cfg.n_vision_tokens)}
    if cfg.family == "encdec":
        return {"self": kv(cfg.n_layers, Seff),
                "cross": kv(cfg.n_layers, min(S, cfg.max_source_positions))}
    raise ValueError(f"unknown model family {cfg.family!r}; have "
                     f"{FAMILIES}")


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                pos: int, tp=NO_TP):
    """ONE new token (N, B, 1) against a pre-allocated cache at absolute
    position ``pos`` -> (logits (N, B, Vp), new cache).  Under a ``tp``
    seam of M > 1 the rows are rank-rows, the cache :func:`init_cache`'s
    with the seam, and the logits a rank's (N M, B, Vp / M)."""
    logits, new_cache, _ = forward(cfg, params, {"tokens": tokens},
                                   mode="decode", cache=cache, pos=pos,
                                   tp=tp)
    return logits[:, :, -1], new_cache


def loss_fn(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor,
            tp=NO_TP) -> torch.Tensor:
    """Mean next-token cross entropy per node: logits (N, B, T, V), labels
    (N, B, T) -> (N,).  logsumexp minus the label's logit, in f32.  Under
    a ``tp`` seam the logits are a rank's (..., Vp / M) columns of the
    padded vocabulary: the max (detached), the sum of exponentials and
    the label's logit are reduced over the model ranks, and every
    rank-row returns its node's loss."""
    lf = logits.to(F32)
    if tp.M == 1:
        lse = torch.logsumexp(lf, dim=-1)
        correct = lf.gather(-1, labels[..., None].to(torch.int64))[..., 0]
        return (lse - correct).reshape(lf.shape[0], -1).mean(dim=1)
    R, Vl = lf.shape[0], lf.shape[-1]
    mx = tp.all_max(lf.detach().amax(dim=-1))
    lse = torch.log(tp.all_sum(torch.exp(lf - mx[..., None]).sum(-1))) + mx
    lead = (R,) + (1,) * (labels.dim() - 1)
    local = labels.to(torch.int64) - (tp.model_index(R, lf.device)
                                      * Vl).view(lead)
    ok = (local >= 0) & (local < Vl)
    picked = lf.gather(-1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    correct = tp.all_sum(torch.where(ok, picked, torch.zeros(
        (), dtype=F32, device=lf.device)))
    return (lse - correct).reshape(R, -1).mean(dim=1)
