"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU + local attention, 1:2.

The port of ``repro.models.rglru``, node-stacked (x (N, B, T, D), every
parameter and cache leaf with a leading node dim).  The block pattern
(rec, rec, attn) repeats, trailing recurrent blocks after the last whole
unit; each temporal block is followed by a gated MLP.  The recurrent
block:

    x -> RMSNorm -> [ branch_x: Linear -> causal depthwise conv(4) -> RG-LRU ]
                    [ branch_g: Linear -> GeLU (tanh approximation)         ]
    out = (branch_x * branch_g) @ W_out

RG-LRU (gates block-diagonal, G blocks; c = 8):
    i_t = sigmoid(Wx y_t + bx),  r_t = sigmoid(Wa y_t + ba)
    log a_t = -c * softplus(Lambda) * r_t
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * y_t)

The reference runs the recurrence as ``jax.lax.associative_scan`` (a
log-depth tree); the port runs it as a loop over T, h_t = a_t h_{t-1} +
b_t, which adds in another order: the two agree to f32 rounding (the
parity tests' ``MODEL_TOL``), not bit for bit.  T == 1 (decode) is the
single step in both.

Tensor parallelism (a ``tp`` seam of M > 1, ``repro_torch.models.tp``;
the rules shard the outputs of ``rg_w_x``/``rg_w_gate`` and the input of
``rg_w_out``, the conv kernel, gates and ``lam`` are replicated).  A rank
holds W / M columns of the recurrence: ``rg_w_x`` and ``rg_w_gate`` are
column-parallel on the ``copy_in``'d norm; ``conv_w``, ``conv_b``,
``lam`` and the gate biases are read on the rank's columns through
``scatter_last`` (an all-gather backward: their gradients come back
whole), so the depthwise conv and the elementwise recurrence are
column-local.  The block-diagonal gates: where M divides the G blocks a
rank applies its G / M blocks (the block dim through ``scatter_last``);
where it does not (G = 1 when W % 16 != 0) y is gathered whole
(``gather_last``), the gates computed whole and their pre-activations
scattered to the rank's columns.  ``rg_w_out`` is row-parallel, then
``reduce_out``.  The attention blocks and MLPs take the seam as the
dense family's do (recurrentgemma's one KV head gathered).  A cache holds
the rank's W / M columns of ``h`` and ``conv``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.tp import NO_TP

F32 = torch.float32
C_RGLRU = 8.0
GATE_BLOCKS = 16


def template(cfg) -> Dict[str, Any]:
    from repro_torch.models.transformer import (ParamT, _attn_template,
                                                _mlp_template)
    D, W = cfg.d_model, cfg.lru_width or cfg.d_model
    Vp = cfg.padded_vocab
    n_attn = cfg.n_layers // len(cfg.block_pattern)
    n_rec = cfg.n_layers - n_attn
    G = GATE_BLOCKS if W % GATE_BLOCKS == 0 else 1
    rec = {
        "ln1": ParamT((n_rec, D), "ones"),
        "rg_w_x": ParamT((n_rec, D, W)),
        "rg_w_gate": ParamT((n_rec, D, W)),
        "conv_w": ParamT((n_rec, cfg.conv_width, W), fan=cfg.conv_width),
        "conv_b": ParamT((n_rec, W), "zeros"),
        "gate_x_w": ParamT((n_rec, G, W // G, W // G), fan=W // G),
        "gate_x_b": ParamT((n_rec, W), "zeros"),
        "gate_a_w": ParamT((n_rec, G, W // G, W // G), fan=W // G),
        "gate_a_b": ParamT((n_rec, W), "zeros"),
        "lam": ParamT((n_rec, W), "ones"),
        "rg_w_out": ParamT((n_rec, W, D), fan=W),
    }
    rec.update(_mlp_template(cfg, n_rec))
    att = _attn_template(cfg, n_attn)
    att.update(_mlp_template(cfg, n_attn))
    return {
        "embed": ParamT((Vp, D), fan=D),
        "final_norm": ParamT((D,), "ones"),
        "lm_head": ParamT((D, Vp)),
        "rec_blocks": rec,
        "attn_blocks": att,
    }


def _v(p: torch.Tensor) -> torch.Tensor:
    """A per-node (N, W) vector viewed against (N, B, T, W)."""
    return p[:, None, None]


def _block_diag(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y (N, B, T, W), w (N, G, W/G, W/G) -> (N, B, T, W)."""
    N, B, T, Wd = y.shape
    G = w.shape[1]
    yg = y.reshape(N, B, T, G, Wd // G)
    return torch.einsum("nbtgk,ngkl->nbtgl", yg, w).reshape(N, B, T, Wd)


def _causal_conv(y, w, b, conv_state=None):
    """Depthwise causal conv of width K.  y (N, B, T, W), w (N, K, W);
    ``conv_state`` (N, B, K-1, W) holds the previous inputs.  -> (out, new
    conv state)."""
    N, B, T, Wd = y.shape
    K = w.shape[1]
    if conv_state is None:
        conv_state = y.new_zeros((N, B, K - 1, Wd))
    ext = torch.cat([conv_state.to(y.dtype), y], dim=2)     # (N,B,T+K-1,W)
    out = sum(ext[:, :, i:i + T] * _v(w[:, i].to(y.dtype)) for i in range(K))
    out = out + _v(b.to(y.dtype))
    new_state = ext[:, :, -(K - 1):] if K > 1 else conv_state
    return out, new_state


def _gate_pre(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor, tp
              ) -> torch.Tensor:
    """A block-diagonal gate's pre-activation on the rank's columns: y
    (N, B, T, W / M), w (N, G, W/G, W/G) and b (N, W) replicated."""
    if w.shape[1] % tp.M == 0:     # the rank's columns are G / M blocks
        w = tp.scatter_last(w.movedim(1, -1)).movedim(-1, 1)
        return _block_diag(y, w) + _v(tp.scatter_last(b))
    # the rank's columns cut a block: the gate whole on the gathered y
    return tp.scatter_last(_block_diag(tp.gather_last(y), w) + _v(b))


def rglru(y: torch.Tensor, p, h_prev: torch.Tensor, tp=NO_TP):
    """y (N, B, T, W) f32, h_prev (N, B, W) f32 -> (h (N, B, T, W), h_last
    (N, B, W)); W a rank's W / M columns under a ``tp`` seam."""
    i_g = torch.sigmoid(_gate_pre(y, p["gate_x_w"].to(F32),
                                  p["gate_x_b"].to(F32), tp))
    r_g = torch.sigmoid(_gate_pre(y, p["gate_a_w"].to(F32),
                                  p["gate_a_b"].to(F32), tp))
    lam = tp.scatter_last(p["lam"].to(F32))
    log_a = -C_RGLRU * F.softplus(_v(lam)) * r_g
    a = torch.exp(log_a)
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))       # sqrt(1 - a^2)
    b = beta * (i_g * y)
    if y.shape[2] == 1:
        h = a[:, :, 0] * h_prev + b[:, :, 0]
        return h[:, :, None], h
    hs, h = [], h_prev
    for t in range(y.shape[2]):
        h = a[:, :, t] * h + b[:, :, t]
        hs.append(h)
    return torch.stack(hs, dim=2), h


def rec_block(cfg, p, x, cache, tp=NO_TP):
    """-> (out, new cache {h, conv} or None)."""
    from repro_torch.models.transformer import _bc
    N, B, T, D = x.shape
    xn = tp.copy_in(L.rmsnorm(x, _bc(p["ln1"], x)))
    yx = torch.einsum("nbtd,ndw->nbtw", xn, p["rg_w_x"].to(xn.dtype))
    gate = F.gelu(torch.einsum("nbtd,ndw->nbtw", xn,
                               p["rg_w_gate"].to(xn.dtype)),
                  approximate="tanh")
    conv_state = None if cache is None else cache["conv"]
    h_prev = (x.new_zeros((N, B, yx.shape[-1]), dtype=F32) if cache is None
              else cache["h"].to(F32))
    yc, new_conv = _causal_conv(yx, tp.scatter_last(p["conv_w"]),
                                tp.scatter_last(p["conv_b"]), conv_state)
    h, h_last = rglru(yc.to(F32), p, h_prev, tp)
    out = tp.reduce_out(torch.einsum("nbtw,nwd->nbtd", h.to(x.dtype) * gate,
                                     p["rg_w_out"].to(x.dtype)))
    new_cache = None
    if cache is not None:
        new_cache = {"h": h_last.to(cfg.dtype),
                     "conv": new_conv.to(cfg.dtype)}
    return out, new_cache


@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype) -> torch.Tensor:
    """sqrt(d_model) rounded to ``dtype``, a 0-d CPU tensor made once (a
    forward lifts nothing from the host)."""
    return torch.tensor(d_model ** 0.5, dtype=dtype)


def forward(cfg, params, batch, *, mode="train", cache=None, pos=None,
            tp=NO_TP):
    """(rec x (plen - 1), attn) units, then the trailing rec blocks ->
    (logits, new cache or None, 0.0).  The attention blocks run RoPE and
    the local window (a ring cache of local_window slots).  Under a ``tp``
    seam the rows are rank-rows and the logits a rank's (..., Vp / M)."""
    from repro_torch.models.transformer import (_layer, _stack_layers,
                                                attn_block, embed_tokens,
                                                lm_logits, mlp_block)
    x = embed_tokens(cfg, params, batch["tokens"], tp)
    x = x * _embed_scale(cfg.d_model, cfg.dtype)
    plen = len(cfg.block_pattern)
    n_super = cfg.n_layers // plen
    n_rec = cfg.n_layers - n_super
    n_rec_per = plen - 1
    rec, att = params["rec_blocks"], params["attn_blocks"]
    new_rec, new_attn = [], []

    def one_rec(h, i):
        c = None if cache is None else _layer(cache["rec"], i)
        p = _layer(rec, i)
        a, nc = rec_block(cfg, p, h, c, tp)
        h = h + a
        m, _ = mlp_block(cfg, p, h, tp=tp)
        new_rec.append(nc)
        return h + m

    for s in range(n_super):
        for j in range(n_rec_per):
            x = one_rec(x, s * n_rec_per + j)
        p = _layer(att, s)
        a, nca = attn_block(cfg, p, x, mode=mode, causal=True, rope=True,
                            window=cfg.local_window,
                            cache=None if cache is None
                            else _layer(cache["attn"], s), pos=pos, tp=tp)
        x = x + a
        m, _ = mlp_block(cfg, p, x, tp=tp)
        x = x + m
        new_attn.append(nca)
    for i in range(n_super * n_rec_per, n_rec):
        x = one_rec(x, i)

    logits = lm_logits(cfg, params, x, tp)
    new_cache = None
    if cache is not None:
        new_cache = {"rec": _stack_layers(new_rec),
                     "attn": (_stack_layers(new_attn) if new_attn
                              else cache["attn"])}
    return logits, new_cache, 0.0


def init_cache(cfg, B, S, mk, model: int, kv_heads: int):
    """A rank's W / M columns of ``h`` and ``conv`` (``model`` = M), and
    ``kv_heads`` KV heads in the local attention's ring."""
    W = (cfg.lru_width or cfg.d_model) // model
    n_attn = cfg.n_layers // len(cfg.block_pattern)
    n_rec = cfg.n_layers - n_attn
    KV, hd = kv_heads, cfg.hd
    Sw = min(S, cfg.local_window)
    return {
        "rec": {"h": mk((n_rec, B, W)),
                "conv": mk((n_rec, B, cfg.conv_width - 1, W))},
        "attn": {"k": mk((n_attn, B, Sw, KV, hd)),
                 "v": mk((n_attn, B, Sw, KV, hd))},
    }
