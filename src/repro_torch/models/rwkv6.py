"""RWKV6 "Finch" (arXiv:2404.05892): attention-free, data-dependent decay.

The port of ``repro.models.rwkv6``, node-stacked (x (N, B, T, D), every
parameter and cache leaf with a leading node dim).  Time mixing: per head a
state S in R^{hd x hd} evolves as

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t

with w_t = exp(-exp(w0 + lora_w(x_t))).  Token-shift ddlerp mixes x_t with
x_{t-1} through a small fused LoRA before the r/k/v/w/g projections; the
per-head group norm uses the POPULATION variance (``jnp.var``).  Channel
mixing is the squared-ReLU FFN with its own token shift.  The recurrence is
a loop over T in f32 (the reference's ``lax.scan``), the state is O(B H
hd^2), constant in the sequence length.

Tensor parallelism (a ``tp`` seam of M > 1, ``repro_torch.models.tp``).
The rules (``repro_torch.models.sharding``, first match wins) shard the
outputs of ``rwkv_wr/wk/wv/wg``, ``cm_wk``, ``cm_wr`` and, through the
``wv$`` rule, ``cm_wv``; ``rwkv_wo`` falls under ``wo$``, its INPUT rows;
everything else is replicated.  A rank holds H / M whole heads (M must
divide H: :func:`check_tp`).  The token shift, the ddlerp and the decay
LoRA run whole on every rank; ``xr, xk, xv, xg`` enter the
column-parallel r, k, v, g products through ``copy_in``; the decay w,
``u``'s heads, ``lnx`` and ``lnx_b`` are read on the rank's columns
through ``scatter_last`` (whose backward all-gathers, so their gradients
come back whole); the WKV recurrence and the per-head group norm run on
the rank's heads, and ``rwkv_wo`` is row-parallel, then ``reduce_out``.
Channel mix: ``cm_wk`` column-parallel; its squared ReLU gathered whole
(``copy_in(gather_last(.))``, a reduce-scatter backward: a rank's
gradient to the whole of it is partial) into the rank's output columns
of ``cm_wv``; ``cm_wr`` column-parallel; their product, column-local,
gathered to the replicated residual.  A cache holds the rank's heads'
wkv state and the token shifts whole.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.tp import NO_TP

F32 = torch.float32
TM_LORA = 64
DECAY_LORA = 64


def template(cfg) -> Dict[str, Any]:
    from repro_torch.models.transformer import ParamT
    D, Fd, Ln = cfg.d_model, cfg.d_ff, cfg.n_layers
    hd = cfg.rwkv_head_size
    H = D // hd
    Vp = cfg.padded_vocab
    blk = {
        "ln1": ParamT((Ln, D), "ones"), "ln1_b": ParamT((Ln, D), "zeros"),
        "ln2": ParamT((Ln, D), "ones"), "ln2_b": ParamT((Ln, D), "zeros"),
        "mu_x": ParamT((Ln, D), "zeros"),
        "mu_rkvwg": ParamT((Ln, 5, D), "zeros"),
        "tm_a1": ParamT((Ln, D, 5 * TM_LORA)),
        "tm_a2": ParamT((Ln, 5, TM_LORA, D), fan=TM_LORA),
        "w0": ParamT((Ln, D), "zeros"),
        "wd1": ParamT((Ln, D, DECAY_LORA)),
        "wd2": ParamT((Ln, DECAY_LORA, D), fan=DECAY_LORA),
        "u": ParamT((Ln, H, hd), "zeros"),
        "rwkv_wr": ParamT((Ln, D, D)), "rwkv_wk": ParamT((Ln, D, D)),
        "rwkv_wv": ParamT((Ln, D, D)), "rwkv_wg": ParamT((Ln, D, D)),
        "rwkv_wo": ParamT((Ln, D, D)),
        "lnx": ParamT((Ln, D), "ones"), "lnx_b": ParamT((Ln, D), "zeros"),
        "cm_mu_k": ParamT((Ln, D), "zeros"), "cm_mu_r": ParamT((Ln, D), "zeros"),
        "cm_wk": ParamT((Ln, D, Fd)), "cm_wv": ParamT((Ln, Fd, D), fan=Fd),
        "cm_wr": ParamT((Ln, D, D)),
    }
    return {
        "embed": ParamT((Vp, D), fan=D),
        "embed_ln": ParamT((D,), "ones"), "embed_ln_b": ParamT((D,), "zeros"),
        "final_norm": ParamT((D,), "ones"),
        "final_norm_b": ParamT((D,), "zeros"),
        "lm_head": ParamT((D, Vp)),
        "blocks": blk,
    }


def _v(p: torch.Tensor) -> torch.Tensor:
    """A per-node (N, D) vector viewed against (N, B, T, D)."""
    return p[:, None, None]


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x (N, B, T, D) -> x_{t-1} with ``prev`` (N, B, D) as x_{-1}."""
    return torch.cat([prev[:, :, None], x[:, :, :-1]], dim=2)


def _ddlerp(p, x, xx):
    """The 5 mixed inputs (r, k, v, w, g) as (5, N, B, T, D) f32."""
    base = x + xx * _v(p["mu_x"].to(x.dtype))
    lora = torch.einsum("nbtd,ndk->nbtk", torch.tanh(base.to(F32)),
                        p["tm_a1"].to(F32))
    lora = lora.reshape(*lora.shape[:-1], 5, TM_LORA)
    mix = torch.einsum("nbtsk,nskd->snbtd", lora, p["tm_a2"].to(F32))
    mus = p["mu_rkvwg"].to(F32).permute(1, 0, 2)[:, :, None, None]
    xf, xxf = x.to(F32), xx.to(F32)
    return xf[None] + xxf[None] * (mus + mix)


def _wkv_scan(r, k, v, w, u, state):
    """The recurrence over time.  r, k, v, w (N, B, T, H, hd) f32; u (N, H,
    hd); state (N, B, H, hd, hd).  -> (y (N, B, T, H, hd), final state)."""
    uu = u[:, None, :, :, None]
    ys = []
    S = state
    for t in range(r.shape[2]):
        rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t]
        a = torch.einsum("nbhk,nbhv->nbhkv", kt, vt)
        ys.append(torch.einsum("nbhk,nbhkv->nbhv", rt, S + uu * a))
        S = wt[..., None] * S + a
    return torch.stack(ys, dim=2), S


def _ln(x, p, name):
    return L.layernorm(x, _v(p[name]), _v(p[name + "_b"]))


def check_tp(cfg, model: int) -> None:
    """A rank holds whole heads: refuse M that does not divide the H =
    D / head_size heads, naming the shapes."""
    H = cfg.d_model // cfg.rwkv_head_size
    if H % model:
        raise ValueError(
            f"{cfg.name}: {H} RWKV heads of {cfg.rwkv_head_size} "
            f"(d_model {cfg.d_model}) do not split into {model} model "
            f"ranks: a rank's {cfg.d_model} / {model} columns of rwkv_wr/"
            f"wk/wv/wg would cut a head, whose WKV state and group norm "
            f"need it whole")


def time_mix(cfg, p, x, shift_prev, wkv_state, tp=NO_TP):
    """-> (out (N, B, T, D), new shift (N, B, D), new wkv state (N, B,
    H / M, hd, hd): the rank's heads under a ``tp`` seam)."""
    N, B, T, D = x.shape
    hd = cfg.rwkv_head_size
    Hl = D // hd // tp.M
    xn = _ln(x, p, "ln1")
    prev = (shift_prev if shift_prev is not None
            else xn.new_zeros((N, B, D)))
    xx = _token_shift(xn, prev) - xn
    xr, xk, xv, xw, xg = _ddlerp(p, xn, xx)

    def col(xm, name):                     # column-parallel at M > 1
        return torch.einsum("nbtd,nde->nbte", tp.copy_in(xm),
                            p[name].to(F32))

    r, k, v = col(xr, "rwkv_wr"), col(xk, "rwkv_wk"), col(xv, "rwkv_wv")
    g = F.silu(col(xg, "rwkv_wg"))
    dec = torch.einsum("nbtd,ndk->nbtk", torch.tanh(xw), p["wd1"].to(F32))
    dec = torch.einsum("nbtk,nkd->nbtd", dec, p["wd2"].to(F32))
    w = tp.scatter_last(torch.exp(-torch.exp(_v(p["w0"].to(F32)) + dec)))
    u = tp.scatter_last(p["u"].to(F32).flatten(-2)).unflatten(-1, (Hl, hd))

    shp = (N, B, T, Hl, hd)
    y, new_state = _wkv_scan(r.reshape(shp), k.reshape(shp), v.reshape(shp),
                             w.reshape(shp), u, wkv_state.to(F32))
    # per-head group norm, population variance
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    lnx, lnx_b = (tp.scatter_last(p[n].to(F32)) for n in ("lnx", "lnx_b"))
    y = y.reshape(N, B, T, Hl * hd) * _v(lnx) + _v(lnx_b)
    out = tp.reduce_out(torch.einsum("nbtd,nde->nbte", y * g,
                                     p["rwkv_wo"].to(F32)))
    return out.to(x.dtype), xn[:, :, -1], new_state.to(cfg.dtype)


def channel_mix(cfg, p, x, shift_prev, tp=NO_TP):
    N, B, T, D = x.shape
    xn = _ln(x, p, "ln2")
    prev = (shift_prev if shift_prev is not None
            else xn.new_zeros((N, B, D)))
    xx = _token_shift(xn, prev) - xn
    xk = xn + xx * _v(p["cm_mu_k"].to(xn.dtype))
    xr = xn + xx * _v(p["cm_mu_r"].to(xn.dtype))
    kk = torch.einsum("nbtd,ndf->nbtf", tp.copy_in(xk),
                      p["cm_wk"].to(xn.dtype))
    kk = torch.square(torch.relu(kk))
    # cm_wv holds the rank's output columns: the whole kk in
    kv = torch.einsum("nbtf,nfd->nbtd", tp.gather_heads(kk),
                      p["cm_wv"].to(xn.dtype))
    rr = torch.sigmoid(torch.einsum("nbtd,nde->nbte", tp.copy_in(xr),
                                    p["cm_wr"].to(xn.dtype)))
    return tp.gather_last(rr * kv), xn[:, :, -1]


def forward(cfg, params, batch, *, mode="train", cache=None, pos=None,
            tp=NO_TP):
    """-> (logits, new cache or None, 0.0).  Every mode runs the same
    recurrence; a cache carries the token shifts and the wkv state.
    Under a ``tp`` seam the rows are rank-rows and the logits a rank's
    (..., Vp / M) (the module docstring)."""
    from repro_torch.models.transformer import _layer, _stack_layers, \
        embed_tokens, lm_logits
    if tp.M > 1:
        check_tp(cfg, tp.M)
    tokens = batch["tokens"]
    N, B, _ = tokens.shape
    D = cfg.d_model
    hd = cfg.rwkv_head_size
    Hl = D // hd // tp.M
    x = embed_tokens(cfg, params, tokens, tp)
    x = L.layernorm(x, _v(params["embed_ln"]), _v(params["embed_ln_b"]))
    new = []
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        if cache is None:
            tm_prev = cm_prev = None
            wkv = torch.zeros((N, B, Hl, hd, hd), dtype=F32, device=x.device)
        else:
            c = _layer(cache["blocks"], i)
            tm_prev, cm_prev, wkv = c["tm_shift"], c["cm_shift"], c["wkv"]
        a, tm_new, wkv_new = time_mix(cfg, p, x, tm_prev, wkv, tp)
        x = x + a
        m, cm_new = channel_mix(cfg, p, x, cm_prev, tp)
        x = x + m
        new.append({"tm_shift": tm_new.to(cfg.dtype),
                    "cm_shift": cm_new.to(cfg.dtype), "wkv": wkv_new})
    logits = lm_logits(cfg, params, x, tp)
    new_cache = None if cache is None else {"blocks": _stack_layers(new)}
    return logits, new_cache, 0.0


def init_cache(cfg, B, mk, model: int):
    """The token shifts whole, the wkv state of a rank's H / M heads
    (``model`` = M)."""
    D = cfg.d_model
    hd = cfg.rwkv_head_size
    if model > 1:
        check_tp(cfg, model)
    Hl = D // hd // model
    Ln = cfg.n_layers
    return {"blocks": {
        "tm_shift": mk((Ln, B, D)),
        "cm_shift": mk((Ln, B, D)),
        "wkv": mk((Ln, B, Hl, hd, hd)),
    }}
