"""Plain reference of the Whisper encoder-decoder (Radford et al.,
"Robust Speech Recognition via Large-Scale Weak Supervision",
arXiv:2212.04356; config.json of openai/whisper-large-v3).

Encoder: the frames (the output of the convolutional front end) plus
sinusoidal positions, then pre-norm layers of LayerNorm, full
self-attention, a residual add, LayerNorm, a GELU MLP, a residual add;
then a final LayerNorm.  Decoder: token embeddings plus learned
positions, pre-norm layers of causal self-attention, cross-attention to
the encoder's output and a GELU MLP, each with a residual add; a final
LayerNorm and the output head; the mean next-token cross entropy.  One
node, float32.

Departures from the published model, each the program's and stated in
the configuration file: the mel front end is left out (frames arrive as
its output); GELU is the tanh approximation; the key projections carry a
bias (zero at the start, and its gradient is nought under the softmax);
the layer norms inside the layers have no bias; the output head is a
matrix of its own; the vocabulary is padded to a multiple of
``vocab_pad_to``.
"""
from __future__ import annotations

import torch

from perfbench.reference import common as C

#: parameters under ``enc_`` see the encoder's frames in a step
TOKEN_STREAMS = {"enc_": "frames"}


def dims(cfg: dict):
    D = cfg["d_model"]
    H = cfg["decoder_attention_heads"]
    if cfg["encoder_attention_heads"] != H or \
            cfg["encoder_ffn_dim"] != cfg["decoder_ffn_dim"]:
        raise ValueError("the encoder and decoder share head and MLP widths")
    return (D, H, D // H, cfg["decoder_ffn_dim"], cfg["encoder_layers"],
            cfg["decoder_layers"],
            C.padded(cfg["vocab_size"], cfg["vocab_pad_to"]))


def _attn(D, L, prefix=""):
    return {prefix + "ln1": C.ones_leaf((L, D)),
            **{prefix + w: C.normal_leaf((L, D, D))
               for w in ("wq", "wk", "wv", "wo")},
            **{prefix + w + "_b": C.zeros_leaf((L, D))
               for w in ("wq", "wk", "wv", "wo")}}


def _mlp(D, F, L):
    return {"ln2": C.ones_leaf((L, D)), "w_in": C.normal_leaf((L, D, F)),
            "w_in_b": C.zeros_leaf((L, F)), "w_out": C.normal_leaf((L, F, D)),
            "w_out_b": C.zeros_leaf((L, D))}


def leaves(cfg: dict):
    """[(path, leaf spec)] in the state's order."""
    D, H, hd, F, Le, Ld, Vp = dims(cfg)
    spec = {f"enc_blocks/{k}": v
            for k, v in {**_attn(D, Le), **_mlp(D, F, Le)}.items()}
    spec.update({f"dec_blocks/{k}": v for k, v in
                 {**_attn(D, Ld), **_attn(D, Ld, "x_"),
                  **_mlp(D, F, Ld)}.items()})
    spec.update({"embed": C.normal_leaf((Vp, D), fan=D),
                  "enc_final_norm": C.ones_leaf((D,)),
                  "enc_final_norm_b": C.zeros_leaf((D,)),
                  "final_norm": C.ones_leaf((D,)),
                  "final_norm_b": C.zeros_leaf((D,)),
                  "lm_head": C.normal_leaf((D, Vp)),
                  "pos_embed": C.normal_leaf(
                      (cfg["max_target_positions"], D), fan=D)})
    return sorted(spec.items())


def _layer(p, prefix, i):
    n = len(prefix)
    return {k[n:]: v[i] for k, v in p.items() if k.startswith(prefix)}


def _attend(prec, cfg, p, x, src, causal, pre=""):
    D, H, hd = cfg["d_model"], cfg["decoder_attention_heads"], \
        cfg["d_model"] // cfg["decoder_attention_heads"]
    B, T, S = x.shape[0], x.shape[1], src.shape[1]
    q = C.linear(prec, x, p[pre + "wq"], p[pre + "wq_b"]).view(B, T, H, hd)
    k = C.linear(prec, src, p[pre + "wk"], p[pre + "wk_b"]).view(B, S, H, hd)
    v = C.linear(prec, src, p[pre + "wv"], p[pre + "wv_b"]).view(B, S, H, hd)
    return C.linear(prec, C.attention(prec, q, k, v, causal=causal),
                    p[pre + "wo"], p[pre + "wo_b"])


def _ln(x, scale, eps, bias=None):
    return C.layernorm(x, scale, torch.zeros_like(scale) if bias is None
                       else bias, eps)


def _mlp_add(prec, p, x, eps):
    h = _ln(x, p["ln2"], eps)
    return x + C.gelu_mlp(prec, h, p["w_in"], p["w_in_b"], p["w_out"],
                          p["w_out_b"])


def node_loss(cfg: dict, prec: C.Precision, p: dict, batch: dict):
    """One node's mean cross entropy: ``p`` its parameters by path,
    ``batch`` its ``frames`` (B, S, D), ``tokens`` and ``labels`` (B,
    T)."""
    D, H, hd, F, Le, Ld, Vp = dims(cfg)
    eps = cfg["layer_norm_eps"]
    frames = batch["frames"]
    x = frames + C.sinusoids(frames.shape[1], D, frames.device)
    for i in range(Le):
        lp = _layer(p, "enc_blocks/", i)
        h = _ln(x, lp["ln1"], eps)
        x = x + _attend(prec, cfg, lp, h, h, causal=False)
        x = _mlp_add(prec, lp, x, eps)
    enc = _ln(x, p["enc_final_norm"], eps, p["enc_final_norm_b"])
    tokens = batch["tokens"]
    T = tokens.shape[1]
    pos = torch.arange(T, device=tokens.device).clamp(
        max=cfg["max_target_positions"] - 1)
    x = p["embed"][tokens] + p["pos_embed"][pos]
    for i in range(Ld):
        lp = _layer(p, "dec_blocks/", i)
        h = _ln(x, lp["ln1"], eps)
        x = x + _attend(prec, cfg, lp, h, h, causal=True)
        h = _ln(x, lp["x_ln1"], eps)
        x = x + _attend(prec, cfg, lp, h, enc, causal=False, pre="x_")
        x = _mlp_add(prec, lp, x, eps)
    x = _ln(x, p["final_norm"], eps, p["final_norm_b"])
    return C.cross_entropy(prec.mm(x, p["lm_head"]), batch["labels"])
