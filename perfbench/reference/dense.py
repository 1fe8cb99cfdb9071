"""Plain reference of the Qwen3 decoder (Qwen Team, "Qwen3 Technical
Report", arXiv:2505.09388; config.json of Qwen/Qwen3-1.7B).

Pre-norm decoder layers: RMSNorm, grouped-query attention with RMSNorm on
each query and key head (qk-norm) and rotary positions, a residual add,
RMSNorm, a SwiGLU MLP, a residual add; then a final RMSNorm and the output
head, and the mean next-token cross entropy.  One node, float32.

Departures from the published model, each the program's and stated in
the configuration file: the output head is a matrix of its own
(``tie_word_embeddings`` false), and the vocabulary is padded to a
multiple of ``vocab_pad_to`` rows and columns, which the softmax covers.

Leaves are named and ordered as the program's state lays them out
(sorted paths, the layers stacked on a leading dim), so that the
benchmark can compare them leaf by leaf.
"""
from __future__ import annotations

from perfbench.reference import common as C

#: parameters whose names start with a key here see that input stream's
#: tokens in a step (every other parameter sees the labelled tokens)
TOKEN_STREAMS: dict = {}


def dims(cfg: dict):
    return (cfg["hidden_size"], cfg["num_attention_heads"],
            cfg["num_key_value_heads"], cfg["head_dim"],
            cfg["intermediate_size"], cfg["num_hidden_layers"],
            C.padded(cfg["vocab_size"], cfg["vocab_pad_to"]))


def leaves(cfg: dict):
    """[(path, leaf spec)] in the state's order."""
    D, H, KV, hd, F, L, Vp = dims(cfg)
    spec = {
        "blocks/k_norm": C.ones_leaf((L, hd)),
        "blocks/ln1": C.ones_leaf((L, D)),
        "blocks/ln2": C.ones_leaf((L, D)),
        "blocks/q_norm": C.ones_leaf((L, hd)),
        "blocks/w_down": C.normal_leaf((L, F, D)),
        "blocks/w_gate": C.normal_leaf((L, D, F)),
        "blocks/w_up": C.normal_leaf((L, D, F)),
        "blocks/wk": C.normal_leaf((L, D, KV * hd)),
        "blocks/wo": C.normal_leaf((L, H * hd, D)),
        "blocks/wq": C.normal_leaf((L, D, H * hd)),
        "blocks/wv": C.normal_leaf((L, D, KV * hd)),
        "embed": C.normal_leaf((Vp, D), fan=D),
        "final_norm": C.ones_leaf((D,)),
        "lm_head": C.normal_leaf((D, Vp)),
    }
    return sorted(spec.items())


def node_loss(cfg: dict, prec: C.Precision, p: dict, batch: dict):
    """One node's mean cross entropy: ``p`` its parameters by path,
    ``batch`` its ``tokens`` and ``labels`` (B, T)."""
    D, H, KV, hd, F, L, Vp = dims(cfg)
    eps = cfg["rms_norm_eps"]
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = p["embed"][tokens]
    for i in range(L):
        h = C.rmsnorm(x, p["blocks/ln1"][i], eps)
        q = prec.mm(h, p["blocks/wq"][i]).view(B, T, H, hd)
        k = prec.mm(h, p["blocks/wk"][i]).view(B, T, KV, hd)
        v = prec.mm(h, p["blocks/wv"][i]).view(B, T, KV, hd)
        q = C.rope(C.rmsnorm(q, p["blocks/q_norm"][i], eps),
                   cfg["rope_theta"])
        k = C.rope(C.rmsnorm(k, p["blocks/k_norm"][i], eps),
                   cfg["rope_theta"])
        x = x + prec.mm(C.attention(prec, q, k, v, causal=True),
                        p["blocks/wo"][i])
        h = C.rmsnorm(x, p["blocks/ln2"][i], eps)
        x = x + C.swiglu(prec, h, p["blocks/w_gate"][i],
                         p["blocks/w_up"][i], p["blocks/w_down"][i])
    logits = prec.mm(C.rmsnorm(x, p["final_norm"], eps), p["lm_head"])
    return C.cross_entropy(logits, batch["labels"])
