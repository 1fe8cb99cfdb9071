"""Plain reference of the DeepSeekMoE decoder (Dai et al., "DeepSeekMoE:
Towards Ultimate Expert Specialization in Mixture-of-Experts Language
Models", arXiv:2401.06066; config.json of
deepseek-ai/deepseek-moe-16b-base), as one chip of an expert-parallel
group holds it.

Pre-norm decoder layers: RMSNorm, multi-head attention with rotary
positions, a residual add, RMSNorm, a feed-forward block, a residual add;
then a final RMSNorm, the output head and the mean next-token cross
entropy.  The first ``first_k_dense_replace`` layers' feed-forward block
is a dense SwiGLU of width ``intermediate_size``; every later one is the
expert layer:

* the router: logits x W_r over all ``router_outputs`` experts, their
  softmax s (float32), the ``num_experts_per_tok`` largest (ties toward
  the lower index), each gate the softmax value itself
  (``norm_topk_prob`` false);
* the routed experts, SwiGLUs of width ``moe_intermediate_size``: a
  token's output adds g_e SwiGLU_e(x) for each of its experts e that this
  chip holds, [first_held_expert, first_held_expert +
  n_routed_experts), run here as a loop over the held experts, each on
  the rows routed to it (no capacity: no token is dropped);
* the shared experts, one SwiGLU of width n_shared_experts x
  moe_intermediate_size, on every token;
* the balance loss, sequence-wise (``seq_aux``): for each sequence of T
  tokens, f_i = E / (k T) #{t : i in top-k(t)} and P_i = mean_t s_{i,t}
  over all E router outputs, L = sum_i f_i P_i, averaged over the node's
  sequences and weighted by ``aux_loss_alpha``.  It is added to the
  gradient; the loss reported is the cross entropy alone, as the
  program reports it.

One node, float32.  Departures from the published model, each stated in
the configuration file: the share (this chip's 8 of the 64 routed
experts; what the other chips' experts would add is left out here as in
the program, and that partial sum goes on to the next layer); the
vocabulary is the first eighth of the published one (12,800 rows, a
multiple of ``vocab_pad_to``, so nothing is padded); 5 of the 28 layers;
float32 for bfloat16.

Leaves are named and ordered as the program's state lays them out
(sorted paths, the layers of a group stacked on a leading dim: the
leading dense layers under ``dense_blocks``, the expert layers under
``blocks``).
"""
from __future__ import annotations

import torch

from perfbench.reference import common as C

#: every parameter sees the labelled tokens (the routed experts see the
#: rows routed to them; ``perfbench/moe_yard.py`` counts those)
TOKEN_STREAMS: dict = {}


def dims(cfg: dict) -> dict:
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg["scoring_func"] != "softmax" or not cfg["seq_aux"] or \
            cfg["moe_layer_freq"] != 1:
        raise ValueError("the reference routes by softmax, with the "
                         "sequence-wise balance loss, every layer after "
                         "the dense ones")
    return {"D": D, "H": H, "KV": cfg["num_key_value_heads"],
            "hd": cfg["head_dim"],
            "F_dense": cfg["intermediate_size"],
            "F": cfg["moe_intermediate_size"],
            "L_dense": cfg["first_k_dense_replace"],
            "L_moe": cfg["num_hidden_layers"] - cfg["first_k_dense_replace"],
            "E": cfg["router_outputs"], "held": cfg["n_routed_experts"],
            "first": cfg["first_held_expert"],
            "k": cfg["num_experts_per_tok"],
            "Fs": cfg["n_shared_experts"] * cfg["moe_intermediate_size"],
            "Vp": C.padded(cfg["vocab_size"], cfg["vocab_pad_to"])}


def _attention_leaves(prefix: str, L: int, d: dict) -> dict:
    D, H, KV, hd = d["D"], d["H"], d["KV"], d["hd"]
    return {prefix + "ln1": C.ones_leaf((L, D)),
            prefix + "ln2": C.ones_leaf((L, D)),
            prefix + "wk": C.normal_leaf((L, D, KV * hd)),
            prefix + "wo": C.normal_leaf((L, H * hd, D)),
            prefix + "wq": C.normal_leaf((L, D, H * hd)),
            prefix + "wv": C.normal_leaf((L, D, KV * hd))}


def leaves(cfg: dict):
    """[(path, leaf spec)] in the state's order."""
    d = dims(cfg)
    D, F, Fd, Fs, L, Ld = d["D"], d["F"], d["F_dense"], d["Fs"], \
        d["L_moe"], d["L_dense"]
    Eh = d["held"]
    spec = {
        **_attention_leaves("blocks/", L, d),
        "blocks/experts_down": C.normal_leaf((L, Eh, F, D)),
        "blocks/experts_gate": C.normal_leaf((L, Eh, D, F)),
        "blocks/experts_up": C.normal_leaf((L, Eh, D, F)),
        "blocks/router": C.normal_leaf((L, D, d["E"])),
        "blocks/shared_down": C.normal_leaf((L, Fs, D)),
        "blocks/shared_gate": C.normal_leaf((L, D, Fs)),
        "blocks/shared_up": C.normal_leaf((L, D, Fs)),
        "embed": C.normal_leaf((d["Vp"], D), fan=D),
        "final_norm": C.ones_leaf((D,)),
        "lm_head": C.normal_leaf((D, d["Vp"])),
    }
    if Ld:
        spec.update(_attention_leaves("dense_blocks/", Ld, d))
        spec.update({"dense_blocks/w_down": C.normal_leaf((Ld, Fd, D)),
                     "dense_blocks/w_gate": C.normal_leaf((Ld, D, Fd)),
                     "dense_blocks/w_up": C.normal_leaf((Ld, D, Fd))})
    return sorted(spec.items())


def top_k(s: torch.Tensor, k: int):
    """The ``k`` largest of ``s`` along the last dim, ties toward the lower
    index -> (values, indices)."""
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    idx = order[..., :k]
    return s.gather(-1, idx), idx


def balance_loss(s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """DeepSeekMoE's sequence-wise balance loss of one node: ``s`` (B, T,
    E) the router's softmax, ``idx`` (B, T, k) the routed experts."""
    B, T, E = s.shape
    k = idx.shape[-1]
    count = torch.zeros((B, E), device=s.device).scatter_add_(
        1, idx.reshape(B, T * k), torch.ones((B, T * k), device=s.device))
    f = E / (k * T) * count
    P = s.mean(1)
    return (f * P).sum(-1).mean()


def expert_layer(prec: C.Precision, d: dict, h: torch.Tensor, p: dict,
                 i: int):
    """Expert layer ``i`` on the normed activations ``h`` (B, T, D) -> (its
    output, its balance loss)."""
    B, T, D = h.shape
    s = torch.softmax(prec.mm(h, p["blocks/router"][i]), -1)
    gates, idx = top_k(s, d["k"])
    x = h.reshape(B * T, D)
    flat_idx, flat_g = idx.reshape(B * T, -1), gates.reshape(B * T, -1)
    out = torch.zeros_like(x)
    for e in range(d["held"]):
        hit = flat_idx == d["first"] + e                   # (B T, k)
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        g = (flat_g * hit).sum(-1)[rows]
        y = C.swiglu(prec, x[rows], p["blocks/experts_gate"][i, e],
                     p["blocks/experts_up"][i, e],
                     p["blocks/experts_down"][i, e])
        out = out.index_add(0, rows, g[:, None] * y)
    out = out.reshape(B, T, D) + C.swiglu(
        prec, h, p["blocks/shared_gate"][i], p["blocks/shared_up"][i],
        p["blocks/shared_down"][i])
    return out, balance_loss(s, idx)


def _attention(prec, d, cfg, x, p, prefix, i):
    B, T, _ = x.shape
    H, KV, hd = d["H"], d["KV"], d["hd"]
    h = C.rmsnorm(x, p[prefix + "ln1"][i], cfg["rms_norm_eps"])
    q = prec.mm(h, p[prefix + "wq"][i]).view(B, T, H, hd)
    k = prec.mm(h, p[prefix + "wk"][i]).view(B, T, KV, hd)
    v = prec.mm(h, p[prefix + "wv"][i]).view(B, T, KV, hd)
    q, k = C.rope(q, cfg["rope_theta"]), C.rope(k, cfg["rope_theta"])
    return x + prec.mm(C.attention(prec, q, k, v, causal=True),
                       p[prefix + "wo"][i])


def node_loss(cfg: dict, prec: C.Precision, p: dict, batch: dict):
    """One node's mean cross entropy, whose gradient is that of the cross
    entropy plus ``aux_loss_alpha`` times the summed balance losses:
    ``p`` its parameters by path, ``batch`` its ``tokens`` and ``labels``
    (B, T)."""
    d = dims(cfg)
    eps = cfg["rms_norm_eps"]
    x = p["embed"][batch["tokens"]]
    for i in range(d["L_dense"]):
        x = _attention(prec, d, cfg, x, p, "dense_blocks/", i)
        h = C.rmsnorm(x, p["dense_blocks/ln2"][i], eps)
        x = x + C.swiglu(prec, h, p["dense_blocks/w_gate"][i],
                         p["dense_blocks/w_up"][i],
                         p["dense_blocks/w_down"][i])
    aux = 0.0
    for i in range(d["L_moe"]):
        x = _attention(prec, d, cfg, x, p, "blocks/", i)
        y, a = expert_layer(prec, d, C.rmsnorm(x, p["blocks/ln2"][i], eps),
                            p, i)
        x, aux = x + y, aux + a
    logits = prec.mm(C.rmsnorm(x, p["final_norm"], eps), p["lm_head"])
    ce = C.cross_entropy(logits, batch["labels"])
    weighted = cfg["aux_loss_alpha"] * aux
    return ce + (weighted - weighted.detach())
