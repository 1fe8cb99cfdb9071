"""Mixture-of-Experts layer: top-k router with capacity-based dispatch
(+ optional always-on shared experts, DeepSeek-MoE style).

The port of ``repro.models.moe``, node-stacked: x (N, B, T, D) and every
weight with a leading node dim.  The same routing as the reference, token
for token:

* top-k over the router's softmax with ties broken toward the LOWER expert
  index (``jax.lax.top_k``'s order; ``torch.topk`` promises none, so the
  port takes the first k of a stable descending sort);
* each expert's queue filled in the order of the flattened (T, k) slots
  (a cumulative sum), tokens past ``capacity = ceil(T k / E * factor)``
  dropped;
* the Switch load-balance loss E * sum_e frac_tokens_e * frac_probs_e.

The dispatch and combine tensors (N, B, T, E, C) are scattered directly
from each (token, slot)'s expert and queue position: a token's k slots name
k distinct experts, so no (token, expert, position) entry takes two
contributions, and the values equal the reference's sum of one-hots over
the slots without its (B, T, k, E, C) intermediate.  Router and experts
compute in f32 whatever the model dtype, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.tp import NO_TP

F32 = torch.float32


def top_k_lower_index(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last dim, ties
    toward the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(T: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    return max(1, int(np.ceil(T * top_k / n_experts * capacity_factor)))


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor,
            experts_gate: torch.Tensor, experts_up: torch.Tensor,
            experts_down: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, shared=None, tp=NO_TP):
    """x (N, B, T, D); router_w (N, D, E); experts_* (N, E, D, F) /
    (N, E, F, D); ``shared`` None or (gate, up, down) SwiGLU weights.

    Under a ``tp`` seam of M > 1 (``repro_torch.models.tp``; the default
    ``NO_TP`` is the identity) the rows are rank-rows and the experts a
    rank's F-slices: the router is replicated, so the routing, dispatch
    and combine are computed on every rank; the experts' input and the
    gate values enter the rank's partial products through
    ``copy_in`` (so the router's gradient is summed over the ranks, and
    its aux-loss part, computed whole on every rank, is not); the shared
    experts are column- then row-parallel; one ``reduce_out`` sums the
    routed and shared partial outputs.

    Returns (out (N, B, T, D), aux (N,) f32: each node's load-balance
    loss)."""
    N, B, T, D = x.shape
    E = router_w.shape[-1]
    xf = x.to(F32)
    logits = torch.einsum("nbtd,nde->nbte", xf, router_w.to(F32))
    probs = torch.softmax(logits, dim=-1)                     # (N,B,T,E)
    gate_vals, gate_idx = top_k_lower_index(probs, top_k)     # (N,B,T,k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    C = capacity(T, top_k, E, capacity_factor)
    gate_vals, xe_in = tp.copy_in(gate_vals), tp.copy_in(xf)

    # queue position of each (token, slot) in its expert, slots in (T, k)
    # order: the count of earlier slots routed to the same expert
    # one-hot by a scatter: F.one_hot range-checks its input on the host
    assign = torch.zeros(gate_idx.shape + (E,), dtype=torch.int64,
                         device=x.device).scatter_(
        -1, gate_idx.unsqueeze(-1), 1).reshape(N, B, T * top_k, E)
    before = (assign.cumsum(dim=2) - assign).gather(
        -1, gate_idx.reshape(N, B, T * top_k, 1))[..., 0]
    pos = before.reshape(N, B, T, top_k)
    keep = (pos < C).to(F32)
    slot = gate_idx * C + pos.clamp(max=C - 1)                # (N,B,T,k)
    flat = (N, B, T, E * C)
    dispatch = torch.zeros(flat, dtype=F32, device=x.device).scatter_add(
        -1, slot, keep).reshape(N, B, T, E, C)
    combine = torch.zeros(flat, dtype=F32, device=x.device).scatter_add(
        -1, slot, keep * gate_vals).reshape(N, B, T, E, C)

    xe = torch.einsum("nbtd,nbtec->nbecd", xe_in, dispatch)
    g = torch.einsum("nbecd,nedf->nbecf", xe, experts_gate.to(F32))
    u = torch.einsum("nbecd,nedf->nbecf", xe, experts_up.to(F32))
    ye = torch.einsum("nbecf,nefd->nbecd", F.silu(g) * u,
                      experts_down.to(F32))
    out = torch.einsum("nbecd,nbtec->nbtd", ye, combine).to(x.dtype)

    frac_tokens = dispatch.sum(-1).mean(dim=(1, 2))           # (N, E)
    frac_probs = probs.mean(dim=(1, 2))
    aux = E * (frac_tokens * frac_probs).sum(-1)

    if shared is not None:
        sg, su, sd = shared
        xs = tp.copy_in(x)
        gsh = torch.einsum("nbtd,ndf->nbtf", xs, sg.to(x.dtype))
        ush = torch.einsum("nbtd,ndf->nbtf", xs, su.to(x.dtype))
        out = out + torch.einsum("nbtf,nfd->nbtd", F.silu(gsh) * ush,
                                 sd.to(x.dtype))
    return tp.reduce_out(out), aux
