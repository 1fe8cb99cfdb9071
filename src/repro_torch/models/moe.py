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

The expert-share path (``dropless=True``; DeepSeekMoE's layer as an
expert-parallel chip holds it) routes over the router's E experts and
computes only the experts it holds, [first, first + held), with no
capacity: the slots routed to a held expert are sorted by (node, held
expert) on the device (:func:`repro_torch.kernels.moe.plan`), their rows
gathered, each group run through its expert's SwiGLU by grouped
products, and the gated outputs added back to their tokens.  What the
absent experts would add is left out.  No (..., T, E, C) tensor is made
and nothing is read back to the host.  Its gates and balance loss are
DeepSeekMoE's: the top-k softmax probabilities as they are (not
renormalised), and the sequence-wise loss (per sequence f_i = E / (k T)
#{t: i in top-k(t)}, P_i = mean_t s_{i,t}, sum_i f_i P_i, averaged over
a node's sequences).  Its four parts run under the phases ``moe/route``,
``moe/dispatch``, ``moe/experts`` and ``moe/combine``
(:func:`repro_torch.obs.trace.phase`), in forward and in backward, and
each call adds the rows each (node, held expert) computed to the
``moe/rows`` counter (:func:`repro_torch.obs.trace.count`) and its widths
(nodes, tokens a node, routed experts a token, D, F; a host tensor) to
``moe/shape``, all only while a profiler records.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import moe as kmoe
from repro_torch.models.tp import NO_TP
from repro_torch.obs import trace

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
            capacity_factor: float = 1.25, shared=None, tp=NO_TP,
            first_expert: int = 0, dropless: bool = False):
    """x (N, B, T, D); router_w (N, D, E); experts_* (N, E, D, F) /
    (N, E, F, D); ``shared`` None or (gate, up, down) SwiGLU weights.

    ``dropless``: the expert-share path (module docstring), where the
    experts' leading dim is the ``held`` experts from ``first_expert``
    (any held <= E); else the capacity path, the reference's layer, which
    holds all E experts, renormalises the gates and takes the Switch
    loss.

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
    if dropless:
        return _moe_share(x, router_w, experts_gate, experts_up,
                          experts_down, top_k=top_k, shared=shared, tp=tp,
                          first=first_expert)
    if first_expert or experts_gate.shape[1] != router_w.shape[-1]:
        raise ValueError(f"the capacity path holds all {router_w.shape[-1]} "
                         f"experts; a share ({experts_gate.shape[1]} from "
                         f"{first_expert}) takes dropless=True")
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
    loss = E * (frac_tokens * frac_probs).sum(-1)
    return tp.reduce_out(_add_shared(out, x, shared, tp)), loss


def _add_shared(out, x, shared, tp):
    if shared is None:
        return out
    sg, su, sd = shared
    xs = tp.copy_in(x)
    gsh = torch.einsum("nbtd,ndf->nbtf", xs, sg.to(x.dtype))
    ush = torch.einsum("nbtd,ndf->nbtf", xs, su.to(x.dtype))
    return out + torch.einsum("nbtf,nfd->nbtd", F.silu(gsh) * ush,
                              sd.to(x.dtype))


def balance_coef(idx: torch.Tensor, E: int) -> torch.Tensor:
    """(N, B, E): DeepSeekMoE's sequence-wise balance loss as sum_{b, t,
    i} coef[n, b, i] s[n, b, t, i] over the router's softmax s, from the
    routed experts ``idx`` (N, B, T, k) (the token counts carry no
    gradient): E / (k T) counts a sequence, mean_t, mean over the
    sequences."""
    N, B, T, k = idx.shape
    cnt = torch.zeros((N, B, E), dtype=F32, device=idx.device).scatter_add_(
        -1, idx.reshape(N, B, T * k), torch.ones((N, B, T * k), dtype=F32,
                                                 device=idx.device))
    return E * cnt / (k * T * T * B)


class _Route(torch.autograd.Function):
    """The router of the expert-share path: f32 logits over all E
    experts, their softmax, the top k (ties toward the lower index), whose
    probabilities are the gates, and the balance loss; backward by hand,
    under the same phase."""

    @staticmethod
    def forward(ctx, x, w, k: int):
        N, B, T, D = x.shape
        E = w.shape[-1]
        with trace.phase("moe/route", x.device,
                         bytes=4 * (x.numel() + w.numel() + 2 * N * B * T
                                    * E)):
            probs = torch.softmax(torch.einsum("nbtd,nde->nbte", x, w), -1)
            gates, idx = top_k_lower_index(probs, k)
            coef = balance_coef(idx, E)
            loss = (coef * probs.sum(2)).sum((1, 2))
        ctx.save_for_backward(x, w, probs, idx, coef)
        ctx.mark_non_differentiable(idx)
        return gates, idx, loss

    @staticmethod
    def backward(ctx, d_gates, _d_idx, d_loss):
        x, w, probs, idx, coef = ctx.saved_tensors
        with trace.phase("moe/route", x.device,
                         bytes=4 * (2 * x.numel() + 2 * w.numel()
                                    + 2 * probs.numel())):
            dp = torch.zeros_like(probs).scatter_(-1, idx, d_gates)
            if d_loss is not None:
                dp = dp + d_loss[:, None, None, None] * coef[:, :, None, :]
            dl = probs * (dp - (probs * dp).sum(-1, keepdim=True))
            dx = torch.einsum("nbte,nde->nbtd", dl, w)
            dw = torch.einsum("nbtd,nbte->nde", x, dl)
        return dx, dw, None


def _live_bytes(p: kmoe.Plan, per_row: int, fixed: int = 0):
    """A phase's bytes: ``per_row`` for each live row, counted on the
    device (resolved after the window), plus ``fixed``."""
    return lambda: p.offsets[-1] * per_row + fixed


class _HeldExperts(torch.autograd.Function):
    """The held experts' part of the layer: dispatch (gather the live
    rows), experts (each group's SwiGLU by grouped products), combine
    (the gated rows added back to their tokens), and their transposes in
    backward, each under its phase."""

    @staticmethod
    def forward(ctx, x2, gates, wg, wu, wd, p: kmoe.Plan):
        M, D = x2.shape
        F_ = wg.shape[-1]
        dev = x2.device
        with trace.phase("moe/dispatch", dev, bytes=_live_bytes(p, 8 * D)):
            xs = kmoe.gather(x2, p.tok, p)
        with trace.phase("moe/experts", dev, bytes=_live_bytes(
                p, 4 * (2 * D + 5 * F_), 12 * wg.numel())):
            a = kmoe.rows_mm(xs, wg, p)
            b = kmoe.rows_mm(xs, wu, p)
            del xs
            y = kmoe.rows_mm(F.silu(a) * b, wd, p)
        with trace.phase("moe/combine", dev,
                         bytes=_live_bytes(p, 4 * D, 4 * M * D)):
            out = kmoe.combine(y, p.pos, gates)
        ctx.save_for_backward(x2, gates, wg, wu, wd, a, b)
        ctx.plan = p
        return out

    @staticmethod
    def backward(ctx, d_out):
        x2, gates, wg, wu, wd, a, b = ctx.saved_tensors
        p = ctx.plan
        M, D = x2.shape
        F_ = wg.shape[-1]
        dev = x2.device
        with trace.phase("moe/combine", dev, bytes=_live_bytes(p, 8 * D)):
            dyu = kmoe.gather(d_out.contiguous(), p.tok, p)
        with trace.phase("moe/dispatch", dev, bytes=_live_bytes(p, 8 * D)):
            xs = kmoe.gather(x2, p.tok, p)
        with trace.phase("moe/experts", dev, bytes=_live_bytes(
                p, 4 * (4 * D + 12 * F_), 24 * wg.numel())):
            g = gates.reshape(-1)[p.order][:, None]
            dhu = kmoe.rows_mm(dyu, wd, p, transpose=True)
            sa = torch.sigmoid(a)
            h = a * sa * b
            d_rows = (dhu * h).sum(-1)
            dwd = kmoe.wgrad(h * g, dyu, p)
            del h, dyu
            dh = dhu * g
            del dhu
            da = dh * b * sa * (1 + a * (1 - sa))
            db = dh * a * sa
            del dh, sa
            dwg = kmoe.wgrad(xs, da, p)
            dwu = kmoe.wgrad(xs, db, p)
            del xs
            dxs = kmoe.rows_mm(da, wg, p, transpose=True)
            kmoe.rows_mm(db, wu, p, transpose=True, out=dxs, accumulate=True)
            del da, db
        with trace.phase("moe/dispatch", dev,
                         bytes=_live_bytes(p, 4 * D, 4 * M * D)):
            dx2 = kmoe.combine(dxs, p.pos, None)
        d_gates = torch.where(p.pos >= 0, d_rows[p.pos.clamp(min=0)], 0.0)
        return dx2, d_gates, dwg, dwu, dwd, None


def _moe_share(x, router_w, eg, eu, ed, *, top_k, shared, tp, first):
    """The expert-share path of :func:`moe_mlp`."""
    if tp.M > 1:
        raise ValueError("the expert-share path runs whole nodes (M = 1)")
    N, B, T, D = x.shape
    E, held = router_w.shape[-1], eg.shape[1]
    if not 0 <= first <= E - held:
        raise ValueError(f"held experts [{first}, {first + held}) lie "
                         f"outside the router's {E}")
    xf = x.to(F32)
    gates, idx, loss = _Route.apply(xf, router_w.to(F32), top_k)
    with trace.phase("moe/route", x.device):
        p = kmoe.plan(idx, first, held)
        trace.count("moe/rows", p.counts)
        trace.count("moe/shape", lambda: torch.tensor(
            [N, B * T, top_k, D, eg.shape[-1]]))
    out = _HeldExperts.apply(xf.reshape(N * B * T, D),
                             gates.reshape(N * B * T, top_k),
                             eg.to(F32), eu.to(F32), ed.to(F32), p)
    out = out.reshape(N, B, T, D).to(x.dtype)
    return _add_shared(out, x, shared, tp), loss
