"""The expert-share MoE layer (``repro_torch.models.moe``'s dropless path
and ``repro_torch.kernels.moe``) at small widths on the CPU, and its
kernels on the card.

* The share: with the router's E experts split into S shares, the held
  parts summed over the shares, plus the shared experts once, are the
  uncut layer that holds every expert -- outputs and gradients -- and
  every share computes the same balance loss.
* Dropless: the layer equals a plain loop over the experts, each on the
  rows routed to it, under even and skewed routing (an expert that no
  token picks, an expert that every token picks).
* With every new option off the layer is the capacity layer (Mixtral's
  rule: renormalised gates, Switch's balance loss, tokens past capacity
  dropped), written out here as the reference, bit for bit.
* The published DeepSeekMoE layout through ``api.build`` and the
  trainer's step (a leading dense layer, then expert layers that hold 4
  of 16 experts), its decode against its teacher-forced forward, and the
  balance loss weighted by the ``aux_weight`` the model spec states.
* The phases ``moe/route``, ``moe/dispatch``, ``moe/experts`` and
  ``moe/combine`` record in forward and in backward while a profiler
  runs, and the ``moe/rows`` counter counts each (node, held expert)'s
  rows; nothing records without a profiler.
* ``cuda``: the kernels (M1, M2 in CUDA, M3, M4 in Triton) against
  their plain twins at the ``deepseek-moe-16b.ring4`` cell's widths,
  under even and skewed routing, and the layer on the card against the
  CPU (even routing: see the test).

Tolerances: the dropless path adds a token's expert outputs in another
order than the loop and than the capacity path's einsums, so f32 results
agree to ~1e-6 of their scale; 1e-5 (outputs) and 1e-4 (gradients, whose
backward adds more terms) leave room for that rounding only.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import api
from repro_torch.configs import get as get_config
from repro_torch.kernels import moe as kmoe
from repro_torch.models import moe
from repro_torch.models import transformer as TR
from repro_torch.obs import trace

N, B, T, D, FF = 2, 2, 12, 24, 10
E, K, SHARES = 16, 4, 4
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def _rel(a, b) -> float:
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _inputs(seed: int, routing: str = "even", shared: bool = True):
    """x (N, B, T, D), the router (N, D, E), E experts' SwiGLU weights and
    the shared experts' (width 2 FF), all requiring gradients.
    ``routing``: ``even`` random; ``idle`` no token picks expert 3;
    ``all`` every token picks expert 5."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).requires_grad_()

    x = torch.randn((N, B, T, D), generator=g)
    rw = torch.randn((N, D, E), generator=g) / D ** 0.5
    if routing != "even":
        # dim 0 of every token is 4: a router row of +-3 there moves one
        # expert's logit by +-12, above or below every other
        x[..., 0] = 4.0
        rw[:, 0] = 0.0
        rw[:, 0, 3 if routing == "idle" else 5] = \
            -3.0 if routing == "idle" else 3.0
    w = {"x": x.requires_grad_(), "router": rw.requires_grad_(),
         "gate": rnd(N, E, D, FF, scale=D ** -0.5),
         "up": rnd(N, E, D, FF, scale=D ** -0.5),
         "down": rnd(N, E, FF, D, scale=FF ** -0.5)}
    if shared:
        w.update(sg=rnd(N, D, 2 * FF, scale=D ** -0.5),
                 su=rnd(N, D, 2 * FF, scale=D ** -0.5),
                 sd=rnd(N, 2 * FF, D, scale=(2 * FF) ** -0.5))
    return w


def _shared(w):
    return (w["sg"], w["su"], w["sd"]) if "sg" in w else None


def _share(w, s: int, held: int, shared: bool = False):
    """Share ``s`` of ``held`` experts: the layer's output and loss."""
    sl = slice(s * held, (s + 1) * held)
    return moe.moe_mlp(w["x"], w["router"], w["gate"][:, sl],
                       w["up"][:, sl], w["down"][:, sl], top_k=K,
                       shared=_shared(w) if shared else None,
                       first_expert=s * held, dropless=True)


def _loop_layer(w, first: int, held: int):
    """The held experts' part by a plain loop over the experts, each on
    the rows routed to it with its softmax probability as the gate, and
    the shared experts."""
    x = w["x"]
    s = torch.softmax(torch.einsum("nbtd,nde->nbte", x, w["router"]), -1)
    vals, idx = moe.top_k_lower_index(s, K)
    out = torch.zeros_like(x)
    for n in range(N):
        xn = x[n].reshape(-1, D)
        on = torch.zeros_like(xn)
        fi, fv = idx[n].reshape(-1, K), vals[n].reshape(-1, K)
        for e in range(held):
            hit = fi == first + e
            rows = hit.any(-1).nonzero()[:, 0]
            if rows.numel() == 0:
                continue
            h = F.silu(xn[rows] @ w["gate"][n, e]) * (xn[rows]
                                                      @ w["up"][n, e])
            on = on.index_add(0, rows, (fv * hit).sum(-1)[rows, None]
                              * (h @ w["down"][n, e]))
        out = torch.cat([out[:n], on.reshape(1, B, T, D), out[n + 1:]])
    if "sg" in w:
        hs = F.silu(x @ w["sg"][:, None]) * (x @ w["su"][:, None])
        out = out + hs @ w["sd"][:, None]
    return out


def _grads(out, loss, w, probe):
    total = (out * probe).sum() + loss.sum()
    names = [k for k in w if w[k].requires_grad]
    gs = torch.autograd.grad(total, [w[k] for k in names],
                             allow_unused=True)
    return {k: (torch.zeros_like(w[k]) if g is None else g)
            for k, g in zip(names, gs)}


# --- the share against the uncut layer ---------------------------------------

@pytest.mark.parametrize("what", ["outputs", "gradients"])
def test_the_shares_add_up_to_the_uncut_layer(what):
    w = _inputs(1)
    held = E // SHARES
    full, full_loss = _share(w, 0, E, shared=True)
    probe = torch.randn(full.shape, generator=torch.Generator().manual_seed(2))
    parts = [_share(w, s, held) for s in range(SHARES)]
    shared_only = full - sum(p[0] for p in parts)
    hs = F.silu(w["x"] @ w["sg"][:, None]) * (w["x"] @ w["su"][:, None])
    if what == "outputs":
        assert _rel(sum(p[0] for p in parts) + hs @ w["sd"][:, None],
                    full) <= OUT_TOL
        assert _rel(shared_only, hs @ w["sd"][:, None]) <= OUT_TOL
        return
    want = _grads(full, full_loss, w, probe)
    got = {k: torch.zeros_like(v) for k, v in want.items()}
    for s, (out, loss) in enumerate(parts):
        # the balance loss comes from the replicated router: count it once
        g = _grads(out, loss if s == 0 else 0 * loss, w, probe)
        for k in got:
            got[k] += g[k]
    shared_out = hs @ w["sd"][:, None]
    g = _grads(shared_out, torch.zeros(()), w, probe)
    for k in got:
        got[k] += g[k]
    for k in want:
        assert _rel(got[k], want[k]) <= GRAD_TOL, k


@pytest.mark.parametrize("routing", ["even", "all"])
def test_every_share_computes_the_same_balance_loss(routing):
    w = _inputs(3, routing, shared=False)
    held = E // SHARES
    losses = [_share(w, s, held)[1] for s in range(SHARES)]
    for loss in losses[1:]:
        assert torch.equal(loss, losses[0])
    s = torch.softmax(torch.einsum("nbtd,nde->nbte", w["x"], w["router"]),
                      -1)
    idx = moe.top_k_lower_index(s, K)[1]
    count = torch.zeros((N, B, E)).scatter_add_(
        -1, idx.reshape(N, B, T * K), torch.ones((N, B, T * K)))
    # DeepSeekMoE's: per sequence, then the mean over a node's sequences
    want = (E / (K * T) * count * s.mean(2)).sum(-1).mean(1)
    assert _rel(losses[0], want) <= OUT_TOL


# --- dropless against the per-expert loop -------------------------------------

@pytest.mark.parametrize("routing", ["even", "idle", "all"])
def test_dropless_equals_the_loop_over_experts(routing):
    w = _inputs(4, routing)
    held, first = 8, 4          # experts 4-11: 5 among them
    sl = slice(first, first + held)
    ws = dict(w, gate=w["gate"][:, sl], up=w["up"][:, sl],
              down=w["down"][:, sl])
    out, loss = moe.moe_mlp(w["x"], w["router"], ws["gate"], ws["up"],
                            ws["down"], top_k=K, shared=_shared(w),
                            first_expert=first, dropless=True)
    want = _loop_layer(ws, first, held)
    assert _rel(out, want) <= OUT_TOL
    if routing != "even":
        idx = moe.top_k_lower_index(torch.softmax(torch.einsum(
            "nbtd,nde->nbte", w["x"], w["router"]), -1), K)[1]
        picked = (idx == (3 if routing == "idle" else 5)).any(-1)
        assert bool((~picked).all() if routing == "idle" else picked.all())
    probe = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    got = _grads(out, torch.zeros(()), w, probe)
    ref = _grads(want, torch.zeros(()), w, probe)
    for k in ref:
        assert _rel(got[k], ref[k]) <= GRAD_TOL, k


def test_the_plan_sorts_every_held_slot_by_node_and_expert():
    g = torch.Generator().manual_seed(6)
    idx = torch.stack([torch.randperm(E, generator=g)[:K]
                       for _ in range(N * B * T)]).view(N, B, T, K)
    first, held = 4, 4
    p = kmoe.plan(idx, first, held)
    S = N * B * T * K
    assert p.rows == S and p.groups == N * held
    off = p.offsets.tolist()
    rel = idx.reshape(N, -1) - first
    for n in range(N):
        for e in range(held):
            rows = list(range(off[n * held + e], off[n * held + e + 1]))
            assert len(rows) == int((rel[n] == e).sum())
            slots = p.order[rows]
            assert bool((idx.reshape(-1)[slots] == first + e).all())
            assert bool((slots // (B * T * K) == n).all())
            assert bool((slots.diff() > 0).all())       # token order kept
    held_slots = ((rel >= 0) & (rel < held)).reshape(-1)
    assert off[-1] == int(held_slots.sum())
    pos = p.pos.reshape(-1)
    assert bool((pos[~held_slots] == -1).all())
    assert torch.equal(p.order[pos[held_slots]],
                       held_slots.nonzero()[:, 0])
    assert torch.equal(p.counts().sum(), torch.tensor(off[-1]))


# --- every option off: the capacity layer --------------------------------------

def _capacity_layer(x, router_w, eg, eu, ed, *, top_k, capacity_factor,
                    shared):
    """The capacity layer written out: renormalised top-k gates, each
    expert's queue cut at its capacity in (T, k) order, dense one-hot
    dispatch and combine, Switch's balance loss over the dispatched
    tokens."""
    Nn, Bb, Tt, _ = x.shape
    Ee = router_w.shape[-1]
    probs = torch.softmax(torch.einsum("nbtd,nde->nbte", x, router_w), -1)
    vals, idx = moe.top_k_lower_index(probs, top_k)
    vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    C = moe.capacity(Tt, top_k, Ee, capacity_factor)
    assign = torch.zeros(idx.shape + (Ee,), dtype=torch.int64).scatter_(
        -1, idx.unsqueeze(-1), 1).reshape(Nn, Bb, Tt * top_k, Ee)
    pos = (assign.cumsum(2) - assign).gather(
        -1, idx.reshape(Nn, Bb, Tt * top_k, 1))[..., 0].reshape(idx.shape)
    keep = (pos < C).float()
    slot = idx * C + pos.clamp(max=C - 1)
    flat = (Nn, Bb, Tt, Ee * C)
    dispatch = torch.zeros(flat).scatter_add(-1, slot, keep).reshape(
        Nn, Bb, Tt, Ee, C)
    combine = torch.zeros(flat).scatter_add(-1, slot, keep * vals).reshape(
        Nn, Bb, Tt, Ee, C)
    xe = torch.einsum("nbtd,nbtec->nbecd", x, dispatch)
    g = torch.einsum("nbecd,nedf->nbecf", xe, eg)
    u = torch.einsum("nbecd,nedf->nbecf", xe, eu)
    ye = torch.einsum("nbecf,nefd->nbecd", F.silu(g) * u, ed)
    out = torch.einsum("nbecd,nbtec->nbtd", ye, combine)
    aux = Ee * (dispatch.sum(-1).mean(dim=(1, 2))
                * probs.mean(dim=(1, 2))).sum(-1)
    if shared is not None:
        sg, su, sd = shared
        gsh = torch.einsum("nbtd,ndf->nbtf", x, sg)
        ush = torch.einsum("nbtd,ndf->nbtf", x, su)
        out = out + torch.einsum("nbtf,nfd->nbtd", F.silu(gsh) * ush, sd)
    return out, aux


@pytest.mark.parametrize("shared", [False, True])
def test_with_every_option_off_the_layer_is_the_capacity_layer(shared):
    w = _inputs(7, shared=shared)
    args = (w["x"], w["router"], w["gate"], w["up"], w["down"])
    got = moe.moe_mlp(*args, top_k=K, capacity_factor=0.75,
                      shared=_shared(w))
    want = _capacity_layer(*args, top_k=K, capacity_factor=0.75,
                           shared=_shared(w))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    probe = torch.randn(got[0].shape)
    ga, gb = _grads(*got, w, probe), _grads(*want, w, probe)
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k


def test_the_capacity_layer_refuses_a_share():
    w = _inputs(8, shared=False)
    with pytest.raises(ValueError, match="dropless=True"):
        moe.moe_mlp(w["x"], w["router"], w["gate"][:, :4], w["up"][:, :4],
                    w["down"][:, :4], top_k=K)
    with pytest.raises(ValueError, match="dropless=True"):
        moe.moe_mlp(w["x"], w["router"], w["gate"], w["up"], w["down"],
                    top_k=K, first_expert=1)
    with pytest.raises(ValueError, match="outside the router"):
        moe.moe_mlp(w["x"], w["router"], w["gate"][:, :4], w["up"][:, :4],
                    w["down"][:, :4], top_k=K, first_expert=13,
                    dropless=True)


# --- the published layout through the normal path ------------------------------

def _published(**over) -> TR.ModelConfig:
    """deepseek-moe-16b's layout at small widths: 1 dense layer of width
    48, then 2 expert layers on the expert-share path holding experts 4-7
    of 16, top 4, 2 shared."""
    cfg = get_config("deepseek-moe-16b").reduced(n_layers=3, d_model=32,
                                                 n_experts=16)
    return dataclasses.replace(
        cfg, top_k=K, n_shared_experts=2, first_k_dense=1, dense_d_ff=48,
        n_experts_held=4, expert_offset=4, moe_dropless=True, **over)


def test_the_published_layout_lays_out_a_dense_group_and_held_experts():
    cfg = _published()
    shapes = {p: tuple(x.shape) for p, x in
              api.tree.flatten_with_paths(TR.abstract_params(cfg))}
    assert shapes["dense_blocks/w_gate"] == (1, 32, 48)
    assert shapes["blocks/router"] == (2, 32, 16)
    assert shapes["blocks/experts_gate"] == (2, 4, 32, cfg.d_ff)
    assert "blocks/w_gate" not in shapes
    assert list(shapes) == sorted(shapes)
    with pytest.raises(ValueError, match="outside the router"):
        TR.abstract_params(dataclasses.replace(cfg, expert_offset=13))


def test_the_trainer_weights_the_balance_loss_by_the_model():
    """The model spec's ``aux_weight`` (a configuration's published
    balance weight) is the trainer's, not a model field."""
    cfg = _published(dtype=torch.float32)
    g = torch.Generator().manual_seed(9)
    params = TR.stack_nodes(TR.init_params(cfg, g, "cpu"), 2)
    toks = torch.randint(0, cfg.vocab, (2, 2, 9), generator=g)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    spec = api.ExperimentSpec(
        name="moe-share", n_nodes=2,
        model=api.ModelSpec(arch="deepseek-moe-16b", full=True,
                            local_batch=2, seq_len=8,
                            params={"aux_weight": 0.5,
                                    **{f.name: getattr(cfg, f.name)
                                       for f in dataclasses.fields(cfg)
                                       if f.name not in ("name",
                                                         "citation")}}),
        execution=api.ExecutionSpec(engine="sharded", backend="neighbor"))
    tr = api.build(spec, device="cpu").trainer
    assert tr.tcfg.aux_weight == 0.5 and tr.mcfg == dataclasses.replace(
        cfg, name=tr.mcfg.name)
    ce, G = tr.loss_and_grad(params, batch)
    leaves, treedef = api.tree.flatten(params)
    xs = [x.detach().requires_grad_() for x in leaves]
    logits, _, aux = TR.forward(cfg, api.tree.unflatten(treedef, xs), batch)
    ces = TR.loss_fn(cfg, logits, batch["labels"])
    want = torch.autograd.grad((ces + 0.5 * aux).sum(), xs)
    assert torch.allclose(ce, ces.mean())
    for a, b in zip(api.tree.leaves(G), want):
        assert torch.equal(a, b)
    assert float(aux.detach().min()) > 0


@pytest.mark.parametrize("fills", [False, True])
def test_allocator_segments_grow_only_where_the_update_fills_the_card(
        monkeypatch, fills):
    """``api.build_trainer_runner`` lets the caching allocator's segments
    grow only where the update's state-sized tables take over three
    quarters of the card."""
    import types
    cfg = _published(dtype=torch.float32)
    table = 4 * cfg.param_count() * 4           # 4 nodes of f32 leaves
    total = int(api.UPDATE_TABLES * table / 0.75) + (-1 if fills else 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(total_memory=total))
    assert api._fills_the_card(cfg, 4, "cuda") is fills
    assert not api._fills_the_card(cfg, 4, "cpu")


def test_the_published_layout_decodes_as_its_forward():
    cfg = _published(dtype=torch.float32)
    g = torch.Generator().manual_seed(10)
    params = TR.stack_nodes(TR.init_params(cfg, g, "cpu"))
    toks = torch.randint(0, cfg.vocab, (1, 2, 12), generator=g)
    full, _, _ = TR.forward(cfg, params, {"tokens": toks})
    cache = TR.init_cache(cfg, 2, 12)
    assert set(cache) == {"blocks", "dense_blocks"}
    _, cache, _ = TR.forward(cfg, params, {"tokens": toks[..., :8]},
                             mode="prefill", cache=cache)
    for t in range(8, 12):
        lg, cache = TR.decode_step(cfg, params, cache, toks[..., t:t + 1],
                                   t)
        assert _rel(lg, full[:, :, t]) <= OUT_TOL, t


# --- phases and the row counter ----------------------------------------------------

PHASES = ("moe/route", "moe/dispatch", "moe/experts", "moe/combine")


def test_the_phases_record_forward_and_backward_under_a_profiler():
    w = _inputs(11)
    trace.RECORDER.clear()
    out, loss = _share(w, 1, 4)
    (out.sum() + loss.sum()).backward()
    assert not trace.recorded() and not trace.counted("moe/rows")
    trace.RECORDER.clear()
    with torch.profiler.profile():
        with trace.phase("train/step"):
            out, loss = _share(w, 1, 4)
            (out.square().sum() + loss.sum()).backward()
    recs = trace.recorded()
    names = [r.name for r in recs]
    for name in PHASES:
        assert names.count(name) >= 2, name     # forward and backward
    assert all(r.parent == "train/step" and r.step == 1 for r in recs
               if r.name in PHASES)
    assert all(isinstance(r.bytes, int) and r.bytes > 0 for r in recs
               if r.name in PHASES[1:])
    (step, rows), = trace.counted("moe/rows")
    idx = moe.top_k_lower_index(torch.softmax(torch.einsum(
        "nbtd,nde->nbte", w["x"], w["router"]), -1), K)[1]
    want = [int((idx[n] == 4 + e).sum()) for n in range(N)
            for e in range(4)]
    assert step == 1 and rows.tolist() == want
    trace.RECORDER.clear()


# --- on the card --------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (M1, M2 in CUDA, M3, M4 in Triton)")
    return torch.device("cuda")


def _cell_routing(dev, seed: int = 0, routing: str = "even"):
    """The deepseek-moe-16b.ring4 cell's routing: 4 nodes x 2 x 1024
    tokens, top 6 of 64 by a random router, experts 0-7 held; ``skewed``
    as :func:`_inputs`'s ``idle`` and ``all`` at once: no token picks
    expert 3 (an empty group) and every token picks expert 5 (a group of
    all its node's 2,048 tokens)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((4, 2, 1024, 2048), generator=g, device=dev)
    rw = torch.randn((4, 2048, 64), generator=g, device=dev) / 2048 ** 0.5
    if routing == "skewed":
        x[..., 0] = 4.0
        rw[:, 0] = 0.0
        rw[:, 0, 3], rw[:, 0, 5] = -3.0, 3.0
    probs = torch.softmax(torch.einsum("nbtd,nde->nbte", x, rw), -1)
    vals, idx = moe.top_k_lower_index(probs, 6)
    return x.reshape(-1, 2048), vals.reshape(-1, 6), kmoe.plan(idx, 0, 8), g


@pytest.mark.cuda
@pytest.mark.parametrize("routing", ["even", "skewed"])
@pytest.mark.parametrize("kernel", ["gather", "combine", "rows_mm",
                                    "rows_mm_t", "wgrad"])
def test_the_kernels_match_their_plain_twins_on_the_card(kernel, routing):
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    x, vals, p, g = _cell_routing(dev, routing=routing)
    R = int(p.offsets[-1])
    if routing == "skewed":
        count = p.counts().view(4, 8)
        assert (count[:, 3] == 0).all() and (count[:, 5] == 2048).all()
    wts = torch.randn((4, 8, 2048, 1408), generator=g, device=dev) / 45.0
    launched = "moe_" + kernel.replace("_t", "")
    before = kmoe.LAUNCHES[launched]
    a = kmoe.gather(x, p.tok, p)
    if kernel == "gather":
        assert torch.equal(a[:R], kmoe.gather_plain(x, p.tok, p)[:R])
    elif kernel == "combine":
        for w in (vals, None):
            got = kmoe.combine(a, p.pos, w)
            want = kmoe.combine_plain(a, p.pos, w)
            assert _rel(got, want) <= 1e-6
    elif kernel == "rows_mm":
        got = kmoe.rows_mm(a, wts, p)
        assert _rel(got[:R], kmoe.rows_mm_plain(a, wts, p)[:R]) <= 1e-5
        acc = got.clone()
        kmoe.rows_mm(a, wts, p, out=acc, accumulate=True)
        assert _rel(acc[:R], 2 * got[:R]) <= 1e-6
    elif kernel == "rows_mm_t":
        h = torch.randn((p.rows, 1408), generator=g, device=dev)
        got = kmoe.rows_mm(h, wts, p, transpose=True)
        want = kmoe.rows_mm_plain(h, wts, p, transpose=True)
        assert _rel(got[:R], want[:R]) <= 1e-5
    else:
        h = torch.randn((p.rows, 1408), generator=g, device=dev)
        got = kmoe.wgrad(a, h, p)
        assert _rel(got, kmoe.wgrad_plain(a, h, p)) <= 1e-5
    assert kmoe.LAUNCHES[launched] > before


@pytest.mark.cuda
def test_the_layer_on_the_card_matches_the_cpu():
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    # even routing: under a saturated softmax (one expert picked by every
    # token) the router's gradient is a difference of nearly equal terms,
    # and two f32 orders of summation part well beyond their rounding
    w = _inputs(12)
    held = 4

    def run(device):
        ws = {k: v.detach().to(device).requires_grad_() for k, v in w.items()}
        out, loss = _share(ws, 1, held, shared=True)
        grads = _grads(out, loss, ws, torch.ones_like(out))
        return [out.cpu(), loss.cpu()] + [v.cpu() for v in grads.values()]

    before = kmoe.launch_counts()
    got, want = run(dev), run("cpu")
    assert all(kmoe.LAUNCHES[k] > before[k] for k in before)
    for a, b in zip(got, want):
        assert _rel(a, b) <= GRAD_TOL
    assert np.isfinite(sum(float(a.abs().sum()) for a in got))
