"""The port's model zoo against the JAX package: the moe, ssm (RWKV-6),
hybrid (RG-LRU + local attention), vlm and encdec families, their prefill
and decode caches, the configurations and input shapes.

* Train mode, node-stacked: logits, the MoE aux loss and the gradient of
  the summed node losses (cross entropy + 0.01 aux) against
  ``repro.models.transformer.forward`` under ``jax.vmap``/``jax.grad``, at
  each architecture's ``.reduced()`` with the reference's initial weights
  perturbed per node (so zero-initialised biases, gates and decays are
  live), f64 and f32, within ``MODEL_TOL`` of each array's largest entry
  (f32's for both dtypes in the moe, ssm and hybrid families: the
  reference computes the MoE router and experts, RWKV-6's time mix and the
  RG-LRU in f32 whatever the model dtype, so there an f64 model agrees to
  f32 accuracy only; RWKV-6's gradients take ``SSM_GRAD_TOL``, and a leaf
  whose gradient is zero up to rounding -- a key bias, which shifts every
  score of a query alike -- is compared at the tree's largest gradient).
* Prefill of an 8-token prompt into a 16-slot cache, then 8 decode steps:
  each step's logits and the whole cache against the reference's, same
  tolerance.  The port's RG-LRU recurrence is a loop over T where the
  reference runs an associative scan, so the two add in another order and
  agree to f32 rounding, inside the same tolerance.
* ``moe_mlp`` alone with exact router ties (zero router columns: the
  logits are exactly 0 in both packages; ``jax.lax.top_k`` breaks ties
  toward the lower index, the port's stable sort too) and with tokens over
  capacity, against the reference.
* Decode against the port's own teacher-forced forward for every
  architecture (MoE at ``capacity_factor = n_experts``, where a token's
  routing does not depend on how many tokens share its pass).
* ROADMAP C11: with a sliding window of 16 and a 20-token prompt the
  reference's prefill stores the last 16 keys at ring slots 0..15 while its
  decode writes position p at slot p % 16, so its decode logits leave its
  teacher-forced ones; the port writes every key at its ring slot and its
  decode equals the teacher-forced forward of both packages.  Where the
  reference is self-consistent (prompts 9, 16, 32) the port equals its
  decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.models import moe as jmoe
from repro.models import transformer as JTR
from repro_torch import configs as tconfigs
from repro_torch import convert, tree
from repro_torch.configs import shapes as tshapes
from repro_torch.data.pipeline import DecentralizedBatches
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TTR

MODEL_TOL = {"float64": 5e-6, "float32": 1e-5}
#: families the reference computes partly in f32 whatever the model dtype
#: (the MoE router and experts, RWKV-6's time mix, the RG-LRU): an f64
#: model of these agrees to f32 accuracy, so both dtypes take f32's bound
F32_ISLANDS = ("moe", "ssm", "hybrid")
#: RWKV-6's gradients: its per-head group norm divides by sqrt(var + 6.4e-4)
#: on heads whose outputs are small, which multiplies f32 rounding by up to
#: ~40; measured 4.1e-5 of a leaf's largest entry (one CPU thread), and the
#: port's own gradients move by 1e-4 between one and many CPU threads
SSM_GRAD_TOL = 3e-4
NEW_ARCHS = ("mixtral-8x7b", "deepseek-moe-16b", "rwkv6-7b",
             "recurrentgemma-9b", "llama-3.2-vision-90b", "whisper-large-v3")
B, T, PROMPT, GEN, CACHE = 2, 12, 8, 8, 16


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops under a parallel pytest run: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _tol(cfg, dtype: str) -> float:
    return MODEL_TOL["float32" if cfg.family in F32_ISLANDS else dtype]


def _cfgs(arch, dtype, **kw):
    j = dataclasses.replace(jconfigs.get(arch).reduced(),
                            dtype=getattr(jnp, dtype), **kw)
    t = dataclasses.replace(tconfigs.get(arch).reduced(),
                            dtype=getattr(torch, dtype), **kw)
    return j, t


def _params(jcfg, rng, n=None):
    """The reference's initial weights, each leaf perturbed by 0.05 N(0, 1)
    (one copy, or ``n`` node copies stacked)."""
    p0 = jax.tree_util.tree_map(np.asarray,
                                JTR.init_params(jcfg, jax.random.key(0)))
    one = lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(a.dtype)  # noqa: E731
    if n is None:
        return jax.tree_util.tree_map(one, p0)
    return jax.tree_util.tree_map(
        lambda a: np.stack([one(a) for _ in range(n)]), p0)


def _extras(jcfg, rng, lead, dtype):
    out = {}
    if jcfg.family == "vlm":
        out["vision"] = rng.normal(
            size=lead + (jcfg.n_vision_tokens, jcfg.d_model)).astype(dtype)
    if jcfg.family == "encdec":
        out["frames"] = rng.normal(size=lead + (8, jcfg.d_model)).astype(dtype)
    return out


def _to_torch(batch, stack=False):
    return {k: (torch.from_numpy(np.asarray(v))[None] if stack
                else torch.from_numpy(np.asarray(v)))
            for k, v in batch.items()}


# --- train mode ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_logits_aux_grads_match_reference(arch, dtype):
    N = 2
    jcfg, tcfg = _cfgs(arch, dtype)
    rng = np.random.default_rng(0)
    X = _params(jcfg, rng, n=N)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (N, B, T)),
             **_extras(jcfg, rng, (N, B), dtype)}
    labels = rng.integers(0, jcfg.vocab, (N, B, T))

    def node_loss(p, b, lb):
        logits, _, aux = JTR.forward(jcfg, p, b)
        return JTR.loss_fn(jcfg, logits, lb) + 0.01 * aux, (logits, aux)

    @jax.jit
    def reference(Xs):
        def total(Xs_):
            losses, out = jax.vmap(node_loss)(Xs_, batch, labels)
            return jnp.sum(losses), out
        return jax.grad(total, has_aux=True)(Xs)

    jgrad, (jlogits, jaux) = reference(X)

    xs, treedef = tree.flatten(convert.tree_to_torch(X, device="cpu"))
    xs = [x.requires_grad_(True) for x in xs]
    logits, cache, aux = TTR.forward(tcfg, tree.unflatten(treedef, xs),
                                     _to_torch(batch))
    loss = TTR.loss_fn(tcfg, logits, torch.from_numpy(labels)) + 0.01 * aux
    grads = torch.autograd.grad(loss.sum(), xs, allow_unused=True)
    tol = _tol(jcfg, dtype)
    assert cache is None and logits.dtype == getattr(torch, dtype)
    assert _rel_err(logits.detach(), jlogits) <= tol
    if jcfg.family == "moe":
        assert aux.shape == (N,)
        np.testing.assert_allclose(aux.detach().numpy(), np.asarray(jaux),
                                   rtol=tol)
    else:
        assert aux == 0.0 and not np.asarray(jaux).any()
    jgs = [np.asarray(jg) for jg in jax.tree_util.tree_leaves(jgrad)]
    top = max(float(np.abs(jg).max()) for jg in jgs)
    gtol = SSM_GRAD_TOL if jcfg.family == "ssm" else tol
    for g, jg in zip(grads, jgs, strict=True):
        if g is None:                 # a leaf the loss never reads
            assert not jg.any()
            continue
        scale = float(np.abs(jg).max())
        if scale <= 1e-6 * top:       # zero up to rounding: the key biases
            scale = top
        err = float(np.abs(g.detach().numpy().astype(np.float64) - jg).max())
        assert err <= gtol * scale


# --- prefill and decode -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_decode_and_caches_match_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    rng = np.random.default_rng(1)
    p = _params(jcfg, rng)
    tp = convert.model_params_to_torch(p, device="cpu")
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, PROMPT)),
             **_extras(jcfg, rng, (B,), dtype)}
    steps = rng.integers(0, jcfg.vocab, (GEN, B, 1))
    tol = _tol(jcfg, dtype)

    prefill = jax.jit(lambda p_, b, c: JTR.forward(
        jcfg, p_, b, mode="prefill", cache=c))
    decode = jax.jit(lambda p_, c, t, pos: JTR.decode_step(
        jcfg, p_, c, t, pos))
    jlog, jcache, _ = prefill(p, batch, JTR.init_cache(jcfg, B, CACHE))
    tlog, tcache, _ = TTR.forward(tcfg, tp, _to_torch(batch, stack=True),
                                  mode="prefill",
                                  cache=TTR.init_cache(tcfg, B, CACHE))

    def check_cache():
        got = convert.cache_to_numpy(tcache)
        leaves = jax.tree_util.tree_leaves(jcache)
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(jcache))
        for a, b in zip(jax.tree_util.tree_leaves(got), leaves, strict=True):
            assert a.shape == b.shape and _rel_err(a, b) <= tol

    assert _rel_err(tlog[0], jlog) <= tol
    check_cache()
    for i in range(GEN):
        jl, jcache = decode(p, jcache, steps[i], PROMPT + i)
        tl, tcache = TTR.decode_step(tcfg, tp, tcache,
                                     torch.from_numpy(steps[i])[None],
                                     PROMPT + i)
        assert tl.shape == (1, B, tcfg.padded_vocab)
        assert _rel_err(tl[0], jl) <= tol, i
        check_cache()


def test_caches_convert_both_ways():
    jcfg, tcfg = _cfgs("whisper-large-v3", "float32")
    jc = jax.tree_util.tree_map(np.asarray, JTR.init_cache(jcfg, B, CACHE))
    tc = convert.cache_to_torch(jc, device="cpu")
    tz = TTR.init_cache(tcfg, B, CACHE)
    for a, b in zip(tree.leaves(tc), tree.leaves(tz), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = convert.cache_to_numpy(tc)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jc)
    with pytest.raises(ValueError, match="stack of one"):
        convert.cache_to_numpy(TTR.init_cache(tcfg, B, CACHE, n_nodes=2))


# --- the MoE layer alone -----------------------------------------------------------

@pytest.mark.parametrize("E,top_k,factor,shared", [
    (4, 2, 1.25, False), (8, 2, 0.5, False), (8, 3, 0.75, True),
    (4, 1, 0.25, True)])
def test_moe_mlp_ties_and_capacity_match_reference(E, top_k, factor, shared):
    N, Bm, Tm, D, F = 2, 2, 16, 32, 24
    rng = np.random.default_rng(E * 10 + top_k)
    x = rng.normal(size=(N, Bm, Tm, D)).astype(np.float32)
    router = rng.normal(size=(N, D, E)).astype(np.float32) * 0.3
    router[:, :, :E // 2] = 0.0       # exact ties: these logits are 0.0
    w = [rng.normal(size=(N, E, D, F)).astype(np.float32) * 0.2,
         rng.normal(size=(N, E, D, F)).astype(np.float32) * 0.2,
         rng.normal(size=(N, E, F, D)).astype(np.float32) * 0.2]
    sh = ([rng.normal(size=(N, D, F)).astype(np.float32) * 0.2,
           rng.normal(size=(N, D, F)).astype(np.float32) * 0.2,
           rng.normal(size=(N, F, D)).astype(np.float32) * 0.2]
          if shared else None)

    def ref(n):
        return jmoe.moe_mlp(x[n], router[n], *(a[n] for a in w),
                            top_k=top_k, capacity_factor=factor,
                            shared=None if sh is None
                            else tuple(a[n] for a in sh))

    want = [ref(n) for n in range(N)]
    t = lambda a: torch.from_numpy(a)                         # noqa: E731
    out, aux = tmoe.moe_mlp(t(x), t(router), *map(t, w), top_k=top_k,
                            capacity_factor=factor,
                            shared=None if sh is None else tuple(map(t, sh)))
    for n in range(N):
        assert _rel_err(out[n], want[n][0]) <= 1e-5
        np.testing.assert_allclose(float(aux[n]), float(want[n][1]),
                                   rtol=1e-5)
    # the case is what it claims: tied router probabilities, and more
    # routed slots than an expert holds
    probs = torch.softmax(torch.einsum("nbtd,nde->nbte", t(x), t(router)), -1)
    _, idx = tmoe.top_k_lower_index(probs, top_k)
    C = tmoe.capacity(Tm, top_k, E, factor)
    per_expert = torch.nn.functional.one_hot(idx, E).sum(dim=(2, 3))
    assert bool((probs[..., 0] == probs[..., 1]).all())
    assert factor >= 1 or int(per_expert.max()) > C


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tmoe.top_k_lower_index(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2, 0], [0, 1, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# --- decode against the teacher-forced forward -------------------------------------

@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_decode_matches_teacher_forced_forward(arch):
    cfg = tconfigs.get(arch).reduced()
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    g = torch.Generator().manual_seed(0)
    params = TTR.stack_nodes(TTR.init_params(cfg, g, "cpu"))
    toks = torch.randint(0, cfg.vocab, (1, B, PROMPT + GEN), generator=g)
    extras = {}
    if cfg.family == "vlm":
        extras["vision"] = torch.randn((1, B, cfg.n_vision_tokens,
                                        cfg.d_model), generator=g)
    if cfg.family == "encdec":
        extras["frames"] = torch.randn((1, B, 8, cfg.d_model), generator=g)
    full, _, _ = TTR.forward(cfg, params, {"tokens": toks, **extras})
    _, cache, _ = TTR.forward(cfg, params,
                              {"tokens": toks[..., :PROMPT], **extras},
                              mode="prefill",
                              cache=TTR.init_cache(cfg, B, PROMPT + GEN))
    for t in range(PROMPT, PROMPT + GEN):
        lg, cache = TTR.decode_step(cfg, params, cache, toks[..., t:t + 1],
                                    t)
        assert _rel_err(lg, full[:, :, t]) <= MODEL_TOL["float32"], t


# --- ROADMAP C11: a sliding window after a prompt longer than it --------------------

@pytest.mark.parametrize("prompt", [9, 16, 20, 32])
def test_sliding_window_decode_after_long_prompt(prompt):
    steps, window = 4, 16
    kw = dict(sliding_window=window)
    jcfg = dataclasses.replace(jconfigs.get("qwen3-1.7b").reduced(
        n_layers=1, d_model=128), **kw)
    tcfg = dataclasses.replace(tconfigs.get("qwen3-1.7b").reduced(
        n_layers=1, d_model=128), **kw)
    rng = np.random.default_rng(prompt)
    p = _params(jcfg, rng)
    tp = convert.model_params_to_torch(p, device="cpu")
    toks = rng.integers(0, jcfg.vocab, (B, prompt + steps))
    S = prompt + steps
    tol = MODEL_TOL["float32"]

    jfull = np.asarray(JTR.forward(jcfg, p, {"tokens": toks})[0])
    tfull = TTR.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)[None]}
                        )[0][0].numpy()
    assert _rel_err(tfull, jfull) <= tol
    _, jc, _ = JTR.forward(jcfg, p, {"tokens": toks[:, :prompt]},
                           mode="prefill", cache=JTR.init_cache(jcfg, B, S))
    _, tc, _ = TTR.forward(tcfg, tp,
                           {"tokens": torch.from_numpy(toks[:, :prompt])[None]},
                           mode="prefill", cache=TTR.init_cache(tcfg, B, S))
    assert tc["blocks"]["k"].shape[-3] == min(window, S)
    ref_off = 0.0
    for i in range(steps):
        pos = prompt + i
        jl, jc = JTR.decode_step(jcfg, p, jc, toks[:, pos:pos + 1], pos)
        tl, tc = TTR.decode_step(tcfg, tp, tc,
                                 torch.from_numpy(toks[:, pos:pos + 1])[None],
                                 pos)
        tl = tl[0].numpy()
        assert _rel_err(tl, tfull[:, pos]) <= tol, pos
        assert _rel_err(tl, jfull[:, pos]) <= tol, pos
        ref_off = max(ref_off, _rel_err(jl, jfull[:, pos]))
        if prompt <= window or prompt % window == 0:
            assert _rel_err(tl, jl) <= tol, pos
    if prompt > window and prompt % window:
        # the reference's decode leaves its own teacher-forced forward
        # (ROADMAP C11); if this fails, the reference was fixed
        assert ref_off > 1e-2, ref_off
    else:
        assert ref_off <= tol


# --- configurations, shapes, data ----------------------------------------------------

@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_input_specs_match_reference(arch):
    t, j = tconfigs.get(arch), jconfigs.get(arch)
    assert t.sub_quadratic == j.sub_quadratic
    if t.n_experts:
        assert t.param_count(active_only=True) == \
            j.param_count(active_only=True)
    assert tuple(tshapes.SHAPES) == tuple(jshapes.SHAPES)
    for name, shape in tshapes.SHAPES.items():
        js = jshapes.SHAPES[name]
        assert dataclasses.astuple(shape) == dataclasses.astuple(js)
        assert tshapes.applicable(t, shape) == jshapes.applicable(j, js)
        n = 8 if shape.global_batch % 8 == 0 else 1
        got = tshapes.train_input_specs(t, shape, n)
        want = jshapes.train_input_specs(j, js, n)
        assert {k: v[0] for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        if shape.kind == "train":
            with pytest.raises(ValueError, match="kind"):
                tshapes.serve_input_specs(t, shape)
            continue
        got = tshapes.serve_input_specs(t, shape)
        want = jshapes.serve_input_specs(j, js)
        assert set(got) == set(want)
        for key in got:
            if key == "cache":
                jl = jax.tree_util.tree_leaves(want[key])
                tl = [v for _, v in sorted(_cache_specs(got[key]))]
                assert [tuple(a.shape) for a in jl] == [s for s, _ in tl]
            else:
                assert got[key][0] == tuple(want[key].shape)


def _cache_specs(tree_, prefix=""):
    """(path, (shape, dtype)) of a spec tree, paths sorting as the
    reference's leaves do."""
    for k in sorted(tree_):
        v = tree_[k]
        if isinstance(v, dict):
            yield from _cache_specs(v, prefix + "/" + k)
        else:
            yield prefix + "/" + k, v


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-large-v3",
                                  "rwkv6-7b"])
def test_batches_carry_the_family_inputs(arch):
    cfg = tconfigs.get(arch).reduced()
    data = DecentralizedBatches(3, 2, 10, cfg.vocab, family=cfg.family,
                                n_vision_tokens=cfg.n_vision_tokens,
                                d_model=cfg.d_model, dtype=torch.float64)
    a, b, c = data.batch_at(4), data.batch_at(4), data.batch_at(5)
    want = {"vlm": ("vision", (3, 2, cfg.n_vision_tokens, cfg.d_model)),
            "encdec": ("frames", (3, 2, 5, cfg.d_model))}.get(cfg.family)
    assert a["tokens"].shape == (3, 2, 10)
    if want is None:
        assert set(a) == {"tokens", "labels"}
        return
    name, shape = want
    assert a[name].shape == shape and a[name].dtype == torch.float64
    assert torch.equal(a[name], b[name]) and not torch.equal(a[name],
                                                            c[name])
    logits = TTR.forward(cfg, TTR.stack_nodes(TTR.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), 3),
        {k: v.float() if v.is_floating_point() else v
         for k, v in a.items()})[0]
    assert logits.shape == (3, 2, 10, cfg.padded_vocab)
