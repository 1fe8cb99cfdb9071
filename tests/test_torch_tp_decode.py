"""Caches on a tensor-parallel node (``repro_torch.models.tp``): prefill and
decode at M > 1 against the port's whole-node decode and the JAX
package's ``decode_step``, on the CPU.

* One reduced configuration of each of the six families (qwen3-1.7b: 4
  query / 2 KV heads; mixtral-8x7b: window 16; rwkv6-7b; recurrentgemma-
  9b; llama-3.2-vision-90b; whisper-large-v3) under ``StackedTP(M)``, M
  in {2, 4}, and two whose ranks cut query heads at M = 4:
  ``dense-qknorm-6q2kv`` (6 / 2 heads, a rank's 1.5 heads read one KV
  head) and ``encdec-6h`` (whisper at 6 heads: a rank's 2 query heads
  each read their own KV head).  f64, one node, batch 2: an 8-token
  prompt into a 16-slot cache (C11: the prompt fits the ring), then 4
  decode steps.  Each step's logits, gathered over the ranks, against
  the port's whole-node decode (PR 24's bars: 1e-10 x max |logits|, f32's
  1e-5 for the families that compute in f32, RWKV-6 ``SSM_LOGIT_TOL``)
  and the reference's ``decode_step`` (``MODEL_TOL``, f32's for those
  families, RWKV-6 ``SSM_LOGIT_TOL``).  The rank-row cache joined
  (``convert.cache_from_rank_rows``) equals the whole node's cache at the
  same bars, and RWKV-6's token shifts (replicated) are bit-equal across
  the ranks after prefill and after every step.  TP decode also starts
  from the whole node's prefill cut into rank-rows
  (``convert.cache_to_rank_rows``).
* Per-rank cache shapes: the KV heads a rank's query heads read
  (``transformer.kv_heads_per_rank``), RWKV-6's H / M heads of wkv state,
  the RG-LRU's W / M columns, the token shifts whole; at the production
  widths too.
* ``convert.cache_to_rank_rows`` from the reference's layout and from the
  port's, and back.
* ``launch.serve.generate(tp=)`` gives the whole node's tokens.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JTR
from repro_torch import configs as tconfigs
from repro_torch import convert, tree
from repro_torch.launch import serve
from repro_torch.models import transformer as TTR
from repro_torch.models.tp import StackedTP
from tests.test_torch_models import F32_ISLANDS, MODEL_TOL, _extras, _params
from tests.test_torch_tp_recurrent import SSM_LOGIT_TOL

B, PROMPT, GEN, CACHE = 2, 8, 4, 16
#: (arch, overrides of .reduced(), model ranks)
CONFIGS = {
    "dense": ("qwen3-1.7b", {}, (2, 4)),
    "moe": ("mixtral-8x7b", {}, (2, 4)),
    "ssm": ("rwkv6-7b", {}, (2, 4)),
    "hybrid": ("recurrentgemma-9b", {}, (2, 4)),
    "vlm": ("llama-3.2-vision-90b", {}, (2, 4)),
    "encdec": ("whisper-large-v3", {}, (2, 4)),
    "dense-qknorm-6q2kv": ("qwen3-1.7b", {"n_heads": 6, "n_kv_heads": 2},
                           (4,)),
    "encdec-6h": ("whisper-large-v3", {"n_heads": 6, "n_kv_heads": 6},
                  (4,)),
}
CASES = [(k, M) for k, (_, _, Ms) in CONFIGS.items() for M in Ms]
#: against the port's whole-node decode (PR 24's bars)
WHOLE_TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(key, dtype="float64"):
    arch, kw, _ = CONFIGS[key]
    j = dataclasses.replace(jconfigs.get(arch).reduced(),
                            dtype=getattr(jnp, dtype), **kw)
    t = dataclasses.replace(tconfigs.get(arch).reduced(),
                            dtype=getattr(torch, dtype), **kw)
    return j, t


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _tols(cfg):
    """(against the whole node, against the reference)."""
    if cfg.family == "ssm":
        return SSM_LOGIT_TOL, SSM_LOGIT_TOL
    if cfg.family in F32_ISLANDS:
        return MODEL_TOL["float32"], MODEL_TOL["float32"]
    return WHOLE_TOL, MODEL_TOL["float64"]


@functools.lru_cache(maxsize=None)
def _whole_runs(key):
    """The weights and inputs of ``key``, the reference's prefill and
    decode logits, and the port's whole-node ones with its caches after
    prefill and after each step (one run for every M)."""
    jcfg, tcfg = _cfgs(key)
    rng = np.random.default_rng(1)
    p = _params(jcfg, rng)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, PROMPT)),
             **_extras(jcfg, rng, (B,), "float64")}
    steps = rng.integers(0, jcfg.vocab, (GEN, B, 1))

    prefill = jax.jit(lambda p_, b, c: JTR.forward(
        jcfg, p_, b, mode="prefill", cache=c))
    decode = jax.jit(lambda p_, c, t, pos: JTR.decode_step(
        jcfg, p_, c, t, pos))
    jlog, jcache, _ = prefill(p, batch, JTR.init_cache(jcfg, B, CACHE))
    jl = [np.asarray(jlog[:, -1])]
    for i in range(GEN):
        lg, jcache = decode(p, jcache, steps[i], PROMPT + i)
        jl.append(np.asarray(lg))

    sp = convert.model_params_to_torch(p, device="cpu")
    tb = {k: torch.from_numpy(np.asarray(v))[None] for k, v in batch.items()}
    tlog, tcache, _ = TTR.forward(tcfg, sp, tb, mode="prefill",
                                  cache=TTR.init_cache(tcfg, B, CACHE))
    wl, caches = [tlog[0, :, -1]], [tcache]
    for i in range(GEN):
        lg, tcache = TTR.decode_step(tcfg, sp, tcache,
                                     torch.from_numpy(steps[i])[None],
                                     PROMPT + i)
        wl.append(lg[0])
        caches.append(tcache)
    return p, tb, steps, jl, wl, caches


def _tp_decode(tcfg, rows, tp, cache, steps):
    """4 decode steps under ``tp`` from ``cache`` -> (each step's whole
    logits, each step's cache)."""
    out, caches = [], []
    for i in range(GEN):
        lg, cache = TTR.decode_step(
            tcfg, rows, cache, tp.node_rows(torch.from_numpy(steps[i])[None]),
            PROMPT + i, tp=tp)
        out.append(tp.first_of_node(tp.gather_last(lg))[0])
        caches.append(cache)
    return out, caches


def _shifts_equal(cache, M) -> bool:
    """RWKV-6's token shifts, replicated, bit-equal over the ranks."""
    ok = True
    for path, x in tree.flatten_with_paths(cache):
        if path.endswith("_shift"):
            v = x.unflatten(0, (-1, M))
            ok &= all(torch.equal(v[:, 0], v[:, m]) for m in range(M))
    return ok


@torch.no_grad()
@pytest.mark.parametrize("key,M", CASES)
def test_tp_prefill_decode_matches_whole_node_and_reference(key, M):
    _, tcfg = _cfgs(key)
    p, tb, steps, jl, wl, wcaches = _whole_runs(key)
    wtol, rtol = _tols(tcfg)
    tp = StackedTP(M)
    rows = convert.model_params_to_rank_rows(p, M, device="cpu")

    cache = TTR.init_cache(tcfg, B, CACHE, tp=tp)
    lg, cache, _ = TTR.forward(tcfg, rows, tp.node_rows(tb), mode="prefill",
                               cache=cache, tp=tp)
    assert lg.shape == (M, B, PROMPT, tcfg.padded_vocab // M)
    got = [tp.first_of_node(tp.gather_last(lg[:, :, -1]))[0]]
    caches = [cache]
    out, more = _tp_decode(tcfg, rows, tp, cache, steps)
    got += out
    caches += more
    for i, (g, w, j) in enumerate(zip(got, wl, jl, strict=True)):
        assert _rel_err(g, w) <= wtol, (i, "whole node")
        assert _rel_err(g, j) <= rtol, (i, "reference")
    for c, wc in zip(caches, wcaches, strict=True):
        assert _shifts_equal(c, M)
        joined = convert.cache_from_rank_rows(c, tcfg, M)
        for a, b in zip(tree.leaves(joined), tree.leaves(wc), strict=True):
            assert a.shape == b.shape and _rel_err(a, b) <= wtol

    # TP decode from the whole node's prefill, cut into rank-rows
    cut = convert.cache_to_rank_rows(wcaches[0], tcfg, M)
    out, _ = _tp_decode(tcfg, rows, tp, cut, steps)
    for i, (g, w) in enumerate(zip(out, wl[1:], strict=True)):
        assert _rel_err(g, w) <= wtol, (i, "from the whole prefill")


def _cache_shapes(cfg, tp, S=CACHE):
    return {path: tuple(x.shape) for path, x in tree.flatten_with_paths(
        TTR.init_cache(cfg, B, S, abstract=True, tp=tp))}


@pytest.mark.parametrize("key,M", CASES)
def test_tp_caches_hold_a_ranks_heads_and_columns(key, M):
    """A rank's cache, by leaf: the KV heads its query heads read, the
    wkv state of its H / M heads, the RG-LRU's W / M columns, the token
    shifts whole."""
    _, cfg = _cfgs(key)
    whole = _cache_shapes(cfg, StackedTP(1))
    got = _cache_shapes(cfg, StackedTP(M))
    kv = TTR.kv_heads_per_rank(cfg, M)
    want_kv = {("dense", 2): 1, ("dense", 4): 1, ("moe", 2): 1,
               ("moe", 4): 1, ("hybrid", 2): 1, ("hybrid", 4): 1,
               ("vlm", 2): 1, ("vlm", 4): 1, ("encdec", 2): 1,
               ("encdec", 4): 1, ("dense-qknorm-6q2kv", 4): 1,
               ("encdec-6h", 4): 2}
    if cfg.family != "ssm":
        assert kv == want_kv[(key, M)]
    for path, shape in whole.items():
        name = path.rsplit("/", 1)[-1]
        want = list(shape)
        want[0] *= M
        if name in ("k", "v"):
            want[-2] = kv
        elif name == "wkv":
            want[-3] //= M
        elif name in ("h", "conv"):
            want[-1] //= M
        else:
            assert name.endswith("_shift")
        assert got[path] == tuple(want), path


def test_tp_caches_at_the_production_widths():
    """KV heads a rank holds at M = 16 (M = 8 for whisper), and the bound
    on them: at most ceil(H / M) + 1 query heads' KV heads."""
    want = {"qwen3-1.7b": 1, "yi-9b": 1, "mixtral-8x7b": 1,
            "deepseek-moe-16b": 1, "llama-3.2-vision-90b": 1,
            "recurrentgemma-9b": 1, "phi4-mini-3.8b": 1, "qwen2-7b": 3}
    for arch, kv in want.items():
        cfg = tconfigs.get(arch)
        assert TTR.kv_heads_per_rank(cfg, 16) == kv, arch
        assert kv <= -(-cfg.n_heads // 16) + 1
    whisper = tconfigs.get("whisper-large-v3")     # 20 heads: 2.5 a rank
    assert TTR.kv_heads_per_rank(whisper, 8) == 3
    rwkv = tconfigs.get("rwkv6-7b")
    shapes = _cache_shapes(rwkv, StackedTP(16), S=8)
    assert shapes["blocks/wkv"][3] == 64 // 16
    assert shapes["blocks/tm_shift"][-1] == rwkv.d_model
    rg = tconfigs.get("recurrentgemma-9b")
    shapes = _cache_shapes(rg, StackedTP(16), S=8)
    assert shapes["rec/h"][-1] == rg.lru_width // 16
    assert shapes["attn/k"][-2] == 1


@pytest.mark.parametrize("key", ["dense-qknorm-6q2kv", "ssm", "hybrid",
                                 "encdec-6h"])
def test_cache_to_rank_rows_round_trips(key):
    jcfg, tcfg = _cfgs(key, "float32")
    M = CONFIGS[key][2][-1]
    rng = np.random.default_rng(3)
    ref = jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32),
        JTR.init_cache(jcfg, B, CACHE))
    rows = convert.cache_to_rank_rows(ref, tcfg, M, device="cpu")
    assert {p: tuple(x.shape) for p, x in tree.flatten_with_paths(rows)} \
        == _cache_shapes(tcfg, StackedTP(M))
    whole = convert.cache_to_torch(ref, device="cpu")
    back = convert.cache_from_rank_rows(rows, tcfg, M)
    for a, b in zip(tree.leaves(back), tree.leaves(whole), strict=True):
        assert torch.equal(a, b)
    # the port's node-stacked cache of two nodes: node n's rows n M + m
    two = tree.tree_map(lambda t: torch.cat([t, 2 * t]), whole)
    rows2 = convert.cache_to_rank_rows(two, tcfg, M)
    for a, b in zip(tree.leaves(rows2), tree.leaves(rows), strict=True):
        assert torch.equal(a[:M], b) and torch.equal(a[M:], 2 * b)
    for a, b in zip(tree.leaves(convert.cache_from_rank_rows(rows2, tcfg, M)),
                    tree.leaves(two), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("key,M", [("ssm", 2), ("hybrid", 4),
                                   ("encdec-6h", 4), ("vlm", 2)])
def test_generate_under_tp_gives_the_whole_nodes_tokens(key, M):
    _, tcfg = _cfgs(key, "float32")
    g = torch.Generator().manual_seed(0)
    params = TTR.init_params(tcfg, g, "cpu")
    prompt = torch.randint(0, tcfg.vocab, (B, PROMPT), generator=g)
    extras = {}
    if tcfg.family == "vlm":
        extras["vision"] = torch.randn((B, tcfg.n_vision_tokens,
                                        tcfg.d_model), generator=g)
    if tcfg.family == "encdec":
        extras["frames"] = torch.randn((B, 8, tcfg.d_model), generator=g)
    want, wlog = serve.generate(tcfg, params, prompt, 6, extras,
                                return_logits=True)
    rows = convert.model_params_to_rank_rows(
        tree.tree_map(lambda t: t.numpy(), params), M, device="cpu")
    got, glog = serve.generate(tcfg, rows, prompt, 6, extras,
                               return_logits=True, tp=StackedTP(M))
    assert torch.equal(got, want)
    tol = SSM_LOGIT_TOL if tcfg.family == "ssm" else MODEL_TOL["float32"]
    assert _rel_err(glog, wlog) <= tol
