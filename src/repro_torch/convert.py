"""Carry states and parameters between the reference and the port as
numpy arrays, so both packages start from one state.

A Prox-LEAD state crosses as a flat mapping of numpy arrays (or trees of
them):

    X, D, comm.H, comm.Hw, oracle.kind, oracle.ref, oracle.ref_grad, k

which is what a ``repro`` ``ProxLEADState`` holds once its leaves are
turned into numpy arrays.  Full-gradient and SGD oracles keep no reference
point: the reference stores a 0-d integer placeholder there, the port
``None``.  Floating arrays take the chosen dtype and device; the counter
and the oracle tag become Python ints.

A baseline's state (``repro.core.baselines.SimpleState``) crosses as

    X, aux, oracle.kind, oracle.ref, oracle.ref_grad, k

where ``aux`` is the algorithm's own: a 0-d integer placeholder in the
reference (``None`` in the port) for DGD and Centralized, a tree for
Choco-SGD, a tuple of trees for PG-EXTRA, NIDS and LessBit.

A trainer state (``repro.optim.decentralized.TrainState``) crosses as

    X, D, comm.H, comm.Hw, k, step, precond.m, precond.v

with the parameter trees (nested dicts) as they are (on the neighbor
backend under a time-varying schedule each ``comm.Hw`` leaf carries one
slot per round, (N, T, ...), in both packages); without the Adam
preconditioner the reference stores a 0-d integer placeholder under
``precond.m`` and ``precond.v``, the port ``None``.  :func:`tree_to_torch`
and :func:`tree_to_numpy` carry a bare parameter tree.

:func:`state_from_checkpoint` reads a dense Prox-LEAD state that the
reference's ``Runner.save`` wrote (``repro_torch.checkpoint.ckpt``'s
format: keys ``.X``, ``.comm/.H``, ``.oracle/.ref``, ...) through the
mapping above.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.baselines import SimpleState
from repro_torch.core.comm import CommState
from repro_torch.core.oracles import OracleState
from repro_torch.core.prox_lead import ProxLEADState
from repro_torch.optim.decentralized import TrainState
from repro_torch.tree import tree_map

KEYS = ("X", "D", "comm.H", "comm.Hw", "oracle.kind", "oracle.ref",
        "oracle.ref_grad", "k")


def _is_placeholder(a) -> bool:
    a = np.asarray(a)
    return a.ndim == 0 and np.issubdtype(a.dtype, np.integer)


SIMPLE_KEYS = ("X", "aux", "oracle.kind", "oracle.ref", "oracle.ref_grad",
               "k")


def _check_keys(arrays: Mapping[str, Any], keys) -> None:
    missing = [k for k in keys if k not in arrays]
    if missing:
        raise KeyError(f"state arrays lack {missing}")


def _to_torch(tree, device, dtype):
    """A tree of arrays -> tensors; a bare 0-d integer placeholder -> None."""
    if not isinstance(tree, (dict, list, tuple)) and _is_placeholder(tree):
        return None
    return tree_map(lambda a: torch.as_tensor(
        np.array(a), dtype=dtype, device=device), tree)


def _to_numpy(tree):
    """Tensors -> numpy arrays; ``None`` -> the reference's 0-d int32
    placeholder."""
    if tree is None:
        return np.int32(0)
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _oracle_from(arrays, device, dtype) -> OracleState:
    return OracleState(int(np.asarray(arrays["oracle.kind"])),
                       _to_torch(arrays["oracle.ref"], device, dtype),
                       _to_torch(arrays["oracle.ref_grad"], device, dtype))


def _oracle_to(oracle: OracleState) -> Dict[str, Any]:
    return {"oracle.kind": np.int32(oracle.kind),
            "oracle.ref": _to_numpy(oracle.ref),
            "oracle.ref_grad": _to_numpy(oracle.ref_grad)}


def state_from_arrays(arrays: Mapping[str, Any], *, device,
                      dtype: torch.dtype) -> ProxLEADState:
    """Arrays (see module docstring) -> the port's state on ``device``."""
    _check_keys(arrays, KEYS)
    to_t = lambda k: _to_torch(arrays[k], device, dtype)     # noqa: E731
    return ProxLEADState(
        X=to_t("X"), D=to_t("D"), comm=CommState(to_t("comm.H"),
                                                 to_t("comm.Hw")),
        oracle=_oracle_from(arrays, device, dtype),
        k=int(np.asarray(arrays["k"])))


def state_to_arrays(state: ProxLEADState) -> Dict[str, Any]:
    """The port's state -> numpy arrays under :data:`KEYS` (``None``
    reference points become the reference's 0-d int32 placeholder)."""
    return {"X": _to_numpy(state.X), "D": _to_numpy(state.D),
            "comm.H": _to_numpy(state.comm.H),
            "comm.Hw": _to_numpy(state.comm.Hw), **_oracle_to(state.oracle),
            "k": np.int32(state.k)}


def simple_state_from_arrays(arrays: Mapping[str, Any], *, device,
                             dtype: torch.dtype) -> SimpleState:
    """Arrays under :data:`SIMPLE_KEYS` -> a baseline's state."""
    _check_keys(arrays, SIMPLE_KEYS)
    return SimpleState(_to_torch(arrays["X"], device, dtype),
                       _to_torch(arrays["aux"], device, dtype),
                       _oracle_from(arrays, device, dtype),
                       int(np.asarray(arrays["k"])))


def simple_state_to_arrays(state: SimpleState) -> Dict[str, Any]:
    """A baseline's state -> numpy arrays under :data:`SIMPLE_KEYS`."""
    return {"X": _to_numpy(state.X), "aux": _to_numpy(state.aux),
            **_oracle_to(state.oracle), "k": np.int32(state.k)}


TRAIN_KEYS = ("X", "D", "comm.H", "comm.Hw", "k", "step", "precond.m",
              "precond.v")


def tree_to_torch(tree, *, device, dtype: torch.dtype = None):
    """A tree of numpy arrays -> torch tensors on ``device`` (in ``dtype``
    when given, else each array's own)."""
    return tree_map(lambda a: torch.as_tensor(np.array(a), dtype=dtype,
                                              device=device), tree)


def tree_to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def trainstate_from_arrays(arrays: Mapping[str, Any], *, device,
                           dtype: torch.dtype = None) -> TrainState:
    """Arrays under :data:`TRAIN_KEYS` -> the port's TrainState."""
    missing = [k for k in TRAIN_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"trainer state arrays lack {missing}")
    to_t = lambda k: tree_to_torch(arrays[k], device=device,  # noqa: E731
                                   dtype=dtype)
    precond = (None if _is_placeholder(arrays["precond.m"])
               else (to_t("precond.m"), to_t("precond.v")))
    plead = ProxLEADState(to_t("X"), to_t("D"),
                          CommState(to_t("comm.H"), to_t("comm.Hw")),
                          OracleState(0, None, None),
                          int(np.asarray(arrays["k"])))
    return TrainState(plead, int(np.asarray(arrays["step"])), precond)


def trainstate_to_arrays(state: TrainState) -> Dict[str, Any]:
    """The port's TrainState -> numpy arrays under :data:`TRAIN_KEYS`."""
    p = state.plead
    m, v = state.precond if state.precond is not None else (None, None)
    placeholder = lambda x: np.int32(0) if x is None else \
        tree_to_numpy(x)                                      # noqa: E731
    return {"X": tree_to_numpy(p.X), "D": tree_to_numpy(p.D),
            "comm.H": tree_to_numpy(p.comm.H),
            "comm.Hw": tree_to_numpy(p.comm.Hw), "k": np.int32(p.k),
            "step": np.int32(state.step), "precond.m": placeholder(m),
            "precond.v": placeholder(v)}


def checkpoint_arrays(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """A checkpoint's arrays by key (``.X``, ``.comm/.H``, ``.k``) -> the
    mapping above (``X``, ``comm.H``, ``k``)."""
    return {k.replace("/.", ".").lstrip("."): a for k, a in flat.items()}


def state_from_checkpoint(path, step: int = 0, *, device,
                          dtype: torch.dtype) -> ProxLEADState:
    """A dense Prox-LEAD state from a checkpoint of either package (the
    reference's ``Runner.save`` or the port's), on ``device``."""
    from repro_torch.checkpoint import ckpt
    return state_from_arrays(checkpoint_arrays(ckpt.load_arrays(path, step)),
                             device=device, dtype=dtype)


def model_params_to_torch(params, *, device, dtype: torch.dtype = None):
    """One replica of a reference model's parameters (a tree of numpy
    arrays in its layout, any family) -> the port's node-stacked tree, a
    stack of one node (serving's layout; a trainer's stacked replicas
    cross with :func:`tree_to_torch`)."""
    return tree_map(lambda t: t[None],
                    tree_to_torch(params, device=device, dtype=dtype))


def model_params_to_rank_rows(params, model: int, *, device,
                              dtype: torch.dtype = None,
                              node_stacked: bool = False):
    """A reference model's parameters (a tree of numpy arrays in its
    layout: one replica, or node-stacked (N, ...) leaves with
    ``node_stacked``) -> the port's rank-rows for ``StackedTP(model)``
    (``repro_torch.models.tp``): row ``n M + m`` holds model shard m of
    node n, each sharded leaf cut as the reference's ``param_specs``
    place it (``sharding.rank_rows``), a replicated leaf whole."""
    from repro_torch import tree
    from repro_torch.models import sharding
    stacked = tree_to_torch(params, device=device, dtype=dtype)
    if not node_stacked:
        stacked = tree_map(lambda t: t[None], stacked)
    leaves, treedef = tree.flatten(stacked)
    specs = tree.leaves(sharding.param_specs(
        tree.unflatten(treedef, [x[0] for x in leaves])))
    return tree.unflatten(treedef, [sharding.rank_rows(x, sp, model)
                                    for x, sp in zip(leaves, specs)])


def cache_to_torch(cache, *, device, dtype: torch.dtype = None):
    """A reference decode cache (a tree of numpy arrays: ``init_cache`` or
    what prefill/decode return) -> the port's, a stack of one node."""
    return tree_map(lambda t: t[None],
                    tree_to_torch(cache, device=device, dtype=dtype))


def cache_to_numpy(cache):
    """The port's decode cache of one node -> numpy arrays in the
    reference's layout (no node dim)."""
    def one(t):
        if t.shape[0] != 1:
            raise ValueError(f"a cache of {t.shape[0]} nodes has no "
                             f"reference layout; want a stack of one")
        return t[0].detach().cpu().numpy()
    return tree_map(one, cache)


def _cache_cut(cfg, name: str, model: int):
    """How a whole node's cache leaf ``name`` splits over ``model`` ranks:
    (its dim, an (M, k) index of the entries each rank holds), or None for
    a leaf every rank holds whole (RWKV-6's token shifts).  KV heads as
    ``transformer._head_plan`` reads them, RWKV-6's wkv state by heads,
    the RG-LRU's ``h`` and ``conv`` by columns."""
    from repro_torch.models import transformer as TR
    from repro_torch.models.tp import StackedTP
    M = model
    if name in ("k", "v"):
        KV = cfg.n_kv_heads
        kv = TR._head_plan(cfg, StackedTP(M), M, "cpu")[1]
        return -2, (torch.arange(KV).view(M, KV // M) if kv is None else kv)
    if name == "wkv":
        H = cfg.d_model // cfg.rwkv_head_size
        return -3, torch.arange(H).view(M, H // M)
    if name in ("h", "conv"):
        W = cfg.lru_width or cfg.d_model
        return -1, torch.arange(W).view(M, W // M)
    return None


def cache_to_rank_rows(cache, cfg, model: int, *, device=None,
                       dtype: torch.dtype = None):
    """A whole node's decode cache -> the rank-rows of ``StackedTP(model)``
    (``transformer.init_cache(..., tp=)``'s layout): the port's M = 1 cache
    (node-stacked torch tensors (n, ...)), or the reference's (a tree of
    numpy arrays without the node dim, one node; carried with
    :func:`cache_to_torch` onto ``device`` in ``dtype``).  Row ``n M + m``
    holds rank m's KV heads, wkv heads and RG-LRU columns of node n and
    the token shifts whole.  Always a copy."""
    from repro_torch import tree
    leaves = tree.leaves(cache)
    if leaves and isinstance(leaves[0], np.ndarray):
        cache = cache_to_torch(cache, device=device, dtype=dtype)
    out = []
    paths = tree.flatten_with_paths(cache)
    for path, x in paths:
        cut = _cache_cut(cfg, path.rsplit("/", 1)[-1], model)
        if cut is None:
            out.append(x.repeat_interleave(model, 0))
            continue
        dim, idx = cut
        idx = idx.to(x.device)
        out.append(torch.stack([x.index_select(x.dim() + dim, idx[m])
                                for m in range(model)], 1).flatten(0, 1))
    return tree.unflatten(tree.flatten(cache)[1], out)


def cache_from_rank_rows(rows, cfg, model: int):
    """Inverse of :func:`cache_to_rank_rows`: ``StackedTP(model)``'s
    rank-row cache -> the whole node's (n, ...), each entry from a rank
    that holds it (a KV head some ranks share: the last of them), a token
    shift from model rank 0."""
    from repro_torch import tree
    out = []
    for path, x in tree.flatten_with_paths(rows):
        v = x.unflatten(0, (x.shape[0] // model, model))
        cut = _cache_cut(cfg, path.rsplit("/", 1)[-1], model)
        if cut is None:
            out.append(v[:, 0].clone())
            continue
        dim, idx = cut
        shape = list(v[:, 0].shape)
        d = len(shape) + dim
        shape[d] = int(idx.max()) + 1
        whole = x.new_empty(shape)
        for m in range(model):
            whole.index_copy_(d, idx[m].to(x.device), v[:, m])
        out.append(whole)
    return tree.unflatten(tree.flatten(rows)[1], out)
