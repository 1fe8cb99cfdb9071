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
