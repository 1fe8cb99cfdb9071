"""Minimal pytrees over tensors: a leaf, or dicts, lists and tuples of them.

Dicts flatten in sorted key order, as JAX's pytrees do, so leaf ``j`` of a
port tree is leaf ``j`` of the reference tree (per-leaf noise is drawn in
that order).  NamedTuples are not trees here: state containers are walked
field by field by the code that owns them.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _flatten(t, out: List[Any]):
    if isinstance(t, dict):
        return {k: _flatten(t[k], out) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_flatten(v, out) for v in t)
    out.append(t)
    return None


def flatten(tree) -> Tuple[List[Any], Any]:
    """-> (leaves in order, treedef); the treedef is the tree with every
    leaf replaced by None.  (Module-level recursion, no self-referencing
    closure: such a closure is a reference cycle that would keep every
    leaf alive until the cyclic garbage collector runs.)"""
    out: List[Any] = []
    return out, _flatten(tree, out)


def _unflatten(d, it):
    if isinstance(d, dict):
        return {k: _unflatten(v, it) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return type(d)(_unflatten(v, it) for v in d)
    return next(it)


def unflatten(treedef, leaves) -> Any:
    return _unflatten(treedef, iter(leaves))


def _flatten_paths(t, prefix: Tuple[str, ...], out: List[Any]) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _flatten_paths(t[k], prefix + (str(k),), out)
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            _flatten_paths(v, prefix + (str(i),), out)
    else:
        out.append(("/".join(prefix), t))


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in :func:`flatten`'s leaf order; a path joins the
    dict keys and sequence indices from the root with ``/``, as the
    reference's ``repro.models.sharding._path_str`` does
    (``"blocks/wq"``)."""
    out: List[Tuple[str, Any]] = []
    _flatten_paths(tree, (), out)
    return out


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leafwise across trees of one structure."""
    ls, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(ls, *others)])
