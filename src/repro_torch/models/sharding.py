"""Logical-axis sharding: parameter partition specs and model shards.

The port of ``repro.models.sharding``.  Mesh axes (``repro_torch.launch.
mesh.Mesh``):

  node axes -- ('data',) single-pod, ('pod', 'data') multi-pod: the
               decentralized graph (the leading N dim of training state)
  'model'   -- tensor parallelism inside each node

The reference hands these specs to GSPMD, which places each model shard
of a leaf on its own device.  The port holds a node's leaves whole, in one
process; the specs say where the leaves split into their M model shards,
and :func:`shard_view` / :func:`join_shards` cut a node-stacked leaf
``(N, *shape)`` into ``(N, M, *model_local_shape)`` and back.  The
neighbor backend's bucketed wire quantizes each model shard on its own
(the reference's full-manual ``shard_map``; ``repro_torch.optim.
decentralized``).
"""
from __future__ import annotations

import re
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree

#: a spec entry: replicated (None), one mesh axis, or several
Entry = Any


class PartitionSpec:
    """A tuple of per-dim entries, each ``None``, a mesh-axis name or a
    tuple of names (``jax.sharding.PartitionSpec``'s meaning).  Not a
    tuple subclass, so that a tree of specs keeps each spec as a leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries: Entry) -> None:
        self.entries: Tuple[Entry, ...] = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and \
            self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.entries!r}"


P = PartitionSpec


def _names(entry: Entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def node_axes(mesh) -> Tuple[str, ...]:
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis_size(mesh) -> int:
    """Tensor-parallel ways on this mesh (1 when there is no model axis,
    or no mesh)."""
    if mesh is None:
        return 1
    return dict(zip(mesh.axis_names, mesh.shape)).get("model", 1)


def spec_mentions(spec: PartitionSpec, axis: str) -> bool:
    """Does any dim entry of ``spec`` name mesh axis ``axis``?"""
    return any(axis in _names(e) for e in spec)


def model_local_shape(shape, spec: PartitionSpec, model: int):
    """Per-model-shard shape of a leaf: divide each dim whose spec entry
    names the model axis (``spec`` aligns with ``shape``'s dims)."""
    local = []
    for d, dim in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        local.append(dim // model if "model" in _names(e) else dim)
    return tuple(local)


def constrain(x, spec: Optional[PartitionSpec]):
    """The reference's activation sharding constraint, a no-op here: one
    process holds every leaf whole, and GSPMD has no counterpart."""
    return x


# ---------------------------------------------------------------------------
# Parameter sharding rules: match on the flattened param path.
# Order matters: first match wins.  Specs are for the *per-node* leaf
# (layer-stacked: leading L dim), the trainer prepends the node axis.
# ---------------------------------------------------------------------------

_RULES: Sequence[Tuple[str, Tuple]] = (
    # token / position embeddings: (V|S, D) -> shard vocab dim
    (r"embed|lm_head_b|pos_embed", ("model", None)),
    (r"lm_head$", (None, "model")),                 # (D, V)
    # attention projections, layer-stacked (L, D, H*hd) etc.
    (r"(wq|wk|wv|w_qkv|cross_wk|cross_wv)$", (None, None, "model")),
    (r"(wq|wk|wv)_b$", (None, "model")),            # qkv biases (L, H*hd)
    (r"wo$", (None, "model", None)),
    (r"wo_b$", (None, None)),
    # MLP, layer-stacked (L, D, F) / (L, F, D)
    (r"(w_gate|w_up|w_in)$", (None, None, "model")),
    (r"(w_in_b)$", (None, "model")),
    (r"w_down$|w_out$", (None, "model", None)),
    (r"w_out_b$", (None, None)),
    # MoE experts, layer-stacked (L, E, D, F) / (L, E, F, D)
    (r"experts_(gate|up)$", (None, None, None, "model")),
    (r"experts_down$", (None, None, "model", None)),
    (r"router$", (None, None, None)),
    # shared experts (L, D, F)/(L, F, D)
    (r"shared_(gate|up)$", (None, None, "model")),
    (r"shared_down$", (None, "model", None)),
    # RWKV6 projections (L, D, D) -> shard output dim (heads)
    (r"rwkv_(wr|wk|wv|wg|wo)$", (None, None, "model")),
    (r"cm_(wk|wr)$", (None, None, "model")),
    (r"cm_wv$", (None, "model", None)),
    # RG-LRU / recurrent block (L, D, W) projections
    (r"rg_(w_x|w_gate)$", (None, None, "model")),
    (r"rg_w_out$", (None, "model", None)),
    # everything else (norms, decay vectors, conv kernels, gates): replicated
)


def spec_for_path(path: str, ndim: int) -> PartitionSpec:
    for pat, axes in _RULES:
        if re.search(pat, path):
            if len(axes) == ndim:
                return P(*axes)
            if len(axes) < ndim:  # extra leading dims (e.g. superblock stack)
                return P(*((None,) * (ndim - len(axes)) + tuple(axes)))
            # rule has more dims than leaf (unstacked variant)
            return P(*axes[len(axes) - ndim:])
    return P(*((None,) * ndim))


def param_specs(params, prepend: Tuple = ()) -> Any:
    """PartitionSpec tree for an UNSTACKED parameter tree (leaves without
    the node dim; ``meta`` tensors will do).  ``prepend`` adds leading
    spec entries for dims the *state* carries in front (e.g.
    ``prepend=(('pod', 'data'),)`` for the node dim)."""
    _, treedef = tree.flatten(params)
    return tree.unflatten(treedef, [
        P(*prepend, *spec_for_path(path, leaf.dim()))
        for path, leaf in tree.flatten_with_paths(params)])


def shard_dim_ok(shape, spec: PartitionSpec, mesh_shape: dict) -> bool:
    for dim, ax in zip(shape, spec):
        if ax is None:
            continue
        k = int(np.prod([mesh_shape[a] for a in _names(ax)]))
        if dim % k != 0:
            return False
    return True


# ---------------------------------------------------------------------------
# Model shards of node-stacked leaves
# ---------------------------------------------------------------------------

def model_dim(spec: PartitionSpec) -> Optional[int]:
    """The per-node dim the model axis shards, or None for a replicated
    leaf.  One mesh axis shards at most one dim of a leaf."""
    dims = [d for d, e in enumerate(spec) if "model" in _names(e)]
    if len(dims) > 1:
        raise ValueError(f"{spec} names the model axis on dims {dims}")
    return dims[0] if dims else None


def shard_view(x: torch.Tensor, spec: PartitionSpec, model: int,
               lead: int = 1) -> torch.Tensor:
    """A node-stacked leaf ``(N, *extra, *shape)`` (``lead`` = 1 + the
    count of ``extra`` dims, e.g. 2 for an Hw leaf ``(N, T, *shape)``) as
    its model shards ``(N, M, *extra, *model_local_shape)``: shard m holds
    rows ``[m S/M, (m+1) S/M)`` of the sharded dim, as GSPMD places them.
    A view, so writing it writes ``x``.  A replicated leaf gives ``(N, 1,
    *extra, *shape)``, which broadcasts against the M shards."""
    d = model_dim(spec)
    if d is None or model == 1:
        return x.unsqueeze(1)
    d += lead
    return x.unflatten(d, (model, x.shape[d] // model)).movedim(d, 1)


def join_shards(xs: torch.Tensor, spec: PartitionSpec,
                lead: int = 1) -> torch.Tensor:
    """Inverse of :func:`shard_view`: ``(N, M, *extra, *local)`` ->
    ``(N, *extra, *shape)``, concatenating the shards along the dim the
    spec shards (a replicated leaf takes shard 0, every shard holding the
    same values)."""
    d = model_dim(spec)
    if d is None or xs.shape[1] == 1:
        return xs[:, 0]
    d += lead
    return xs.movedim(1, d).flatten(d, d + 1)


# ---------------------------------------------------------------------------
# Rank-rows: one (node, model shard) a row, for a tensor-parallel node
# ---------------------------------------------------------------------------

def rank_rows(x: torch.Tensor, spec: PartitionSpec, model: int,
              m: Optional[int] = None, lead: int = 1) -> torch.Tensor:
    """A node-stacked leaf ``(n, *extra, *shape)`` cut into rank-rows (a
    copy; ``lead`` as in :func:`shard_view`): with ``m`` None all M model
    ranks of each node, ``(n M, *extra, *local)``, row ``n M + m``; else
    model rank m's rows ``(n, *extra, *local)``.  A sharded leaf gives its
    model-local slices, a replicated leaf its whole self on every rank."""
    v = shard_view(x, spec, model, lead)             # (n, M or 1, ...)
    if m is not None:
        return v[:, min(m, v.shape[1] - 1)].clone()
    v = v.expand((v.shape[0], model) + tuple(v.shape[2:]))
    out = x.new_empty((v.shape[0] * model,) + tuple(v.shape[2:]))
    out.view(v.shape).copy_(v)        # never a view of x, whatever strides
    return out


def join_rank_rows(x: torch.Tensor, spec: PartitionSpec, model: int,
                   lead: int = 1) -> torch.Tensor:
    """Inverse of :func:`rank_rows` with ``m`` None: ``(n M, *extra,
    *local)`` -> ``(n, *extra, *shape)`` (a replicated leaf from model
    rank 0).  The rows of M processes join by stacking each rank's
    ``(n, ...)`` on dim 1 first: ``torch.stack(ranks, 1).flatten(0, 1)``."""
    return join_shards(x.unflatten(0, (x.shape[0] // model, model)), spec,
                       lead)
