"""The ``tp`` seam: a node's products split over its M model ranks.

The reference shards a node's heads, FF dimension and vocabulary over the
mesh's ``'model'`` axis (``repro_torch.models.sharding``'s rules) and
leaves the split of the products, and the all-gathers and reduce-scatters
around them, to GSPMD.  The port writes them out, Megatron-style.  Model
code sees a seam object with these operators over the model axis, each a
``torch.autograd.Function``:

  copy_in(x)      f: identity forward, sum over the model ranks backward.
                  Where a replicated tensor enters a rank's partial
                  products (after a norm, at the column-parallel inputs;
                  a replicated scale used on a rank's heads).
  reduce_out(x)   g: sum forward, identity backward.  After a
                  row-parallel product; a row bias is added once, after it.
  gather_last(x)  concatenation of the ranks' last dims forward, the
                  rank's own slice backward.
  scatter_last(x) the rank's own slice of a replicated tensor's last dim
                  forward, the concatenation of the ranks' gradients
                  backward (an all-gather).  How a rank reads its columns
                  of a replicated per-channel leaf or activation: the
                  gradient comes back whole and the same on every rank,
                  cheaper than ``copy_in`` and a slice, whose backward
                  all-reduces a mostly-zero whole tensor.
  all_max(x)      max forward; no gradient (the loss's detached shift).
  all_sum(x)      sum forward, identity backward (the vocab-parallel
                  loss's sums).
  whole(x, spec)  a leaf's model-local slices joined over the ranks along
                  the dim its spec shards (an all-gather; no gradient):
                  how the optimizer quantizes a split leaf whole.

The gradient convention is Megatron's: the M rank-rows of a node hold the
same loss, and each backpropagates its own copy.  With f and g placed as
above every leaf's gradient is that of the node's loss counted once: a
sharded leaf's is its slice of the whole node's, a replicated leaf's is
the whole node's and the same on every model rank.  A gathered tensor
that feeds rank-specific work (a rank computing only the heads its
``wo`` rows read) goes through ``copy_in(gather_last(x))``, whose
backward sums over the ranks before slicing: a reduce-scatter.

Rank-rows.  A rank-row is one (node, model shard), laid out as row
``n M + m`` (the wire's row tables use the same layout, ``repro_torch.
optim.wire``).  Parameters, batches and activations are stacked over the
rank-rows a process holds: a sharded leaf holds its model-local slice
(``sharding.model_local_shape``), a replicated leaf the whole leaf.

Implementations:

  NoTP           M = 1, every operator the identity: the default, and the
                 path every whole-node run takes unchanged.
  StackedTP(M)   one process holds all N x M rank-rows, node-stacked as
                 (N M, ...); a collective is a ``view(N, M, ...)`` and a
                 sum, max or concatenation over the M dim.  This is how
                 one card runs a tensor-parallel node (the ``pp`` seam's
                 ``stacked_pp`` is the same idea).
  DistTP(pm)     the model axis over a ``torch.distributed`` model group
                 (:class:`repro_torch.launch.mesh.TPProcessMesh`): the
                 process holds the rank-rows (n, m) of its node block at
                 its model rank m.  NCCL on CUDA tensors, gloo on CPU
                 ones.  A sum is an all-reduce written as its two
                 halves: an all-to-all hands rank m part m of every rank's
                 buffer (a reduce-scatter's traffic), rank m adds the M
                 parts in rank order as StackedTP adds its (n, M, ...)
                 rows, and an all-gather hands every rank the M sums.  It
                 moves a ring all-reduce's 2 (M - 1) / M of the buffer and
                 holds two copies of it, and the ranks' state is the
                 one-process run's bit for bit at any M (a backend's
                 all-reduce adds in its own order).  Every rank makes the
                 same calls in the same order; a failure raises, nothing
                 is caught.
  DryDistTP(pm)  :class:`DistTP`'s allocations on ``meta`` without the
                 transfers (a dry run's seam).

Every collective is first handed to the seam's ``recorder``, where one is
set: a callable ``(kind, operand)``, kind ``"all-reduce"`` (a sum),
``"all-reduce-max"``, ``"all-gather"`` (``gather_last``'s forward) or
``"all-gather-grad"`` (``scatter_last``'s backward: the ranks' gradient
slices joined), so that ``repro_torch.obs.record.RecordingTP`` counts a
step's bytes by kind.

Each seam also maps between a process's node rows and its rank-rows
(:meth:`node_rows`, :meth:`first_of_node`, ``rows_per_node``: the
rank-rows a process holds of each of its nodes) and cuts a node-stacked
state into rank-rows and back (:meth:`cut`, :meth:`join`).
"""
from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from repro_torch.models import sharding


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, seam, x):
        ctx.seam = seam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.seam._collective("all-reduce", ctx.seam._sum, g)


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, seam, x):
        return seam._collective("all-reduce", seam._sum, x)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, seam, x):
        ctx.seam = seam
        return seam._collective("all-gather", seam._cat_last, x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.seam._slice_last(g)


class _ScatterLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, seam, x):
        ctx.seam = seam
        return seam._slice_last(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.seam._collective("all-gather-grad",
                                          ctx.seam._cat_last, g)


class TPSeam:
    """The Megatron operators over the primitives a seam implements:
    ``_sum``, ``_max`` and ``_cat_last`` (collectives over the model
    ranks, each returning a new tensor) and ``_slice_last`` (the rank's
    own columns, local)."""

    M: int = 1
    #: rank-rows a process holds of each of its nodes
    rows_per_node: int = 1
    #: None, or a callable ``(kind, operand)`` told of each collective
    #: before it runs (the module docstring)
    recorder = None

    def _collective(self, kind: str, fn, t: torch.Tensor) -> torch.Tensor:
        if self.recorder is not None:
            self.recorder(kind, t)
        return fn(t)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(self, x)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(self, x)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherLast.apply(self, x)

    def scatter_last(self, x: torch.Tensor) -> torch.Tensor:
        return _ScatterLast.apply(self, x)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        return self._collective("all-reduce-max", self._max, x.detach())

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(self, x)

    def gather_heads(self, x: torch.Tensor) -> torch.Tensor:
        """``copy_in(gather_last(x))``: every rank's columns forward, the
        sum over the ranks of the gathered gradient sliced to the rank's
        columns backward (a reduce-scatter), for a gathered tensor whose
        consumers differ by rank."""
        return self.copy_in(self.gather_last(x))

    def whole(self, x: torch.Tensor, spec) -> torch.Tensor:
        """A leaf's rank-rows ``(rows, *local)`` -> the node's whole leaf
        on each rank-row ``(rows, *shape)``: a sharded leaf's slices
        joined over the model ranks along the dim ``spec`` (the per-node
        leaf's partition spec) shards, by an ``"all-gather"``; a
        replicated leaf as it is.  Contiguous (kernel B1 reads it as
        rows).  No gradient (the optimizer's view of a split leaf)."""
        d = sharding.model_dim(spec)
        if d is None:
            return x
        t = x.detach().movedim(d + 1, -1)
        return self._collective("all-gather", self._cat_last, t) \
            .movedim(-1, d + 1).contiguous()


class NoTP(TPSeam):
    """M = 1: every operator is the identity and a process's rows are its
    nodes."""

    M = 1

    def copy_in(self, x):
        return x

    def reduce_out(self, x):
        return x

    def gather_last(self, x):
        return x

    def scatter_last(self, x):
        return x

    def all_max(self, x):
        return x.detach()

    def all_sum(self, x):
        return x

    def gather_heads(self, x):
        return x

    def whole(self, x, spec):
        return x

    def model_index(self, n_rows: int, device) -> torch.Tensor:
        return torch.zeros((n_rows,), dtype=torch.int64, device=device)

    def node_rows(self, x):
        return x

    def first_of_node(self, x):
        return x

    def cut(self, leaves, specs, lead: int = 1):
        return list(leaves)

    def join(self, leaves, specs, lead: int = 1):
        return list(leaves)


NO_TP = NoTP()


def _map_batch(fn, batch):
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return fn(batch)


class StackedTP(TPSeam):
    """All N x M rank-rows in one process, row ``n M + m``."""

    def __init__(self, model: int) -> None:
        if model < 1:
            raise ValueError(f"StackedTP needs M >= 1, got {model}")
        self.M = self.rows_per_node = int(model)

    def _nodes(self, t: torch.Tensor) -> torch.Tensor:
        return t.unflatten(0, (t.shape[0] // self.M, self.M))

    def _sum(self, t):
        v = self._nodes(t)
        return v.sum(1, keepdim=True).expand_as(v).reshape(t.shape)

    def _max(self, t):
        v = self._nodes(t)
        return v.amax(1, keepdim=True).expand_as(v).reshape(t.shape)

    def _cat_last(self, t):
        v = self._nodes(t)                               # (n, M, ..., k)
        whole = v.movedim(1, -2).flatten(-2)             # (n, ..., M k)
        return whole.unsqueeze(1).expand(
            (v.shape[0], self.M) + tuple(whole.shape[1:])).reshape(
            (t.shape[0],) + tuple(whole.shape[1:]))

    def _slice_last(self, g):
        v = self._nodes(g)                               # (n, M, ..., M k)
        v = v.unflatten(-1, (self.M, g.shape[-1] // self.M))
        own = torch.diagonal(v, dim1=1, dim2=-2)         # (n, ..., k, M)
        return own.movedim(-1, 1).flatten(0, 1)

    def model_index(self, n_rows: int, device) -> torch.Tensor:
        return torch.arange(n_rows, device=device) % self.M

    def node_rows(self, batch):
        """Node rows (n, ...) -> rank-rows (n M, ...): each rank-row its
        node's rows."""
        return _map_batch(lambda t: t.repeat_interleave(self.M, 0), batch)

    def first_of_node(self, x):
        """Rank-rows (n M, ...) -> the node's value on its model rank 0."""
        return x[::self.M]

    def cut(self, leaves, specs, lead: int = 1) -> List[torch.Tensor]:
        """Node-stacked leaves (n, *extra, *shape) -> rank-rows (n M,
        *extra, *local): the model-local slices of a sharded leaf, M
        copies of a replicated one (``lead`` as in
        :func:`sharding.shard_view`)."""
        return [sharding.rank_rows(x, sp, self.M, lead=lead)
                for x, sp in zip(leaves, specs)]

    def join(self, leaves, specs, lead: int = 1) -> List[torch.Tensor]:
        """Inverse of :meth:`cut` (a replicated leaf from model rank 0)."""
        return [sharding.join_rank_rows(x, sp, self.M, lead)
                for x, sp in zip(leaves, specs)]


class DistTP(TPSeam):
    """The model axis over the model group of a :class:`repro_torch.
    launch.mesh.TPProcessMesh`: this process is model rank ``pm.m`` of
    the node block ``[pm.lo, pm.hi)``."""

    def __init__(self, process_mesh) -> None:
        self.pm = process_mesh
        self.M = process_mesh.M
        self.m = process_mesh.m

    def _xfer(self, fn: str, *args, **kw) -> None:
        """``torch.distributed.<fn>(*args, **kw)`` over the model group
        (a dry seam skips it)."""
        import torch.distributed as dist
        getattr(dist, fn)(*args, group=self.pm.model_group, **kw)

    def _sum(self, t):
        # all-to-all, a sum of the M parts in rank order, all-gather (the
        # module docstring): every rank gets the one-process run's bits
        n, M = t.numel(), self.M
        k = -(-n // M)
        flat = torch.nn.functional.pad(t.reshape(-1), (0, k * M - n))
        parts = torch.empty_like(flat)
        self._xfer("all_to_all_single", parts, flat)
        own = parts.view(M, k).sum(0)
        whole = torch.empty_like(flat)
        self._xfer("all_gather_into_tensor", whole, own)
        return whole[:n].view(t.shape)

    def _max(self, t):
        import torch.distributed as dist
        out = t.contiguous().clone()
        self._xfer("all_reduce", out, op=dist.ReduceOp.MAX)
        return out

    def _cat_last(self, t):
        t = t.contiguous()
        parts = t.new_empty((self.M * t.shape[0],) + tuple(t.shape[1:]))
        self._xfer("all_gather_into_tensor", parts, t)   # ranks along dim 0
        return parts.unflatten(0, (self.M, t.shape[0])).movedim(0, -2) \
            .flatten(-2)

    def _slice_last(self, g):
        k = g.shape[-1] // self.M
        return g[..., self.m * k:(self.m + 1) * k].contiguous()

    def model_index(self, n_rows: int, device) -> torch.Tensor:
        return torch.full((n_rows,), self.m, dtype=torch.int64,
                          device=device)

    def node_rows(self, batch):
        return batch

    def first_of_node(self, x):
        return x

    def cut(self, leaves, specs, lead: int = 1) -> List[torch.Tensor]:
        """This process's node rows (n, *extra, *shape) -> its rank-rows:
        model rank m's slice of a sharded leaf, a replicated leaf whole."""
        return [sharding.rank_rows(x, sp, self.M, self.m, lead)
                for x, sp in zip(leaves, specs)]

    def join(self, leaves, specs, lead: int = 1):
        raise ValueError("a DistTP rank holds one model shard: stack the "
                         "M ranks' rows and join them (sharding."
                         "join_rank_rows)")

    def rank_draws(self, seed: int, device):
        """The draws of this rank in a seeded run: its own stream per
        (node block, model rank) for sharded leaves, one stream per node
        block, shared by the block's model ranks, for replicated leaves,
        and one every rank shares (:func:`rank_draws`)."""
        from repro_torch.core.draws import TPRankDraws, draws_on
        b = self.pm.b
        return TPRankDraws(draws_on(_stream(seed, 1, b, self.m), device),
                           draws_on(_stream(seed, 2, b), device),
                           draws_on(_stream(seed, 3), device))


def _stream(*key: int) -> int:
    """The seed of a rank's stream ``key`` (the run's seed first)."""
    return int(np.random.SeedSequence(list(key)).generate_state(1)[0])


class DryDistTP(DistTP):
    """:class:`DistTP`'s ops without the transfers: what a dry run
    (``meta`` tensors, no process group) hands the trainer."""

    def _xfer(self, fn, *args, **kw):
        pass


def rank_draws(tp, seed: int, device, process_mesh=None):
    """The draws a seeded run of this process makes: a ``DistTP`` rank's
    :meth:`DistTP.rank_draws`; a rank of a plain ``ProcessMesh``
    (``process_mesh``) its node block's own stream for what it draws row
    by row (the oracle, QInf's noise: each node block's differs) and the
    stream every rank shares for RandK and TopK (``Draws.common``); else
    one generator seeded ``seed``."""
    from repro_torch.core.draws import TPRankDraws, draws_on
    if isinstance(tp, DistTP):
        return tp.rank_draws(seed, device)
    if process_mesh is not None:
        own = draws_on(_stream(seed, 2, process_mesh.rank), device)
        return TPRankDraws(own, own, draws_on(_stream(seed, 3), device))
    return draws_on(seed, device)


def head_geometry(n_heads: int, head_dim: int, model: int):
    """How a rank's ``H hd / M`` query columns fall on whole heads: (the
    query heads are whole on every rank, heads a rank computes Hn, the
    first head of each rank h0[m]).  Where the columns cut a head, a rank
    computes every head its columns touch, Hn = the most over the ranks
    (at most ceil(H / M) + 1)."""
    H, hd, M = n_heads, head_dim, model
    cols = H * hd // M
    if H % M == 0:
        return True, H // M, [m * (H // M) for m in range(M)]
    h0 = [m * cols // hd for m in range(M)]
    h1 = [-(-(m + 1) * cols // hd) for m in range(M)]
    return False, max(b - a for a, b in zip(h0, h1)), h0


@functools.lru_cache(maxsize=None)
def kv_group(n_heads: int, n_kv_heads: int, head_dim: int, model: int
             ) -> int:
    """How many of a rank's query heads share one KV slot of its cache
    where its heads are not aligned with the KV heads
    (:func:`head_geometry`): the largest g dividing the Hn heads a rank
    computes such that every block of g of them reads one KV head, on
    every rank (1: a KV slot a query head).  ``transformer._head_plan``
    keeps every g-th KV head of a rank's heads, so a rank's attention
    groups g query heads a KV slot, as GQA does."""
    H, KV, hd, M = n_heads, n_kv_heads, head_dim, model
    whole, Hn, h0 = head_geometry(H, hd, M)
    rep = H // KV
    kv = [[min(h0[m] + j, H - 1) // rep for j in range(Hn)]
          for m in range(M)]
    return max(g for g in range(1, Hn + 1) if Hn % g == 0 and all(
        row[j] == row[j - j % g] for row in kv for j in range(Hn)))
