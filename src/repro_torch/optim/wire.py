"""COMM wire path of the neighbor-gossip backend, node-stacked on one card.

The port of ``repro.optim.wire``.  Every mode turns per-leaf difference
tensors into, per leaf, (wq (N, T, *shape), qself (N, *shape)) where
wq[n, t] = sum_s w[n, t, s] Q_s over sender 0 = node n itself plus one
sender per hop:

  bucketed -- ONE packed-codes buffer and ONE byte-cast-scales buffer per
              node, laid out by :mod:`repro_torch.core.bucket`; each hop
              is 2 ``pp`` calls whatever the leaf count, and quantize+pack
              / unpack+dequant+mix run as kernels B3 / B4, one launch per
              bucket group for all N nodes.
  per_leaf -- every leaf moves its own packed codes and scales (2 x hops x
              leaves ``pp`` calls) through B1, PAIRS packing and B2.  The
              parity oracle: codes, scales, qself and mix equal bucketed's.
  identity -- C = 0: raw leaves move, no quantization.

The reference runs one node per device inside ``shard_map`` and moves
payloads with ``jax.lax.ppermute``.  Here all N nodes are stacked on a
leading node dim, and payloads cross the ``pp(x, pairs)`` seam, which has
ppermute's semantics on the stacked tensor: ``out[dst] = x[src]`` for
every (src, dst) in ``pairs``, rows that receive nothing are zero.  Only
u8 wire buffers cross it (raw leaves in identity mode).  :func:`stacked_pp`
is the one-card seam.

``wmat`` is the (1 + hops, T, N) receiver-indexed weight table (row 0 =
self weight), as the reference's trainer builds it.  Randomness comes from
the draw source: one ``uniform`` per leaf, in leaf order, of the
node-stacked blocked shape (N, ..., nb, block); row n is node n's noise.

Model shards (the bucketed wire on an (N, M) mesh, M > 1).  The reference
runs one device per (node, model shard), each quantizing its model-local
slice of every leaf (full-manual ``shard_map``).  Here a node's M shards
are rows ``n M + m`` of the row tables (N x M rows, the layout computed
from model-local shapes), so B3 and B4 run once per group over all N x M
rows.  The draw rule, which keeps the replicated copies equal:

  * a leaf the model axis shards draws its noise once for all its shards,
    ``(N, M, ..., nb, block)`` in one ``uniform`` -- shard m's noise is
    its own, as the reference folds the shard index into its key;
  * a model-replicated leaf (norms, biases) draws ``(N, ..., nb, block)``
    once, and every shard quantizes with that same noise: the reference
    draws it from one key on every shard, or its replicated copies would
    diverge.

On a tensor-parallel node (``repro_torch.models.tp``) the state's rows
are the rank-rows themselves and the trainer writes each into its own row
of the tables.  Under ``StackedTP`` the draws are the same calls as above,
so a rank-row (n, m) consumes exactly the noise the one-process (N, M)
run gives shard m of a sharded leaf, and every model rank of a node the
same noise of a replicated leaf: the replicated copies stay bit-equal.
A ``DistTP`` rank (its rows: model rank m of its node block, M = 1
here) draws a sharded leaf's noise from its draw source and a replicated
leaf's from ``draws.shared()``, the source its node block's model ranks
share (``core.draws.TPRankDraws``: in a seeded run its own stream per
(node block, model rank) and one per node block; a replay of the
one-process run's noise hands rank (b, m) shard m's rows of a sharded
leaf and the node rows of a replicated one, in leaf order).

The wire buffers are laid out ``(N, M x bytes)``: a node's M shard
payloads side by side, so the node-dim ``pp`` moves all M shards of a
node with the hop pairs as they are, and a process holding whole nodes
(:class:`DistPP`) sends each node's M payloads as one row.  B4's per-node
weights repeat for each shard.  A node sends M x the per-shard bytes a
hop, as the reference's M devices of a node do together.

Several processes.  :class:`DistPP` is ``pp`` over a
:class:`repro_torch.launch.mesh.ProcessMesh`: a rank holds the rows of its
node block, pairs within it are copied in place, pairs across ranks are
``torch.distributed`` point-to-point transfers (gloo on CPU tensors, NCCL
on CUDA ones).
"""
from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import bucket
from repro_torch.core.draws import Draws
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.obs.meters import current_meters

WIRE_MODES = ("bucketed", "per_leaf")


@functools.lru_cache(maxsize=None)
def _pair_index(pairs: Tuple[Tuple[int, int], ...], device: torch.device):
    """(src, dst) index tensors of ``pairs`` on ``device``, built once."""
    return (torch.tensor([s for s, _ in pairs], device=device),
            torch.tensor([d for _, d in pairs], device=device))


def stacked_pp(x: torch.Tensor, pairs) -> torch.Tensor:
    """The one-card exchange seam: ``out[dst] = x[src]`` for every
    (src, dst) in ``pairs`` along the leading node dim; rows that receive
    nothing are zero (``jax.lax.ppermute`` semantics)."""
    out = torch.zeros_like(x)
    if pairs:
        src, dst = _pair_index(tuple(map(tuple, pairs)), x.device)
        out[dst] = x[src]
    return out


class DistPP:
    """``pp(x, pairs)`` with :func:`stacked_pp`'s semantics over a
    process mesh: ``x`` is this rank's rows ``(n_local, ...)`` of a
    node-stacked tensor, ``pairs`` the global (src, dst) node pairs.
    Every rank must make the same calls in the same order; each call posts
    all of the rank's sends and receives in ONE ``batch_isend_irecv``, in
    pair order and tagged by pair index, so no pair of ranks waits on
    another's order.  A rank with nothing to send or receive in a call
    posts nothing and returns zeros."""

    def __init__(self, process_mesh) -> None:
        self.pm = process_mesh

    def _peer(self, rank: int) -> int:
        import torch.distributed as dist
        g = self.pm.group
        return rank if g is None else dist.get_global_rank(g, rank)

    def __call__(self, x: torch.Tensor, pairs) -> torch.Tensor:
        pm = self.pm
        lo, hi = pm.lo, pm.hi
        x = x.contiguous()
        out = torch.zeros_like(x)
        posts = []            # (send?, pair index, row, peer rank)
        for i, (s, d) in enumerate(pairs):
            mine_s, mine_d = lo <= s < hi, lo <= d < hi
            if mine_s and mine_d:
                out[d - lo].copy_(x[s - lo])
            elif mine_s:
                posts.append((True, i, x[s - lo], pm.owner(d)))
            elif mine_d:
                posts.append((False, i, out[d - lo], pm.owner(s)))
        if posts:
            self._transfer(posts)
        return out

    def _transfer(self, posts) -> None:
        import torch.distributed as dist
        ops = [dist.P2POp(dist.isend if send else dist.irecv, row,
                          self._peer(peer), self.pm.group, tag=i)
               for send, i, row, peer in posts]
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class DryDistPP(DistPP):
    """:class:`DistPP`'s ops on the rank's rows without the transfers:
    what a dry run (``meta`` tensors, no process group) hands the trainer
    as its seam.  The rows it would receive stay zero."""

    def _transfer(self, posts) -> None:
        pass


def node_weights(wmat, device) -> torch.Tensor:
    """(1 + hops, T, N) receiver-indexed table -> (N, T, S) f32 weights on
    ``device``, node n's (T, S) being the reference's per-node
    ``wmat.T``."""
    w = torch.as_tensor(wmat, dtype=torch.float32, device=device)
    return w.permute(2, 1, 0).contiguous()


class WireExchange:
    """One COMM exchange: node-stacked diffs -> (wq leaves, qself leaves)."""

    def __init__(self, *, bits: int = 2, block: int = 256,
                 scales_bf16: bool = False, pack_mode: str = "lastdim",
                 block_for: Optional[Callable] = None):
        self.bits = bits
        self.scales_bf16 = scales_bf16
        self.pack_mode = pack_mode
        self.block_for = block_for or functools.partial(
            bucket.default_quant_block, block=block)

    @staticmethod
    def local_shapes(diffs) -> List[Tuple[int, ...]]:
        """Per-node shapes with the local node dim of 1, as the reference's
        shard_map hands them to its exchange."""
        return [(1,) + tuple(d.shape[1:]) for d in diffs]

    def layout(self, shapes: Sequence[Tuple[int, ...]],
               dtypes: Sequence) -> bucket.BucketLayout:
        return bucket.compute_layout(
            shapes, dtypes, bits=self.bits, block_for=self.block_for,
            scale_bytes=2 if self.scales_bf16 else 4)

    # ------------------------------------------------------------ telemetry
    def _record(self, hop_pairs, *, bytes_per_hop: int,
                collectives_per_hop: int) -> None:
        """Gauge the static wire facts into the ambient Meters (no-op when
        none is installed); ``wire/exchanges`` counts exchanges."""
        m = current_meters()
        if m is None:
            return
        hops = len(hop_pairs)
        m.set("wire/bytes_per_hop", bytes_per_hop)
        m.set("wire/hops", hops)
        m.set("wire/collectives_per_step", collectives_per_hop * hops)
        m.inc("wire/exchanges")

    # ------------------------------------------------------------ bucketed
    def bucketed(self, rows: bucket.RowTables, draws: Draws, wmat,
                 hop_pairs, pp=stacked_pp, sharded: Sequence[bool] = ()):
        """``rows``: the node-stacked diffs, already written into their
        bucket groups' row tables (the trainer writes them there, to skip a
        copy; from leaves: :meth:`bucket.RowTables.from_leaves`).  The
        exchange consumes the tables once packed.  With M model shards a
        node (``rows.n`` = N x M, N from ``wmat``), ``sharded`` says per
        leaf whether the model axis shards it (the draw rule of the module
        docstring); wq and qself come back at N x M rows."""
        layout = rows.layout
        n = wmat.shape[-1]
        M = rows.n // n
        if M > 1 and len(sharded) != len(layout.slots):
            raise ValueError(f"{M} model shards need the sharded flag of "
                             f"every leaf, got {len(sharded)}")
        self._record(hop_pairs, bytes_per_hop=M * layout.wire_bits // 8,
                     collectives_per_hop=2)
        # noise of the per-leaf quantizer's shape, drawn straight into the
        # group tables; the blocked views cover the padding, as the
        # reference's draw does
        noise = bucket.RowTables(layout, rows.n, rows.tables[0].device,
                                 zero_pad=False)
        for j in range(len(layout.slots)):
            view = noise.block_view(j)
            # a model-replicated leaf draws from the node's shared source
            src = draws.shared() if sharded and not sharded[j] else draws
            if M == 1:
                src.uniform(tuple(view.shape), out=view)
                continue
            view = view.unflatten(0, (n, M))
            if sharded[j]:
                draws.uniform(tuple(view.shape), out=view)
            else:                     # one draw, the same on every shard
                view.copy_(src.uniform(
                    (n,) + tuple(view.shape[2:])).unsqueeze(1))
        cw, sw = bucket.pack_to_wire(layout, rows.tables, noise.tables)
        rows.free()
        noise.free()
        # the ONLY communication: 2 buffers x hops, leaf-count independent;
        # a node's row holds its M shard payloads
        cw, sw = cw.view(n, -1), sw.view(n, -1)
        wires = [(cw, sw)] + [(pp(cw, pr), pp(sw, pr)) for pr in hop_pairs]
        del cw, sw
        wires = [(c.view(n * M, -1), s.view(n * M, -1)) for c, s in wires]
        w = node_weights(wmat, wires[0][0].device)
        return bucket.mix_from_wire(
            layout, wires, w if M == 1 else w.repeat_interleave(M, 0))

    # ------------------------------------------------------------ per-leaf
    def per_leaf(self, diffs, draws: Draws, wmat, hop_pairs, pp=stacked_pp):
        # same bytes as bucketed (the bucket is a concatenation), but each
        # leaf ships its own (codes, scales) pair per hop
        self._record(hop_pairs,
                     bytes_per_hop=self.layout(
                         self.local_shapes(diffs),
                         [d.dtype for d in diffs]).wire_bits // 8,
                     collectives_per_hop=2 * len(diffs))
        w = node_weights(wmat, diffs[0].device)
        wq: List = []
        qs: List = []
        bits = self.bits
        for d in diffs:
            blk = self.block_for((1,) + tuple(d.shape[1:]))
            u = draws.uniform(kops.blockwise_shape(d.shape, blk))
            codes, scales = kops.qinf_quantize_lastdim(d, u, bits=bits,
                                                       block=blk)
            del u
            if self.scales_bf16:
                scales = scales.to(torch.bfloat16)
            if self.pack_mode == "lastdim":
                packed = kops.pack_codes_lastdim(codes, bits=bits)
                unpack = functools.partial(kops.unpack_codes_lastdim,
                                           bits=bits)
            else:  # flat: every node's codes flattened into one payload
                packed = torch.stack([kops.pack_codes(c, bits=bits)
                                      for c in codes])
                unpack = functools.partial(self._unpack_flat, bits=bits,
                                           like=codes)
            # byte-cast scales: EVERY wire payload is u8
            s_wire = scales.contiguous().view(torch.uint8)

            def dq(pk, su8, sdtype=scales.dtype, shape=d.shape,
                   dtype=d.dtype, b=blk):
                return kops.qinf_dequantize_lastdim(
                    unpack(pk), su8.view(sdtype).to(torch.float32), shape,
                    dtype, block=b)

            recvs = [dq(pp(packed, pr), pp(s_wire, pr)) for pr in hop_pairs]
            q_self = kops.qinf_dequantize_lastdim(
                codes, scales.to(torch.float32), d.shape, d.dtype, block=blk)
            qstack = torch.stack([q_self] + recvs)        # (1 + hops, N, ...)
            wq.append(kref.weighted_mix_ref(w, qstack).to(d.dtype))
            qs.append(q_self)
        return wq, qs

    @staticmethod
    def _unpack_flat(packed, *, bits, like):
        n = like[0].numel()
        return torch.stack([kops.unpack_codes(p, bits=bits, n=n)
                            for p in packed]).reshape(like.shape)

    # ------------------------------------------------------------ identity
    def identity(self, diffs, wmat, hop_pairs, pp=stacked_pp):
        """C = 0 wire path: raw leaves move, no quantization."""
        self._record(hop_pairs,
                     bytes_per_hop=sum(d[0].numel() * d.element_size()
                                       for d in diffs),
                     collectives_per_hop=len(diffs))
        w = node_weights(wmat, diffs[0].device)
        wq: List = []
        for d in diffs:
            recvs = [pp(d, pr) for pr in hop_pairs]
            qstack = torch.stack([d] + recvs)
            wq.append(kref.weighted_mix_ref(w, qstack).to(d.dtype))
        return wq, list(diffs)
