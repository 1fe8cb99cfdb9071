"""Bucketed wire layout for the neighbor-gossip backend.

The port of ``repro.core.bucket``.  A STATIC layout table maps every
leaf's quantization blocks into one contiguous row table per
(block-width, dtype) group, and the groups concatenate into exactly TWO
flat u8 wire buffers per node:

  codes buffer  -- the nibble/byte-packed offset codes of every block of
                   every leaf, group by group, leaf by leaf;
  scales buffer -- one byte-cast scale (f32 or bf16) per block, same order.

A gossip hop moves those two buffers and nothing else, whatever the leaf
count.  ``compute_layout`` is pure Python over per-node leaf shapes and
gives the reference's offsets exactly.

The port holds all N nodes on one card, stacked on a leading node dim, so
the tensor half differs from the reference's in one way: a group's rows
live in one preallocated ``(N, rows, block)`` f32 table
(:class:`RowTables`) whose per-leaf views the caller writes into, and the
fused kernels (B3 quantize+pack, B4 unpack+dequant+mix) run once per group
over all nodes.  Nothing is concatenated on the way in.  Per-node layout
shapes carry a leading 1 (the local node dim of the reference's
``shard_map``); a leaf stacked over N nodes has shape ``(N,) +
slot.shape[1:]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.quantize import packed_width

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_name(dtype) -> str:
    """'float32', 'bfloat16', ... for a torch dtype or a numpy-like one."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def default_quant_block(shape: Sequence[int], block: int = 256) -> int:
    """Quantization block width for a leaf of ``shape``: the configured
    ``block``, capped at the leaf's own last dim when that is even and
    smaller -- a row narrower than the block would otherwise ship a full
    padded block per row on every hop (nibble packing needs even widths,
    so odd last dims keep the padded block)."""
    ld = shape[-1] if shape else 1
    if ld % 2 == 0 and ld < block:
        return ld
    return block


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one leaf's quantization blocks live inside its group."""
    index: int                  # position in the flattened leaf list
    shape: Tuple[int, ...]      # per-node leaf shape as the quantizer sees it
    dtype: torch.dtype
    block: int                  # quantization block width for this leaf
    nb: int                     # blocks per row: ceil(last_dim / block)
    rows: int                   # total blocks: prod(shape[:-1]) * nb
    group: int                  # index into BucketLayout.groups
    row_offset: int             # first row within the group's row table


@dataclasses.dataclass(frozen=True)
class GroupSlot:
    """One (block-width, dtype) row table and its wire-buffer segment."""
    block: int
    dtype: torch.dtype
    packed_width: int           # wire bytes per row (codes)
    rows: int                   # total rows over member leaves (per node)
    codes_offset: int           # byte offset into the codes wire buffer
    scales_offset: int          # byte offset into the scales wire buffer
    leaf_indices: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Static map: leaves <-> two flat u8 wire buffers per node."""
    slots: Tuple[LeafSlot, ...]
    groups: Tuple[GroupSlot, ...]
    codes_bytes: int
    scales_bytes: int
    scale_bytes: int            # bytes per block scale (4 f32 / 2 bf16)
    bits: int

    @property
    def wire_bits(self) -> int:
        """Exact bits one directed edge moves per hop (both buffers)."""
        return 8 * (self.codes_bytes + self.scales_bytes)


def compute_layout(shapes: Sequence[Tuple[int, ...]],
                   dtypes: Sequence[Any], *, bits: int,
                   block_for: Optional[Callable] = None,
                   scale_bytes: int = 4) -> BucketLayout:
    """Build the static layout for per-node leaves of ``shapes``/``dtypes``
    (torch or numpy-like dtypes).

    ``block_for(shape) -> int`` chooses each leaf's quantization block
    (default :func:`default_quant_block`); leaves sharing (block, dtype)
    land in one group so a single fused kernel call covers them."""
    block_for = block_for or default_quant_block
    keys: List[Tuple[int, str]] = []        # group keys, first appearance
    members: List[List[int]] = []
    slots_raw = []
    for j, (shape, dtype) in enumerate(zip(shapes, dtypes)):
        shape = tuple(int(d) for d in shape) or (1,)
        blk = int(block_for(shape))
        nb = -(-shape[-1] // blk)
        rows = int(np.prod(shape[:-1], dtype=np.int64)) * nb
        key = (blk, dtype_name(dtype))
        if key not in keys:
            keys.append(key)
            members.append([])
        g = keys.index(key)
        members[g].append(j)
        slots_raw.append((j, shape, _TORCH_DTYPES[key[1]], blk, nb, rows, g))

    group_rows = [sum(slots_raw[j][5] for j in m) for m in members]
    groups, codes_off, scales_off = [], 0, 0
    for g, (blk, dname) in enumerate(keys):
        pw = packed_width(blk, bits)
        groups.append(GroupSlot(
            block=blk, dtype=_TORCH_DTYPES[dname], packed_width=pw,
            rows=group_rows[g], codes_offset=codes_off,
            scales_offset=scales_off, leaf_indices=tuple(members[g])))
        codes_off += group_rows[g] * pw
        scales_off += group_rows[g] * scale_bytes

    slots, row_off = [None] * len(shapes), [0] * len(groups)
    for (j, shape, dtype, blk, nb, rows, g) in slots_raw:
        slots[j] = LeafSlot(index=j, shape=shape, dtype=dtype, block=blk,
                            nb=nb, rows=rows, group=g, row_offset=row_off[g])
        row_off[g] += rows
    return BucketLayout(slots=tuple(slots), groups=tuple(groups),
                        codes_bytes=codes_off, scales_bytes=scales_off,
                        scale_bytes=scale_bytes, bits=bits)


def _scales_dtype(layout: BucketLayout) -> torch.dtype:
    return torch.bfloat16 if layout.scale_bytes == 2 else torch.float32


# ---------------------------------------------------------------------------
# Row tables: leaves <-> (N, rows, block) f32 tables, one per group.
# ---------------------------------------------------------------------------

class RowTables:
    """One ``(N, group.rows, block)`` f32 table per group of ``layout``,
    with a view per leaf into it.

    ``block_view(j)`` is leaf j blocked as the quantizer blocks it,
    ``(N, *shape[1:-1], nb, block)``; ``leaf_view(j)`` is leaf j itself,
    ``(N,) + shape[1:]``, with the last-axis padding dropped.  The padding
    of every padded leaf is zeroed at allocation (``zero_pad``), so writing
    each ``leaf_view`` fills the tables exactly as the reference's
    zero-padded blocking would."""

    def __init__(self, layout: BucketLayout, n: int, device, *,
                 zero_pad: bool = True) -> None:
        self.layout = layout
        self.n = int(n)
        self.tables: List[torch.Tensor] = [
            torch.empty((self.n, g.rows, g.block), dtype=torch.float32,
                        device=device) for g in layout.groups]
        if zero_pad:
            for j, sl in enumerate(layout.slots):
                if sl.nb * sl.block != sl.shape[-1]:
                    self._flat_view(j)[..., sl.shape[-1]:].zero_()

    def __len__(self) -> int:
        return len(self.layout.slots)

    def block_view(self, j: int) -> torch.Tensor:
        sl = self.layout.slots[j]
        rows = self.tables[sl.group][:, sl.row_offset: sl.row_offset
                                     + sl.rows]
        return rows.view((self.n,) + sl.shape[1:-1] + (sl.nb, sl.block))

    def _flat_view(self, j: int) -> torch.Tensor:
        sl = self.layout.slots[j]
        return self.block_view(j).view(
            (self.n,) + sl.shape[1:-1] + (sl.nb * sl.block,))

    def leaf_view(self, j: int) -> torch.Tensor:
        sl = self.layout.slots[j]
        return self._flat_view(j)[..., :sl.shape[-1]].view(
            (self.n,) + sl.shape[1:])

    @classmethod
    def from_leaves(cls, layout: BucketLayout,
                    leaves: Sequence[torch.Tensor]) -> "RowTables":
        """Copy node-stacked ``leaves`` (N, ...) into fresh row tables."""
        rt = cls(layout, leaves[0].shape[0], leaves[0].device)
        for j, leaf in enumerate(leaves):
            rt.leaf_view(j).copy_(leaf)
        return rt

    def free(self) -> None:
        """Drop the tables (the exchange consumes them once packed)."""
        self.tables = []


# ---------------------------------------------------------------------------
# Row tables -> wire buffers -> mixed leaves.
# ---------------------------------------------------------------------------

def pack_to_wire(layout: BucketLayout, xrows: Sequence[torch.Tensor],
                 urows: Sequence[torch.Tensor]):
    """Quantize + pack every group into the two flat u8 wire buffers.

    ``xrows[g]`` / ``urows[g]`` are group g's ``(N, rows, block)`` f32
    tables of values and U[0,1) noise (:class:`RowTables`).  One B3 launch
    per group covers all N nodes.  Returns (codes u8 (N, codes_bytes),
    scales u8 (N, scales_bytes)); the scale bytes are the little-endian
    bytes of each f32 (or bf16) scale, as ``jax.lax.bitcast_convert_type``
    gives them."""
    codes_segs, scales_segs = [], []
    for g, xr, ur in zip(layout.groups, xrows, urows):
        n = xr.shape[0]
        packed, scales = kops.qinf_quantize_pack(
            xr.reshape(-1, g.block), ur.reshape(-1, g.block),
            bits=layout.bits, block=g.block)
        scales = scales.to(_scales_dtype(layout)).reshape(n, -1)
        codes_segs.append(packed.reshape(n, -1))
        scales_segs.append(scales.view(torch.uint8))
    return torch.cat(codes_segs, 1), torch.cat(scales_segs, 1)


def rows_to_leaf(slot: LeafSlot, rows: torch.Tensor,
                 lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """Inverse of the row mapping: ``rows`` (*lead, slot.rows, block) ->
    (*lead, *slot.shape), dropping last-axis block padding (a view where
    the strides allow one)."""
    shape = slot.shape
    flat = rows.reshape(tuple(lead) + shape[:-1]
                        + (slot.nb * rows.shape[-1],))
    return flat[..., :shape[-1]].reshape(tuple(lead) + shape)


def mix_from_wire(layout: BucketLayout,
                  wires: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  w: torch.Tensor):
    """Unpack + dequantize + mix the received wire buffers back to leaves.

    ``wires`` -- [(codes u8 (N, codes_bytes), scales u8 (N, scales_bytes))]:
    entry 0 is every node's own payload, then one entry per hop (row n of
    a hop's buffers is what node n received).  ``w`` -- (N, T, S) receiver
    weights, S == len(wires), node n mixing with w[n].  One B4 launch per
    group covers all N nodes.  Returns (wq leaves [(N, T, *shape)],
    qself leaves [(N, *shape)]) in leaf order (``shape`` without the
    per-node leading 1), where wq[:, t] = sum_s w[:, t, s] Q_s; both are
    views into the per-group outputs.  Each group's payload stacks are a
    ``wire/stack`` phase (:func:`repro_torch.obs.trace.phase`)."""
    from repro_torch.obs.trace import phase   # repro_torch.obs imports us
    n, T = wires[0][0].shape[0], w.shape[1]
    sdtype = _scales_dtype(layout)
    wq: list = [None] * len(layout.slots)
    qs: list = [None] * len(layout.slots)
    for g in layout.groups:
        pw, sb = g.packed_width, layout.scale_bytes
        # the stacks read every payload and write it again, scales as f32
        with phase("wire/stack", w.device,
                   bytes=len(wires) * n * g.rows * (2 * pw + sb + 4)):
            pstack = torch.stack([
                c[:, g.codes_offset: g.codes_offset + g.rows * pw].reshape(
                    n, g.rows, pw) for c, _ in wires], 1)
            sstack = torch.stack([
                s[:, g.scales_offset: g.scales_offset + g.rows * sb].reshape(
                    n, g.rows, sb).contiguous().view(sdtype).to(torch.float32)
                for _, s in wires], 1)
        mix, qself = kops.qinf_unpack_dequant_mix(
            pstack, sstack, w, bits=layout.bits, block=g.block,
            out_dtype=g.dtype)
        del pstack, sstack
        for i in g.leaf_indices:
            sl = layout.slots[i]
            r0, r1 = sl.row_offset, sl.row_offset + sl.rows
            wq[i] = rows_to_leaf(sl, mix[:, :, r0:r1], lead=(n, T)).squeeze(2)
            qs[i] = rows_to_leaf(sl, qself[:, r0:r1], lead=(n,)).squeeze(1)
    return wq, qs
