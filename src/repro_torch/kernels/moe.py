"""The expert-share MoE layer's kernels: grouped products over the held
experts of every node, and the row permutes around them.

No TPU kernel of the reference computes this: ``repro.models.moe`` routes
through dense one-hot dispatch and combine tensors (N, B, T, E, C) and
einsums.  The port's dropless layer (:mod:`repro_torch.models.moe`) sorts
the routed slots by (node, held expert) on the device instead, and these
kernels work on the sorted rows:

* :func:`gather` -- ``out[r] = src[idx[r]]`` for the live rows (the
  dispatch, and the transpose of the combine in backward);
* :func:`combine` -- ``out[t] = sum_j w[t, j] rows[pos[t, j]]`` over a
  token's held slots (the gated combine, and the transpose of the
  dispatch in backward, unweighted);
* :func:`rows_mm` -- each group's rows times that group's expert matrix
  (or its transpose), ``W[n, e]`` for group ``g = n held + e``;
* :func:`wgrad` -- each group's ``A_g^T B_g``, the experts' weight
  gradients.

The number of live rows ``R`` (slots routed to a held expert) is known
only on the device.  A :class:`Plan`'s buffers are sized for the most a
step can route here (every slot of every token, S = N B T k rows), and
every kernel reads the group offsets from device memory and leaves the
rows past ``R`` alone, so a step reads nothing back to the host.  Rows
past ``R`` of an output are left as they were (garbage from
``torch.empty``); every consumer reads only live rows.

What bounds them on the H100: the products are float32 outside the
tensor cores (TF32 stays off, as in the rest of the port), 67 TFLOP/s,
at ~192 rows a group; the permutes move R rows of D floats each way,
3.35 TB/s.  The products, M1 and M2, are hand-written CUDA
(``csrc/moe_gemm.cu``, whose note gives their design), built and bound
with the QInf kernels (:func:`repro_torch.kernels.quantize.build`,
``csrc/binding.cpp``): M1 walks a tile table computed on the device from
the offsets, sized for the worst case, and a tile past the live ones
returns at once.  The permutes, M3 and M4, are Triton kernels, one
program a (row tile, column tile).

Each wrapper dispatches on its first operand's device: a CUDA tensor
launches the kernel (counted in :data:`LAUNCHES`; Triton is imported and
the CUDA sources built inside the launcher, never when this module is
imported), a CPU tensor runs the plain twin, which reads the offsets on
the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

F32 = torch.float32

LAUNCHES: Dict[str, int] = {"moe_gather": 0, "moe_combine": 0,
                            "moe_rows_mm": 0, "moe_wgrad": 0}
#: M1's rows a tile (``csrc/moe_gemm.cu``'s kRowsBM; the launcher
#: refuses a table made for another)
ROWS_MM_ROWS = 64
GATHER_TILE = (16, 512)
COMBINE_TILE = (16, 512)


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


@dataclasses.dataclass
class Plan:
    """The routed slots of one MoE layer's call, sorted by (node, held
    expert): ``order`` (S,) the slot (t k + j) of each sorted row,
    ``tok`` (S,) its token, ``pos`` (M, k) the sorted row of each slot
    (-1 where its expert is not held), ``offsets`` (G + 1,) the first row
    of each group and, last, the live rows R; ``held`` experts a node,
    G = N held groups."""
    order: torch.Tensor
    tok: torch.Tensor
    pos: torch.Tensor
    offsets: torch.Tensor
    held: int
    groups: int
    tiles: dict = dataclasses.field(default_factory=dict)

    @property
    def rows(self) -> int:
        """S: the rows every buffer holds."""
        return self.order.shape[0]

    def counts(self) -> torch.Tensor:
        """(G,) live rows of each group, on the device."""
        return self.offsets[1:] - self.offsets[:-1]

    def tile_table(self, bm: int):
        """(group, first row) of each ``bm``-row tile of every group, on
        the device; ``G`` past the live tiles.  Sized S / bm + G, the most
        tiles any routing gives."""
        if bm not in self.tiles:
            G, dev = self.groups, self.offsets.device
            n = self.rows // bm + G
            count = self.counts()
            per = (count + bm - 1) // bm
            end = per.cumsum(0)
            t = torch.arange(n, device=dev, dtype=end.dtype)
            grp = torch.searchsorted(end, t, right=True)
            live = grp < G
            g = grp.clamp(max=G - 1)
            row0 = self.offsets[g] + (t - (end[g] - per[g])) * bm
            self.tiles[bm] = (grp.to(torch.int32).contiguous(),
                              torch.where(live, row0, 0).to(torch.int32)
                              .contiguous())
        return self.tiles[bm]

    def offsets32(self) -> torch.Tensor:
        if "offsets32" not in self.tiles:
            self.tiles["offsets32"] = self.offsets.to(torch.int32)
        return self.tiles["offsets32"]


def plan(idx: torch.Tensor, first: int, held: int) -> Plan:
    """The :class:`Plan` of routed experts ``idx`` (N, B, T, k) for the
    experts [first, first + held), all on the device."""
    N, k = idx.shape[0], idx.shape[-1]
    dev = idx.device
    rel = idx - first
    mine = (rel >= 0) & (rel < held)
    G = N * held
    node = torch.arange(N, device=dev).view(N, 1, 1, 1)
    key = torch.where(mine, node * held + rel, G).reshape(-1)
    S = key.shape[0]
    skey, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(skey, torch.arange(G + 1, device=dev,
                                                    dtype=skey.dtype))
    pos = torch.empty(S, dtype=torch.int64, device=dev).scatter_(
        0, order, torch.arange(S, device=dev))
    pos = torch.where(mine.reshape(-1), pos, -1).view(S // k, k)
    return Plan(order, order // k, pos, offsets, held, G)


def _weight(w: torch.Tensor, g: int, held: int, transpose: bool):
    m = w[g // held, g % held]
    return m.t() if transpose else m


# -------------------------------------------------------------- plain twins

def _live(p: Plan):
    return p.offsets.tolist()


def gather_plain(src: torch.Tensor, idx: torch.Tensor, p: Plan,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = torch.zeros((p.rows, src.shape[-1]), dtype=src.dtype,
                      device=src.device) if out is None else out
    R = _live(p)[-1]
    out[:R] = src.index_select(0, idx[:R])
    return out


def combine_plain(rows: torch.Tensor, pos: torch.Tensor,
                  w: Optional[torch.Tensor]) -> torch.Tensor:
    M, k = pos.shape
    out = torch.zeros((M, rows.shape[-1]), dtype=rows.dtype,
                      device=rows.device)
    for j in range(k):
        p = pos[:, j]
        ok = p >= 0
        x = rows.index_select(0, p.clamp(min=0))
        if w is not None:
            x = x * w[:, j, None]
        out = out + torch.where(ok[:, None], x, 0.0)
    return out


def rows_mm_plain(a: torch.Tensor, w: torch.Tensor, p: Plan,
                  transpose: bool = False,
                  out: Optional[torch.Tensor] = None,
                  accumulate: bool = False) -> torch.Tensor:
    n_out = w.shape[-2] if transpose else w.shape[-1]
    if out is None:
        out = torch.zeros((p.rows, n_out), dtype=F32, device=a.device)
    off = _live(p)
    for g in range(p.groups):
        o0, o1 = off[g], off[g + 1]
        if o1 > o0:
            y = a[o0:o1] @ _weight(w, g, p.held, transpose)
            out[o0:o1] = out[o0:o1] + y if accumulate else y
    return out


def wgrad_plain(a: torch.Tensor, b: torch.Tensor, p: Plan) -> torch.Tensor:
    N = p.groups // p.held
    out = torch.zeros((N, p.held, a.shape[-1], b.shape[-1]), dtype=F32,
                      device=a.device)
    off = _live(p)
    for g in range(p.groups):
        o0, o1 = off[g], off[g + 1]
        if o1 > o0:
            out[g // p.held, g % p.held] = a[o0:o1].t() @ b[o0:o1]
    return out


# ----------------------------------------------------------------- kernels

_KERNELS: dict = {}


def _kernels():
    """The Triton kernels (M3, M4), built at first use."""
    if _KERNELS:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def moe_gather_kernel(src, idx, dst, offsets, G, D, s_src, s_dst,
                          BR: tl.constexpr, BD: tl.constexpr):
        r = tl.program_id(0) * BR + tl.arange(0, BR)
        d = tl.program_id(1) * BD + tl.arange(0, BD)
        live = r < tl.load(offsets + G)
        t = tl.load(idx + r, mask=live, other=0).to(tl.int64)
        m = live[:, None] & (d < D)[None, :]
        x = tl.load(src + t[:, None] * s_src + d[None, :], mask=m)
        tl.store(dst + r.to(tl.int64)[:, None] * s_dst + d[None, :], x,
                 mask=m)

    @triton.jit
    def moe_combine_kernel(rows, pos, w, out, M, D, s_rows, s_out,
                           K: tl.constexpr, WEIGHTED: tl.constexpr,
                           BT: tl.constexpr, BD: tl.constexpr):
        t = tl.program_id(0) * BT + tl.arange(0, BT)
        d = tl.program_id(1) * BD + tl.arange(0, BD)
        tm, dm = t < M, d < D
        acc = tl.zeros((BT, BD), dtype=tl.float32)
        for j in tl.static_range(K):
            p = tl.load(pos + t * K + j, mask=tm, other=-1)
            ok = tm & (p >= 0)
            x = tl.load(rows + p.to(tl.int64)[:, None] * s_rows + d[None, :],
                        mask=ok[:, None] & dm[None, :], other=0.0)
            if WEIGHTED:
                x = x * tl.load(w + t * K + j, mask=tm, other=0.0)[:, None]
            acc += x
        tl.store(out + t.to(tl.int64)[:, None] * s_out + d[None, :], acc,
                 mask=tm[:, None] & dm[None, :])

    _KERNELS.update(triton=triton, gather=moe_gather_kernel,
                    combine=moe_combine_kernel)
    return _KERNELS


def _rows(t: torch.Tensor, name: str) -> None:
    if t.dtype != F32 or t.dim() != 2 or t.stride(-1) != 1:
        raise ValueError(f"{name}: an f32 (rows, width) operand with unit "
                         f"last stride, got {t.dtype} {tuple(t.shape)} "
                         f"strides {t.stride()}")


def gather(src: torch.Tensor, idx: torch.Tensor, p: Plan,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, D): row r of the live rows is ``src[idx[r]]``."""
    if not src.is_cuda:
        return gather_plain(src, idx, p, out)
    _rows(src, "gather")
    D = src.shape[-1]
    out = torch.empty((p.rows, D), dtype=src.dtype, device=src.device) \
        if out is None else out
    k = _kernels()
    br, bd = GATHER_TILE
    grid = (k["triton"].cdiv(p.rows, br), k["triton"].cdiv(D, bd))
    k["gather"][grid](src, idx, out, p.offsets32(), p.groups, D,
                      src.stride(0), out.stride(0), BR=br, BD=bd)
    LAUNCHES["moe_gather"] += 1
    return out


def combine(rows: torch.Tensor, pos: torch.Tensor,
            w: Optional[torch.Tensor]) -> torch.Tensor:
    """(M, D): token t's sum over its held slots j of ``w[t, j]
    rows[pos[t, j]]`` (``w`` None: unweighted)."""
    if not rows.is_cuda:
        return combine_plain(rows, pos, w)
    _rows(rows, "combine")
    M, K = pos.shape
    D = rows.shape[-1]
    out = torch.empty((M, D), dtype=F32, device=rows.device)
    k = _kernels()
    bt, bd = COMBINE_TILE
    grid = (k["triton"].cdiv(M, bt), k["triton"].cdiv(D, bd))
    k["combine"][grid](rows, pos.contiguous(),
                       rows if w is None else w.contiguous(), out, M, D,
                       rows.stride(0), out.stride(0), K=K,
                       WEIGHTED=w is not None, BT=bt, BD=bd)
    LAUNCHES["moe_combine"] += 1
    return out


def rows_mm(a: torch.Tensor, w: torch.Tensor, p: Plan,
            transpose: bool = False, out: Optional[torch.Tensor] = None,
            accumulate: bool = False) -> torch.Tensor:
    """(S, n): each group g's live rows of ``a`` times ``W = w[g //
    held, g % held]`` (``w`` (N, held, K, n)), or times W^T where
    ``transpose``; added to ``out`` where ``accumulate``."""
    if not a.is_cuda:
        return rows_mm_plain(a, w, p, transpose, out, accumulate)
    from repro_torch.kernels import quantize
    group, row0 = p.tile_table(ROWS_MM_ROWS)
    out = quantize.binding().moe_rows_mm(a, w, group, row0, p.offsets32(),
                                         int(transpose), int(accumulate),
                                         ROWS_MM_ROWS, out)
    LAUNCHES["moe_rows_mm"] += 1
    return out


def wgrad(a: torch.Tensor, b: torch.Tensor, p: Plan) -> torch.Tensor:
    """(N, held, m1, m2): group g's live rows, ``a_g^T b_g``; zero for a
    group with no rows."""
    if not a.is_cuda:
        return wgrad_plain(a, b, p)
    from repro_torch.kernels import quantize
    out = quantize.binding().moe_wgrad(a, b, p.offsets32(), p.held)
    LAUNCHES["moe_wgrad"] += 1
    return out
