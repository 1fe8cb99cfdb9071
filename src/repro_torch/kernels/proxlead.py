"""B5 and B6: the neighbor trainer's Prox-LEAD update in two passes a leaf.

``csrc/proxlead_update.cu`` holds the kernels (its note says what bounds
them and how they are built), ``csrc/binding.cpp`` checks and launches
them, and :func:`repro_torch.kernels.quantize.build` compiles them with the
QInf kernels.  :func:`head` (B5) runs lines 6-7 of Algorithm 1 before the
exchange: z = x - eta g - eta d and the diff z - h, written where the
wire takes it.  :func:`tail` (B6) runs lines 7-10 after it: H, the Hw
slots and D updated in place and the prox of the corrected z written over
z, which becomes the new X.

The wrappers dispatch on the device of their first operand, as
:mod:`repro_torch.kernels.quantize`'s do: a CUDA tensor launches the
kernel (counted in ``quantize.LAUNCHES``) and never falls back; a CPU
tensor takes the binding's checks (:func:`_check`) and runs the plain
twin, :func:`head_plain` / :func:`tail_plain` and the prox; a ``meta``
tensor takes the card's route dry: the binding's checks, its one output,
a count in ``quantize.META_CALLS``.  The twins are the eager update
itself: ``optim/decentralized.py::_sharded_update`` runs them, on its
model-shard views, wherever the kernels do not serve.  The kernels
compute that sequence in its order with its roundings, so on the card
they equal the eager ops bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.prox import Elementwise
from repro_torch.kernels import quantize as qk

#: the prox form's flags, shared with csrc/proxlead_update.cu
PROX_FLAGS = {"soft": 1, "nonneg": 2, "div": 4}
HEAD, TAIL = "proxlead_head", "proxlead_tail"
#: per operand, its leading axes: the node, and the slot on B6's hw and w
LEAD = {HEAD: (1,) * 6, TAIL: (1, 1, 1, 2, 1, 2)}


def node_rows(t: torch.Tensor, lead: int = 1):
    """A node-stacked operand (N, [T,] *shape) as the binding reads it
    (``csrc/binding.cpp::node_rows``): ((node, slot, row) strides, rows
    L, last axis D), or None where its last axis is not of unit stride or
    its leaf's leading axes do not collapse to one row stride."""
    d = t.dim()
    if d < lead:
        return None
    D = t.shape[-1] if d > lead else 1
    s = [t.stride(0), t.stride(1) if lead == 2 else 0, D]
    L = 1
    if d == lead:
        return s, L, D
    if D > 1 and t.stride(-1) != 1:
        return None
    span = None                     # elements spanned by the axes below
    for i in reversed(range(lead, d - 1)):
        L *= t.shape[i]
        if t.shape[i] == 1:
            continue
        if span is None:
            s[2] = t.stride(i)
        elif t.stride(i) != span:
            return None
        span = t.stride(i) * t.shape[i]
    return s, L, D


def _check(name: str, ops: Sequence[torch.Tensor], lead: Sequence[int]):
    """The binding's checks of the six operands (``update_operands``):
    f32 (TypeError), the leaf's shape, one slot count, then one device
    and node rows (ValueError).  -> the slot count."""
    for k, t in enumerate(ops):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes f32 leaves, got {t.dtype} for "
                            f"operand {k}")
    like, T = ops[0], None
    for k, (t, ld) in enumerate(zip(ops, lead)):
        got = tuple(t.shape[:1]) + tuple(t.shape[ld:])
        ok = like.dim() >= 1 and t.dim() == like.dim() + ld - 1 and \
            got == tuple(like.shape)
        if ok and ld == 2:
            T = t.shape[1] if T is None else T
            ok = t.shape[1] == T and T >= 1
        if not ok:
            raise ValueError(f"{name}: operand {k} {list(t.shape)} does not "
                             f"match the leaf {list(like.shape)}")
    for k, (t, ld) in enumerate(zip(ops, lead)):
        if t.device != like.device or node_rows(t, ld) is None:
            raise ValueError(f"{name}: the operands must lie on one device, "
                             f"each with rows of unit stride (operand {k})")
    if like.shape[0] > 65535:
        raise ValueError(f"{name}: {like.shape[0]} nodes, at most 65535")
    return T or 1


def _vector_args(ops: Sequence[torch.Tensor], lead: Sequence[int]):
    """(pointers, strides, cols) of a call as the launchers' variant
    queries take them (ctypes arrays)."""
    import ctypes
    geo = [node_rows(t, ld) for t, ld in zip(ops, lead)]
    ptrs = (ctypes.c_void_p * 6)(*[t.data_ptr() for t in ops])
    strides = (ctypes.c_longlong * 18)(*[v for s, _, _ in geo for v in s])
    return ptrs, strides, geo[0][2]


def uses_vector_variant(kernel: str, *ops: torch.Tensor) -> bool:
    """Whether the launcher of B5 (``ops``: x, g, d, h, z, diff) or B6
    (z, d, h, hw, q, w, the slot axis on hw and w) takes its vector
    variant (``proxlead_vector``, the query both launchers ask): every
    operand 16-byte aligned, the last axis and every stride whole 16-byte
    units."""
    lib = qk._libs()["proxlead_update"]
    return bool(lib.proxlead_vector(*_vector_args(ops, LEAD[kernel])))


# ---------------------------------------------------------------------------
# B5
# ---------------------------------------------------------------------------

def head_plain(x, g, d, h, eta: float):
    """The eager lines 6-7 -> (z, z - h), z = x - eta g - eta d."""
    z = x - eta * g - eta * d
    return z, z - h


def head(x: torch.Tensor, g: torch.Tensor, d: torch.Tensor, h: torch.Tensor,
         eta: float, out: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B5 on node-stacked f32 leaves (N, *shape) -> (z, diff): z = x -
    eta g - eta d, a fresh leaf, and diff = z - h written into ``out`` (a
    view of the leaf's shape: the bucketed wire's rows) or a fresh leaf."""
    if x.is_cuda:
        diff = torch.empty_like(x) if out is None else out
        return qk._launch(HEAD, x, g, d, h, diff, eta), diff
    if not x.is_meta:
        qk._plain_device(x)
    # z and a fresh diff are laid out as x
    _check(HEAD, (x, g, d, h, x, x if out is None else out), LEAD[HEAD])
    if x.is_meta:
        qk.META_CALLS[HEAD] += 1
        return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
                torch.empty_like(x) if out is None else out)
    z, diff = head_plain(x, g, d, h, eta)
    return z, diff if out is None else out.copy_(diff)


# ---------------------------------------------------------------------------
# B6
# ---------------------------------------------------------------------------

def tail_plain(z, d, h, hw, q, w, t: int, *, eta: float, alpha: float,
               gamma: float, slot: int = 1) -> torch.Tensor:
    """The eager lines 7-10 on node-stacked leaves, or on their model-shard
    views: z, d, h and the self payload q; the Hw slots ``hw`` and the
    mixed payloads ``w``, their slot axis at ``slot``; round ``t``'s slot
    read.  Updates d, h, hw in place and corrects z in place, which it
    returns for the prox (q and w are the wire's buffers and are used
    up)."""
    zhat = q.add_(h)                              # h + Q_self
    if w.shape[slot] == 1:
        hw0 = hw.select(slot, 0)
        zhat_w = w.select(slot, 0).add_(hw0)      # Hw + (W Q)
        hw0.mul_(1 - alpha).add_(alpha * zhat_w)
    else:
        zhat_w = hw.select(slot, t) + w.select(slot, t)   # slot k % T
        # Hw[t'] tracks W_t' H: H += alpha Q => += alpha W_t' Q
        hw.add_(w, alpha=alpha)
    h.mul_(1 - alpha).add_(alpha * zhat)
    e = zhat.sub_(zhat_w)                         # zhat - zhat_w
    d.add_(gamma / (2 * eta) * e)
    return z.sub_(gamma / 2.0 * e)


def prox_args(prox: Elementwise) -> Tuple[int, float, float]:
    """(flags, threshold, divisor) of a prox form as B6 takes them."""
    flags = ((PROX_FLAGS["soft"] if prox.thresh is not None else 0)
             | (PROX_FLAGS["nonneg"] if prox.nonneg else 0)
             | (PROX_FLAGS["div"] if prox.div is not None else 0))
    return (flags, 0.0 if prox.thresh is None else float(prox.thresh),
            1.0 if prox.div is None else float(prox.div))


def tail(z: torch.Tensor, d: torch.Tensor, h: torch.Tensor, hw: torch.Tensor,
         q: torch.Tensor, w: torch.Tensor, t: int, *, eta: float,
         alpha: float, gamma: float, prox: Elementwise) -> torch.Tensor:
    """B6 on node-stacked f32 leaves: z, d, h and the self payload q (N,
    *shape), the Hw slots ``hw`` and the mixed payloads ``w`` (N, T,
    *shape) -> the new X, written over z.  d, h and hw are updated in
    place; ``prox`` is the prox's :class:`Elementwise` form at ``eta``."""
    if z.is_cuda:
        qk._launch(TAIL, z, d, h, hw, q, w, t, 1 - alpha, alpha,
                   gamma / (2 * eta), gamma / 2.0, *prox_args(prox))
        return z
    if not z.is_meta:
        qk._plain_device(z)
    T = _check(TAIL, (z, d, h, hw, q, w), LEAD[TAIL])
    if not 0 <= t < T:
        raise ValueError(f"{TAIL}: slot {t} of {T}")
    if z.is_meta:
        qk.META_CALLS[TAIL] += 1
        return z
    tail_plain(z, d, h, hw, q, w, t, eta=eta, alpha=alpha, gamma=gamma)
    return z.copy_(prox(z))


def tail_bytes(z: torch.Tensor, slots: int) -> int:
    """Bytes B6 reads and writes on a leaf like ``z`` at ``slots`` Hw
    slots: z, d, h, q and the slots of Hw and W Q read, d, h, the Hw
    slots and x written -- (7 + 3 T) whole leaves."""
    return (7 + 3 * slots) * z.numel() * z.element_size()


def head_bytes(x: torch.Tensor) -> int:
    """Bytes B5 reads and writes: x, g, d, h read, z and the diff
    written."""
    return 6 * x.numel() * x.element_size()

