"""What one step does, recorded: its ATen ops and its ``pp`` calls.

Two recorders, shared by :func:`repro_torch.obs.roofline.analyze` and the
contract audit (:mod:`repro_torch.check.contracts`):

* :class:`StepRecorder` -- a ``TorchDispatchMode`` over a step.  It
  records the ops that produce float64, the host reads (:class:`Read`)
  and, when asked, the bytes every op reads and writes.  A host read is
  one of:

  - ``scalar``    -- ``aten._local_scalar_dense`` (``.item()``,
    ``float(t)``, ``bool(t)``): the host waits for the value;
  - ``shape``     -- an op whose output shape depends on the data
    (``nonzero``, ``masked_select``, ``unique``, a boolean index, ...):
    on the card it copies a count back before it can allocate;
  - ``upload``    -- host data lifted into a tensor (``torch.tensor``,
    ``torch.as_tensor``, ``torch.from_numpy`` of host values): where the
    step runs on the card, a blocking host-to-device copy follows unless
    the tensor stays on the CPU, and the CPU, which has no copy to make,
    sees the same lift;
  - ``transfer``  -- a copy between the CPU and a device.

  Each read names the innermost frame of ``repro_torch`` that made it.
* :class:`RecordingPP` -- a ``pp(x, pairs)`` seam that records each call's
  dtype and the bytes one node sends (a row of the node-stacked ``x``)
  before handing the call on; :func:`recording_pp` puts one in a
  trainer's seam for a block.  Over a process mesh it records the bytes
  the rank sends to other ranks.
* :class:`RecordingAllReduce` -- the trainer's metric ``all_reduce``
  seam, recording each call's dtype and bytes; :func:`recording_all_reduce`.
* :class:`RecordingTP` -- the ``recorder`` of a tensor-parallel seam
  (``repro_torch.models.tp``): each collective its operators make,
  forward and backward, as ``(kind, dtype, bytes one rank-row hands
  it)``, kind ``all-reduce`` (a sum), ``all-reduce-max`` or
  ``all-gather``; :func:`recording_tp`.
* :class:`LiveBytes` -- a ``TorchDispatchMode`` that follows every storage
  an op makes (a weakref finalizer on its ``untyped_storage()``) from its
  first output to its death, beside the arguments' storages: the peak
  live bytes of a block, and the argument, output and alias bytes (an
  output storage that is an argument's: what an in-place update hands
  back).  On ``meta`` tensors it predicts a step's memory without
  allocating it (``repro_torch.launch.dryrun``).

Kernels B1-B4 run through the binding, not through ATen: a recorder sees
only the ``aten::empty`` of each output the binding allocates (on
``meta``, the wrapper's dry route allocates the same), never the
kernel's own traffic.
"""
from __future__ import annotations

import contextlib
import pathlib
import traceback
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_PKG = pathlib.Path(__file__).resolve().parent.parent     # src/repro_torch
_SELF = pathlib.Path(__file__).resolve()

#: ops whose output shape depends on the values of their input
DATA_DEPENDENT = frozenset({
    "aten::nonzero", "aten::masked_select", "aten::unique_dim",
    "aten::_unique", "aten::_unique2", "aten::unique_consecutive",
    "aten::bincount", "aten::histc", "aten::argwhere", "aten::nonzero_numpy",
})
_INDEXING = frozenset({"aten::index", "aten::index_put", "aten::index_put_",
                       "aten::_index_put_impl_"})
_COPIES = frozenset({"aten::_to_copy", "aten::copy_"})


class Read(NamedTuple):
    """One host read: its kind (see the module docstring), the op, and
    where in ``repro_torch`` it was made (``path:line function``)."""
    kind: str
    op: str
    where: str


def caller(frames=None) -> str:
    """``path:line function`` of the innermost ``repro_torch`` frame of
    ``frames`` (default: the stack) outside this module (path relative to
    the package), or ``"?"``."""
    for fr in reversed(frames or traceback.extract_stack()):
        p = pathlib.Path(fr.filename).resolve()
        if p == _SELF or _PKG not in p.parents:
            continue
        return f"{p.relative_to(_PKG).as_posix()}:{fr.lineno} {fr.name}"
    return "?"


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _bool_index(args) -> bool:
    return any(t.dtype == torch.bool for a in args[1:2]
               for t in _tensors(a))


class StepRecorder(TorchDispatchMode):
    """Records the f64 ops, host reads and (``count_bytes``) op bytes of
    the ATen calls made inside it (see the module docstring)."""

    def __init__(self, *, count_bytes: bool = False) -> None:
        super().__init__()
        self.count_bytes = count_bytes
        self.f64: List[str] = []       # ops with a float64 output
        self.reads: List[Read] = []
        self.bytes = 0                 # operand + output bytes, views free

    def _read(self, kind: str, name: str) -> None:
        self.reads.append(Read(kind, name, caller()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        outs = list(_tensors(out))
        if any(t.dtype == torch.float64 for t in outs):
            self.f64.append(str(func))
        if name == "aten::_local_scalar_dense":
            self._read("scalar", str(func))
        elif name in DATA_DEPENDENT or (
                name == "aten::repeat_interleave"
                and func._overloadname == "Tensor"
                and kwargs.get("output_size") is None):
            self._read("shape", str(func))
        elif name in _INDEXING and _bool_index(args):
            self._read("shape", str(func))
        elif name == "aten::lift_fresh":
            self._read("upload", str(func))
        elif name in _COPIES:
            src = [t.device.type for t in _tensors(args[:2])]
            if any(t.device.type != s for t in outs for s in src):
                self._read("transfer", str(func))
        if self.count_bytes and not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors((args, kwargs)))
            self.bytes += sum(t.numel() * t.element_size() for t in outs)
        return out


class LiveBytes(TorchDispatchMode):
    """Live storage bytes over the block it is entered for (see the module
    docstring).  ``arguments``: the tensors handed to the block (a tree of
    lists, tuples and dicts), whose storages are live from the start.
    After the block: :attr:`peak`, :attr:`argument_bytes`, and
    :meth:`outputs` of what the block returned."""

    def __init__(self, arguments=()) -> None:
        super().__init__()
        self._live: Dict[int, int] = {}      # id(storage) -> bytes
        self._args: Dict[int, weakref.ref] = {}
        self.live = 0
        for t in _tensors(arguments):
            st = t.untyped_storage()
            if self._follow(st):
                self._args[id(st)] = weakref.ref(st)
        self.argument_bytes = self.live
        self.peak = self.live

    def _follow(self, st) -> bool:
        """Start following storage ``st``; False if it is followed."""
        key = id(st)
        if key in self._live:
            return False
        self._live[key] = st.nbytes()
        self.live += self._live[key]
        weakref.finalize(st, self._died, key)
        return True

    def _died(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self._follow(t.untyped_storage())
        self.peak = max(self.peak, self.live)
        return out

    def outputs(self, result) -> Dict[str, int]:
        """``output_bytes`` (the distinct storages of ``result``'s
        tensors) and ``alias_bytes`` (those of them that are argument
        storages)."""
        seen, out, alias = set(), 0, 0
        for t in _tensors(result):
            st = t.untyped_storage()
            if id(st) in seen:
                continue
            seen.add(id(st))
            out += st.nbytes()
            ref = self._args.get(id(st))
            if ref is not None and ref() is st:
                alias += st.nbytes()
        return {"output_bytes": out, "alias_bytes": alias}


class RecordingPP:
    """A ``pp(x, pairs)`` seam that records ``(dtype, bytes one node
    sends)`` for each call in ``calls`` and hands the call on to ``inner``
    (default: :func:`repro_torch.optim.wire.stacked_pp`).  With a
    ``process_mesh`` (:class:`repro_torch.launch.mesh.ProcessMesh`) the
    bytes are those the rank sends to other ranks: a row for each pair
    from one of its nodes to a node it does not hold."""

    def __init__(self, inner: Optional[Callable] = None,
                 process_mesh=None) -> None:
        self.inner = inner
        self.process_mesh = process_mesh
        self.calls: List[Tuple[torch.dtype, int]] = []

    def __call__(self, x: torch.Tensor, pairs) -> torch.Tensor:
        if self.inner is None:
            from repro_torch.optim.wire import stacked_pp
            self.inner = stacked_pp
        row = x.numel() // x.shape[0] if x.dim() else x.numel()
        rows, pm = 1, self.process_mesh
        if pm is not None:
            rows = sum(pm.lo <= s < pm.hi and not pm.lo <= d < pm.hi
                       for s, d in pairs)
        self.calls.append((x.dtype, rows * row * x.element_size()))
        return self.inner(x, pairs)


class RecordingAllReduce:
    """An ``all_reduce(t, group)`` seam (the trainer's metric all-reduce)
    that records ``(dtype, bytes)`` of each call in ``calls`` and hands it
    on to ``inner`` (None: nothing more; a dry run's sums stay its
    rank's)."""

    def __init__(self, inner: Optional[Callable] = None) -> None:
        self.inner = inner
        self.calls: List[Tuple[torch.dtype, int]] = []

    def __call__(self, t: torch.Tensor, group) -> None:
        self.calls.append((t.dtype, t.numel() * t.element_size()))
        if self.inner is not None:
            self.inner(t, group)


class RecordingTP:
    """A tensor-parallel seam's ``recorder`` (``repro_torch.models.tp``):
    each collective in ``calls`` as ``(kind, dtype, bytes)``, where the
    bytes are one rank-row's operand (a row of the rank-row-stacked
    tensor: what a rank holding one node's model shard hands the
    collective)."""

    def __init__(self) -> None:
        self.calls: List[Tuple[str, torch.dtype, int]] = []

    def __call__(self, kind: str, t: torch.Tensor) -> None:
        row = t.numel() // t.shape[0] if t.dim() else t.numel()
        self.calls.append((kind, t.dtype, row * t.element_size()))

    def bytes_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for kind, _, b in self.calls:
            out[kind] = out.get(kind, 0.0) + b
        return out


def warm_trainer(runner, state=None, data=None, draws=None):
    """The first of two steps of a :class:`repro_torch.api.TrainerRunner`
    from ``state`` (default: a fresh one; consumed) over ``data`` (default:
    the spec's stream) with ``draws`` (default: a generator seeded
    ``spec.seed``): it builds the caches and lazy index tensors a step
    keeps.  -> (the state after it, the second step's batch, draws): the
    second step is the one to record."""
    from repro_torch.core.draws import GeneratorDraws
    if state is None:
        state = runner.init_state()
    if data is None:
        data = runner.default_data()
    if draws is None:
        draws = GeneratorDraws(runner.spec.seed if runner.spec else 0,
                               runner.device)
    t0 = int(state.step)
    state, _ = runner.step(state, data.batch_at(t0), draws)
    return state, data.batch_at(t0 + 1), draws


@contextlib.contextmanager
def recording_pp(trainer):
    """A :class:`RecordingPP` in ``trainer.pp`` for the block, its
    ``calls`` empty on entry: the trainer's own when it already has one
    (``build_trainer_runner(..., pp=RecordingPP())``), else one wrapped
    around its seam and taken out again on exit."""
    if isinstance(trainer.pp, RecordingPP):
        trainer.pp.calls.clear()
        yield trainer.pp
        return
    rec = RecordingPP(trainer.pp)
    trainer.pp = rec
    try:
        yield rec
    finally:
        trainer.pp = rec.inner


@contextlib.contextmanager
def recording_all_reduce(trainer):
    """A :class:`RecordingAllReduce` in ``trainer.all_reduce`` for the
    block, its ``calls`` empty on entry (the trainer's own when it already
    has one, else one wrapped around its seam and taken out on exit)."""
    if isinstance(trainer.all_reduce, RecordingAllReduce):
        trainer.all_reduce.calls.clear()
        yield trainer.all_reduce
        return
    rec = RecordingAllReduce(trainer.all_reduce)
    trainer.all_reduce = rec
    try:
        yield rec
    finally:
        trainer.all_reduce = rec.inner


@contextlib.contextmanager
def recording_tp(seam):
    """A :class:`RecordingTP` in ``seam.recorder`` for the block, the
    seam's earlier recorder put back on exit; None when the node runs
    whole (M = 1)."""
    if seam.M == 1:
        yield None
        return
    rec, prev = RecordingTP(), seam.recorder
    seam.recorder = rec
    try:
        yield rec
    finally:
        seam.recorder = prev
