"""The port's contract audit: one recorded step of every golden spec.

The port of ``repro.check.contracts``.  The reference lowers a step to
optimized HLO and reads its contracts off the text; the port runs the
step and records what it did (:mod:`repro_torch.obs.record`):

* ``audit_wire_calls`` -- the gossip wire moves only u8 payloads through
  the ``pp(x, pairs)`` seam: exactly ``2 x hops`` calls a step (one codes
  and one scales buffer a hop, whatever the leaf count), and their bytes a
  node equal ``hops x per_edge_bits / 8`` as integers.  On a (4, 2) mesh
  a node's row carries its M model shards' payloads, M x the reference's
  per-device figure: the audit splits each row into its shards and holds
  them to ``hops x per_edge_bits / 8 / M`` a shard, the reference's
  count.  The reference allows GSPMD resharding copies there as long as
  the u8 payloads dominate their bytes; one process holding a node's
  shards makes no reshard, so the rule holds with zero other bytes, and
  every ``pp`` payload must be u8 at any mesh;
* ``audit_no_f64`` -- no op of a sharded step outputs float64 (the
  trainer is f32 end to end);
* ``audit_no_host_sync`` -- no host read inside a step (a ``.item()``, an
  op whose output shape depends on the data, an upload or a copy between
  the CPU and the card), except those named in :data:`EXPECTED_READS`,
  each with its reason.  On a CUDA device the audited step also runs under
  ``torch.cuda.set_sync_debug_mode("error")``, which catches what no
  dispatch mode sees: blocking host-to-device copies and stream
  synchronisations made below ATen.

A tensor-parallel node (``repro_torch.models.tp``) holds the same
contracts: :func:`audit_tp_spec` audits a sharded spec's (4, 2) variant
with its two model ranks under ``StackedTP(2)`` (its collectives are
sums, maxima and concatenations over the rank-rows: no f64, no host
read), and its ``pp`` seam still moves only u8 buffers, the same bytes a
model shard.

The pure ``audit_*`` functions take recorded facts, so tests can inject
violations.  The drivers run two steps of a spec's runner and record the
second: the first is the warm-up, where caches, lazy index tensors and B1's
per-point level check happen.  ``audit_spec`` dispatches on the engine;
a sharded spec is audited on both its (8, 1) and its (4, 2) realization.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import traceback
import warnings
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.obs.record import (Read, StepRecorder, caller,
                                    recording_pp, warm_trainer)

#: (claim, ok, detail)
GateFinding = Tuple[str, bool, str]


class ExpectedRead(NamedTuple):
    """Host reads a step may make: where (a path under ``repro_torch``
    and a function), their kinds, and why."""
    path: str
    function: str
    kinds: Tuple[str, ...]
    reason: str

    def matches(self, read: Read) -> bool:
        loc, _, fn = read.where.partition(" ")
        return (read.kind in self.kinds and fn == self.function
                and loc.split(":")[0] == self.path)


#: every host read a step may make, each with its reason
EXPECTED_READS: Tuple[ExpectedRead, ...] = (
    ExpectedRead(
        "kernels/quantize.py", "_launch", ("transfer",),
        "B1's per-point level count: the binding copies a stacked grid's "
        "(P,) levels to the host to check them, once per operand version "
        "(the first step; the operand is built once per run)"),
    ExpectedRead(
        "kernels/ref.py", "levels_per_row", ("scalar",),
        "B1's plain version checks the per-point level count on the host "
        "at every call (it runs on the CPU only; on the card the binding "
        "checks once per operand version)"),
    ExpectedRead(
        "kernels/ref.py", "qinf_quantize_blocks_ref", ("upload",),
        "the plain B1 (and B3, which calls it) forms its level count as a "
        "0-d tensor; the plain versions run on the CPU only, where nothing "
        "is uploaded"),
    ExpectedRead(
        "optim/decentralized.py", "_adam_precondition", ("upload", "scalar"),
        "Adam's bias correction forms its two scalars from a CPU tensor "
        "(precondition='adam'); the card never waits for them"),
)


# --- the pure audits ---------------------------------------------------------

def audit_wire_calls(calls: Sequence[Tuple[torch.dtype, int]], *, hops: int,
                     per_edge_bits: int, model_shards: int = 1,
                     name: str = "wire") -> List[GateFinding]:
    """The three gossip-wire contracts against one step's ``pp`` calls,
    each ``(dtype, bytes one model shard sends)``; ``per_edge_bits``
    counts a node's ``model_shards`` shard payloads."""
    u8 = [b for dt, b in calls if dt == torch.uint8]
    other = [(str(dt), b) for dt, b in calls if dt != torch.uint8]
    got = sum(u8)
    predicted = hops * per_edge_bits // 8 // model_shards
    exact = hops * per_edge_bits % (8 * model_shards) == 0
    return [
        (f"{name}: pp call count == 2 x hops", len(u8) == 2 * hops,
         f"{len(u8)} u8 pp calls vs 2 x {hops} hops"),
        (f"{name}: every pp payload is u8", not other,
         f"non-u8: {other[:5]}" if other else ""),
        (f"{name}: pp bytes == bucketed payload accounting",
         exact and got == predicted,
         f"pp {got}B a {'model shard' if model_shards > 1 else 'node'} vs "
         f"plan {hops * per_edge_bits / 8 / model_shards:.0f}B "
         f"(hops={hops}, per_edge={per_edge_bits}b, "
         f"shards={model_shards})"),
    ]


def shard_calls(calls: Sequence[Tuple[torch.dtype, int]], model_shards: int
                ) -> List[Tuple[torch.dtype, int]]:
    """Recorded ``pp`` calls (bytes a node) as the bytes one model shard
    sends: a node's row holds its shards' payloads side by side.  A row
    that does not split evenly keeps its bytes (and fails the count)."""
    return [(dt, b // model_shards if b % model_shards == 0 else b)
            for dt, b in calls]


def audit_no_f64(ops: Sequence[str], *, name: str = "step"
                 ) -> List[GateFinding]:
    """``ops``: the ops of a sharded step that output float64."""
    return [(f"{name}: no f64 in the step", not ops,
             f"{len(ops)} f64 ops, first {list(ops[:3])}" if ops else "")]


def audit_no_host_sync(reads: Iterable[Read], *, name: str = "step",
                       expected: Sequence[ExpectedRead] = EXPECTED_READS
                       ) -> List[GateFinding]:
    """No host read in a step but those ``expected`` names."""
    reads = list(reads)
    named = [r for r in reads if any(e.matches(r) for e in expected)]
    bad = [r for r in reads if r not in named]
    detail = "; ".join(f"{r.kind} {r.op} at {r.where}" for r in bad[:4])
    if not bad and named:
        detail = "expected: " + "; ".join(
            sorted({f"{r.kind} at {r.where}" for r in named}))
    return [(f"{name}: no host sync in the step", not bad, detail)]


# --- recording one step ------------------------------------------------------

@contextlib.contextmanager
def sync_debug(device: torch.device):
    """``torch.cuda.set_sync_debug_mode("error")`` for the block on a CUDA
    device (a no-op elsewhere)."""
    if device.type != "cuda":
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


@dataclasses.dataclass
class StepFacts:
    """What one recorded step did."""
    f64: List[str]
    reads: List[Read]
    calls: List[Tuple[torch.dtype, int]]


def _recorded(step, device: torch.device) -> Tuple[StepFacts, object]:
    """Run ``step()`` under a :class:`StepRecorder` (and the sync debug
    mode on a card); a sync the card refuses becomes a read of kind
    ``sync``.  -> (facts, step's result or None)."""
    rec = StepRecorder()
    out = None
    try:
        with sync_debug(device), rec:
            out = step()
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        rec.reads.append(Read("sync", str(e).splitlines()[0][:120],
                              caller(traceback.extract_tb(e.__traceback__))))
    return StepFacts(rec.f64, rec.reads, []), out


def trainer_step_facts(runner, *, state=None, data=None, draws=None
                       ) -> Tuple[StepFacts, object]:
    """The facts of a trainer's second step (:func:`repro_torch.obs.record.
    warm_trainer` takes the first from ``state``, ``data``, ``draws``);
    the recording seam sees its ``pp`` calls.  -> (facts, the state after
    it, or None if the card refused a sync)."""
    state, batch, draws = warm_trainer(runner, state, data, draws)
    with recording_pp(runner.trainer) as pp:
        facts, out = _recorded(lambda: runner.step(state, batch, draws)[0],
                               runner.device)
        facts.calls = list(pp.calls)
    return facts, out


def runner_step_facts(runner) -> StepFacts:
    """The facts of the second step of a dense, netsim or sweep runner,
    from its init with its default draws."""
    from repro_torch.core.draws import GeneratorDraws
    if hasattr(runner, "point_draws"):               # a SweepRunner
        draws = runner.point_draws()
    else:
        draws = GeneratorDraws(runner.spec.seed if runner.spec else 0,
                               runner.device)
    state = runner.init_state(draws)
    state = runner.step(state, draws)
    facts, _ = _recorded(lambda: runner.step(state, draws), runner.device)
    return facts


def audit_trainer(runner, name: str, facts: StepFacts, leaves
                  ) -> List[GateFinding]:
    """The wire (neighbor backend), f64 and host-sync audits of a
    trainer's recorded step; ``leaves``: its ``plead.X`` leaves (shapes
    suffice)."""
    from repro_torch.netsim import metrics as netsim_metrics
    tr = runner.trainer
    out: List[GateFinding] = []
    if tr.plan is not None:
        per_edge = (netsim_metrics.bucketed_payload_bits(tr, leaves)
                    if tr.tcfg.wire_mode == "bucketed"
                    else netsim_metrics.sharded_payload_bits(tr, leaves))
        M = tr.wire_shards
        out.extend(audit_wire_calls(shard_calls(facts.calls, M),
                                    hops=len(tr.plan.hops),
                                    per_edge_bits=per_edge, model_shards=M,
                                    name=name))
    out.extend(audit_no_f64(facts.f64, name=name))
    out.extend(audit_no_host_sync(facts.reads, name=name))
    return out


# --- specs -------------------------------------------------------------------

def mesh_variants(spec) -> list:
    """The sharded spec on both canonical mesh shapes, as the reference's
    ``_mesh_variants`` realizes them (its own shape kept as it is, a
    meshless spec realized on both).  The (4, 2) variant keeps a node's
    two model shards in one process."""
    variants = []
    for shape in ((8, 1), (4, 2)):
        mesh = spec.execution.mesh
        if mesh is not None and tuple(mesh) == shape \
                and spec.n_nodes == shape[0]:
            variant = spec
        else:
            variant = dataclasses.replace(
                spec, name=f"{spec.name}@{shape[0]}x{shape[1]}",
                n_nodes=shape[0],
                execution=dataclasses.replace(spec.execution, mesh=shape))
        variants.append(variant)
    return variants


def audit_spec(spec, device="cpu") -> List[GateFinding]:
    """Every contract finding of one spec (Experiment or Sweep) on
    ``device``."""
    from repro_torch import api, tree
    from repro_torch.obs.record import RecordingPP
    device = torch.device(device)
    out: List[GateFinding] = []
    if hasattr(spec, "axes"):                          # a SweepSpec
        runner = api.build(spec, device=device)
        out.extend(audit_no_host_sync(runner_step_facts(runner).reads,
                                      name=f"{spec.name}@map"))
        with warnings.catch_warnings():   # vmap in f32: a tolerance note
            warnings.simplefilter("ignore", UserWarning)
            stacked = runner.with_batch("vmap")
        out.extend(audit_no_host_sync(runner_step_facts(stacked).reads,
                                      name=f"{spec.name}@vmap"))
        return out
    if spec.execution.engine != "sharded":
        runner = api.build(spec, device=device)
        out.extend(audit_no_host_sync(runner_step_facts(runner).reads,
                                      name=spec.name))
        return out
    for variant in mesh_variants(spec):
        runner = api.build_trainer_runner(variant, device=device,
                                          pp=RecordingPP())
        state = runner.init_state()
        leaves = [torch.empty(x.shape, dtype=x.dtype, device="meta")
                  for x in tree.leaves(state.plead.X)]
        facts, _ = trainer_step_facts(runner, state=state)
        out.extend(audit_trainer(runner, variant.name, facts, leaves))
    return out


def audit_tp_spec(spec, device="cpu") -> List[GateFinding]:
    """The contract findings of a sharded neighbor spec's (4, 2) variant
    as a tensor-parallel node (``StackedTP(2)``), named ``<variant>/tp``;
    none for a spec that does not run tensor-parallel (another backend,
    wire or compressor)."""
    from repro_torch import api, tree
    from repro_torch.models.tp import StackedTP
    from repro_torch.obs.record import RecordingPP
    if hasattr(spec, "axes"):                          # a SweepSpec
        return []
    ex = spec.execution
    if (ex.engine != "sharded"
            or ex.backend not in ("neighbor", "ring")
            or ex.wire_mode != "bucketed" or spec.compressor.name != "qinf"
            or spec.model is None):
        return []
    variant = mesh_variants(spec)[1]
    variant = dataclasses.replace(variant, name=variant.name + "/tp")
    runner = api.build_trainer_runner(variant, device=torch.device(device),
                                      pp=RecordingPP(), tp=StackedTP(2))
    state = runner.init_state()
    leaves = [torch.empty(x.shape, dtype=x.dtype, device="meta")
              for x in tree.leaves(state.plead.X)]
    facts, _ = trainer_step_facts(runner, state=state)
    return audit_trainer(runner, variant.name, facts, leaves)


def load_spec(path: pathlib.Path):
    from repro_torch import api
    text = pathlib.Path(path).read_text()
    cls = api.SweepSpec if "base" in json.loads(text) else api.ExperimentSpec
    return cls.from_json(text)


def audit_spec_dir(spec_dir, device="cpu",
                   only: Optional[Sequence[str]] = None
                   ) -> List[GateFinding]:
    """Contract-audit every ``*.json`` golden spec under ``spec_dir`` on
    ``device``, each sharded neighbor spec's tensor-parallel (4, 2)
    variant too (:func:`audit_tp_spec`); ``only``: these stems alone."""
    spec_dir = pathlib.Path(spec_dir)
    files = sorted(spec_dir.glob("*.json"))
    if not files:
        return [(f"contracts: no golden specs under {spec_dir}", False, "")]
    out: List[GateFinding] = []
    for f in files:
        if only and f.stem not in only:
            continue
        try:
            spec = load_spec(f)
            out.extend(audit_spec(spec, device))
            out.extend(audit_tp_spec(spec, device))
        except Exception as e:                    # noqa: BLE001
            out.append((f"{f.stem}: contract audit raised", False,
                        f"{type(e).__name__}: {e}"))
    return out
