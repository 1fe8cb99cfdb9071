"""One run of one cell: set-up, the measured (or traced) window, the
reference's check, and the result line.

Set-up builds the trainer through ``repro_torch.api.build(spec)``, makes
the weights, a bank of batches and the uniforms from the seed on the
device, and drives the one state through the cell's first
``checked_steps`` with ``TrainerRunner.step``, the window's own call on
the window's own feed, reading what the check needs as it goes.  The
window then drives the same state and runner:

* ``--trace 0``: steps back to back for ``seconds``, each step's end
  marked by a CUDA event (no host read inside the loop), then one
  ``synchronize``; the end-to-end metrics.
* ``--trace 1``: ``traced_steps`` steps under ``torch.profiler`` behind
  an idle guard, with the ``bench/`` ranges that the cell's per-layer
  metrics ask for put around the program's callables; the per-layer
  metrics, each from its reader in ``perfbench/metrics/<name>.py``.

Once the window has closed and the peak memory has been read, the
program's state is freed and the plain reference follows the checked
steps from the same inputs (``perfbench/check.py`` decides).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import math
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from perfbench import check, tracing, traffic, yardstick
from perfbench.reference import common as RC
from perfbench.reference import proxlead

#: top-level module names the process may not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(RuntimeError):
    """A run that must print no result."""


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict
    cell: dict
    conf: dict
    cfg: dict
    model: object          # the reference family module
    leaves: list           # [(path, spec)] of one replica

    @property
    def paths(self) -> List[str]:
        return [p for p, _ in self.leaves]


def open_cell(name: str, bench: dict) -> Cell:
    """Cell ``name`` of ``bench`` with its files read."""
    entry, cell, conf, cfg = traffic.find_cell(name, bench)
    model = traffic.reference_model(cfg)
    return Cell(name, entry, cell, conf, cfg, model, model.leaves(cfg))


def metric_modules(cell: Cell, bench: dict):
    """{name: reader module} of the per-layer metrics the cell reports."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and cell.name not in m["workloads"]:
            continue
        path = traffic.ROOT / "perfbench" / "metrics" / f"{m['name']}.py"
        if not path.exists():
            raise traffic.UnknownName(f"no reader {path} for per-layer "
                                      f"metric {m['name']!r}")
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{len(out)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[m["name"]] = mod
    return out


def nested(paths: Sequence[str], values) -> dict:
    """Leaves by ``a/b`` path -> the program's nested parameter tree."""
    root: dict = {}
    for path, v in zip(paths, values):
        *head, last = path.split("/")
        d = root
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return root


def _leaf_norms(leaves) -> torch.Tensor:
    """(nodes, leaves) norms of node-stacked leaves."""
    return torch.stack([x.flatten(1).norm(dim=1) for x in leaves], 1)


def _l1_norms(leaves) -> torch.Tensor:
    """(nodes, leaves) l1 norms of node-stacked leaves, summed in
    float64 a node at a time."""
    return torch.stack([torch.stack([x[i].abs().sum(dtype=torch.float64)
                                     for i in range(x.shape[0])])
                        for x in leaves], 1)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The system under test for one cell: the runner ``api.build``
    makes, its state, and what its checked steps gave."""

    def __init__(self, cell: Cell, device, prepare=None) -> None:
        from repro_torch import api, tree
        from repro_torch.models import transformer as TR
        self.tree, self.cell = tree, cell
        spec = traffic.program_spec(api, cell.cell, cell.cfg)
        self.runner = api.build(spec, device=device)
        tr = self.runner.trainer
        got = [(p, tuple(x.shape)) for p, x in
               tree.flatten_with_paths(TR.abstract_params(tr.mcfg))]
        want = [(p, s["shape"]) for p, s in cell.leaves]
        if got != want:
            raise ValueError(f"the program's parameters {got} are not the "
                             f"configuration's {want}")
        if prepare is not None:
            prepare(tr)

    def start(self, X0: List[torch.Tensor]):
        N = self.cell.cell["nodes"]
        X = nested(self.cell.paths,
                   [x[None].repeat((N,) + (1,) * x.dim()) for x in X0])
        return self.runner.trainer.state_from_stacked(X)

    def checked(self, state, bank, draws, X0):
        """The first ``checked_steps`` steps -> (state, readout): the
        losses, the first step's gradient norms as the update gets them,
        ||X - X0||, ||X||_1 and the norms of D, H and each Hw slot after
        the last, the bits a node sent in a step."""
        from repro_torch.obs.meters import Meters, using_meters
        tr, tree = self.runner.trainer, self.tree
        own = "loss_and_grad" in tr.__dict__
        inner = tr.loss_and_grad
        seen: Dict[str, torch.Tensor] = {}

        def first(X, batch):
            ce, G = inner(X, batch)
            seen["grad"] = _leaf_norms(tree.leaves(G))
            if own:
                tr.loss_and_grad = inner
            else:
                del tr.loss_and_grad
            return ce, G

        tr.loss_and_grad = first
        meters, losses = Meters(), []
        K = len(bank)
        with using_meters(meters):
            for s in range(self.cell.cell["checked_steps"]):
                state, m = self.runner.step(state, bank[s % K], draws)
                losses.append(m["loss"])
        X = tree.leaves(state.plead.X)
        change = torch.stack([(x - x0[None]).flatten(1).norm(dim=1)
                              for x, x0 in zip(X, X0)], 1)
        st = tr.join_state(state)
        hw = tree.leaves(st["Hw"])
        slots = [hw] if tr.hw_slots is None else \
            [[x[:, t] for x in hw] for t in range(tr.hw_slots)]
        parts = [tree.leaves(st["D"]), tree.leaves(st["H"])] + slots
        bits = 8 * meters.get("wire/bytes_per_hop") * meters.get("wire/hops")
        return state, {"losses": [float(x) for x in losses],
                       "grad_norms": seen["grad"].cpu(),
                       "change_norms": change.cpu(),
                       "l1_norms": _l1_norms(X).cpu(),
                       "state_norms": [_leaf_norms(p).cpu() for p in parts],
                       "bits": int(bits)}


def reference_readout(cell: Cell, seed: int, X0, bank, device,
                      precision: str = "f32") -> dict:
    """The plain reference's readout of the checked steps from the same
    weights, batches and uniforms."""
    c = cell.cell
    ref = proxlead.Trainer(
        cell.model, cell.cfg, X0, n_nodes=c["nodes"],
        eta=c["algorithm"]["eta"], alpha=c["algorithm"]["alpha"],
        gamma=c["algorithm"]["gamma"], lam=c["prox"]["lam"],
        bits=c["compressor"]["bits"], block=c["compressor"]["block"],
        graphs=c["mixing_cycle"], precision=RC.Precision(precision))
    L, K = len(cell.leaves), len(bank)
    losses, first = [], None
    for s in range(c["checked_steps"]):
        loss, gn = ref.step(bank[s % K], lambda j, shape, s=s: traffic.noise(
            seed, s * L + j, shape, device))
        losses.append(float(loss))
        first = gn if first is None else first
    bits = proxlead.payload_bits([s["shape"] for _, s in cell.leaves],
                                 c["compressor"]["bits"],
                                 c["compressor"]["block"])
    return {"losses": losses, "grad_norms": first.cpu(),
            "change_norms": ref.change_norms(X0).cpu(),
            "l1_norms": ref.l1_norms().cpu(),
            "state_norms": [n.cpu() for n in ref.state_norms()],
            "bits": _union_hops(c) * bits}


def _union_hops(c: dict) -> int:
    """Neighbours a node sends to in every round: the union of the
    cycle's graphs (each link a hop)."""
    W = proxlead.mixing_cycle(c["mixing_cycle"], c["nodes"])
    links = (abs(W) > 1e-12).any(0)
    return int(links[0].sum()) - 1


def yard(cell: Cell) -> Dict[str, float]:
    """The frozen arithmetic of this cell, a step: B4 takes every node's
    own payload and one a hop, and mixes one round a graph of the
    cycle."""
    c = cell.cell
    groups = yardstick.wire_groups([s["shape"] for _, s in cell.leaves],
                                   c["compressor"]["bits"],
                                   c["compressor"]["block"])
    return {"b3_bytes": yardstick.b3_bytes(groups, c["nodes"]),
            "b4_bytes": yardstick.b4_bytes(groups, c["nodes"],
                                           1 + _union_hops(c),
                                           len(c["mixing_cycle"])),
            "flops": yardstick.model_flops(cell.leaves,
                                           cell.model.TOKEN_STREAMS,
                                           traffic.stream_tokens(c))}


class Clock:
    """Each step's end on the device's clock (CUDA events, no host read)
    or, on the CPU, the host's."""

    def __init__(self, device) -> None:
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def steps_ms(self) -> List[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [1e3 * (b - a) for a, b in zip(m, m[1:])]


def p90(values: List[float]) -> float:
    """The nearest-rank 90th percentile."""
    v = sorted(values)
    return v[max(0, math.ceil(0.9 * len(v)) - 1)]


@dataclasses.dataclass
class ReadContext:
    """What a per-layer metric's reader is handed: the trace, the
    kernels' launch counts over the traced steps, this cell's
    :func:`yard`, and where to print a diagnostic line."""
    trace: tracing.Trace
    launches: Dict[str, int]
    yard: Dict[str, float]
    note: Callable[[str], None]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device, peak: Optional[int]) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": peak}


@dataclasses.dataclass
class SetUp:
    """A cell's program after its checked steps, and its inputs."""
    prog: Program
    X0: List[torch.Tensor]
    bank: List[dict]
    draws: object
    state: object
    readout: dict


def set_up(cell: Cell, seed: int, device, prepare=None) -> SetUp:
    """Build the program, make the inputs from ``seed`` and drive the one
    state through the checked steps (``prepare(trainer)``, where given,
    runs once the trainer is built)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prog = Program(cell, device, prepare)
    X0 = traffic.make_weights(cell.leaves, seed, device)
    bank = traffic.make_bank(cell.cell, cell.cfg, seed, device)
    draws = traffic.draws(seed, device)
    state, readout = prog.checked(prog.start(X0), bank, draws, X0)
    return SetUp(prog, X0, bank, draws, state, readout)


def measure(su: SetUp, cell: Cell, seconds: float, device, err):
    """Steps back to back for ``seconds`` -> (end-to-end metrics, the
    steps' losses)."""
    c, K = cell.cell, len(su.bank)
    clock, losses = Clock(device), []
    clock.mark()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        su.state, m = su.prog.runner.step(
            su.state, su.bank[(c["checked_steps"] + i) % K], su.draws)
        losses.append(m["loss"])
        clock.mark()
        i += 1
    _sync(device)
    window_s = time.perf_counter() - t0
    step_ms = clock.steps_ms()
    err(f"window: {i} steps in {window_s} s; step ms median "
        f"{sorted(step_ms)[len(step_ms) // 2]}, min {min(step_ms)}, max "
        f"{max(step_ms)}")
    return {"tokens_per_s": {"value": i * traffic.label_tokens(c) / window_s,
                             "unit": "tokens/s"},
            "step_ms_p90": {"value": p90(step_ms), "unit": "ms"}}, losses


def traced(su: SetUp, cell: Cell, readers: dict, units: dict, device, err):
    """``traced_steps`` steps under the profiler -> (per-layer metrics,
    the device's busy and window seconds, the breakdown, the losses)."""
    from repro_torch.kernels import quantize
    c, K = cell.cell, len(su.bank)
    steps, losses = c["traced_steps"], []
    wraps = {t: n for mod in readers.values() for t, n in mod.WRAPS}
    quantize.reset_launch_counts()
    with tracing.ranges(torch, list(wraps.items())), \
            tracing.guarded_profile(torch, device) as prof:
        with torch.profiler.record_function(tracing.PREFIX + "window"):
            for i in range(steps):
                with torch.profiler.record_function(tracing.PREFIX + "step"):
                    su.state, m = su.prog.runner.step(
                        su.state, su.bank[(c["checked_steps"] + i) % K],
                        su.draws)
                losses.append(m["loss"])
            _sync(device)
    launches = quantize.launch_counts()
    tr = tracing.Trace(tracing.events_of(prof), steps)
    err(f"traced {steps} steps; launches {launches}")
    metrics = {}
    if device.type == "cuda":       # no device metric from a CPU run
        ctx = ReadContext(tr, launches, yard(cell), err)
        for name, mod in readers.items():
            v = mod.read(ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
    return (metrics, {"busy_s": tr.busy_s, "window_s": tr.window_s},
            {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}, losses)


def run(cell: Cell, seed: int, seconds: float, trace: bool, *,
        t_start: float, device="cuda", prepare=None,
        err: Callable[[str], None] = print) -> dict:
    """One run of ``cell`` -> the result line's object (``checks``
    last); raises :class:`Refused` where no result may be printed."""
    device = torch.device(device)
    bench = traffic.benchmark()
    readers = metric_modules(cell, bench) if trace else {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    su = set_up(cell, seed, device, prepare)
    if trace:
        tracing.warm(torch, device)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    if trace:
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        metrics, busy, breakdown, losses = traced(su, cell, readers, units,
                                                  device, err)
    else:
        metrics, losses = measure(su, cell, seconds, device, err)
        busy = {}
    attempted = len(losses)
    failed = sum(not math.isfinite(float(x)) for x in losses)
    err(f"last window loss {float(losses[-1])}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    if not trace:
        metrics["peak_gib"] = {"value": peak / 2 ** 30 if peak else 0.0,
                               "unit": "GiB"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    X0, bank, readout = su.X0, su.bank, su.readout
    del su, losses
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readout(cell, seed, X0, bank, device)
    correct, lines, checks = check.judge(check.gaps(readout, ref),
                                         cell.cell["limits"])
    err(f"program losses {readout['losses']}, reference {ref['losses']}")
    bad = forbidden_modules()
    if bad:
        raise Refused(f"the process holds {bad} after the window")
    for line in lines:
        err(line)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {**device_info(device, peak), **busy}}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
