"""The declarative experiment API of the port: specs, ``build``, DenseRunner.

The spec dataclasses read the same JSON as ``repro.api`` (the golden files
under ``tests/golden_specs``); this slice runs the dense engine only, and a
spec for any other engine is refused with the slice that will bring it.
``build(spec)`` resolves every component through ``repro_torch.registry``
and returns a :class:`DenseRunner`, which runs on the card unless the
caller passes ``device="cpu"``::

    runner = build(ExperimentSpec.load("spec.json"))          # on cuda
    state, logs = runner.run()
    runner.last_report.to_dict()

Randomness is a draw source (``core.draws``): ``run`` makes one from
``spec.seed`` on the run's device unless it is handed one, and calls it in
a fixed order -- the oracle's draws at init, then every step the oracle's
draws followed by one noise array per compressed leaf.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import registry
# imported for their registration side effects
from repro_torch.core import compression as _compression        # noqa: F401
from repro_torch.core import oracles as _oracles                # noqa: F401
from repro_torch.core import prox as _prox                      # noqa: F401
from repro_torch.core import prox_lead as _prox_lead            # noqa: F401
from repro_torch.core import topology as topo_mod
from repro_torch.core.comm import DenseMixer
from repro_torch.core.draws import Draws, GeneratorDraws
from repro_torch.data import synthetic as _synthetic            # noqa: F401
from repro_torch.netsim import metrics as netsim_metrics
from repro_torch.obs import RunReport, span

# engines of the reference that later slices of the port bring
_LATER_ENGINES = {
    "netsim": "slice 3 (ROADMAP A12: netsim schedules and faults)",
    "sharded": "slice 5 (ROADMAP A15-A16: models and the decentralized "
               "trainer)",
}


# ===========================================================================
# Spec tree (field for field the JSON schema of repro.api)
# ===========================================================================

def _norm_params(params) -> dict:
    """Lists become tuples (JSON has no tuple type), recursively."""
    def norm(v):
        if isinstance(v, (list, tuple)):
            return tuple(norm(x) for x in v)
        if isinstance(v, Mapping):
            return {k: norm(x) for k, x in v.items()}
        return v

    return {k: norm(v) for k, v in dict(params or {}).items()}


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, Mapping):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """A scalar hyperparameter as a function of the iteration k:
    ``constant`` (``value``) or ``harmonic`` (``value * t0 / (k + t0)``)."""
    kind: str = "constant"
    value: float = 0.0
    t0: float = 1.0

    @classmethod
    def coerce(cls, v) -> "ScheduleSpec":
        if isinstance(v, cls):
            return v
        if isinstance(v, Mapping):
            return cls(**v)
        return cls("constant", float(v))

    def resolve(self):
        """A float (constant) or a callable k -> float, as ProxLEAD takes."""
        if self.kind == "constant":
            return float(self.value)
        if self.kind == "harmonic":
            v, t0 = float(self.value), float(self.t0)
            return lambda k: v * t0 / (k + t0)
        raise ValueError(f"unknown schedule kind {self.kind!r}; "
                         f"have ['constant', 'harmonic']")


def constant(v: float) -> ScheduleSpec:
    return ScheduleSpec("constant", float(v))


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    name: str = "prox_lead"
    eta: ScheduleSpec = dataclasses.field(default_factory=lambda: constant(0.05))
    alpha: ScheduleSpec = dataclasses.field(default_factory=lambda: constant(0.5))
    gamma: ScheduleSpec = dataclasses.field(default_factory=lambda: constant(1.0))
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for f in ("eta", "alpha", "gamma"):
            object.__setattr__(self, f, ScheduleSpec.coerce(getattr(self, f)))
        object.__setattr__(self, "params", _norm_params(self.params))


@dataclasses.dataclass(frozen=True)
class CompressorSpec:
    name: str = "qinf"
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "params", _norm_params(self.params))

    def build(self):
        return registry.make("compressor", self.name, **self.params)


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """A static graph; ``schedule``/``rounds``/``schedule_params`` describe
    netsim schedules, which the dense engine refuses."""
    graph: str = "ring"
    schedule: str = "static"
    rounds: int = 32
    params: dict = dataclasses.field(default_factory=dict)
    schedule_params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "params", _norm_params(self.params))
        object.__setattr__(self, "schedule_params",
                           _norm_params(self.schedule_params))

    def build_graph(self, n: int) -> topo_mod.Topology:
        return topo_mod.make_topology(self.graph, n, **self.params)


@dataclasses.dataclass(frozen=True)
class ProxSpec:
    name: str = "none"
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "params", _norm_params(self.params))

    def build(self):
        return registry.make("prox", self.name, **self.params)


@dataclasses.dataclass(frozen=True)
class OracleSpec:
    """A registered ``problem`` factory plus the sampling scheme over it."""
    name: str = "full"               # full | sgd | lsvrg | saga
    problem: str = "logreg"
    params: dict = dataclasses.field(default_factory=dict)
    problem_params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "params", _norm_params(self.params))
        object.__setattr__(self, "problem_params",
                           _norm_params(self.problem_params))

    def build_problem(self, n_nodes: int, device, dtype):
        """-> (FiniteSumProblem, X0 stacked zeros) on device, in dtype."""
        return registry.make("problem", self.problem, n_nodes=n_nodes,
                             device=device, dtype=dtype,
                             **self.problem_params)

    def build(self, problem):
        return registry.make("oracle", self.name, problem=problem,
                             **self.params)


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """``engine`` must be ``dense`` here; the other fields are the sharded
    engine's knobs, kept so the JSON round-trips."""
    engine: str = "dense"
    backend: str = "dense"
    wire_mode: str = "bucketed"
    pack_mode: str = "lastdim"
    mesh: Optional[Tuple[int, int]] = None
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.mesh is not None:
            object.__setattr__(self, "mesh", tuple(int(x) for x in self.mesh))
        object.__setattr__(self, "params", _norm_params(self.params))


_NESTED = {"algorithm": AlgorithmSpec, "compressor": CompressorSpec,
           "topology": TopologySpec, "prox": ProxSpec, "oracle": OracleSpec,
           "execution": ExecutionSpec}


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """The declarative experiment, JSON-compatible with
    ``repro.api.ExperimentSpec``.  ``faults`` and ``model`` are carried as
    their JSON (they belong to engines the port has not reached) and must
    be empty for the dense engine."""
    name: str = "experiment"
    n_nodes: int = 8
    steps: int = 200
    seed: int = 0
    fault_seed: int = 0
    algorithm: AlgorithmSpec = dataclasses.field(default_factory=AlgorithmSpec)
    compressor: CompressorSpec = dataclasses.field(
        default_factory=CompressorSpec)
    topology: TopologySpec = dataclasses.field(default_factory=TopologySpec)
    faults: Tuple[Any, ...] = ()
    prox: ProxSpec = dataclasses.field(default_factory=ProxSpec)
    oracle: Optional[OracleSpec] = None
    model: Optional[dict] = None
    execution: ExecutionSpec = dataclasses.field(default_factory=ExecutionSpec)

    def __post_init__(self):
        for f, cls in _NESTED.items():
            v = getattr(self, f)
            if isinstance(v, Mapping):
                object.__setattr__(self, f, cls(**v))
        object.__setattr__(self, "faults", tuple(
            _norm_params(f) if isinstance(f, Mapping) else f
            for f in self.faults))
        engine = self.execution.engine
        if engine in _LATER_ENGINES:
            raise ValueError(
                f"spec {self.name!r}: engine {engine!r} is not ported yet; "
                f"it arrives with {_LATER_ENGINES[engine]}")
        if engine != "dense":
            raise ValueError(f"unknown engine {engine!r}; the port runs "
                             f"'dense'")
        if self.topology.schedule != "static" or self.faults:
            raise ValueError(
                f"spec {self.name!r}: time-varying schedules and faults run "
                f"on engine 'netsim', which arrives with "
                f"{_LATER_ENGINES['netsim']}")
        if self.model is not None:
            raise ValueError(
                f"spec {self.name!r}: a model objective runs on engine "
                f"'sharded', which arrives with {_LATER_ENGINES['sharded']}")

    def to_dict(self) -> dict:
        return _to_jsonable(self)

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping) -> "ExperimentSpec":
        if "base" in d and "axes" in d:
            raise ValueError(
                "a sweep spec (base + axes) is not ported yet; it arrives "
                "with slice 6 (ROADMAP A18)")
        return cls(**dict(d))

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path) -> "ExperimentSpec":
        return cls.from_json(pathlib.Path(path).read_text())


# ===========================================================================
# Runner
# ===========================================================================

def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raises when CUDA is unavailable, so a run
    never lands on the CPU unless the caller asked for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default -- pass device='cpu' to run its plain torch path")
    return torch.device("cuda")


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


class DenseRunner:
    """Prox-LEAD / LEAD / NIDS over a DenseMixer, stacked leaves.

    ``init_state(draws)`` and ``step(state, draws)`` are the algorithm's;
    ``run`` is the driver loop (one init, ``num_steps`` steps)."""

    def __init__(self, algo, X0, *, spec: Optional[ExperimentSpec] = None,
                 problem=None):
        self.algo = algo
        self.X0 = X0
        self.spec = spec
        self.problem = problem
        self.last_report: Optional[RunReport] = None

    @property
    def device(self) -> torch.device:
        return self.X0.device

    def init_state(self, draws: Draws):
        return self.algo.init(self.X0, draws)

    def step(self, state, draws: Draws):
        return self.algo.step(state, draws)

    def run(self, *, num_steps: Optional[int] = None,
            draws: Optional[Draws] = None, X0=None,
            callback: Optional[Callable] = None, log_every: int = 0):
        """-> (final state, [callback(state, t) every ``log_every`` steps])."""
        if num_steps is None:
            num_steps = self.spec.steps if self.spec else 0
        if draws is None:
            draws = GeneratorDraws(self.spec.seed if self.spec else 0,
                                   self.device)
        with span("run_total", self.device) as sp:
            state = self.algo.init(X0 if X0 is not None else self.X0, draws)
            logs = []
            for t in range(num_steps):
                state = self.algo.step(state, draws)
                if callback is not None and log_every and t % log_every == 0:
                    logs.append(callback(state, t))
        self.last_report = RunReport(
            name=self.spec.name if self.spec else "dense", engine="dense",
            device=device_label(self.device), steps=num_steps,
            total_s=sp.elapsed_s, bits_per_step=self.bits_per_step(),
            extra={"algo": type(self.algo).__name__})
        return state, logs

    def bits_per_step(self, X=None) -> float:
        """Exact bits ONE node sends per step: per-edge payload bits times
        the node's out-degree under the mixer's W support."""
        X = X if X is not None else self.X0
        per_edge = netsim_metrics.payload_bits_per_node(
            self.algo.compressor, X)
        Wn = np.abs(np.asarray(self.algo.mixer.W))
        directed = int((Wn > 1e-12).sum() - (np.diag(Wn) > 1e-12).sum())
        return per_edge * directed / Wn.shape[0]


def build_algorithm(spec: ExperimentSpec, mixer, oracle):
    """Resolve AlgorithmSpec through the registry: factories receive the
    subset of the shared context their signature declares; params are
    strict."""
    a = spec.algorithm
    ctx = {"eta": a.eta.resolve(), "alpha": a.alpha.resolve(),
           "gamma": a.gamma.resolve(), "compressor": spec.compressor.build(),
           "prox": spec.prox.build(), "mixer": mixer, "oracle": oracle}
    ctx = registry.kwargs_subset("algorithm", a.name, ctx)
    return registry.make("algorithm", a.name, **ctx, **a.params)


@registry.register_engine("dense")
def _build_dense(spec: ExperimentSpec, device, dtype) -> DenseRunner:
    osp = spec.oracle if spec.oracle is not None else OracleSpec()
    problem, X0 = osp.build_problem(spec.n_nodes, device, dtype)
    mixer = DenseMixer(spec.topology.build_graph(spec.n_nodes).W)
    algo = build_algorithm(spec, mixer, osp.build(problem))
    return DenseRunner(algo, X0, spec=spec, problem=problem)


def build(spec: ExperimentSpec, *, device=None,
          dtype: torch.dtype = torch.float32) -> DenseRunner:
    """Resolve a spec into a runner on ``device`` (default: the card; raises
    without one) with state and data in ``dtype``."""
    return registry.make("engine", spec.execution.engine, spec=spec,
                         device=resolve_device(device), dtype=dtype)
