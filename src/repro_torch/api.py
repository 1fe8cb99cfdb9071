"""The declarative experiment API of the port: specs, ``build``, runners.

The spec dataclasses read the same JSON as ``repro.api`` (the golden files
under ``tests/golden_specs``).  The port runs three engines: ``dense``
(:class:`DenseRunner`: Prox-LEAD, LEAD, NIDS and the six baselines of
``core.baselines`` over a DenseMixer; static and fault-free), ``netsim``
(:class:`NetsimRunner`: the same algorithms under a time-varying schedule
and communication faults, ``repro_torch.netsim``) and ``sharded``
(:class:`TrainerRunner`: the decentralized NN trainer, dense or
neighbor-gossip backend, any schedule); a sweep spec is refused with the
slice that will bring it.  ``build(spec)`` resolves every
component through ``repro_torch.registry`` and returns a runner on the
card unless the caller passes ``device="cpu"``::

    runner = build(ExperimentSpec.load("spec.json"))          # on cuda
    state, logs = runner.run()
    runner.last_report.to_dict()

Randomness is a draw source (``core.draws``): ``run`` makes one from
``spec.seed`` on the run's device unless it is handed one, and calls it in
a fixed order.  Dense and netsim engines: the algorithm's draws at init
(the oracle's, where it samples there), then every step the oracle's draws
followed by the compressor's draws for each compressed leaf; the netsim
engine's faults draw from a second source, seeded ``spec.fault_seed``.
Sharded engine: every step the compressor's draws for each compressed
leaf (the trainer's data stream is its own, ``data.pipeline``).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs, registry, tree
# imported for their registration side effects
from repro_torch.core import baselines as _baselines            # noqa: F401
from repro_torch.core import compression as _compression        # noqa: F401
from repro_torch.core import oracles as _oracles                # noqa: F401
from repro_torch.core import prox as _prox                      # noqa: F401
from repro_torch.core import prox_lead as _prox_lead            # noqa: F401
from repro_torch.core import topology as topo_mod
from repro_torch.core.comm import DenseMixer
from repro_torch.core.draws import Draws, GeneratorDraws
from repro_torch.data import synthetic as _synthetic            # noqa: F401
from repro_torch.data.pipeline import DecentralizedBatches
from repro_torch.models import transformer as TR
from repro_torch.netsim import engine as netsim_engine
from repro_torch.netsim import metrics as netsim_metrics
from repro_torch.netsim import schedule as sched_mod
from repro_torch.obs import Meters, RunReport, span, using_meters
from repro_torch.optim import decentralized as dec

# engines of the reference that later slices of the port bring
_LATER_ENGINES = {
    "sweep": "the sweep slice (ROADMAP A18: the sweep engine)",
}
ENGINES = ("dense", "netsim", "sharded")
#: model-sharded meshes need more than one card
MULTI_CARD_SLICE = ("the multi-card slice (ROADMAP: NCCL point-to-point "
                    "behind the pp seam, 4 cards)")
#: the reference's TrainerConfig fields that no ported path reads: a spec
#: may set them to their defaults (field -> (default, the slice that
#: brings it)); any other value is refused
LATER_TRAINER_FIELDS = {
    "shard_aligned_blocks": (False, MULTI_CARD_SLICE),
    "tp_ways": (16, MULTI_CARD_SLICE),
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
    """A graph and a netsim schedule over it (``static`` by default; the
    dense engine refuses any other)."""
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

    def build_schedule(self, n: int, seed: int = 0
                       ) -> sched_mod.TopologySchedule:
        return sched_mod.make_schedule(
            self.schedule, n, base=self.graph, rounds=self.rounds, seed=seed,
            **self.schedule_params)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """linkdrop | straggler | noise (``repro_torch.netsim.faults``)."""
    name: str = "linkdrop"
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "params", _norm_params(self.params))

    def build(self):
        return registry.make("fault", self.name, **self.params)


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
class ModelSpec:
    """The NN objective of the sharded engine (``repro_torch.configs``
    arch ids): ``full`` keeps the published widths, else ``reduced(
    n_layers, d_model)``; ``params`` override config fields afterwards
    (e.g. ``{"n_layers": 2, "vocab": 18992}``; ``dtype`` by name)."""
    arch: str = "qwen3-1.7b"
    full: bool = False
    n_layers: int = 2
    d_model: int = 256
    local_batch: int = 4
    seq_len: int = 64
    params: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "params", _norm_params(self.params))

    def build(self) -> TR.ModelConfig:
        cfg = configs.get(self.arch)
        if not self.full:
            cfg = cfg.reduced(n_layers=self.n_layers, d_model=self.d_model)
        overrides = dict(self.params)
        if isinstance(overrides.get("dtype"), str):
            overrides["dtype"] = getattr(torch, overrides["dtype"])
        return dataclasses.replace(cfg, **overrides) if overrides else cfg


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """``engine``: dense | sharded.  ``backend`` (dense | neighbor | ring),
    ``wire_mode``, ``pack_mode`` and ``params`` (extra TrainerConfig
    fields, strict) are the sharded engine's knobs; ``mesh`` is the
    reference's (data, model) mesh: one card holds every node whole, so a
    model dim above 1 is refused."""
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
           "model": ModelSpec, "execution": ExecutionSpec}


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """The declarative experiment, JSON-compatible with
    ``repro.api.ExperimentSpec``.  ``faults`` run on the netsim engine (the
    sharded engine's dense backend takes one ``linkdrop``); ``model`` is
    the sharded engine's objective."""
    name: str = "experiment"
    n_nodes: int = 8
    steps: int = 200
    seed: int = 0
    fault_seed: int = 0
    algorithm: AlgorithmSpec = dataclasses.field(default_factory=AlgorithmSpec)
    compressor: CompressorSpec = dataclasses.field(
        default_factory=CompressorSpec)
    topology: TopologySpec = dataclasses.field(default_factory=TopologySpec)
    faults: Tuple[FaultSpec, ...] = ()
    prox: ProxSpec = dataclasses.field(default_factory=ProxSpec)
    oracle: Optional[OracleSpec] = None
    model: Optional[ModelSpec] = None
    execution: ExecutionSpec = dataclasses.field(default_factory=ExecutionSpec)

    def __post_init__(self):
        for f, cls in _NESTED.items():
            v = getattr(self, f)
            if isinstance(v, Mapping):
                object.__setattr__(self, f, cls(**v))
        object.__setattr__(self, "faults", tuple(
            FaultSpec(**f) if isinstance(f, Mapping) else f
            for f in self.faults))
        engine = self.execution.engine
        if engine in _LATER_ENGINES:
            raise ValueError(
                f"spec {self.name!r}: engine {engine!r} is not ported yet; "
                f"it arrives with {_LATER_ENGINES[engine]}")
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; the port runs "
                             f"{list(ENGINES)}")
        if engine != "sharded" and self.model is not None:
            raise ValueError(
                f"spec {self.name!r}: a model objective runs on engine "
                f"'sharded'")

    def to_dict(self) -> dict:
        return _to_jsonable(self)

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping) -> "ExperimentSpec":
        if "base" in d and "axes" in d:
            raise ValueError(
                f"a sweep spec (base + axes) is not ported yet; it arrives "
                f"with {_LATER_ENGINES['sweep']}")
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
    """Any dense algorithm (Prox-LEAD and the baselines) over a DenseMixer,
    stacked leaves.

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
            extra={"algo": getattr(self.algo, "name",
                                   type(self.algo).__name__)})
        return state, logs

    def bits_per_step(self, X=None) -> float:
        """Exact bits ONE node sends per step: per-edge payload bits times
        the node's out-degree under the mixer's W support.  An algorithm
        without a compressor is priced uncompressed (f32); 0.0 when the
        mixer has no explicit W (nothing to price)."""
        X = X if X is not None else self.X0
        per_edge = netsim_metrics.payload_bits_per_node(
            getattr(self.algo, "compressor", None), X)
        W = getattr(getattr(self.algo, "mixer", None), "W", None)
        if W is None:
            return 0.0
        Wn = np.abs(np.asarray(W))
        directed = int((Wn > 1e-12).sum() - (np.diag(Wn) > 1e-12).sum())
        return per_edge * directed / Wn.shape[0]


def runner_for(algo, X0, *, spec: Optional[ExperimentSpec] = None,
               problem=None) -> DenseRunner:
    """Wrap an already-built dense algorithm (ProxLEAD or any baseline) in
    the runner protocol."""
    return DenseRunner(algo, X0, spec=spec, problem=problem)


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


def _oracle_and_problem(spec: ExperimentSpec, device, dtype):
    osp = spec.oracle if spec.oracle is not None else OracleSpec()
    problem, X0 = osp.build_problem(spec.n_nodes, device,
                                    dtype or torch.float32)
    return osp.build(problem), problem, X0


@registry.register_engine("dense")
def _build_dense(spec: ExperimentSpec, device, dtype) -> DenseRunner:
    if spec.topology.schedule != "static" or spec.faults:
        raise ValueError(
            "engine='dense' is the static, fault-free path; time-varying "
            "schedules and faults run on engine='netsim'")
    oracle, problem, X0 = _oracle_and_problem(spec, device, dtype)
    mixer = DenseMixer(spec.topology.build_graph(spec.n_nodes).W)
    algo = build_algorithm(spec, mixer, oracle)
    return DenseRunner(algo, X0, spec=spec, problem=problem)


class NetsimRunner:
    """Runner over :func:`repro_torch.netsim.engine.simulate`: the
    algorithm's mixer is swapped for a SimMixer (schedule + faults) and the
    steps run with exact, fault-exact bits-on-wire accounting.

    ``init_state(draws)`` starts a run: the algorithm over a new SimMixer
    whose faults draw from a generator seeded ``spec.fault_seed``, kept for
    the ``step(state, draws)`` calls that follow.  ``run`` starts afresh,
    both streams seeded anew."""

    def __init__(self, algo, X0, schedule: sched_mod.TopologySchedule,
                 faults=(), *, spec: Optional[ExperimentSpec] = None,
                 problem=None):
        self.algo = algo
        self.X0 = X0
        self.schedule = schedule
        self.faults = tuple(faults)
        self.spec = spec
        self.problem = problem
        self.last_report: Optional[RunReport] = None
        self._run_algo = None

    @property
    def device(self) -> torch.device:
        return self.X0.device

    def with_fault_draws(self, fault_draws: Draws):
        """The algorithm over a fresh SimMixer drawing from
        ``fault_draws``."""
        return dataclasses.replace(self.algo, mixer=netsim_engine.SimMixer(
            self.schedule, self.faults, fault_draws))

    def init_state(self, draws: Draws):
        self._run_algo = self.with_fault_draws(GeneratorDraws(
            self.spec.fault_seed if self.spec else 0, self.device))
        return self._run_algo.init(self.X0, draws)

    def step(self, state, draws: Draws):
        if self._run_algo is None:
            raise RuntimeError("NetsimRunner.step needs init_state first: "
                               "it starts the run's fault stream")
        return self._run_algo.step(state, draws)

    def run(self, *, num_steps: Optional[int] = None,
            draws: Optional[Draws] = None,
            fault_draws: Optional[Draws] = None, X0=None,
            objective_fn: Optional[Callable] = None, mask_log=None):
        """-> (final state, ``netsim.metrics.Trajectory``).  Draw sources
        default to generators seeded ``spec.seed`` and ``spec.fault_seed``
        on the run's device; ``mask_log``: see ``SimMixer``."""
        sp = self.spec
        if num_steps is None:
            num_steps = sp.steps if sp else 0
        meters = Meters()
        with using_meters(meters), span("run_total", self.device) as tsp:
            final, traj = netsim_engine.simulate(
                self.algo, self.schedule, self.faults,
                X0=X0 if X0 is not None else self.X0, steps=num_steps,
                seed=sp.seed if sp else 0,
                fault_seed=sp.fault_seed if sp else 0,
                objective_fn=objective_fn, draws=draws,
                fault_draws=fault_draws, mask_log=mask_log)
        # trajectory bits are the fault-exact SYSTEM total per round (every
        # directed edge that actually carried a payload), not one node's
        self.last_report = RunReport(
            name=sp.name if sp else "netsim", engine="netsim",
            device=device_label(self.device), steps=traj.steps,
            total_s=tsp.elapsed_s,
            bits_per_step=(traj.total_bits / traj.steps if traj.steps
                           else 0.0),
            scope="system",
            extra={"algo": traj.meta.get("algo"),
                   "schedule": traj.meta.get("schedule"),
                   "bits_total": traj.total_bits,
                   "final_consensus": (float(traj.consensus[-1])
                                       if traj.steps else None),
                   "meters": meters.as_dict()})
        return final, traj


@registry.register_engine("netsim")
def _build_netsim(spec: ExperimentSpec, device, dtype) -> NetsimRunner:
    oracle, problem, X0 = _oracle_and_problem(spec, device, dtype)
    schedule = spec.topology.build_schedule(spec.n_nodes, seed=spec.seed)
    faults = tuple(f.build() for f in spec.faults)
    # placeholder mixer: the runner swaps in the SimMixer
    mixer = DenseMixer(spec.topology.build_graph(spec.n_nodes).W)
    algo = build_algorithm(spec, mixer, oracle)
    return NetsimRunner(algo, X0, schedule, faults, spec=spec,
                        problem=problem)


class TrainerRunner:
    """Runner over :class:`repro_torch.optim.decentralized.
    DecentralizedTrainer` (the decentralized NN trainer).

    ``init_state(generator)`` and ``step(state, batch, draws)`` are the
    trainer's; ``run`` is the run loop.  On the neighbor backend a step
    consumes the state it is given (D, H and Hw update in place)."""

    def __init__(self, trainer: dec.DecentralizedTrainer, *,
                 spec: Optional[ExperimentSpec] = None):
        self.trainer = trainer
        self.spec = spec
        self.last_report: Optional[RunReport] = None

    @property
    def device(self) -> torch.device:
        return self.trainer.device

    def init_state(self, generator: Optional[torch.Generator] = None):
        return self.trainer.init_state(generator)

    def step(self, state, batch, draws: Draws):
        """-> (state, metrics: loss, consensus (0-d tensors), step)."""
        return self.trainer.train_step(state, batch, draws)

    def run(self, *, num_steps: Optional[int] = None, data=None, state=None,
            draws: Optional[Draws] = None,
            generator: Optional[torch.Generator] = None,
            callback: Optional[Callable] = None, log_every: int = 0):
        """Drive ``num_steps`` train steps over ``data`` (an object with
        ``batch_at(t)``; default :meth:`default_data`), step indices
        continuing from ``state.step``.  -> (final state, [callback(state,
        metrics, t) every ``log_every`` steps])."""
        sp = self.spec
        if num_steps is None:
            num_steps = sp.steps if sp else 0
        if data is None:
            data = self.default_data()
        if draws is None:
            draws = GeneratorDraws(sp.seed if sp else 0, self.device)
        meters = Meters()
        with using_meters(meters), span("run_total", self.device) as tsp:
            if state is None:
                state = self.init_state(generator)
            logs = []
            t0 = int(state.step)
            for t in range(t0, t0 + num_steps):
                state, metrics = self.step(state, data.batch_at(t), draws)
                if callback is not None and log_every and t % log_every == 0:
                    logs.append(callback(state, metrics, t))
        tcfg = self.trainer.tcfg
        self.last_report = RunReport(
            name=sp.name if sp else "trainer", engine="sharded",
            device=device_label(self.device), steps=num_steps,
            total_s=tsp.elapsed_s, bits_per_step=self.bits_per_step(state),
            extra={"backend": tcfg.backend, "wire_mode": tcfg.wire_mode,
                   "meters": meters.as_dict()})
        return state, logs

    def bits_per_step(self, state=None) -> float:
        """Exact bits ONE node ships per train step.  Neighbor/ring: hops x
        the per-edge u8 wire payload (``netsim.metrics.{bucketed,
        sharded}_payload_bits``).  Dense: ideal per-edge payload x W
        out-degree.  Without a state the count comes from the parameter
        shapes alone (``meta`` tensors, nothing allocated)."""
        tr = self.trainer
        if state is not None:
            leaves = tree.leaves(state.plead.X)
        else:
            N = tr.tcfg.n_nodes
            leaves = [torch.empty((N,) + tuple(p.shape), dtype=p.dtype,
                                  device="meta")
                      for p in tree.leaves(TR.abstract_params(tr.mcfg))]
        if tr.plan is not None:
            if tr.tcfg.wire_mode == "bucketed":
                per_edge = netsim_metrics.bucketed_payload_bits(tr, leaves)
            else:
                per_edge = netsim_metrics.sharded_payload_bits(tr, leaves)
            return float(len(tr.plan.hops) * per_edge)
        per_edge = netsim_metrics.payload_bits_per_node(tr.compressor,
                                                         leaves)
        W = getattr(tr.mixer, "W", None)
        if W is None:                 # a netsim mixer: no one W to price
            return 0.0
        Wn = np.abs(np.asarray(W))
        directed = int((Wn > 1e-12).sum() - (np.diag(Wn) > 1e-12).sum())
        return per_edge * directed / Wn.shape[0]

    def default_data(self) -> DecentralizedBatches:
        """The spec's synthetic token stream (seed 0, as the reference)."""
        if self.spec is None or self.spec.model is None:
            raise ValueError("no spec/model to derive a data stream from; "
                             "pass data= explicitly")
        ms, cfg = self.spec.model, self.trainer.mcfg
        return DecentralizedBatches(
            self.spec.n_nodes, ms.local_batch, ms.seq_len, cfg.vocab,
            family=cfg.family, device=str(self.device))


def _later_field(name: str, value) -> None:
    """Accept a not-yet-ported trainer knob only at its default."""
    default, where = LATER_TRAINER_FIELDS[name]
    if value != default:
        raise NotImplementedError(
            f"trainer knob {name}={value!r} is not ported yet (only the "
            f"default {default!r}); it arrives with {where}")


def trainer_config_from_spec(spec: ExperimentSpec) -> dec.TrainerConfig:
    """Map an ExperimentSpec onto TrainerConfig, strictly: spec entries
    that map onto no TrainerConfig field raise (the reference's rule), and
    the reference's knobs that only a later slice reads are refused unless
    at their defaults (:data:`LATER_TRAINER_FIELDS`).  The schedule's
    ``rounds`` and ``drop`` and the spec's ``fault_seed`` map onto
    ``schedule_rounds``, ``schedule_drop`` and ``fault_seed``; one
    ``linkdrop`` fault onto ``drop_rate``."""
    tc_fields = {f.name for f in dataclasses.fields(dec.TrainerConfig)}
    if spec.algorithm.name != "prox_lead":
        raise ValueError(
            f"engine='sharded' runs Prox-LEAD (the trainer's outer "
            f"optimizer); algorithm {spec.algorithm.name!r} runs on the "
            f"dense engine")
    consts = {}
    for f in ("eta", "alpha", "gamma"):
        s = getattr(spec.algorithm, f)
        if s.kind != "constant":
            raise ValueError(f"the sharded trainer takes a constant {f}, "
                             f"got a {s.kind!r} schedule")
        consts[f] = float(s.value)
    kw = dict(
        n_nodes=spec.n_nodes, **consts,
        compressor=spec.compressor.name,
        allow_biased=bool(spec.algorithm.params.get("allow_biased", False)),
        prox=spec.prox.build(), topology=spec.topology.graph,
        backend=spec.execution.backend, schedule=spec.topology.schedule,
        schedule_rounds=spec.topology.rounds,
        wire_mode=spec.execution.wire_mode,
        pack_mode=spec.execution.pack_mode, seed=spec.seed,
        fault_seed=spec.fault_seed)
    extra = set(spec.algorithm.params) - {"allow_biased"}
    if extra:
        raise ValueError(f"sharded engine: unsupported algorithm params "
                         f"{sorted(extra)}")
    sp = dict(spec.topology.schedule_params)
    if "drop" in sp:
        kw["schedule_drop"] = sp.pop("drop")
    if sp:
        raise ValueError(f"sharded engine: unsupported schedule params "
                         f"{sorted(sp)}")
    for f in spec.faults:
        if f.name != "linkdrop" or "drop_rate" in kw:
            raise ValueError(
                f"sharded engine supports a single linkdrop fault only "
                f"(got {[x.name for x in spec.faults]}); richer fault "
                f"models run on engine='netsim'")
        kw["drop_rate"] = f.params.get("rate", 0.1)
    for where, params in (("compressor", spec.compressor.params),
                          ("execution", spec.execution.params)):
        for k, v in params.items():
            if k in LATER_TRAINER_FIELDS:
                _later_field(k, v)
                continue
            if k not in tc_fields:
                raise ValueError(
                    f"{where} param {k!r} has no TrainerConfig field; the "
                    f"trainer understands {sorted(tc_fields)}")
            kw[k] = v
    return dec.TrainerConfig(**kw)


def build_trainer_runner(spec: ExperimentSpec, *, device,
                         dtype: Optional[torch.dtype] = None,
                         model_cfg: Optional[TR.ModelConfig] = None,
                         pp=None) -> TrainerRunner:
    """The sharded engine on ``device``, with an optional prebuilt
    ModelConfig and exchange seam ``pp`` (default: the one-card
    :func:`repro_torch.optim.wire.stacked_pp`)."""
    if model_cfg is None:
        if spec.model is None:
            raise ValueError(
                "engine='sharded' needs a ModelSpec (spec.model)")
        model_cfg = spec.model.build()
    if dtype is not None:
        model_cfg = dataclasses.replace(model_cfg, dtype=dtype)
    mesh = spec.execution.mesh
    if mesh is not None and len(mesh) > 1 and mesh[1] > 1:
        raise NotImplementedError(
            f"spec {spec.name!r}: mesh {mesh} shards the model over "
            f"{mesh[1]} devices; one card holds every node whole, and "
            f"model-sharded meshes arrive with {MULTI_CARD_SLICE}")
    trainer = dec.DecentralizedTrainer(
        model_cfg, trainer_config_from_spec(spec), device=device, pp=pp)
    return TrainerRunner(trainer, spec=spec)


@registry.register_engine("sharded")
def _build_sharded(spec: ExperimentSpec, device, dtype) -> TrainerRunner:
    return build_trainer_runner(spec, device=device, dtype=dtype)


def build(spec: ExperimentSpec, *, device=None,
          dtype: Optional[torch.dtype] = None):
    """Resolve a spec into a runner on ``device`` (default: the card; raises
    without one).  ``dtype``: the dense and netsim engines' state and data
    (default f32); the sharded engine's parameters (default: the model
    config's)."""
    return registry.make("engine", spec.execution.engine, spec=spec,
                         device=resolve_device(device), dtype=dtype)
