"""The declarative experiment API of the port: specs, ``build``, runners.

The spec dataclasses read the same JSON as ``repro.api`` (the golden files
under ``tests/golden_specs``).  The port runs three engines: ``dense``
(:class:`DenseRunner`: Prox-LEAD, LEAD, NIDS and the six baselines of
``core.baselines`` over a DenseMixer; static and fault-free), ``netsim``
(:class:`NetsimRunner`: the same algorithms under a time-varying schedule
and communication faults, ``repro_torch.netsim``) and ``sharded``
(:class:`TrainerRunner`: the decentralized NN trainer, dense or
neighbor-gossip backend, any schedule).  A :class:`SweepSpec` (a base
spec plus :class:`AxisSpec` axes) builds a grid runner,
``repro_torch.sweep.SweepRunner``.  ``build(spec)`` resolves every
component through ``repro_torch.registry`` and returns a runner on the
card unless the caller passes ``device="cpu"``::

    runner = build(ExperimentSpec.load("spec.json"))          # on cuda
    state, logs = runner.run()
    runner.last_report.to_dict()
    runner.save("ckpt", state, step=spec.steps)     # embeds the spec
    runner, state, step = load_checkpoint("ckpt")   # rebuilds and restores

Spec gate (round-trip and build every golden spec)::

    PYTHONPATH=src python -m repro_torch.api --check tests/golden_specs \
        --device cpu

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

import argparse
import dataclasses
import itertools
import json
import pathlib
import sys
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import configs, registry, tree
from repro_torch.checkpoint import ckpt
# imported for their registration side effects
from repro_torch.core import baselines as _baselines            # noqa: F401
from repro_torch.core import compression as _compression        # noqa: F401
from repro_torch.core import oracles as _oracles                # noqa: F401
from repro_torch.core import prox as _prox                      # noqa: F401
from repro_torch.core import prox_lead as _prox_lead            # noqa: F401
from repro_torch.core import topology as topo_mod
from repro_torch.core.comm import DenseMixer
from repro_torch.core.compression import Identity
from repro_torch.core.draws import Draws, GeneratorDraws
from repro_torch.data import synthetic as _synthetic            # noqa: F401
from repro_torch.data.pipeline import DecentralizedBatches
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as TR
from repro_torch.models.tp import rank_draws as tp_rank_draws
from repro_torch.netsim import engine as netsim_engine
from repro_torch.netsim import metrics as netsim_metrics
from repro_torch.netsim import schedule as sched_mod
from repro_torch.obs import (Meters, RunReport, build_report, span,
                             step_roofline, trainer_wire_layout,
                             using_meters)
from repro_torch.obs.report import device_label  # noqa: F401 (re-export)
from repro_torch.optim import decentralized as dec

ENGINES = ("dense", "netsim", "sharded")


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


#: ModelSpec params that are TrainerConfig fields of the sharded engine
MODEL_TRAINER_PARAMS = ("aux_weight",)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The NN objective of the sharded engine (``repro_torch.configs``
    arch ids): ``full`` keeps the published widths, else ``reduced(
    n_layers, d_model)``; ``params`` override config fields afterwards
    (e.g. ``{"n_layers": 2, "vocab": 18992}``; ``dtype`` by name), but
    for :data:`MODEL_TRAINER_PARAMS`, which the trainer takes: the weight
    a model states for its balance loss (DeepSeekMoE's ``aux_loss_alpha``)
    is the trainer's ``aux_weight``."""
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
        overrides = {k: v for k, v in self.params.items()
                     if k not in MODEL_TRAINER_PARAMS}
        if isinstance(overrides.get("dtype"), str):
            overrides["dtype"] = getattr(torch, overrides["dtype"])
        return dataclasses.replace(cfg, **overrides) if overrides else cfg


@dataclasses.dataclass(frozen=True)
class ExecutionSpec:
    """``engine``: dense | sharded.  ``backend`` (dense | neighbor | ring),
    ``wire_mode``, ``pack_mode`` and ``params`` (extra TrainerConfig
    fields, strict) are the sharded engine's knobs; ``mesh`` is the
    reference's (data, model) mesh: its model dim M is the number of
    model shards the bucketed neighbor wire cuts each node's leaves into
    (the shards of a node stay in one process)."""
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
        if engine == "sweep":
            raise ValueError(
                f"spec {self.name!r}: the sweep engine takes a SweepSpec (a "
                f"base ExperimentSpec plus axes), not an ExperimentSpec "
                f"with engine='sweep'")
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
            raise ValueError("a sweep spec (base + axes) is a SweepSpec; "
                             "read it with SweepSpec.from_json")
        return cls(**dict(d))

    @classmethod
    def from_json(cls, text: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(text))

    def save(self, path) -> pathlib.Path:
        p = pathlib.Path(path)
        p.write_text(self.to_json() + "\n")
        return p

    @classmethod
    def load(cls, path) -> "ExperimentSpec":
        return cls.from_json(pathlib.Path(path).read_text())

    def diff(self, other: "ExperimentSpec") -> Dict[str, Tuple[Any, Any]]:
        """Dotted-path map of every field that differs: path -> (self,
        other); the reference's paths (``compressor.params.bits``,
        ``algorithm.eta.value``), a list compared as a whole.  Empty dict
        == equal specs."""
        a, b = {}, {}
        _flat("", self.to_dict(), a)
        _flat("", other.to_dict(), b)
        return {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b))
                if a.get(k, _MISSING) != b.get(k, _MISSING)}

    @classmethod
    def from_flags(cls, args, *, engine: Optional[str] = None,
                   **overrides) -> "ExperimentSpec":
        """A spec from an argparse.Namespace carrying the launch CLIs'
        flags (the reference's names; a missing flag falls back to the
        spec default)."""
        return _spec_from_flags(cls, args, engine=engine, **overrides)


_MISSING = object()


def _flat(prefix: str, v, out: dict) -> None:
    if isinstance(v, Mapping):
        for k in sorted(v):
            _flat(f"{prefix}.{k}" if prefix else str(k), v[k], out)
    elif isinstance(v, list):
        out[prefix] = tuple(json.dumps(x, sort_keys=True) for x in v)
    else:
        out[prefix] = v


# ===========================================================================
# SweepSpec: a grid of ExperimentSpecs as one declarative object
# ===========================================================================

#: axis paths a SweepSpec understands (the table repro_torch.sweep enforces)
SWEEP_AXIS_PATHS = (
    "seed", "fault_seed",
    "algorithm.eta[.value|.t0]", "algorithm.alpha[.value|.t0]",
    "algorithm.gamma[.value|.t0]",
    "algorithm.params.<field>", "compressor.bits",
)

_AXIS_SCHED = {f"algorithm.{f}{sfx}": (f, attr)
               for f in ("eta", "alpha", "gamma")
               for sfx, attr in (("", "value"), (".value", "value"),
                                 (".t0", "t0"))}


def set_axis_value(spec: ExperimentSpec, path: str, value) -> ExperimentSpec:
    """``spec`` with the sweep axis ``path`` set to ``value``: the one
    place axis paths are read, for ``SweepSpec.points()`` and the
    ``--axis`` flag.  An unknown path raises, listing the axes."""
    if path == "seed":
        return dataclasses.replace(spec, seed=int(value))
    if path == "fault_seed":
        return dataclasses.replace(spec, fault_seed=int(value))
    if path in _AXIS_SCHED:
        field, attr = _AXIS_SCHED[path]
        sched = dataclasses.replace(getattr(spec.algorithm, field),
                                    **{attr: float(value)})
        algorithm = dataclasses.replace(spec.algorithm, **{field: sched})
        return dataclasses.replace(spec, algorithm=algorithm)
    if path.startswith("algorithm.params."):
        params = dict(spec.algorithm.params)
        params[path[len("algorithm.params."):]] = value
        algorithm = dataclasses.replace(spec.algorithm, params=params)
        return dataclasses.replace(spec, algorithm=algorithm)
    if path in ("compressor.bits", "compressor.params.bits"):
        params = dict(spec.compressor.params, bits=int(value))
        return dataclasses.replace(
            spec, compressor=dataclasses.replace(spec.compressor,
                                                 params=params))
    raise ValueError(f"unknown sweep axis {path!r}; supported axes: "
                     f"{SWEEP_AXIS_PATHS}")


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """One sweep axis: a ``path`` of :data:`SWEEP_AXIS_PATHS` and the
    values it takes."""
    path: str
    values: Tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))
        if not self.values:
            raise ValueError(f"axis {self.path!r} needs at least one value")


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """An experiment grid, JSON-compatible with ``repro.api.SweepSpec``:
    one ``base`` ExperimentSpec and :class:`AxisSpec` axes whose cartesian
    product (later axes fastest) gives the points; ``build`` makes a
    ``repro_torch.sweep.SweepRunner`` of it."""
    name: str = "sweep"
    base: ExperimentSpec = dataclasses.field(default_factory=ExperimentSpec)
    axes: Tuple[AxisSpec, ...] = ()

    def __post_init__(self):
        if isinstance(self.base, Mapping):
            object.__setattr__(self, "base",
                               ExperimentSpec.from_dict(self.base))
        object.__setattr__(self, "axes", tuple(
            AxisSpec(**a) if isinstance(a, Mapping) else a
            for a in self.axes))

    @property
    def n_points(self) -> int:
        n = 1
        for a in self.axes:
            n *= len(a.values)
        return n

    def points(self) -> Tuple[ExperimentSpec, ...]:
        """The grid, later axes varying fastest; each point is named
        ``<base.name>@path=value,...``."""
        out = []
        for combo in itertools.product(*(a.values for a in self.axes)):
            p, tags = self.base, []
            for a, v in zip(self.axes, combo):
                p = set_axis_value(p, a.path, v)
                tags.append(f"{a.path}={v:g}" if isinstance(v, float)
                            else f"{a.path}={v}")
            if tags:
                p = dataclasses.replace(p, name=f"{self.base.name}@"
                                        + ",".join(tags))
            out.append(p)
        return tuple(out)

    def to_dict(self) -> dict:
        return _to_jsonable(self)

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping) -> "SweepSpec":
        return cls(**dict(d))

    @classmethod
    def from_json(cls, text: str) -> "SweepSpec":
        return cls.from_dict(json.loads(text))

    def save(self, path) -> pathlib.Path:
        p = pathlib.Path(path)
        p.write_text(self.to_json() + "\n")
        return p

    @classmethod
    def load(cls, path) -> "SweepSpec":
        return cls.from_json(pathlib.Path(path).read_text())


def parse_axis(arg: str) -> AxisSpec:
    """The ``--axis`` shorthand ``path=v1,v2,...`` or ``path=lo:hi[:step]``
    (an integer range, half-open) -> AxisSpec: ``seed=0:16``,
    ``compressor.bits=2,4,8``, ``algorithm.eta=0.05,0.1``."""
    path, sep, rhs = arg.partition("=")
    if not sep or not rhs:
        raise ValueError(f"--axis wants path=values, got {arg!r}")
    if ":" in rhs:
        parts = [int(x) for x in rhs.split(":")]
        if len(parts) not in (2, 3):
            raise ValueError(f"range axis wants lo:hi[:step], got {rhs!r}")
        return AxisSpec(path, tuple(range(*parts)))
    return AxisSpec(path, tuple(_cast_scalar(v) for v in rhs.split(",")))


# ===========================================================================
# Flag -> spec layer (the launch CLIs)
# ===========================================================================

def _cast_scalar(arg: str):
    try:
        return int(arg)
    except ValueError:
        try:
            return float(arg)
        except ValueError:
            return arg


# factory params that carry shared construction context rather than a
# component's own tunable (skipped by the name:arg shorthand)
_CONTEXT_PARAMS = frozenset({"n", "n_nodes", "base", "rounds", "seed",
                             "problem", "name"})


def parse_component(kind: str, spec_str: str) -> Tuple[str, dict]:
    """The CLI shorthand ``name[:arg]`` (``qinf:2``, ``linkdrop:0.1``,
    ``markov_drop:0.2``) -> (name, params): the argument binds to the
    factory's first tunable field (bits, frac, rate, sigma, drop, ...)."""
    name, _, arg = spec_str.partition(":")
    name = name.replace("-", "_")
    if not arg:
        return name, {}
    acc = [a for a in registry.accepts(kind, name) if a not in _CONTEXT_PARAMS]
    if not acc:
        raise ValueError(f"{kind} {name!r} takes no parameters "
                         f"(got {spec_str!r})")
    return name, {acc[0]: _cast_scalar(arg)}


def parse_faults(spec_str: str) -> Tuple[FaultSpec, ...]:
    """``'linkdrop:0.1,noise:0.01'`` -> FaultSpec tuple ('' -> ())."""
    out = []
    for part in (spec_str or "").split(","):
        part = part.strip()
        if part:
            name, params = parse_component("fault", part)
            out.append(FaultSpec(name, params))
    return tuple(out)


def _spec_from_flags(cls, args, *, engine=None, **overrides):
    def g(name, default=None):
        return getattr(args, name, default)

    engine = engine or g("engine") or ("sharded" if g("arch") else "dense")
    aparams = {"allow_biased": True} if g("allow_biased") else {}
    algorithm = AlgorithmSpec(
        (g("algo") or "prox_lead").replace("-", "_"),
        eta=constant(g("eta", 0.05)), alpha=constant(g("alpha", 0.5)),
        gamma=constant(g("gamma", 1.0)), params=aparams)

    cname, cparams = parse_component("compressor", g("compressor", "qinf"))
    for flag in ("bits", "block", "frac"):
        v = g(flag)
        if v is not None and flag not in cparams \
                and flag in registry.accepts("compressor", cname):
            cparams[flag] = v
    compressor = CompressorSpec(cname, cparams)

    sname, sparams = parse_component("schedule", g("schedule", "static"))
    topology = TopologySpec(
        graph=g("topology", "ring"), schedule=sname,
        rounds=g("rounds", g("schedule_rounds", 32)),
        schedule_params=sparams)

    faults = parse_faults(g("fault", ""))
    drop_rate = g("drop_rate", 0.0)
    if drop_rate:
        faults = faults + (FaultSpec("linkdrop", {"rate": drop_rate}),)

    pname = g("prox")
    if pname in (None, "none"):
        l1 = g("l1", 0.0)
        prox = ProxSpec("l1", {"lam": l1}) if l1 else ProxSpec("none")
    else:
        prox = ProxSpec(pname, ({"lam": g("lam", 1e-5)}
                                if pname in ("l1", "l2sq") else {}))

    oracle = model = None
    if engine == "sharded":
        model = ModelSpec(arch=g("arch", "qwen3-1.7b"), full=g("full", False),
                          n_layers=g("layers", 2), d_model=g("d_model", 256),
                          local_batch=g("local_batch", 4),
                          seq_len=g("seq_len", 64))
    else:
        pparams = {}
        for flag, field in (("features", "n_features"),
                            ("classes", "n_classes"), ("lam2", "lam2"),
                            ("n_per_node", "n_per_node"),
                            ("n_batches", "n_batches")):
            v = g(flag)
            if v is not None:
                pparams[field] = v
        if g("seed") is not None:
            pparams["seed"] = g("seed")
        oracle = OracleSpec(
            name=g("oracle", "full"),
            problem=g("problem", "logreg2d" if engine == "netsim"
                      else "logreg"),
            problem_params=pparams)

    execution = ExecutionSpec(
        engine=engine, backend=g("backend", "dense"),
        wire_mode=g("wire_mode", "bucketed"),
        pack_mode=g("pack_mode", "lastdim"))

    spec = cls(name=g("name", "experiment"), n_nodes=g("nodes", 8),
               steps=g("steps", 200), seed=g("seed", 0),
               fault_seed=g("fault_seed", g("seed", 0)),
               algorithm=algorithm, compressor=compressor, topology=topology,
               faults=faults, prox=prox, oracle=oracle, model=model,
               execution=execution)
    return dataclasses.replace(spec, **overrides) if overrides else spec


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


class Runner:
    """What every runner shares: ``save`` writes a checkpoint that embeds
    the originating spec under ``extra["spec"]``, so
    :func:`load_checkpoint` rebuilds the experiment."""
    spec: Optional[ExperimentSpec] = None

    def save(self, path, state, step: int = 0,
             extra: Optional[dict] = None) -> pathlib.Path:
        meta = dict(extra or {})
        if self.spec is not None:
            meta["spec"] = self.spec.to_dict()
        return ckpt.save_state(path, state, step=step, extra=meta)


class DenseRunner(Runner):
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
        return tree.leaves(self.X0)[0].device

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
        self.last_report = build_report(
            name=self.spec.name if self.spec else "dense", engine="dense",
            device=self.device, steps=num_steps, total_s=sp.elapsed_s,
            bits_per_step=self.bits_per_step(),
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


def default_oracle_spec(spec: ExperimentSpec) -> OracleSpec:
    """``spec.oracle``, or what an engine falls back on without one: the
    small natural-shape ``logreg2d`` on the netsim engine, the paper-scale
    flat ``logreg`` on the dense one (the reference's convention)."""
    if spec.oracle is not None:
        return spec.oracle
    return OracleSpec(problem="logreg2d"
                      if spec.execution.engine == "netsim" else "logreg")


def _oracle_and_problem(spec: ExperimentSpec, device, dtype):
    osp = default_oracle_spec(spec)
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


class NetsimRunner(Runner):
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
        return tree.leaves(self.X0)[0].device

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
        self.last_report = build_report(
            name=sp.name if sp else "netsim", engine="netsim",
            device=self.device, steps=traj.steps, total_s=tsp.elapsed_s,
            bits_per_step=(traj.total_bits / traj.steps if traj.steps
                           else 0.0),
            bits_total=traj.total_bits, scope="system", meters=meters,
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


class TrainerRunner(Runner):
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
        if draws is None:             # a rank: its own and shared streams
            draws = tp_rank_draws(self.trainer.tp, sp.seed if sp else 0,
                                  self.device, self.trainer.process_mesh)
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
        mean_step = tsp.elapsed_s / num_steps if num_steps else 0.0
        self.last_report = build_report(
            name=sp.name if sp else "trainer", engine="sharded",
            device=self.device, steps=num_steps, total_s=tsp.elapsed_s,
            bits_per_step=self.bits_per_step(state), meters=meters,
            roofline=self._wire_roofline(state, mean_step),
            extra={"backend": tcfg.backend, "wire_mode": tcfg.wire_mode,
                   "meters": meters.as_dict()})
        return state, logs

    def _wire_roofline(self, state, mean_step_s: float) -> dict:
        """Kernel/wire roofline of the bucketed neighbor wire
        (:func:`repro_torch.obs.roofline_gate.step_roofline`; empty when
        this trainer has no bucket layout to price: the dense backend, the
        per-leaf wire, identity compression)."""
        tr = self.trainer
        if tr.plan is None or isinstance(tr.compressor, Identity) \
                or tr.tcfg.wire_mode != "bucketed":
            return {}
        layout, model = trainer_wire_layout(tr, tree.leaves(state.plead.X))
        return step_roofline(layout, hops=len(tr.plan.hops), shards=model,
                             measured_step_s=mean_step_s or None)

    def bits_per_step(self, state=None) -> float:
        """Exact bits ONE node ships per train step.  Neighbor/ring: hops x
        the per-edge u8 wire payload (``netsim.metrics.{bucketed,
        sharded}_payload_bits``: on a model-sharded mesh, a node's M
        shard payloads).  Dense: ideal per-edge payload x W
        out-degree.  Without a state the count comes from the parameter
        shapes alone (``meta`` tensors, nothing allocated)."""
        tr = self.trainer
        if tr.plan is not None and (state is not None or tr.tp.M > 1):
            leaves = tree.leaves((state or tr.abstract_state()).plead.X)
        elif state is not None and not tr.splits:
            leaves = tree.leaves(state.plead.X)
        else:                         # a node's whole leaves, by shape
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
            family=cfg.family, n_vision_tokens=cfg.n_vision_tokens,
            d_model=cfg.d_model, dtype=cfg.dtype, device=str(self.device))


def trainer_config_from_spec(spec: ExperimentSpec) -> dec.TrainerConfig:
    """Map an ExperimentSpec onto TrainerConfig, strictly: spec entries
    that map onto no TrainerConfig field raise (the reference's rule).
    The schedule's
    ``rounds`` and ``drop`` and the spec's ``fault_seed`` map onto
    ``schedule_rounds``, ``schedule_drop`` and ``fault_seed``; one
    ``linkdrop`` fault onto ``drop_rate``; the model's
    :data:`MODEL_TRAINER_PARAMS` onto their own fields."""
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
    for k in MODEL_TRAINER_PARAMS:
        if spec.model is not None and k in spec.model.params:
            kw[k] = spec.model.params[k]
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
            if k not in tc_fields:
                raise ValueError(
                    f"{where} param {k!r} has no TrainerConfig field; the "
                    f"trainer understands {sorted(tc_fields)}")
            kw[k] = v
    return dec.TrainerConfig(**kw)


def spec_mesh(spec: ExperimentSpec) -> Optional[Mesh]:
    """The spec's ``execution.mesh`` as a logical mesh: (data, model), or
    (pod, data, model) for three dims."""
    shape = spec.execution.mesh
    if shape is None:
        return None
    names = {1: ("data",), 2: ("data", "model"),
             3: ("pod", "data", "model")}.get(len(shape))
    if names is None:
        raise ValueError(f"spec {spec.name!r}: mesh {shape} has "
                         f"{len(shape)} dims; have 1-3")
    return Mesh(shape, names)


def build_trainer_runner(spec: ExperimentSpec, *, device,
                         dtype: Optional[torch.dtype] = None,
                         model_cfg: Optional[TR.ModelConfig] = None,
                         pp=None, process_mesh=None, tp=None, ag=None
                         ) -> TrainerRunner:
    """The sharded engine on ``device``, with an optional prebuilt
    ModelConfig, exchange seam ``pp`` (default: the one-card
    :func:`repro_torch.optim.wire.stacked_pp`, or :class:`repro_torch.
    optim.wire.DistPP` over ``process_mesh``'s node axis),
    ``process_mesh`` (a :class:`repro_torch.launch.mesh.ProcessMesh`: this
    rank's node block of a ``torch.distributed`` group; or a
    :class:`~repro_torch.launch.mesh.TPProcessMesh`: its node block and
    model rank, a tensor-parallel node over ranks) and ``tp`` (the
    tensor-parallel seam, ``repro_torch.models.tp``: ``StackedTP(M)`` runs
    a node's M model ranks in this process; default ``DistTP`` over a
    TPProcessMesh, else a node's products run whole) and ``ag`` (the dense
    backend's node-axis all-gather seam: default :class:`repro_torch.optim.
    wire.DistAG` over ``process_mesh``'s node axis, else the one-process
    seam).  The spec's mesh sets the model shards of the bucketed wire
    and the tp seam's M.  At M > 1 every family builds (RWKV-6 where M
    divides its heads), on either backend and wire mode."""
    if model_cfg is None:
        if spec.model is None:
            raise ValueError(
                "engine='sharded' needs a ModelSpec (spec.model)")
        model_cfg = spec.model.build()
    if dtype is not None:
        model_cfg = dataclasses.replace(model_cfg, dtype=dtype)
    if _fills_the_card(model_cfg, spec.n_nodes, device):
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    trainer = dec.DecentralizedTrainer(
        model_cfg, trainer_config_from_spec(spec), device=device, pp=pp,
        mesh=spec_mesh(spec), process_mesh=process_mesh, tp=tp, ag=ag)
    return TrainerRunner(trainer, spec=spec)


#: state-sized tables the sharded update holds at its peak (X, D, H, Hw,
#: z, the wire's rows, codes and mixes): deepseek-moe-16b.ring4 peaks at
#: 66.5 GiB, 8.1 tables of 8.2 GiB
UPDATE_TABLES = 8


def _fills_the_card(model_cfg: TR.ModelConfig, n_nodes: int, device) -> bool:
    """Whether the update's state-sized tables take over three quarters
    of the card ``device``.  The caching allocator's fixed segments then
    fragment past what the card holds (deepseek-moe-16b.ring4 on an H100
    was refused 8.45 GiB with 12.9 GiB free in pieces), so the trainer lets
    segments grow; below that it keeps fixed ones, under which
    whisper-large-v3.ring8 on an H100 steps 1.3 ms faster."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return False
    table = n_nodes * model_cfg.param_count() * model_cfg.dtype.itemsize
    return UPDATE_TABLES * table > 0.75 * torch.cuda.get_device_properties(
        dev).total_memory


@registry.register_engine("sharded")
def _build_sharded(spec: ExperimentSpec, device, dtype) -> TrainerRunner:
    return build_trainer_runner(spec, device=device, dtype=dtype)


def build(spec, *, device=None, dtype: Optional[torch.dtype] = None):
    """Resolve a spec into a runner on ``device`` (default: the card; raises
    without one).  An ExperimentSpec builds its ``execution.engine``; a
    SweepSpec the grid engine (``repro_torch.sweep.SweepRunner``, map
    mode).  ``dtype``: the dense and netsim engines' state and data
    (default f32); the sharded engine's parameters (default: the model
    config's)."""
    if hasattr(spec, "axes"):          # a SweepSpec (also as __main__'s)
        from repro_torch import sweep as _sweep    # noqa: F401 (registers)
        engine = "sweep"
    else:
        engine = spec.execution.engine
    return registry.make("engine", engine, spec=spec,
                         device=resolve_device(device), dtype=dtype)


# ===========================================================================
# Checkpoints embed the spec
# ===========================================================================

def _template_state(runner, device):
    """An initial state of ``runner``: the structure a checkpoint restores
    into (a dense or netsim run's draws do not matter here)."""
    if isinstance(runner, TrainerRunner):
        return runner.init_state()
    return runner.init_state(GeneratorDraws(0, device))


def load_checkpoint(path, step: Optional[int] = None, *, device=None,
                    dtype: Optional[torch.dtype] = None):
    """Rebuild the runner from the spec a checkpoint embeds, on ``device``
    (default: the card; raises without one), and restore its state into
    the structure of the runner's initial state: -> (runner, state, step).
    A dense or trainer run continues bit for bit from the restored state
    (the trainer's step index resumes from it); a netsim runner's fault
    stream starts afresh with ``init_state``."""
    if step is None:
        step = ckpt.latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint manifests under {path}")
    manifest = ckpt.load_manifest(path, step)
    spec_dict = (manifest.get("extra") or {}).get("spec")
    if spec_dict is None:
        raise ValueError(
            f"checkpoint {path} (step {step}) embeds no ExperimentSpec; "
            f"re-save through Runner.save or pass the spec explicitly")
    spec = ExperimentSpec.from_dict(spec_dict)
    if dtype is None and spec.execution.engine != "sharded":
        # the run's dtype: that of its first floating leaf
        dtype = next((getattr(torch, d) for d in manifest["dtypes"]
                      if d.startswith(("float", "bfloat"))), None)
    runner = build(spec, device=device, dtype=dtype)
    template = _template_state(runner, runner.device)
    state = ckpt.load_state(path, template, step=step)
    return runner, state, step


# ===========================================================================
# Golden-spec gate
# ===========================================================================

def check_spec_file(path, *, device=None):
    """Round-trip one spec file through JSON and build it on ``device``;
    raises on any failure.  A JSON object with a ``base`` key is a SweepSpec
    (its build checks the axis plan), anything else an ExperimentSpec."""
    text = pathlib.Path(path).read_text()
    cls = SweepSpec if "base" in json.loads(text) else ExperimentSpec
    spec = cls.from_json(text)
    again = cls.from_json(spec.to_json())
    if spec != again:
        detail = spec.diff(again) if cls is ExperimentSpec else ""
        raise ValueError(f"{path}: spec does not round-trip through JSON; "
                         f"diff: {detail}")
    build(spec, device=device)
    return spec


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api",
        description="spec utilities: the golden-spec round-trip and build "
                    "gate, spec diffing")
    ap.add_argument("--check", default=None, metavar="DIR_OR_JSON",
                    help="round-trip and build every *.json under the path")
    ap.add_argument("--diff", nargs=2, default=None, metavar=("A", "B"),
                    help="print the field-level diff of two spec files")
    ap.add_argument("--device", default=None,
                    help="where --check builds (default: the card)")
    args = ap.parse_args(argv)
    if args.diff:
        a = ExperimentSpec.load(args.diff[0])
        b = ExperimentSpec.load(args.diff[1])
        for k, (va, vb) in a.diff(b).items():
            print(f"{k}: {va!r} -> {vb!r}")
        return 0
    if args.check:
        root = pathlib.Path(args.check)
        files = sorted(root.glob("*.json")) if root.is_dir() else [root]
        if not files:
            print(f"[spec-check] FAIL: no spec files under {root}")
            return 1
        for f in files:
            spec = check_spec_file(f, device=args.device)
            if hasattr(spec, "axes"):
                print(f"[spec-check] OK {f.name}: {spec.name} (sweep of "
                      f"{spec.n_points} points over "
                      f"{[a.path for a in spec.axes]}, "
                      f"engine={spec.base.execution.engine})")
            else:
                print(f"[spec-check] OK {f.name}: {spec.name} "
                      f"(engine={spec.execution.engine}, "
                      f"algo={spec.algorithm.name}, "
                      f"compressor={spec.compressor.name})")
        print(f"[spec-check] {len(files)} golden specs round-trip and "
              f"build")
        return 0
    ap.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(_main())
