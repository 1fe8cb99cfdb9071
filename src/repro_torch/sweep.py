"""Grids of experiments on one card: the sweep engine.

The port of ``repro.sweep``.  The paper's results are grids -- algorithm
x bits x oracle x seed -- and a :class:`repro_torch.api.SweepSpec` (a base
spec plus axes) describes one::

    spec   = api.SweepSpec("grid", base, axes=(
                 api.AxisSpec("seed", (0, 1, 2, 3)),
                 api.AxisSpec("compressor.bits", (2, 4))))
    runner = api.build(spec)                     # SweepRunner, on the card
    final, result = runner.run()
    runner.point_state(final, i)                 # point i's final state

Supported axes (:data:`SUPPORTED_AXES`; the grid is the cartesian product,
later axes fastest): ``seed`` (the point's draw stream; the problem data
is shared), ``fault_seed`` (netsim fault draws), the constant and harmonic
fields of ``algorithm.{eta|alpha|gamma}[.value|.t0]``, any numeric
``algorithm.params.<field>``, and ``compressor.bits`` (QInf; payload
shapes do not depend on the bits).  Engines ``dense`` and ``netsim``; a
sharded grid is refused (run its points as separate trainer runs).

Two batch modes.

``batch='map'`` (the default) runs the points one after another, each
with the algorithm ``api.build(point)`` builds (sharing the template's
problem, data, mixer and oracle: the same construction inputs) and the
draw stream its serial run uses -- ``GeneratorDraws(point.seed)`` for the
dense engine, and on the netsim engine the same plus a SimMixer whose
faults draw from ``GeneratorDraws(point.fault_seed)``.  Every point is
therefore bit for bit ``api.build(point).run()``: final state, and for
netsim the consensus, objective and int64 bits of every round.  Recorded
metrics stay on the device until the last step; final states are stacked
leaf by leaf on a leading point axis.

``batch='vmap'`` is the card's throughput mode (the reference's name; the
mechanism here is stacking): every state leaf gains a leading point axis
(P, n, ...), the per-point scalars become (P,) f64 operands (``eta``,
``alpha``, ``gamma``; a harmonic schedule as ``vt0 / (k + t0)`` with
``vt0`` the host-double product ``value * t0``; any numeric
``algorithm.params`` field such as Choco's ``gamma_c`` or LessBit's
``theta``), each viewed at the rank of the leaf it scales, (P, 1, ...,
1), and rounded once to its dtype where it is used (``core.comm.coef``),
and one step of the template's algorithm advances every point: the
mixer contracts the node axis for all points in one batched product, the
oracle folds the points into one sampled-gradient call
(``Oracle.over_points``), RandK and TopK compress each point's slice
(``Compressor.over_points``), and each step launches B1 and B2 once a
leaf for the whole grid -- a ``compressor.bits`` axis through B1's
per-point level count.  Each point still draws from its own stream
(``core.draws.StackedDraws``) and starts from its serial init.  On the
netsim engine one SimMixer serves the grid (``SimMixer.stacked``): the
schedule is shared, each point's faults draw from its own
``fault_seed`` stream, and the records -- consensus, objective and the
int64 bits priced by each point's own compressor -- are one a point every
round.  Every registered algorithm, oracle and compressor stacks, and
every axis of :data:`SUPPORTED_AXES`.  Stacked products may sum in
another order than a point's own, so this mode is held to a tolerance
(rtol = atol = 1e-12 in f64 on the CPU), not to bits; netsim bits stay
exact.  Both modes take a tree-valued iterate (a dict of leaves, as
JAX's pytrees, ``repro_torch.tree``): in vmap mode every leaf gains the
point axis and takes each operand at its own rank, and the leaves must
share one dtype.
"""
from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import api, registry
from repro_torch.core.compression import Compressor
from repro_torch.core.draws import GeneratorDraws, StackedDraws
from repro_torch.kernels import ops as kops
from repro_torch.netsim import engine as netsim_engine
from repro_torch.netsim import metrics as netsim_metrics
from repro_torch.obs import Meters, build_report, span, using_meters
from repro_torch.tree import leaves

# ===========================================================================
# Operand plan: how the points differ
# ===========================================================================

_SCHED_RE = re.compile(r"^algorithm\.(eta|alpha|gamma)(\.value|\.t0)?$")
_PARAM_RE = re.compile(r"^algorithm\.params\.(\w+)$")

SUPPORTED_AXES = (
    "seed", "fault_seed",
    "algorithm.{eta|alpha|gamma}[.value|.t0]",
    "algorithm.params.<numeric field>",
    "compressor.bits",
)


@dataclasses.dataclass
class _Plan:
    """How a list of point specs differ.

    ``operands``  name -> (P,) array: the scalar axes' values (f64) and
                  the level counts 2^{b-1} of a bits axis (f32).
    ``sched``     algorithm field ("eta", ...) -> the base ScheduleSpec,
                  for the fields whose value or t0 varies.
    ``params``    varying algorithm-dataclass fields.
    ``bits``      whether compressor.bits varies.
    ``varying``   every dotted path that differs across points.
    """
    operands: Dict[str, np.ndarray]
    sched: Dict[str, Any]
    params: Tuple[str, ...]
    bits: bool
    varying: frozenset


def plan_points(points: Sequence) -> _Plan:
    """Classify how ``points`` differ and stack their per-point operands.
    Raises ``ValueError`` for a difference outside :data:`SUPPORTED_AXES`:
    grid points share everything but the axis values."""
    base = points[0]
    varying = set()
    for p in points[1:]:
        varying |= set(base.diff(p))
    varying.discard("name")                       # labels are free to differ

    operands: Dict[str, np.ndarray] = {}
    sched: Dict[str, Any] = {}
    params: List[str] = []
    bits = False
    for path in sorted(varying):
        if path in ("seed", "fault_seed"):
            if path == "fault_seed" and base.execution.engine != "netsim":
                raise ValueError("fault_seed axis: netsim engine only")
        elif _SCHED_RE.match(path):
            field = _SCHED_RE.match(path).group(1)
            sched[field] = getattr(base.algorithm, field)
        elif _PARAM_RE.match(path):
            name = _PARAM_RE.match(path).group(1)
            vals = [p.algorithm.params.get(name) for p in points]
            if not all(isinstance(v, (int, float)) and not isinstance(v, bool)
                       for v in vals):
                raise ValueError(
                    f"axis {path!r}: only numeric algorithm params sweep, "
                    f"set on EVERY point (got {vals!r})")
            operands[f"param:{name}"] = np.asarray(vals, np.float64)
            params.append(name)
        elif path == "compressor.params.bits":
            if base.compressor.name != "qinf":
                raise ValueError(
                    f"compressor.bits axis needs a 'qinf' base compressor "
                    f"(got {base.compressor.name!r}: payload shapes must be "
                    f"bit-width independent)")
            bvals = [int(p.compressor.params.get("bits", 2)) for p in points]
            if not all(1 <= b <= 8 for b in bvals):
                raise ValueError(f"compressor.bits axis: bits must be in "
                                 f"1..8, got {sorted(set(bvals))}")
            # 2^{b-1} is exact in f32 for every b
            operands["levels"] = np.asarray(
                [float(2 ** (b - 1)) for b in bvals], np.float32)
            bits = True
        else:
            raise ValueError(
                f"unsupported sweep axis {path!r}; grid points may differ "
                f"only in {SUPPORTED_AXES}")

    # schedule fields: value * t0 is the host-double product, so a stacked
    # harmonic vt0 / (k + t0) reproduces the serial v * t0 / (k + t0)
    for field, base_sched in sched.items():
        kinds = {getattr(p.algorithm, field).kind for p in points}
        if len(kinds) > 1:
            raise ValueError(f"axis algorithm.{field}: schedule *kind* must "
                             f"not vary across points (got {sorted(kinds)})")
        ss = [getattr(p.algorithm, field) for p in points]
        if base_sched.kind == "constant":
            operands[f"{field}:value"] = np.asarray([s.value for s in ss],
                                                    np.float64)
        elif base_sched.kind == "harmonic":
            operands[f"{field}:vt0"] = np.asarray(
                [s.value * s.t0 for s in ss], np.float64)
            operands[f"{field}:t0"] = np.asarray([s.t0 for s in ss],
                                                 np.float64)
        else:
            raise ValueError(f"axis algorithm.{field}: unknown schedule "
                             f"kind {base_sched.kind!r}")
    return _Plan(operands, sched, tuple(params), bits, frozenset(varying))


# ===========================================================================
# Stacked states
# ===========================================================================

def stack_states(states: Sequence):
    """Per-point states of one structure -> one state whose tensors carry
    a leading point axis; ints (the iteration) must agree and stay ints,
    None stays None."""
    first = states[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(stack_states([getattr(s, f) for s in states])
                             for f in first._fields))
    if isinstance(first, dict):
        return {k: stack_states([s[k] for s in states]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_states(list(v)) for v in zip(*states))
    if first is None:
        return None
    if isinstance(first, int):
        if any(s != first for s in states):
            raise ValueError(f"points disagree on an integer field: "
                             f"{sorted(set(states))}")
        return first
    return torch.stack(list(states))


def point_state(state, i: int):
    """Point ``i`` of a stacked state."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(point_state(getattr(state, f), i)
                             for f in state._fields))
    if isinstance(state, dict):
        return {k: point_state(v, i) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(point_state(v, i) for v in state)
    if state is None or isinstance(state, int):
        return state
    return state[i]


# ===========================================================================
# The per-point-bits QInf of a stacked grid
# ===========================================================================

class PointLevelsQInf(Compressor):
    """QInf over a stacked grid whose points differ in bits: the stacked
    leaf (P, n, ...) is quantized in one B1 launch, point p at its own
    level count ``levels[p]`` = 2^{b_p - 1} (a (P,) f32 tensor on the
    run's device), with the noise drawn on the blocked shape as QInf draws
    it; B2 decodes every point at once (the scales carry the level
    counts).  Point by point the codes and scales are those of QInf at the
    point's bits."""
    name = "qinf_point_levels"
    rowwise = True

    def __init__(self, levels: torch.Tensor, block: int):
        self.levels = levels
        self.block = block

    def compress(self, x, draws):
        u = draws.uniform(kops.blockwise_shape(x.shape, self.block))
        codes, scales = kops.qinf_quantize_lastdim(
            x, u, block=self.block, levels=self.levels)
        return {"codes": codes, "scales": scales}

    def decompress(self, payload, shape, dtype):
        return kops.qinf_dequantize_lastdim(
            payload["codes"], payload["scales"], shape, dtype,
            block=self.block)


# ===========================================================================
# SweepRunner
# ===========================================================================

class SweepResult:
    """The host-side record of one sweep run.  ``metrics``: name -> (P,
    records) array -- a netsim grid's ``consensus`` and ``objective``
    (f64) and ``bits`` (int64, exact) every round; a dense grid's optional
    ``metric`` (f64)."""

    def __init__(self, names: Sequence[str], metrics: Dict[str, np.ndarray],
                 wall_s: float, meta: Optional[dict] = None,
                 point_s: Optional[Sequence[float]] = None):
        self.names = list(names)
        self.metrics = metrics
        self.wall_s = wall_s
        self.meta = dict(meta or {})
        #: fenced seconds of each point's run (map mode: its own span;
        #: vmap mode: the grid's share)
        self.point_s = (list(point_s) if point_s is not None
                        else [wall_s / max(len(self.names), 1)] * len(
                            self.names))

    @property
    def n_points(self) -> int:
        return len(self.names)

    def trajectory(self, i: int) -> netsim_metrics.Trajectory:
        """Point ``i`` as a netsim Trajectory (netsim grids only)."""
        if "bits" not in self.metrics:
            raise ValueError("trajectory(): netsim sweep results only")
        return netsim_metrics.Trajectory(
            consensus=self.metrics["consensus"][i],
            objective=self.metrics["objective"][i],
            bits=self.metrics["bits"][i],
            meta={**self.meta, "point": self.names[i]})


class SweepRunner:
    """A grid of points on one device (see the module docstring).

    ``init_state(draws)`` runs every point's serial init, each from its
    own stream of the :class:`StackedDraws` ``draws`` (default
    :meth:`point_draws`), and stacks the states; ``step(state, draws)``
    advances every point one step (map: point by point; vmap: one stacked
    step); ``run`` is the whole grid from its inits."""

    def __init__(self, points: Sequence, *, name: str = "sweep", spec=None,
                 batch: str = "map", device=None,
                 dtype: Optional[torch.dtype] = None, template=None):
        if not points:
            raise ValueError("sweep needs at least one grid point")
        if batch not in ("map", "vmap"):
            raise ValueError(f"batch must be 'map' or 'vmap', got {batch!r}")
        self.points = list(points)
        self.name = name
        self.spec = spec                   # the SweepSpec, when built from one
        self.batch = batch
        base = self.points[0]
        engine = base.execution.engine
        if engine == "sharded":
            raise ValueError(
                "engine='sharded' sweeps are not supported: the trainer's "
                "state is one run's, not batchable -- run sharded grid "
                "points as separate runs (repro_torch.launch.train)")
        if engine not in ("dense", "netsim"):
            raise ValueError(f"sweep supports dense|netsim engines, "
                             f"got {engine!r}")
        self.engine = engine
        self.plan = plan_points(self.points)
        if engine == "netsim" and "seed" in self.plan.varying \
                and "seed" in registry.accepts("schedule",
                                               base.topology.schedule):
            raise ValueError(
                f"seed axis with the seed-dependent "
                f"{base.topology.schedule!r} schedule: the netsim sweep "
                f"shares ONE materialized schedule stack across points; "
                f"sweep fault_seed instead, or run seeds serially")
        # the template: problem, data, X0, mixer, oracle (and the netsim
        # schedule and faults) built once and shared by every point
        self._template = (template if template is not None
                          else api.build(base, device=device, dtype=dtype))
        dtypes = {leaf.dtype for leaf in leaves(self._template.X0)}
        if batch == "vmap" and len(dtypes) > 1:
            raise ValueError(
                f"batch='vmap' over an iterate whose leaves mix dtypes "
                f"({sorted(map(str, dtypes))}): the stacked products take "
                f"one dtype; cast the problem's X0 to one")
        if batch == "vmap" and dtypes != {torch.float64}:
            warnings.warn(
                f"batch='vmap' in {dtypes.pop()}: the stacked products (the "
                f"mixer's batched GEMM, the folded gradients) may sum in "
                f"another order than a point's own, so points agree with "
                f"their serial runs to a tolerance, not bit for bit (the "
                f"per-point scalars are formed in f64 and rounded once, as "
                f"the host's are)", stacklevel=2)
        self.base = base
        self.device = self._template.device
        self.last_report = None
        self._algos: Optional[List] = None
        self._stacked = None

    @property
    def n_points(self) -> int:
        return len(self.points)

    @property
    def X0(self):
        """The initial iterate every point starts from (the template's)."""
        return self._template.X0

    @property
    def problem(self):
        """The problem (and data) every point shares (the template's)."""
        return self._template.problem

    def with_batch(self, batch: str) -> "SweepRunner":
        """The same grid in the other batch mode, sharing this runner's
        template (problem, data, mixer, oracle)."""
        return SweepRunner(self.points, name=self.name, spec=self.spec,
                           batch=batch, template=self._template)

    # --- per-point algorithms and draws -------------------------------------
    def _point_algo(self, p):
        """Point ``p``'s algorithm as ``api.build(p)`` makes it, over the
        template's mixer and oracle (the same construction inputs)."""
        t = self._template
        return api.build_algorithm(p, t.algo.mixer, t.algo.oracle)

    def point_draws(self) -> StackedDraws:
        """Every point's draw stream as its serial run makes it: a
        generator seeded ``point.seed`` on the run's device."""
        return StackedDraws([GeneratorDraws(p.seed, self.device)
                             for p in self.points])

    def point_fault_draws(self) -> StackedDraws:
        """Every point's fault stream as its serial run makes it: a
        generator seeded ``point.fault_seed`` on the run's device."""
        return StackedDraws([GeneratorDraws(p.fault_seed, self.device)
                             for p in self.points])

    def point_algos(self, fault_draws: Optional[StackedDraws] = None
                    ) -> List:
        """Each point's algorithm for a run; on the netsim engine over a
        fresh SimMixer whose faults draw from ``fault_draws.points[i]``
        (default :meth:`point_fault_draws`: a new fault stream, as
        ``NetsimRunner.init_state`` starts one)."""
        algos = [self._point_algo(p) for p in self.points]
        if self.engine == "netsim":
            t = self._template
            srcs = (fault_draws or self.point_fault_draws()).points
            algos = [dataclasses.replace(a, mixer=netsim_engine.SimMixer(
                t.schedule, t.faults, src)) for a, src in zip(algos, srcs)]
        return algos

    def _ops(self, name: str) -> torch.Tensor:
        """A per-point operand, (P,) f64 on the run's device; each use
        views it at the rank of the leaf it scales (``core.comm.coef``)."""
        return torch.as_tensor(self.plan.operands[name], dtype=torch.float64,
                               device=self.device)

    def stacked_algo(self):
        """The template's algorithm over the stacked grid (``batch=
        'vmap'``): per-point operands bound to the fields its factory
        takes and to the swept ``algorithm.params`` fields (as the
        reference's ``_bind_algo``), the oracle and the compressor over
        the points (for a bits axis :class:`PointLevelsQInf`), and the
        mixer over the node axis behind the point axis -- on the netsim
        engine the points' own mixers stacked (``SimMixer.stacked``), so
        it needs :meth:`init_state` first."""
        t = self._template
        P = self.n_points
        accepted = registry.accepts("algorithm", self.base.algorithm.name)
        repl = {}
        for field, base_sched in self.plan.sched.items():
            if field not in accepted:      # e.g. NIDS fixes alpha, gamma
                continue
            if base_sched.kind == "constant":
                repl[field] = self._ops(f"{field}:value")
            else:
                vt0, t0 = self._ops(f"{field}:vt0"), self._ops(f"{field}:t0")
                repl[field] = (lambda vt0, t0: lambda k: vt0 / (k + t0))(
                    vt0, t0)
        for name in self.plan.params:
            repl[name] = self._ops(f"param:{name}")
        comp = getattr(t.algo, "compressor", None)
        if comp is not None and self.plan.bits:
            levels = torch.as_tensor(self.plan.operands["levels"],
                                     device=self.device)
            repl["compressor"] = PointLevelsQInf(levels, comp.block)
        elif comp is not None:
            repl["compressor"] = comp.over_points(P)
        if self.engine == "netsim":
            if self._algos is None:
                raise RuntimeError("a stacked netsim grid continues its "
                                   "points' fault streams: init_state first")
            mixer = netsim_engine.SimMixer.stacked(
                [a.mixer for a in self._algos])
        else:
            mixer = dataclasses.replace(t.algo.mixer, node_axis=1)
        return dataclasses.replace(t.algo, mixer=mixer,
                                   oracle=t.algo.oracle.over_points(P),
                                   **repl)

    # --- the runner protocol -------------------------------------------------
    def init_state(self, draws: Optional[StackedDraws] = None,
                   fault_draws: Optional[StackedDraws] = None):
        """Every point's serial init (from ``draws.points[i]``; default
        :meth:`point_draws`), stacked.  Starts a run: the netsim points'
        fault streams (``fault_draws``, default :meth:`point_fault_draws`)
        start here, and ``step`` continues them."""
        if draws is None:
            draws = self.point_draws()
        self._algos = self.point_algos(fault_draws)
        X0 = self._template.X0
        states = [a.init(X0, d) for a, d in zip(self._algos, draws.points)]
        if self.batch == "vmap":
            self._stacked = self.stacked_algo()
        return stack_states(states)

    def step(self, state, draws: StackedDraws):
        """One step of every point: point i draws from ``draws.points[i]``
        (map mode), or the grid takes one stacked step from ``draws``
        (vmap mode)."""
        if self._algos is None:
            raise RuntimeError("SweepRunner.step needs init_state first: it "
                               "starts the run")
        if self.batch == "vmap":
            return self._stacked.step(state, draws)
        return stack_states([a.step(point_state(state, i), d)
                             for i, (a, d) in enumerate(
                                 zip(self._algos, draws.points))])

    @property
    def metrics_fns(self) -> Dict[str, Callable]:
        return {"consensus": lambda st: netsim_metrics.consensus_error(
                    st.X, node_axis=1),
                "iteration": lambda st: st.k}

    def point_state(self, state, i: int):
        """Point ``i`` of a stacked state."""
        return point_state(state, i)

    def run(self, *, num_steps: Optional[int] = None,
            metric_fn: Optional[Callable] = None,
            objective_fn: Optional[Callable] = None, metric_every: int = 1,
            draws: Optional[StackedDraws] = None,
            fault_draws: Optional[StackedDraws] = None):
        """The whole grid from its inits: -> (stacked final states,
        :class:`SweepResult`).  ``draws`` (default :meth:`point_draws`)
        and, on the netsim engine, ``fault_draws`` (default: generators
        seeded each point's ``fault_seed``) are the points' streams.

        dense  -- ``metric_fn(point state) -> 0-d tensor`` recorded after
                  the steps t (0-based) with ``t % metric_every == 0`` and
                  after the last one, into ``result.metrics['metric']``.
        netsim -- each point's ``simulate`` record (consensus, objective
                  via ``objective_fn``, int64 bits) every round.
        Records stay on the device until the last step."""
        if num_steps is None:
            num_steps = self.base.steps
        meters = Meters()
        meta: Dict[str, Any] = {}
        with using_meters(meters), span("run_total", self.device) as tsp:
            if self.engine == "netsim":
                final, metrics, point_s = self._run_netsim(
                    num_steps, objective_fn, draws, fault_draws)
                t = self._template
                meta = {"schedule": t.schedule.name,
                        "T_cycle": t.schedule.T_cycle,
                        "faults": [f.name for f in t.faults]}
            else:
                final, metrics, point_s = self._run_dense(
                    num_steps, metric_fn, metric_every, draws)
        result = SweepResult([p.name for p in self.points], metrics,
                             tsp.elapsed_s, meta, point_s)
        meters.set("sweep/points", self.n_points)
        bits_total = (float(metrics["bits"].sum()) if "bits" in metrics
                      else 0.0)
        self.last_report = build_report(
            name=self.name, engine="sweep", device=self.device,
            steps=num_steps, total_s=tsp.elapsed_s,
            bits_per_step=bits_total / num_steps if num_steps else 0.0,
            bits_total=bits_total, scope="system", meters=meters,
            extra={"points": self.n_points, "base_engine": self.engine,
                   "batch": self.batch})
        return final, result

    def _run_dense(self, num_steps, metric_fn, metric_every, draws):
        logged = {t for t in range(num_steps)
                  if t % metric_every == 0 or t == num_steps - 1}
        if draws is None:
            draws = self.point_draws()
        recs: List[List[torch.Tensor]] = [[] for _ in self.points]
        point_s = None
        if self.batch == "map":
            finals, point_s = [], []
            X0 = self._template.X0
            for i, (algo, d) in enumerate(zip(self.point_algos(),
                                              draws.points)):
                with span("point", self.device) as sp:
                    state = algo.init(X0, d)
                    for t in range(num_steps):
                        state = algo.step(state, d)
                        if metric_fn is not None and t in logged:
                            recs[i].append(metric_fn(state))
                finals.append(state)
                point_s.append(sp.elapsed_s)
            final = stack_states(finals)
        else:
            final = self.init_state(draws)
            for t in range(num_steps):
                final = self._stacked.step(final, draws)
                if metric_fn is not None and t in logged:
                    for i in range(self.n_points):
                        recs[i].append(metric_fn(point_state(final, i)))
        metrics = {}
        if metric_fn is not None:            # one copy, after the last step
            metrics["metric"] = torch.stack(
                [torch.stack(r) for r in recs]).cpu().to(
                    torch.float64).numpy()
        return final, metrics, point_s

    def _run_netsim(self, num_steps, objective_fn, draws, fault_draws):
        if self.batch == "vmap":
            return self._run_netsim_stacked(num_steps, objective_fn, draws,
                                            fault_draws)
        t = self._template
        finals, trajs, point_s = [], [], []
        for i, p in enumerate(self.points):
            with span("point", self.device) as sp:
                final, traj = netsim_engine.simulate(
                    self._point_algo(p), t.schedule, t.faults, X0=t.X0,
                    steps=num_steps, seed=p.seed, fault_seed=p.fault_seed,
                    objective_fn=objective_fn,
                    draws=draws.points[i] if draws else None,
                    fault_draws=fault_draws.points[i] if fault_draws
                    else None)
            finals.append(final)
            trajs.append(traj)
            point_s.append(sp.elapsed_s)
        metrics = {
            "consensus": np.stack([tr.consensus for tr in trajs]),
            "objective": np.stack([tr.objective for tr in trajs]),
            "bits": np.stack([tr.bits for tr in trajs]).astype(np.int64)}
        return stack_states(finals), metrics, point_s

    def _run_netsim_stacked(self, num_steps, objective_fn, draws,
                            fault_draws):
        """The stacked grid under ``simulate``'s record: every round's
        consensus, objective and int64 bits, one a point, priced by each
        point's own compressor as its serial run prices them."""
        t = self._template
        if draws is None:
            draws = self.point_draws()
        state = self.init_state(draws, fault_draws)
        algo = self._stacked
        bpe = torch.as_tensor(
            [netsim_metrics.payload_bits_per_node(
                getattr(a, "compressor", None), t.X0) for a in self._algos],
            dtype=torch.int64, device=self.device)
        step = netsim_engine.make_step_record(
            algo, algo.mixer, t.schedule, device=self.device,
            objective_fn=objective_fn, bits_per_edge=bpe)
        recs = []
        for _ in range(num_steps):
            state, rec = step(state, draws)
            recs.append(rec)
        if recs:                          # one copy to the host, at the end
            cons, obj, bits = (torch.stack(c, dim=1).cpu()
                               for c in zip(*recs))
        else:
            cons = obj = bits = torch.zeros((self.n_points, 0),
                                            dtype=torch.int64)
        return state, {
            "consensus": cons.to(torch.float64).numpy(),
            "objective": obj.to(torch.float64).numpy(),
            "bits": bits.numpy().astype(np.int64)}, None


def runner_for_points(points: Sequence, *, name: str = "sweep",
                      batch: str = "map", device=None,
                      dtype: Optional[torch.dtype] = None) -> SweepRunner:
    """A SweepRunner over an explicit list of point specs sharing one
    structure (how the paper harness batches its rows)."""
    return SweepRunner(points, name=name, batch=batch, device=device,
                       dtype=dtype)


def group_points(points: Sequence) -> List[List[int]]:
    """Partition spec indices into groups one runner can take: two points
    share a group iff they differ only along :data:`SUPPORTED_AXES` (the
    runner's own classifier).  Greedy and order-preserving."""
    groups: List[List[int]] = []
    for i, p in enumerate(points):
        for g in groups:
            try:
                plan_points([points[g[0]], p])
            except ValueError:
                continue
            g.append(i)
            break
        else:
            groups.append([i])
    return groups


# ===========================================================================
# Engine registration (api.build(SweepSpec) resolves through this)
# ===========================================================================

@registry.register_engine("sweep")
def _build_sweep(spec, device, dtype=None) -> SweepRunner:
    # duck-typed rather than isinstance: `python -m repro_torch.api` runs
    # the api module as __main__, whose SweepSpec class is another one
    if not (hasattr(spec, "base") and hasattr(spec, "points")):
        raise ValueError(
            "the sweep engine takes a SweepSpec (a base ExperimentSpec "
            "plus axes), not an ExperimentSpec with engine='sweep'")
    return SweepRunner(spec.points(), name=spec.name, spec=spec,
                       device=device, dtype=dtype)

