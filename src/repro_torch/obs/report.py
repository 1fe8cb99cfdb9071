"""RunReport: the record every ``Runner.run`` leaves on ``last_report``.

The port of ``repro.obs.report``: what ran, where, for how many steps and
how long (fenced wall clock, ``obs.trace.span``), and the exact bits per
step (``netsim.metrics``): what one node sends (``scope='node'``: the
dense and sharded engines) or what the whole system moved
(``scope='system'``: the netsim engine's fault-exact count and a sweep's
whole grid).  :func:`build_report` fills in the sections every engine
shares:

=========  ================================================================
env        :func:`repro_torch.obs.meters.env_info`: torch, CUDA, the
           device's name and power limit, CPU count.
timing     the measured mean step time beside the analytic time of the
           step's exact bits over one link of :data:`LINK_BW`
           (:func:`wire_breakdown`): at link speed, what share of a step
           communication would take.  An analytic split, not a profile.
wire       scope, bits per step and in all, and the wire gauges (bytes a
           hop, hops, collectives a step) of the run's meters.
meters     the run's :class:`~repro_torch.obs.meters.Meters` snapshot.
roofline   :func:`repro_torch.obs.roofline_gate.step_roofline` of the
           run's wire when the engine has a bucket layout to price (the
           neighbor trainer's bucketed wire with QInf), else empty.
extra      engine-specific fields (algo, schedule, points, ...).
=========  ================================================================
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, Optional

from repro_torch.obs.meters import Meters, env_info
from repro_torch.obs.roofline import LINK_BW


@dataclasses.dataclass
class RunReport:
    name: str
    engine: str
    device: str          # e.g. "cuda:0 (NVIDIA H100 80GB HBM3)" or "cpu"
    steps: int
    total_s: float
    bits_per_step: float
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    scope: str = "node"  # whose bits: one node's ("node") or all ("system")
    env: Dict[str, Any] = dataclasses.field(default_factory=dict)
    timing: Dict[str, float] = dataclasses.field(default_factory=dict)
    wire: Dict[str, Any] = dataclasses.field(default_factory=dict)
    meters: Dict[str, float] = dataclasses.field(default_factory=dict)
    roofline: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def s_per_step(self) -> float:
        return self.total_s / self.steps if self.steps else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return dict(dataclasses.asdict(self), s_per_step=self.s_per_step)

    def save(self, path) -> pathlib.Path:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_dict(), indent=1, default=str))
        return p


def device_label(device) -> str:
    """A run's device as a report names it: "cuda:0 (NVIDIA H100 80GB
    HBM3)" or "cpu"."""
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def wire_breakdown(total_s: float, steps: int,
                   bits_per_step: float) -> Dict[str, float]:
    """The compute-vs-wire split: measured mean step time against the
    analytic link time of the exact bits a step (see the module
    docstring)."""
    mean = total_s / steps if steps else 0.0
    wire_model = (bits_per_step / 8.0) / LINK_BW
    return {
        "total_s": float(total_s),
        "mean_step_s": mean,
        "wire_model_s_per_step": wire_model,
        "compute_residual_s_per_step": max(0.0, mean - wire_model),
        "wire_fraction_of_step": (min(1.0, wire_model / mean)
                                  if mean > 0 else 0.0),
    }


def build_report(*, name: str, engine: str, device, steps: int,
                 total_s: float, bits_per_step: float = 0.0,
                 bits_total: Optional[float] = None, scope: str = "node",
                 meters: Optional[Meters] = None,
                 roofline: Optional[Dict] = None,
                 extra: Optional[Dict] = None) -> RunReport:
    """A RunReport from a run's measured seconds and exact bit accounting,
    the shared sections filled in here, so every engine reports through
    one code path.  ``device``: the run's torch device."""
    import torch
    device = torch.device(device)
    m = meters.as_dict() if isinstance(meters, Meters) else dict(meters or {})
    wire = {
        "scope": scope,
        "bits_per_step": float(bits_per_step),
        "bits_total": float(bits_total if bits_total is not None
                            else bits_per_step * steps),
        "bytes_per_hop": m.get("wire/bytes_per_hop", 0),
        "hops": m.get("wire/hops", 0),
        "collectives_per_step": m.get("wire/collectives_per_step", 0),
    }
    return RunReport(
        name=name, engine=engine, device=device_label(device),
        steps=int(steps),
        total_s=float(total_s), bits_per_step=float(bits_per_step),
        extra=dict(extra or {}), scope=scope, env=env_info(device),
        timing=wire_breakdown(total_s, steps, bits_per_step), wire=wire,
        meters=m, roofline=dict(roofline or {}))
