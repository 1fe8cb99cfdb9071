"""RunReport: the record every ``Runner.run`` leaves on ``last_report``.

The port's minimal form of ``repro.obs.report``: what ran, where, for how
many steps and how long (fenced wall clock, ``obs.trace.span``), and the
exact bits per step (``netsim.metrics``): what one node sends
(``scope='node'``: the dense and sharded engines) or what the whole system
moved (``scope='system'``: the netsim engine's fault-exact count).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


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

    @property
    def s_per_step(self) -> float:
        return self.total_s / self.steps if self.steps else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return dict(dataclasses.asdict(self), s_per_step=self.s_per_step)
