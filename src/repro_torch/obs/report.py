"""RunReport: the record every ``Runner.run`` leaves on ``last_report``.

The port's minimal form of ``repro.obs.report``: what ran, where, for how
many steps and how long (fenced wall clock, ``obs.trace.span``), and the
exact bits one node sends per step (``netsim.metrics``).
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

    @property
    def s_per_step(self) -> float:
        return self.total_s / self.steps if self.steps else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return dict(dataclasses.asdict(self), s_per_step=self.s_per_step)
