"""repro_torch.netsim -- time-varying topologies and fault injection.

The port of ``repro.netsim``: per-iteration mixing matrices
(:mod:`~repro_torch.netsim.schedule`), composable communication faults
(:mod:`~repro_torch.netsim.faults`), the scenario loop with exact
bits-on-wire accounting (:mod:`~repro_torch.netsim.engine`) and trajectory
containers (:mod:`~repro_torch.netsim.metrics`).  Specs reach it through
``repro_torch.api.build`` with ``execution.engine = "netsim"``.
"""
from repro_torch.netsim.engine import SimMixer, simulate
from repro_torch.netsim.faults import (FaultModel, LinkDrop, NoisyChannel,
                                       Straggler, apply_edge_mask,
                                       effective_C, make_fault, make_faults,
                                       mean_edge_survival)
from repro_torch.netsim.metrics import (Trajectory, consensus_error,
                                        effective_bits_per_iter,
                                        payload_bits_per_node)
from repro_torch.netsim.schedule import (ScheduledMixer, TopologySchedule,
                                         alternating_schedule, make_schedule,
                                         markov_drop_schedule,
                                         random_matching_schedule,
                                         static_schedule)

__all__ = [
    "SimMixer", "simulate",
    "FaultModel", "LinkDrop", "NoisyChannel", "Straggler",
    "apply_edge_mask", "effective_C", "make_fault", "make_faults",
    "mean_edge_survival",
    "Trajectory", "consensus_error", "effective_bits_per_iter",
    "payload_bits_per_node",
    "ScheduledMixer", "TopologySchedule", "alternating_schedule",
    "make_schedule", "markov_drop_schedule", "random_matching_schedule",
    "static_schedule",
]
