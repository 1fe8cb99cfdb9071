"""repro_torch.obs -- meters, spans, run reports and rooflines.

The port of ``repro.obs``: the metric registry and environment stamp
(:mod:`~repro_torch.obs.meters`), synchronised spans
(:mod:`~repro_torch.obs.trace`), the :class:`RunReport` every
``Runner.run`` leaves (:mod:`~repro_torch.obs.report`), the whole-step
roofline on the H100 (:mod:`~repro_torch.obs.roofline`), the wire
kernels' byte rooflines (:mod:`~repro_torch.obs.roofline_gate`) and the
recorders of one step's ops and ``pp`` calls (:mod:`~repro_torch.obs.
record`).
"""
from repro_torch.obs.meters import (Meters, current_meters,  # noqa: F401
                                    env_info, using_meters)
from repro_torch.obs.report import (RunReport, build_report,  # noqa: F401
                                    wire_breakdown)
from repro_torch.obs.roofline_gate import (kernel_roofline,  # noqa: F401
                                           step_roofline,
                                           trainer_wire_layout)
from repro_torch.obs.trace import Span, span  # noqa: F401
