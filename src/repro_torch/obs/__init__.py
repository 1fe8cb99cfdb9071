from repro_torch.obs.meters import (Meters, current_meters,  # noqa: F401
                                    env_info, using_meters)
from repro_torch.obs.report import (RunReport, build_report,  # noqa: F401
                                    wire_breakdown)
from repro_torch.obs.trace import Span, span  # noqa: F401
