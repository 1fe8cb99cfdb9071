from repro_torch.obs.meters import Meters, current_meters, using_meters  # noqa: F401
from repro_torch.obs.report import RunReport  # noqa: F401
from repro_torch.obs.trace import Span, span  # noqa: F401
