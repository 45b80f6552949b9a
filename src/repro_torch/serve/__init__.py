from .engine import Request, ServeEngine, SimClock  # noqa: F401
from .slo import AdmissionPlanner, step_need_s  # noqa: F401
