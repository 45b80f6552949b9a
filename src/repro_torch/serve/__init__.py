from .engine import Request, ServeEngine, SimClock, step_need_s  # noqa: F401
