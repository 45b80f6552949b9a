"""Structural equality across the two packages: ``repro`` and
``repro_torch`` define classes of the same names, which never compare equal
to each other, so the parity tests compare canonical forms instead. Floats
compare by ``==`` (no tolerance); NaN equals NaN; class names but not their
modules are part of the form."""
import dataclasses

import numpy as np

# fields a port class has beyond its reference counterpart (the reference
# has no such field to compare them with), left out of the form
PORT_ONLY = {"Request": ("first_token_s",)}


def canon(x):
    if isinstance(x, float):
        return ("nan",) if x != x else float(x)
    if isinstance(x, (bool, int, str, type(None))):
        return x
    if isinstance(x, np.generic):
        return canon(x.item())
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple((canon(k), canon(v)) for k, v in x.items())
    name = type(x).__name__
    if name == "TaskChain":
        return (name, canon(x.w["B"]), canon(x.w["L"]), canon(x.replicable),
                x.names)
    if name == "ParetoPoint":
        return (name, canon(x.period), canon(x.energy), canon(x.budget),
                canon(x.solution))
    if name == "VariantSpec":
        return (name, x.names, x.task_names, canon(x.mult))
    if dataclasses.is_dataclass(x):
        return (name,) + tuple((f.name, canon(getattr(x, f.name)))
                               for f in dataclasses.fields(x) if f.compare
                               and f.name not in PORT_ONLY.get(name, ()))
    if callable(x):
        return ("callable", getattr(x, "__qualname__", name))
    raise TypeError(f"no canonical form for {type(x)!r}")


def outcome(fn, *args, **kw):
    """``canon`` of what ``fn`` returns, or the name of what it raises."""
    try:
        return canon(fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the raise is the outcome
        return ("raised", type(e).__name__)
