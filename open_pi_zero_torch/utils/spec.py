"""ModuleSpec: a JSON-serializable reference ``module:name`` to a callable,
with bound args and kwargs (counterpart of the JAX package's
``utils/spec.py``; reference src/utils/spec.py:6-76, which the data layer
uses to name standardize and filter functions inside configs).

``create`` makes a spec from a callable or a ``'pkg.module:Name'`` string,
``instantiate`` imports the callable and binds the spec's arguments,
``to_string`` renders it as ``module:name(args, kwargs)``.
"""

from __future__ import annotations

import importlib
from functools import partial
from typing import Callable, Dict, Union

KEYS = {"module", "name", "args", "kwargs"}


def create(callable_or_full_name: Union[str, Callable], *args, **kwargs) -> Dict:
    """A spec of the callable (or its ``'pkg.module:Name'``) with these
    arguments bound."""
    if isinstance(callable_or_full_name, str):
        if callable_or_full_name.count(":") != 1:
            raise ValueError(f"expected fully qualified import string 'pkg.module:Name', got {callable_or_full_name!r}")
        module, name = callable_or_full_name.split(":")
    else:
        o = callable_or_full_name
        if not (hasattr(o, "__module__") and hasattr(o, "__name__")):
            raise ValueError(f"cannot infer import path of {o!r}")
        module, name = o.__module__, o.__name__
    return {"module": module, "name": name, "args": args, "kwargs": kwargs}


def instantiate(spec: Dict) -> Callable:
    """The spec's callable, imported, with its arguments bound."""
    if set(spec.keys()) != KEYS:
        raise ValueError(f"expected ModuleSpec with keys {KEYS}, got {spec}")
    obj = getattr(importlib.import_module(spec["module"]), spec["name"])
    return partial(obj, *spec["args"], **spec["kwargs"])


def to_string(spec: Dict) -> str:
    """``module:name(arg, ..., key=value, ...)``."""
    args = ", ".join(map(str, spec["args"]))
    kwargs = ", ".join(f"{k}={v}" for k, v in spec["kwargs"].items())
    sep = ", " if args and kwargs else ""
    return f"{spec['module']}:{spec['name']}({args}{sep}{kwargs})"
