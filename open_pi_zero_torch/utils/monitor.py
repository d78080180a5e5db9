"""Timing, logging and profiler ranges (counterpart of the JAX package's
``utils/monitor.py``; reference src/utils/monitor.py). Ranges are
``torch.profiler``'s."""

from __future__ import annotations

import functools
import logging
import time
from typing import Optional

import torch


def log_execution_time(logger: Optional[logging.Logger] = None):
    """Decorator logging the wall-clock runtime of heavy calls (reference
    monitor.py:15-35)."""

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            start = time.time()
            result = func(*args, **kwargs)
            msg = f"{func.__name__} took {time.time() - start:.2f} seconds to execute."
            (logger.info if logger else print)(msg)
            return result

        return wrapper

    return decorator


class Timer:
    """Wall-clock timer returning seconds since the last call (reference
    monitor.py:38-47)."""

    def __init__(self):
        self._start = time.time()

    def __call__(self, reset: bool = True) -> float:
        now = time.time()
        diff = now - self._start
        if reset:
            self._start = now
        return diff


def annotate(name: str):
    """A named range in profiler traces (``torch.profiler.record_function``):
    its CPU event's device time is that of the kernels launched inside."""
    return torch.profiler.record_function(name)
