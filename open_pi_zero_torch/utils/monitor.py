"""Timing, logging, memory and profiler helpers (counterpart of the JAX
package's ``utils/monitor.py``; reference src/utils/monitor.py). Ranges and
traces are ``torch.profiler``'s; the main rank is rank 0 of the process
group (``parallel.mesh.process_index``)."""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Optional

import torch


def _main_rank() -> bool:
    from open_pi_zero_torch.parallel.mesh import process_index

    return process_index() == 0


def log_device_memory(log: Optional[logging.Logger] = None, stage: str = "loading model", device=None) -> int:
    """Log the bytes allocated on a card (reference
    log_allocated_gpu_memory, monitor.py:8-12); returns them."""
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    in_use = torch.cuda.memory_allocated(device)
    msg = f"Device memory after {stage}: {in_use / 1024**3:.2f} GB"
    (log.info if log else print)(msg)
    return in_use


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


class MainRankFilter(logging.Filter):
    """Let records through on the main rank only (reference
    monitor.py:51-58), decided at each record, so that a filter made
    before the process group exists does not take every rank for rank 0."""

    def filter(self, record) -> bool:
        return _main_rank()


def main_process_only(func):
    """Run ``func`` on rank 0 only; the other ranks get None (reference
    main_rank_only, src/utils/decorator.py:31-37)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        return func(*args, **kwargs) if _main_rank() else None

    return wrapper


class profile_trace:
    """``torch.profiler`` over the block, the host and (when there is one)
    the card, its trace written as Chrome JSON under ``log_dir``
    (``trace_rank<r>.json``):

        with profile_trace("/tmp/opz_trace"):
            step(...)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        from open_pi_zero_torch.parallel.mesh import process_index

        self._prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, f"trace_rank{process_index()}.json")
        self._prof.export_chrome_trace(self.path)
        return False


def annotate(name: str):
    """A named range in profiler traces (``torch.profiler.record_function``):
    its CPU event's device time is that of the kernels launched inside."""
    return torch.profiler.record_function(name)
