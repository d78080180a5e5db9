"""Host-side stream helpers of the data pipeline (what ``tf.data`` gives the
JAX package): a shuffle buffer on an explicit generator, an ordered map
over a thread pool, a background prefetch, and numpy's BLAS held to one
thread. Each output order depends only on the input order and the
generator, never on thread timing."""

from __future__ import annotations

import collections
import ctypes
import functools
import glob
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

_DONE = object()


def shuffle_buffer(items: Iterable, size: int, rng: np.random.Generator) -> Iterator:
    """``tf.data.Dataset.shuffle``'s law: fill a buffer of ``size``, then
    hand out a uniformly drawn slot and refill it from the input; drain the
    buffer the same way at the end."""
    buffer = []
    for item in items:
        if len(buffer) < size:
            buffer.append(item)
            continue
        j = int(rng.integers(len(buffer)))
        out, buffer[j] = buffer[j], item
        yield out
    while buffer:
        j = int(rng.integers(len(buffer)))
        buffer[j], buffer[-1] = buffer[-1], buffer[j]
        yield buffer.pop()


def ordered_map(fn: Callable, items: Iterable, threads: int) -> Iterator:
    """``fn`` over ``items`` on ``threads`` threads, results in input order,
    at most 2 x ``threads`` items in flight. One thread (or fewer) maps in
    the caller's thread."""
    if threads <= 1:
        yield from map(fn, items)
        return
    with ThreadPoolExecutor(threads, thread_name_prefix="opz-data") as pool:
        pending = collections.deque()
        for item in items:
            pending.append(pool.submit(fn, item))
            if len(pending) >= 2 * threads:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def prefetch(items: Iterable, depth: int) -> Iterator:
    """Iterate ``items`` in a background thread, ``depth`` ahead of the
    consumer. An exception in the producer is raised in the consumer; the
    producer stops when the consumer closes the iterator or drops it."""
    out: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(x) -> bool:
        while not stop.is_set():
            try:
                out.put(x, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        source = iter(items)
        try:
            for item in source:
                if not put((True, item)):
                    return
            put((True, _DONE))
        except BaseException as e:  # handed to the consumer, which raises it
            put((False, e))
        finally:
            close = getattr(source, "close", None)
            if close is not None:
                close()  # stops the source's own thread pools now, in this thread

    thread = threading.Thread(target=produce, name="opz-data-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            ok, item = out.get()
            if not ok:
                raise item
            if item is _DONE:
                return
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)


# numpy's bundled OpenBLAS: the setter's name in its wheels (numpy 2's
# scipy-openblas with 64-bit ints, then older builds)
_BLAS_SETTERS = ("scipy_openblas_set_num_threads64_", "scipy_openblas_set_num_threads",
                 "openblas_set_num_threads64_", "openblas_set_num_threads")


@functools.lru_cache(maxsize=None)
def _blas_setter() -> Optional[Callable[[int], None]]:
    numpy_dir = os.path.dirname(np.__file__)
    for path in sorted(glob.glob(os.path.join(numpy_dir, os.pardir, "numpy.libs", "*openblas*"))
                       + glob.glob(os.path.join(numpy_dir, ".libs", "*openblas*"))):
        lib = ctypes.CDLL(path)  # the handle numpy already holds
        for name in _BLAS_SETTERS:
            setter = getattr(lib, name, None)
            if setter is not None:
                setter.argtypes, setter.restype = [ctypes.c_int], None
                return setter
    return None


def one_blas_thread() -> bool:
    """Run numpy's BLAS calls on one thread, in this whole process;
    whether numpy's OpenBLAS was found. The pipeline's parallelism is its
    own threads (``ordered_map``): a BLAS pool on every core under each of
    them spins on the cores that those threads and the trainer need, and
    the frame transforms' small products gain nothing from it. A product's
    values do not depend on the count."""
    setter = _blas_setter()
    if setter is not None:
        setter(1)
    return setter is not None
