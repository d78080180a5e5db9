"""Host-side stream helpers of the data pipeline (what ``tf.data`` gives the
JAX package): a shuffle buffer on an explicit generator, an ordered map
over a thread pool, and a background prefetch. Each output order depends
only on the input order and the generator, never on thread timing."""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

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
