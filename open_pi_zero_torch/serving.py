"""Dynamic-batching action-chunk server (counterpart of the JAX package's
``serving.py``).

One card serves many robots, so the server batches concurrent requests:

  - requests land on a queue; the worker drains up to `max_batch` of
    them, waiting at most `batch_window_ms` after the first arrival,
  - the batch is padded up to the nearest size in `batch_sizes`, so the
    model sees a few fixed batch shapes,
  - one `infer_action` call serves the whole bucket; each caller gets its
    row.

In-flight batching: the worker dispatches each batch (the model returns a
CUDA tensor while the card still computes it) and hands it to a completion
thread that materializes the result on the host and wakes the callers.
While batch N executes on the card, the worker is already draining,
stacking and enqueueing batch N+1. `max_inflight` bounds the queue of
dispatched batches (backpressure).

Transport: one TCP port, two codecs, auto-detected per message by the
first byte —

  - binary (default for clients): `OPZ1` magic + uint32 header length +
    JSON header {name: {dtype, shape}} + concatenated raw array bytes.
  - newline-delimited JSON (arrays as nested lists): debuggable with
    netcat, kept for interop.

Refined steady-state tier (opt-in: a server `refine_fn` and a client
`prev_chunk` field): requests carrying the caller's previous action chunk
are routed to `pizero.infer_action_refined`, which warm-starts from the
re-noised previous chunk and integrates [t, 1] (half the Euler loop at
t = 0.5). The server stays stateless: the client owns episode boundaries
by omitting `prev_chunk` on the first request.

Model callables: `make_compiled_infer_fn` captures each bucket's chunk (and
its refined chunk) as one CUDA graph (`models/compiled.py`), the serving
path on a card; `make_infer_fn` runs the eager chunk, on the CPU or on a
card. `open_pi_zero_torch/scripts/serve.py` is the CLI.
"""

from __future__ import annotations

import json
import logging
import queue
import socket
import socketserver
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from open_pi_zero_torch import resolve_device
from open_pi_zero_torch.models import pizero
from open_pi_zero_torch.models.compiled import compile_chunk

log = logging.getLogger(__name__)

DEFAULT_BATCH_SIZES = (1, 4, 8, 16)


def _materialize(x) -> np.ndarray:
    """Host copy of a model result: a tensor (on the card, waiting for it)
    or anything numpy reads."""
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x)


class _Request:
    __slots__ = ("inputs", "event", "result", "error", "t_enqueue")

    def __init__(self, inputs: dict):
        self.inputs = inputs
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None
        self.t_enqueue = 0.0  # stamped by submit(); read by the worker


class BatchingPolicy:
    """Owns the model function and the batching loop.

    `infer_fn(batch: dict) -> [B, A, act_dim]` must accept a dict of
    stacked numpy arrays {input_ids, pixel_values, attention_mask,
    proprios} (`warmup` calls it once with each padded bucket size). For
    in-flight batching to pay off it should return the CUDA tensor without
    waiting for it — the completion thread copies it to the host; an
    infer_fn that returns numpy still works, it just serializes dispatch
    and completion.

    `refine_fn` (optional) enables the refined steady-state tier: requests
    carrying a `prev_chunk` array are routed to it (its batch also holds
    the stacked prev_chunk [B, A, act_dim]); each queue drain is
    partitioned into a fresh sub-batch and a refined sub-batch (two
    programs). With refine_fn unset, prev_chunk fields are stripped and
    every request gets the full flow."""

    def __init__(
        self,
        infer_fn: Callable[[dict], np.ndarray],
        batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES,
        batch_window_ms: float = 3.0,
        queue_size: int = 256,
        max_inflight: int = 2,
        refine_fn: Optional[Callable[[dict], np.ndarray]] = None,
    ):
        self.infer_fn = infer_fn
        self.refine_fn = refine_fn
        self.batch_sizes = tuple(sorted(batch_sizes))
        self.max_batch = self.batch_sizes[-1]
        self.batch_window_s = batch_window_ms / 1e3
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        # dispatched-but-unmaterialized batches; put() blocks once
        # max_inflight are queued on the device (backpressure)
        self._pending: "queue.Queue[tuple]" = queue.Queue(
            maxsize=max(1, max_inflight)
        )
        self._completer = threading.Thread(target=self._complete_loop,
                                           daemon=True)
        self.n_batches = 0
        self.n_requests = 0
        self.n_refined = 0  # requests dispatched to refine_fn
        # per-stage breakdown (queue_wait/stack appended by the worker,
        # infer/fanout by the completer; list.append is GIL-atomic):
        # queue_wait = enqueue -> batch dispatch (includes the batching
        # window), stack = host numpy batching + async dispatch, infer =
        # dispatch -> result materialized (device time INCLUDING overlap
        # behind earlier in-flight batches), fanout = scatter + wakeups
        self.stage_ms = {"queue_wait": [], "stack": [], "infer": [], "fanout": []}

    def stats_snapshot(self) -> dict:
        """Median/percentile summary of the per-stage timings since start
        (or the last reset_stats) — the through-socket latency breakdown."""
        out = {"n_batches": self.n_batches, "n_requests": self.n_requests,
               "n_refined": self.n_refined}
        for k, v in self.stage_ms.items():
            if v:
                arr = np.asarray(v)
                out[k] = {
                    "p50_ms": round(float(np.percentile(arr, 50)), 3),
                    "p99_ms": round(float(np.percentile(arr, 99)), 3),
                    "mean_ms": round(float(arr.mean()), 3),
                }
        return out

    def reset_stats(self):
        self.n_batches = 0
        self.n_requests = 0
        self.n_refined = 0
        for v in self.stage_ms.values():
            v.clear()

    # ------------------------------------------------------------------ #
    def start(self):
        self._worker.start()
        self._completer.start()
        return self

    def stop(self):
        self._stop.set()
        if self._worker.ident is not None:  # join() raises on unstarted threads
            self._worker.join(timeout=5)
        if self._completer.ident is not None:
            self._completer.join(timeout=5)
        # fail still-enqueued requests fast instead of leaving their
        # submitters blocked for the full submit() timeout
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.error = "server shutting down"
            req.event.set()
        while True:
            try:
                reqs, _, _ = self._pending.get_nowait()
            except queue.Empty:
                break
            for req in reqs:
                req.error = "server shutting down"
                req.event.set()

    def submit(self, inputs: dict, timeout: float = 30.0) -> np.ndarray:
        """Blocking: enqueue one observation, wait for its action chunk."""
        req = _Request(inputs)
        req.t_enqueue = time.monotonic()
        self._q.put(req, timeout=timeout)
        if not req.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.result

    def warmup(self, example: dict):
        """Run every bucket size once before accepting traffic (the first
        eager call builds the CUDA kernels). With the refined tier enabled,
        each bucket's refined program runs too, with the fresh result as the
        previous chunk."""
        for b in self.batch_sizes:
            batch = {k: np.repeat(v[None], b, axis=0) for k, v in example.items()}
            chunk = _materialize(self.infer_fn(batch))
            log.info("warmed batch size %d", b)
            if self.refine_fn is not None:
                batch["prev_chunk"] = np.asarray(chunk, np.float32)
                _materialize(self.refine_fn(batch))
                log.info("warmed refined batch size %d", b)

    # ------------------------------------------------------------------ #
    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.max_batch

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            reqs = [first]
            deadline = time.monotonic() + self.batch_window_s
            while len(reqs) < self.max_batch:
                remaining = deadline - time.monotonic()
                # CONTINUOUS batching: while the device is saturated
                # (in-flight queue full) dispatching earlier buys nothing,
                # so keep accumulating past the window — the batch that
                # eventually dispatches is as full as the arrival stream
                # allows. This lifts the mean formed-batch size toward the
                # bucket size under concurrent load.
                if remaining <= 0 and not self._pending.full():
                    break
                try:
                    reqs.append(
                        self._q.get(timeout=max(remaining, 0.002))
                    )
                except queue.Empty:
                    if remaining <= 0:
                        break
            self._run(reqs)

    def _run(self, reqs):
        if self.refine_fn is None:
            for r in reqs:
                r.inputs.pop("prev_chunk", None)  # tier disabled: full flow
            self._dispatch(self.infer_fn, reqs)
            return
        fresh = [r for r in reqs if "prev_chunk" not in r.inputs]
        refined = [r for r in reqs if "prev_chunk" in r.inputs]
        if fresh:
            self._dispatch(self.infer_fn, fresh)
        if refined:
            self.n_refined += len(refined)
            self._dispatch(self.refine_fn, refined)

    def _dispatch(self, fn, reqs):
        """Stack + async-dispatch one group; the completer materializes.
        Runs on the worker thread — by the time the device finishes this
        batch, the worker is already assembling the next one."""
        try:
            t0 = time.monotonic()
            self.stage_ms["queue_wait"].extend(
                (t0 - r.t_enqueue) * 1e3 for r in reqs if r.t_enqueue
            )
            n = len(reqs)
            b = self._bucket(n)
            batch = {
                k: np.stack(
                    [r.inputs[k] for r in reqs]
                    + [reqs[-1].inputs[k]] * (b - n)  # pad rows (discarded)
                )
                for k in reqs[0].inputs
            }
            lazy = fn(batch)  # a CUDA tensor: returns without waiting
            t1 = time.monotonic()
            self.stage_ms["stack"].append((t1 - t0) * 1e3)
        except Exception as e:  # noqa: BLE001 — report to callers
            log.exception("batch dispatch failed")
            for r in reqs:
                r.error = f"{type(e).__name__}: {e}"
                r.event.set()
            return
        # blocks when max_inflight batches already sit on the device —
        # bounded device queue; submitters keep queueing into self._q
        while not self._stop.is_set():
            try:
                self._pending.put((reqs, lazy, t1), timeout=0.5)
                return
            except queue.Full:
                continue
        for r in reqs:  # shutdown while the device queue was full
            r.error = "server shutting down"
            r.event.set()

    def _complete_loop(self):
        while True:
            try:
                reqs, lazy, t1 = self._pending.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            try:
                chunks = _materialize(lazy)  # waits for the device
                t2 = time.monotonic()
                for i, r in enumerate(reqs):
                    r.result = chunks[i]
                    r.event.set()
                t3 = time.monotonic()
                self.stage_ms["infer"].append((t2 - t1) * 1e3)
                self.stage_ms["fanout"].append((t3 - t2) * 1e3)
                self.n_batches += 1
                self.n_requests += len(reqs)
            except Exception as e:  # noqa: BLE001 — report to callers
                log.exception("batch completion failed")
                for r in reqs:
                    r.error = f"{type(e).__name__}: {e}"
                    r.event.set()


# --------------------------------------------------------------------------- #
# TCP transport: binary frames (default) + newline-delimited JSON (interop)
# --------------------------------------------------------------------------- #

_MAGIC = b"OPZ1"
_INPUT_DTYPES = {
    "input_ids": np.int32,
    "pixel_values": np.float32,
    "attention_mask": np.int32,
    "proprios": np.float32,
}


# optional per-request fields. prev_chunk = the caller's previous action
# chunk [A, act_dim]: opts this request into the refined steady-state tier
# (pizero.infer_action_refined) when the server enables it
_OPTIONAL_INPUT_DTYPES = {"prev_chunk": np.float32}


def _coerce_inputs(msg: dict) -> dict:
    inputs = {k: np.asarray(msg[k], dt) for k, dt in _INPUT_DTYPES.items()}
    for k, dt in _OPTIONAL_INPUT_DTYPES.items():
        if k in msg:
            inputs[k] = np.asarray(msg[k], dt)
    return inputs


def pack_frame(arrays: dict) -> bytes:
    """{name: ndarray} -> OPZ1 frame: magic + u32 header length + JSON
    header {name: {dtype, shape}} + raw array bytes in header order."""
    header = {
        k: {"dtype": str(v.dtype), "shape": list(v.shape)}
        for k, v in arrays.items()
    }
    hb = json.dumps(header).encode()
    parts = [_MAGIC, len(hb).to_bytes(4, "big"), hb]
    parts += [np.ascontiguousarray(v).tobytes() for v in arrays.values()]
    return b"".join(parts)


def _read_exact(f, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            raise EOFError("connection closed mid-frame")
        buf += chunk
    return buf


def read_frame(f, first: bytes = b"") -> dict:
    """Read one OPZ1 frame from a file-like; `first` holds magic bytes
    already consumed by protocol sniffing."""
    magic = first + _read_exact(f, len(_MAGIC) - len(first))
    if magic != _MAGIC:
        raise ValueError(f"bad frame magic {magic!r}")
    (hlen,) = (int.from_bytes(_read_exact(f, 4), "big"),)
    header = json.loads(_read_exact(f, hlen))
    out = {}
    for k, meta in header.items():
        dt = np.dtype(meta["dtype"])
        n = int(np.prod(meta["shape"])) if meta["shape"] else 1
        raw = _read_exact(f, n * dt.itemsize)
        out[k] = np.frombuffer(raw, dt).reshape(meta["shape"])
    return out


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        policy: BatchingPolicy = self.server.policy  # type: ignore[attr-defined]
        io_stats = getattr(self.server, "io_stats", None)
        io_lock = getattr(self.server, "io_lock", None)
        while True:
            first = self.rfile.read(1)
            if not first:
                return
            if first == _MAGIC[:1]:
                try:
                    t0 = time.monotonic()
                    msg = read_frame(self.rfile, first)
                    t1 = time.monotonic()
                    chunk = policy.submit(_coerce_inputs(msg))
                    t2 = time.monotonic()
                    resp = pack_frame(
                        {"action_chunk": np.asarray(chunk, np.float32)}
                    )
                    if io_stats is not None:
                        with io_lock:
                            io_stats["decode_ms"].append((t1 - t0) * 1e3)
                            io_stats["encode_ms"].append(
                                (time.monotonic() - t2) * 1e3
                            )
                except EOFError:
                    return
                except Exception as e:  # noqa: BLE001 — protocol error reply
                    resp = pack_frame(
                        {"error": np.frombuffer(
                            f"{type(e).__name__}: {e}".encode(), np.uint8
                        )}
                    )
                self.wfile.write(resp)
                self.wfile.flush()
                continue
            # JSON line protocol (first byte was part of the line)
            line = (first + self.rfile.readline()).strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
                chunk = policy.submit(_coerce_inputs(msg))
                resp = {"action_chunk": np.asarray(chunk, np.float64).tolist()}
            except Exception as e:  # noqa: BLE001 — protocol-level error reply
                resp = {"error": f"{type(e).__name__}: {e}"}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


class ActionServer(socketserver.ThreadingTCPServer):
    """One thread per connection; all inference funnels through the
    shared BatchingPolicy (concurrent robots => batched work on the card)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, policy: BatchingPolicy):
        super().__init__(addr, _Handler)
        self.policy = policy
        # per-request codec timings from all handler threads (the frame
        # decode happens on the handler thread, so its cost is visible
        # only here, not in the policy's stage breakdown)
        self.io_stats = {"decode_ms": [], "encode_ms": []}
        self.io_lock = threading.Lock()

    def io_snapshot(self) -> dict:
        with self.io_lock:
            out = {}
            for k, v in self.io_stats.items():
                if v:
                    arr = np.asarray(v)
                    out[k] = {
                        "p50_ms": round(float(np.percentile(arr, 50)), 3),
                        "p99_ms": round(float(np.percentile(arr, 99)), 3),
                        "mean_ms": round(float(arr.mean()), 3),
                    }
            return out

    def reset_io_stats(self):
        with self.io_lock:
            for v in self.io_stats.values():
                v.clear()


def serve_forever(host: str, port: int, policy: BatchingPolicy):
    policy.start()
    with ActionServer((host, port), policy) as srv:
        log.info("serving on %s:%d", *srv.server_address[:2])  # port 0: the one the OS chose
        srv.serve_forever()


# --------------------------------------------------------------------------- #
# client helper (also used by tests)
# --------------------------------------------------------------------------- #


def request_action(
    host: str, port: int, inputs: dict, timeout: float = 60.0,
    binary: bool = True,
) -> np.ndarray:
    """One observation -> one action chunk. binary=True ships arrays as
    raw OPZ1 frames (the production codec); binary=False uses the JSON
    line protocol."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        f = s.makefile("rwb")
        if binary:
            f.write(pack_frame({k: np.asarray(v) for k, v in inputs.items()}))
            f.flush()
            resp = read_frame(f)
            if "error" in resp:
                raise RuntimeError(resp["error"].tobytes().decode())
            return np.asarray(resp["action_chunk"], np.float32)
        msg = {k: np.asarray(v).tolist() for k, v in inputs.items()}
        f.write((json.dumps(msg) + "\n").encode())
        f.flush()
        resp = json.loads(f.readline())
    if "error" in resp:
        raise RuntimeError(resp["error"])
    return np.asarray(resp["action_chunk"], np.float32)


def open_action_connection(host: str, port: int, timeout: float = 60.0,
                           binary: bool = True):
    """Persistent connection: returns (send(inputs) -> chunk, close).
    Reuses one socket for a robot's whole episode — connection setup is
    off the per-step critical path (the eval loop calls act() every
    act_steps env steps, reference eval.py:97-131). binary=False keeps the
    connection but ships JSON lines — the codec-isolation mode of
    scripts/bench_serving_daemon.py."""
    s = socket.create_connection((host, port), timeout=timeout)
    f = s.makefile("rwb")

    def send(inputs: dict) -> np.ndarray:
        if binary:
            f.write(pack_frame({k: np.asarray(v) for k, v in inputs.items()}))
            f.flush()
            resp = read_frame(f)
            if "error" in resp:
                raise RuntimeError(resp["error"].tobytes().decode())
            return np.asarray(resp["action_chunk"], np.float32)
        msg = {k: np.asarray(v).tolist() for k, v in inputs.items()}
        f.write((json.dumps(msg) + "\n").encode())
        f.flush()
        resp = json.loads(f.readline())
        if "error" in resp:
            raise RuntimeError(resp["error"])
        return np.asarray(resp["action_chunk"], np.float32)

    def close():
        f.close()
        s.close()

    return send, close


# --------------------------------------------------------------------------- #
# model callable
# --------------------------------------------------------------------------- #


def make_infer_fn(
    params: dict, cfg, device="cuda", seed: int = 42, t_start: float = 0.0
) -> Callable[[dict], torch.Tensor]:
    """The BatchingPolicy's eager `infer_fn` for a param tree on `device`:
    stacks a numpy batch onto the device in the params' dtype and calls
    `pizero.infer_action` (or, with `t_start` > 0, the refined tier's
    `pizero.infer_action_refined` on the batch's `prev_chunk`: a
    `refine_fn`), returning the [B, A, act_dim] tensor without waiting for
    it. The noise comes from one generator seeded with `seed`."""
    device = resolve_device(device)
    dtype = params["embed_tokens"].dtype
    generator = torch.Generator(device=device).manual_seed(seed)

    def infer_fn(batch: dict) -> torch.Tensor:
        x = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        args = (
            params, cfg, generator, x["input_ids"], x["pixel_values"].to(dtype),
            x["attention_mask"], x["proprios"].to(dtype),
        )
        if t_start > 0.0:
            return pizero.infer_action_refined(*args, x["prev_chunk"].to(dtype), t_start=t_start)
        return pizero.infer_action(*args)

    return infer_fn


def make_compiled_infer_fn(
    params: dict, cfg, batch_sizes: Sequence[int], refine_t: float = 0.0, device="cuda", seed: int = 42
) -> tuple:
    """(infer_fn, refine_fn) for the BatchingPolicy on a card: each bucket's
    chunk captured as one CUDA graph (`models/compiled.py`), and with
    `refine_t` > 0 each bucket's refined chunk from `refine_t` too
    (`refine_fn` is None otherwise). All graphs share one memory pool and
    one noise generator seeded with `seed`, which each call draws from
    once. A batch whose size is not a bucket raises."""
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    tiers = (0.0, refine_t) if refine_t > 0.0 else (0.0,)
    graphs, pool = {}, None
    for b in sorted(batch_sizes):
        for t in tiers:
            graphs[b, t] = compile_chunk(params, cfg, b, generator=generator, t_start=t, device=device, pool=pool)
            pool = graphs[b, t].pool
            log.info("captured the %s chunk of batch size %d", "refined" if t else "full", b)

    def tier_fn(t: float) -> Callable[[dict], torch.Tensor]:
        def run(batch: dict) -> torch.Tensor:
            b = len(batch["input_ids"])
            if (b, t) not in graphs:
                raise ValueError(f"no graph for batch size {b}; the buckets are {sorted(batch_sizes)}")
            return graphs[b, t](batch)

        return run

    return tier_fn(0.0), (tier_fn(refine_t) if refine_t > 0.0 else None)
