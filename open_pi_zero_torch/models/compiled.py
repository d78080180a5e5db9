"""The compiled chunk: one CUDA graph per batch bucket, the counterpart of
the JAX package's ``jax.jit`` over ``infer_action`` (and over
``infer_action_refined`` for the refined tier), whose Euler scan is fully
unrolled into one program. And the compiled text decode
(``CompiledDecode``), the counterpart of the ``jax.jit`` over
``generate_text`` in the JAX package's ``models/paligemma.py``: the
prompt's prefill runs eagerly, and each greedy decode step is one replay
of a captured graph.

The eager chunk launches some 13,000-16,000 kernels from Python, and the
card waits for the host between them. ``compile_chunk`` runs the chunk once
eagerly on a side stream (which builds and loads K1, sets its attributes,
and makes cuBLAS's handle and workspace for that stream), then captures the
same launches into one ``torch.cuda.CUDAGraph``; a call replays it.

  - Inputs: static buffers in the dtypes the serving layer hands over
    (int32 ids and mask, fp32 pixels, proprios and ``prev_chunk``), filled
    by ``copy_`` on the caller's stream; the casts to the params' dtype are
    in the graph, as they are in the eager chunk.
  - Noise: drawn from the explicit ``generator`` into a static buffer just
    before each replay, one draw per call as the eager chunk draws it (the
    flow's start, or the refined tier's re-noising), so a graph and the
    eager chunk from generators seeded alike give bitwise-equal chunks.
  - Output: cloned on the stream before it is returned, so that a result
    still in flight (the server's completion thread) is not overwritten by
    the next replay of the same graph.
  - Memory: the graphs of one server share one pool (``pool``) and replay
    on one stream, one at a time, so each graph's temporaries may reuse
    another's.

A graph needs a card: on the CPU ``compile_chunk`` raises (CPU callers use
the eager chunk, ``serving.make_infer_fn``). Under a registered mesh it
raises too: the gloo collectives of tensor parallelism cannot be captured.
A failed capture raises; nothing falls back to the eager chunk.

``fused_attention.launches`` is a Python counter: it moves at the capture
(by the chunk's K1 launches) and never at a replay.

The decode step (``CompiledDecode``) follows the same pattern: one graph
per (B, T_max), T_max the static cache's slots, over the state of a
``pizero.TextDecode``, which lives in static device buffers: the two
caches, the last token, the write offset (a 0-d tensor that
``pizero.text_decode_step`` reads on the device for the RoPE positions,
the mask and the cache write), the done flags and the emitted tokens. The
graph holds ``TextDecode.step``: the embedding gather, the trunk,
``lm_logits``, the greedy pick and the updates of the token, offset and
flags. Sampled (top-p) decoding stays eager (``pizero.generate_text``
with a generator): only greedy decoding is captured.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from open_pi_zero_torch import resolve_device
from open_pi_zero_torch.config import PiZeroConfig
from open_pi_zero_torch.models import pizero
from open_pi_zero_torch.parallel.mesh import get_mesh

Tensor = torch.Tensor


def _graph_device(device, on_cpu: str) -> torch.device:
    """The card a graph is captured on; raises on the CPU and under a mesh."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"a CUDA graph needs a card: {on_cpu}")
    if get_mesh() is not None:
        raise NotImplementedError(
            "no CUDA graph under a mesh: gloo collectives cannot be captured "
            "(TP graphs wait in ROADMAP.md)"
        )
    return device


def _capture(fn, device: torch.device, pool):
    """(graph, its output, its stream): ``fn`` run once eagerly on a side
    stream (the warm-up: it builds and loads K1, sets its attributes and
    makes cuBLAS's handle and workspace for that stream), then captured
    into one graph in ``pool`` on that stream. Python's cyclic GC is
    collected before the capture and held off during it: a collection that
    freed a dead cycle's device memory among the captured launches would
    invalidate the capture."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream(device).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    gc.collect()
    gc_was_enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            out = fn()
    finally:
        if gc_was_enabled:
            gc.enable()
    return graph, out, stream


class CompiledChunk:
    """One batch bucket's chunk as a captured CUDA graph; see the module
    docstring. Call it with a batch dict of arrays or tensors of exactly
    the bucket's shapes: {input_ids [B, S], pixel_values [B, H, W, C],
    attention_mask [B, S], proprios [B, P, proprio_dim]}, plus
    ``prev_chunk`` [B, A, act_dim] for the refined tier (``t_start`` > 0).
    Returns the [B, A, act_dim] chunk, a CUDA tensor that the card may
    still be computing."""

    def __init__(
        self,
        params: dict,
        cfg: PiZeroConfig,
        batch_size: int,
        *,
        generator: torch.Generator,
        t_start: float = 0.0,
        device="cuda",
        pool=None,
    ):
        device = _graph_device(device, "on the CPU serve the eager chunk (serving.make_infer_fn)")
        if not 0.0 <= t_start < 1.0:
            raise ValueError(f"t_start must be in [0, 1), got {t_start}")
        self.params, self.cfg, self.t_start, self.generator = params, cfg, t_start, generator
        self.dtype = params["embed_tokens"].dtype
        b, size = batch_size, cfg.siglip.image_size
        zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
        chunk_shape = (b, cfg.horizon_steps, cfg.action_dim)
        self.inputs = {
            "input_ids": zeros((b, cfg.max_image_text_tokens), torch.int32),
            "pixel_values": zeros((b, size, size, cfg.siglip.num_channels), torch.float32),
            "attention_mask": zeros((b, cfg.max_image_text_tokens), torch.int32),
            "proprios": zeros((b, cfg.cond_steps, cfg.proprio_dim), torch.float32),
        }
        if t_start > 0.0:
            self.inputs["prev_chunk"] = zeros(chunk_shape, torch.float32)
        self.noise = zeros(chunk_shape, self.dtype)
        self.graph, self.out, self.stream = _capture(self._chunk, device, pool)
        self.pool = self.graph.pool()

    def _chunk(self) -> Tensor:
        """The eager chunk on the static buffers: what the graph holds."""
        x = self.inputs
        args = (
            self.params, self.cfg, None, x["input_ids"], x["pixel_values"].to(self.dtype),
            x["attention_mask"], x["proprios"].to(self.dtype),
        )
        if self.t_start > 0.0:
            return pizero.infer_action_refined(
                *args, x["prev_chunk"].to(self.dtype), t_start=self.t_start, x0=self.noise
            )
        return pizero.infer_action(*args, action0=self.noise)

    def __call__(self, batch: dict) -> Tensor:
        for name, buf in self.inputs.items():
            value = batch[name]
            value = value if isinstance(value, Tensor) else torch.from_numpy(np.asarray(value))
            if tuple(value.shape) != tuple(buf.shape):
                raise ValueError(f"{name} has shape {tuple(value.shape)}; this graph takes {tuple(buf.shape)}")
            buf.copy_(value)
        self.noise.normal_(generator=self.generator)  # the eager chunk's one draw
        self.graph.replay()
        return self.out.clone()


def compile_chunk(
    params: dict,
    cfg: PiZeroConfig,
    batch_size: int,
    *,
    generator: torch.Generator,
    t_start: float = 0.0,
    device="cuda",
    pool=None,
) -> CompiledChunk:
    """The chunk of ``batch_size`` rows captured as one CUDA graph:
    ``pizero.infer_action`` (``t_start`` 0) or
    ``pizero.infer_action_refined`` from ``t_start``, with the noise from
    ``generator`` (a CUDA generator) and its temporaries in ``pool`` (a
    ``torch.cuda.graph_pool_handle()`` or another graph's ``pool``; a new
    pool if None)."""
    return CompiledChunk(
        params, cfg, batch_size, generator=generator, t_start=t_start, device=device, pool=pool
    )


class CompiledDecode:
    """Greedy text decoding of ``batch_size`` rows against a static cache of
    ``max_len`` slots, each decode step one replay of a captured CUDA graph
    of ``pizero.TextDecode.step``; see the module docstring.
    ``decoder(input_ids, pixel_values, max_new_tokens)`` runs ``prefill``
    eagerly, then ``step`` max_new_tokens times, and returns the [B,
    max_new_tokens] ids; with ``max_len`` = S + max_new_tokens they are
    ``pizero.generate_text``'s greedy ids."""

    def __init__(
        self,
        params: dict,
        cfg: PiZeroConfig,
        batch_size: int,
        max_len: int,
        *,
        eos_token_id: int = 1,
        device="cuda",
        pool=None,
    ):
        device = _graph_device(device, "on the CPU decode eagerly (pizero.generate_text)")
        self.device, self.dtype = device, params["embed_tokens"].dtype
        self.state = pizero.TextDecode(params, cfg, batch_size, max_len, eos_token_id)
        self.graph, _, self.stream = _capture(self.state.step, device, pool)
        self.pool = self.graph.pool()

    def prefill(self, input_ids, pixel_values) -> None:
        """The prompt [B, S] eagerly into the zeroed caches
        (``TextDecode.prefill``)."""
        input_ids = torch.as_tensor(input_ids, device=self.device)
        pixel_values = torch.as_tensor(pixel_values, device=self.device).to(self.dtype)
        self.state.prefill(input_ids, pixel_values)

    def step(self) -> None:
        """One decode step: a replay of the graph."""
        self.graph.replay()

    def __call__(self, input_ids, pixel_values, max_new_tokens: int) -> Tensor:
        slots = self.state.tokens.shape[1]
        if torch.as_tensor(input_ids).shape[1] + max_new_tokens > slots:
            raise ValueError(f"S + max_new_tokens must fit in the cache's {slots} slots")
        self.prefill(input_ids, pixel_values)
        for _ in range(max_new_tokens):
            self.step()
        return self.state.tokens[:, :max_new_tokens].clone()
