"""Rank programs: what ``parallel.run_ranks`` runs on every position of a
mesh, for the tests (on the CPU, over gloo) and for ``chip_smoke.py``
phases 9-11, tp-train and dp-main (on the card). Each takes this rank's ``Mesh``
first and returns, on rank 0, plain data on the CPU (numpy arrays,
numbers).

They live in the package because a spawned process imports the function
it runs: none of them may pull in JAX.
"""

from __future__ import annotations

import importlib
import os
import statistics
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from open_pi_zero_torch.config import PiZeroConfig, TrainingConfig
from open_pi_zero_torch.models import pizero
from open_pi_zero_torch.models.from_jax import params_from_jax
from open_pi_zero_torch.models.tree import tree_leaves, tree_map
from open_pi_zero_torch.ops import fused_attention as fa
from open_pi_zero_torch.ops import lora as lora_lib
from open_pi_zero_torch.ops.attention import mot_attention_ref
from open_pi_zero_torch.ops.quantization import dequantize_blocks, quantize_blockwise
from open_pi_zero_torch.parallel import collectives
from open_pi_zero_torch.parallel.mesh import Mesh, set_mesh, shard_batch
from open_pi_zero_torch.parallel.sharding import gather_tp, shard_params_tp, tp_param_specs
from open_pi_zero_torch.training import averaging as avg_lib
from open_pi_zero_torch.training import optimizer as opt_lib
from open_pi_zero_torch.training import quantized_adam, seeds
from open_pi_zero_torch.training.train_step import init_train_state, make_train_step, shard_state_zero1

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def sequence(mesh: Mesh, calls: list) -> list:
    """Several rank programs ``(fn, args)`` in one world, in order."""
    return [fn(mesh, *args) for fn, args in calls]


def _exact_fp32() -> None:
    # fp32 products in full fp32 on the card (TF32 off), as the references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0] // mesh.n_data
    return x[mesh.data_index * n : (mesh.data_index + 1) * n]


def _heads(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    n = x.shape[2] // mesh.n_model
    return x[:, :, mesh.model_index * n : (mesh.model_index + 1) * n]


def _gather(mesh: Mesh, x: torch.Tensor, heads: bool) -> torch.Tensor:
    if heads:
        x = collectives.all_gather(x, mesh.model_group, dim=2)
    return collectives.all_gather(x, mesh.data_group, dim=0)


# --------------------------------------------------------------------------- #
# K1-shard against the plain version
# --------------------------------------------------------------------------- #


def attention_rank(mesh: Mesh, cases: List[dict]) -> list:
    """K1-shard on this rank's shard of each case's whole inputs (numpy
    ``q``, ``k``, ``v``, ``mask``, optional cotangent ``g``, ``softcap``,
    ``dtype``): batch rows over ``data``, query heads over ``model``, K/V
    heads too when Hkv % tp == 0, else replicated (JAX's in_specs). Each
    rank holds its out, dq, dk, dv (dk, dv after the VJP's all-reduce)
    against the plain version on the whole inputs, sliced to the rank.
    Returns per case the shards gathered into whole arrays, the max|Δ| and
    closeness at ``tol`` over all ranks, and ``bwd_launches``, the fewest
    backward-kernel launches that a rank counted for the case."""
    dev = mesh.device
    _exact_fp32()
    results = []
    for case in cases:
        dtype = DTYPES[case["dtype"]]
        q, k, v = (torch.from_numpy(case[n]).to(dev, dtype) for n in "qkv")
        mask = torch.from_numpy(case["mask"]).to(dev)
        softcap, tol = case["softcap"], case["tol"]
        kv_split = mesh.n_model > 1 and k.shape[2] % mesh.n_model == 0
        kv_replicated = mesh.n_model > 1 and not kv_split
        mine = [_rows(mesh, _heads(mesh, q))]
        mine += [_rows(mesh, _heads(mesh, x) if kv_split else x) for x in (k, v)]
        mine = [x.contiguous().requires_grad_() for x in mine]
        local_mask = _rows(mesh, mask)
        bwd_before = fa.bwd_launches
        out = fa.mot_attention_fused_sharded(*mine, local_mask, softcap, kv_replicated)
        whole = [x.detach().requires_grad_() for x in (q, k, v)]
        ref = mot_attention_ref(*whole, mask, softcap)
        got, want = {"out": out.detach()}, {"out": _rows(mesh, _heads(mesh, ref.detach()))}
        if "g" in case:
            g = torch.from_numpy(case["g"]).to(dev, dtype)
            got.update(zip(("dq", "dk", "dv"), torch.autograd.grad(out, mine, _rows(mesh, _heads(mesh, g)))))
            dq, dk, dv = torch.autograd.grad(ref, whole, g)
            want["dq"] = _rows(mesh, _heads(mesh, dq))
            want.update((n, _rows(mesh, _heads(mesh, x) if kv_split else x)) for n, x in (("dk", dk), ("dv", dv)))
        _sync(dev)
        launched = torch.tensor([float(fa.bwd_launches - bwd_before)], device=dev)
        collectives.all_reduce(launched, op=torch.distributed.ReduceOp.MIN)
        row = {"name": case["name"], "bwd_launches": int(launched[0])}
        for n, a in got.items():
            b = want[n]
            err = (a.float() - b.float()).abs()
            bad = (err > tol + tol * b.float().abs()).sum() + (~torch.isfinite(a)).sum()
            stats = torch.stack([err.max(), bad.float()]).to(torch.float32)
            collectives.all_reduce(stats, op=torch.distributed.ReduceOp.MAX)
            row[f"max_abs_err_{n}"], row[f"not_close_{n}"] = float(stats[0]), int(stats[1])
            row[n] = _gather(mesh, a, heads=n in ("out", "dq") or kv_split).float().cpu().numpy()
        results.append(row)
    return results


# --------------------------------------------------------------------------- #
# action inference under a mesh
# --------------------------------------------------------------------------- #


def _on(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _infer(params, cfg, t: dict, action0=None, generator=None) -> torch.Tensor:
    return pizero.infer_action(
        params, cfg, generator, t["input_ids"], t["pixel_values"], t["attention_mask"],
        t["proprios"], action0=action0,
    )


def infer_rank(
    mesh: Mesh, cfg: PiZeroConfig, batch: dict, action0: Optional[np.ndarray] = None,
    params_np: Optional[dict] = None, seed: int = 0,
) -> dict:
    """``infer_action`` on this rank's data rows and TP shard of the
    params, fp32: the params are ``params_np`` (a JAX tree with numpy
    leaves) or drawn on the CPU from ``seed``; the noise is ``action0``
    (the whole batch's, numpy) or drawn from a generator seeded with
    ``seed`` on the rank's device. Returns the chunk gathered over
    ``data`` and the rank's launch counts."""
    dev = mesh.device
    _exact_fp32()
    if params_np is not None:
        params = params_from_jax(params_np, device=dev)
    else:
        params = tree_map(lambda x: x.to(dev), pizero.init_params(cfg, seed=seed, device="cpu"))
    params = shard_params_tp(params, cfg, mesh)
    rows = shard_batch(mesh, _on(batch, dev))
    a0 = None if action0 is None else _rows(mesh, torch.from_numpy(action0).to(dev))
    generator = None if action0 is not None else torch.Generator(dev).manual_seed(seed)
    fa.launches = 0
    chunk = _infer(params, cfg, rows, a0, generator)
    _sync(dev)
    launches = fa.launches
    return {
        "chunk": collectives.all_gather(chunk, mesh.data_group, dim=0).cpu().numpy(),
        "launches": launches,
    }


def foreign_modules_rank(mesh: Mesh, modules: Sequence[str] = ()) -> list:
    """The modules of JAX or of the JAX package this rank has imported
    after importing ``modules`` (none may be)."""
    for name in modules:
        importlib.import_module(name)
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "open_pi_zero_tpu"))


def fault_rank(mesh: Mesh, fault: str) -> None:
    """A world that fails once it has started (a barrier first): rank 1
    raises (``"raise"``), or leaves rank 0 alone in an all-reduce over the
    model group for 60 s (``"stall"``), which the group's timeout ends
    first."""
    torch.distributed.barrier()
    if mesh.rank == 1:
        if fault == "raise":
            raise RuntimeError("rank 1 fails")
        time.sleep(60)
    collectives.all_reduce(torch.zeros(1, device=mesh.device), mesh.model_group)


def main_path_rank(
    mesh: Mesh, cfg: PiZeroConfig, seed: int, batch: dict, action0: np.ndarray, timed: int,
) -> dict:
    """``chip_smoke.py`` phase 11, on the card: the full params in fp32
    from ``seed`` on every rank; rank 0 first runs one unsharded chunk
    (the mesh cleared, so the path of a single card) and times 3 more;
    then every rank keeps its TP shard, frees the rest and runs TP chunks
    of its data rows with the same noise: two counted (K1 launches, all
    through K1-shard under the mesh; bitwise equal), ``timed`` more on
    the host clock after a barrier each, one profiled on rank 0. One more
    chunk records
    K1-shard's inputs on rank 0 (copied to the CPU) for the caller to
    replay. Returns the chunks, the counts, the times, the profile, and
    each rank's card and memory."""
    dev = mesh.device
    _exact_fp32()
    t0 = time.perf_counter()
    params = pizero.init_params(cfg, seed=seed, device=dev, dtype=torch.float32)
    inputs = _on(batch, dev)
    a0 = torch.from_numpy(action0).to(dev)
    out = {}
    if mesh.rank == 0:
        set_mesh(None)
        try:
            out["unsharded"] = _infer(params, cfg, inputs, a0).cpu().numpy()
            out["unsharded_ms"] = []
            for _ in range(3):
                t1 = time.perf_counter()
                _infer(params, cfg, inputs, a0)
                _sync(dev)
                out["unsharded_ms"].append((time.perf_counter() - t1) * 1e3)
        finally:
            set_mesh(mesh)
    params = shard_params_tp(params, cfg, mesh)  # the full leaves are freed here
    _sync(dev)
    cuda = dev.type == "cuda"  # the CPU runs it too, for a rehearsal
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    weights = torch.cuda.memory_allocated(dev) if cuda else 0
    rows = shard_batch(mesh, inputs)
    a0 = _rows(mesh, a0)
    build_s = time.perf_counter() - t0

    torch.distributed.barrier()
    fa.launches = 0
    first = _infer(params, cfg, rows, a0)
    _sync(dev)
    launches = fa.launches
    second = _infer(params, cfg, rows, a0)
    _sync(dev)
    times = []
    for _ in range(timed):
        torch.distributed.barrier()
        t0 = time.perf_counter()
        _infer(params, cfg, rows, a0)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    profiled = _profile_chunk(mesh, lambda: _infer(params, cfg, rows, a0))

    calls = []
    launch = fa.mot_attention_fused_sharded

    def recording(q, k, v, mask, softcap=50.0, kv_replicated=False):
        if mesh.rank == 0:
            calls.append((*(x.detach().cpu() for x in (q, k, v, mask)), softcap))
        return launch(q, k, v, mask, softcap, kv_replicated)

    fa.mot_attention_fused_sharded = recording  # ops.attention looks it up at each call
    try:
        _infer(params, cfg, rows, a0)
    finally:
        fa.mot_attention_fused_sharded = launch
    _sync(dev)

    per_rank = torch.tensor(
        [dev.index if cuda else -1, weights, peak, float(torch.equal(first, second)), launches,
         statistics.median(times), build_s],
        dtype=torch.float64, device=dev,
    )
    per_rank = collectives.all_gather(per_rank[None], dim=0).cpu()
    out.update(
        chunk=collectives.all_gather(first, mesh.data_group, dim=0).cpu().numpy(),
        backend=mesh.backend,
        card=torch.cuda.get_device_name(dev) if cuda else "cpu",
        ranks=[
            {"device": f"cuda:{int(r[0])}" if r[0] >= 0 else "cpu", "weights_gb": float(r[1]) / 1e9,
             "peak_mem_gb": float(r[2]) / 1e9, "bitwise_equal_chunks": bool(r[3]),
             "launches": int(r[4]), "chunk_ms_median": float(r[5]), "build_s": float(r[6])}
            for r in per_rank
        ],
        chunk_ms=times,
        profile=profiled,
        calls=calls,
    )
    return out


def _profile_chunk(mesh: Mesh, run, top: int = 12) -> Optional[dict]:
    """One more chunk, under ``torch.profiler`` on rank 0 (the other ranks
    run it plain): its wall time, the device's busy time, and the host ops
    with the most self time (where the staged collectives' waits show)."""
    from contextlib import nullcontext

    from torch.profiler import ProfilerActivity, profile

    cuda = mesh.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    torch.distributed.barrier()
    with profile(activities=acts) if mesh.rank == 0 else nullcontext() as prof:
        t0 = time.perf_counter()
        run()
        _sync(mesh.device)
        wall = (time.perf_counter() - t0) * 1e3
    if prof is None:
        return None
    events = [e for e in prof.key_averages() if not e.is_user_annotation]
    device = [e for e in events if e.device_type.name == "CUDA"]
    host = sorted((e for e in events if e.device_type.name == "CPU"), key=lambda e: e.self_cpu_time_total, reverse=True)
    return {
        "wall_ms": wall,
        "device_busy_ms": sum(e.self_device_time_total for e in device) / 1e3,
        "host_top": [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in host[:top]],
    }


# --------------------------------------------------------------------------- #
# training on a data mesh
# --------------------------------------------------------------------------- #


def _host(x: torch.Tensor) -> torch.Tensor:
    """A copy on the CPU (``.cpu()`` of a CPU tensor is the tensor itself)."""
    return x.detach().to("cpu", copy=True)


def _numpy(x: torch.Tensor) -> np.ndarray:
    """A copy: ``.numpy()`` of a CPU tensor shares its memory, which a later
    update would change."""
    return _host(x).numpy()


def _numpy_tree(tree):
    return tree_map(_numpy, tree)


def opt_state_numpy(state_dict: dict) -> dict:
    """An optimizer state dict in the one-device layout as numpy: the
    per-param tensors and each group's hyperparameters and counts."""
    return {
        "state": {i: {k: _numpy(v) for k, v in st.items()} for i, st in state_dict["state"].items()},
        "groups": [{k: v for k, v in g.items() if k != "params"} for g in state_dict["param_groups"]],
    }


def moment_bytes(opt_state) -> int:
    """The bytes of the optimizer state that this rank holds."""
    inner = getattr(opt_state, "inner", opt_state)
    return sum(t.numel() * t.element_size() for st in inner.state.values() for t in st.values() if torch.is_tensor(t))


class _Spans:
    """The calls of ``owner.<name>`` (those that ``counts`` accepts, by
    their arguments), counted and timed while the block runs without making
    the host wait: on the card a pair of CUDA events on the current stream
    around each call, read by ``take`` once the caller has synchronised; on
    the CPU the host clock. Callers look the function up on ``owner`` at
    each call."""

    def __init__(self, owner, name: str, device: torch.device, counts=None):
        self.owner, self.name, self.device, self.counts = owner, name, device, counts
        self.spans = []

    def _now(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _spanned(self, *args, **kwargs):
        if self.counts is not None and not self.counts(*args, **kwargs):
            return self._original(*args, **kwargs)
        start = self._now()
        out = self._original(*args, **kwargs)
        self.spans.append((start, self._now()))
        return out

    def __enter__(self):
        self._original = getattr(self.owner, self.name)
        setattr(self.owner, self.name, self._spanned)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self._original)
        return False

    def take(self) -> tuple:
        """(ms, calls) of the spans since the last ``take``."""
        if self.device.type == "cuda":
            ms = sum(a.elapsed_time(b) for a, b in self.spans)
        else:
            ms = sum(b - a for a, b in self.spans) * 1e3
        out, self.spans = (ms, len(self.spans)), []
        return out


class _Timed:
    """Per update: the loss and grad norm, the device-synchronised ms of
    the train step, the kernels' launches, and the ms of its data group's
    gradient all-reduce (``collectives.all_reduce_mean_``, where it runs);
    under a model axis of ``mesh`` also K1-shard's calls and the ms and
    count of the model group's all-reduces (``collectives.all_reduce``).
    Each is a ``_Spans``: the host never waits on them, so the update's ms
    is the unwrapped step's."""

    def __init__(self, device: torch.device, mesh: Optional[Mesh] = None):
        self.device = device
        self.losses, self.grad_norms, self.update_ms, self.allreduce_ms = [], [], [], []
        self.launches, self.bwd_launches = [], []
        self.shard_calls, self.model_allreduce_ms, self.model_allreduce_calls = [], [], []
        self.spans = {"data": _Spans(collectives, "all_reduce_mean_", device)}
        if mesh is not None and mesh.n_model > 1:
            self.spans["model"] = _Spans(collectives, "all_reduce", device,
                                         lambda x, group=None, op=None: group is mesh.model_group)
            self.spans["shard"] = _Spans(fa, "mot_attention_fused_sharded", device)

    def __enter__(self):
        for spans in self.spans.values():
            spans.__enter__()
        return self

    def __exit__(self, *exc):
        for spans in reversed(self.spans.values()):
            spans.__exit__(*exc)
        return False

    def step(self, step_fn, state, batch) -> dict:
        _sync(self.device)
        k1, bwd = fa.launches, fa.bwd_launches
        t0 = time.perf_counter()
        metrics = step_fn(state, batch)
        _sync(self.device)
        self.update_ms.append((time.perf_counter() - t0) * 1e3)
        self.launches.append(fa.launches - k1)
        self.bwd_launches.append(fa.bwd_launches - bwd)
        self.losses.append(float(metrics["loss"]))
        self.grad_norms.append(float(metrics["grad_norm"]))
        ms, calls = self.spans["data"].take()
        if calls:
            self.allreduce_ms.append(ms)
        if "model" in self.spans:
            ms, calls = self.spans["model"].take()
            self.model_allreduce_ms.append(ms)
            self.model_allreduce_calls.append(calls)
            self.shard_calls.append(self.spans["shard"].take()[1])
        return metrics


def _peak_gb(device: torch.device) -> float:
    return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else 0.0


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _trained(params: dict) -> list:
    return [x for x in tree_leaves(params) if x.requires_grad]


def _opt_tensors(state_dict: dict) -> list:
    return [v for _, st in sorted(state_dict["state"].items()) for _, v in sorted(st.items()) if torch.is_tensor(v)]


def state_numpy(state) -> dict:
    """A TrainState in the one-device layout as numpy: the ZeRO-1 slices
    gathered (a collective)."""
    return {
        "step": state.step, "params": _numpy_tree(state.params), "opt": opt_state_numpy(state.opt_state.state_dict()),
        "avg": None if state.avg is None else _numpy_tree(avg_lib.gathered(state.avg, state.params)),
        "n_averaged": None if state.avg is None else state.avg.n_averaged,
        "generator": _numpy(state.generator.get_state()),
    }


def _gather_objects(mesh: Mesh, obj) -> list:
    out = [None] * mesh.size
    torch.distributed.all_gather_object(out, obj)
    return out


def _update_on_fresh_batch(agent) -> None:
    """One update on the first batch of a fresh iterator of the agent's
    dataset (its shard)."""
    it = agent.dataset.iterator(agent.step_batch_size)
    try:
        batch = agent.next_update_batch(it)
    finally:
        it.close()
    agent.train_step(agent.state, batch)


def agent_rank(mesh: Mesh, cfg, resume_cfg, partial: str) -> dict:
    """The TrainAgent on this rank: ``cfg``'s run (its frame batches
    recorded, its validations kept), the state it saved at its last update
    (gathered), one more update on a fresh iterator's first batch; then
    rank 0 makes the partial checkpoint directory ``partial`` (no
    meta.json) and a second agent from ``resume_cfg`` (``auto``) resumes and
    takes the same update. Returns the ranks' frames, the validations
    (results and the ranks' model inputs: the stand-in tokenizer numbers
    words as a process first meets them), the states and the resumed
    agent's step and cnt_batch."""
    import os

    from open_pi_zero_torch.agents.train import TrainAgent

    frames = []
    agent = TrainAgent(cfg, device=mesh.device)
    iterator, validate = agent.dataset.iterator, agent.validate
    validations = {}

    def recording(batch_size):
        for batch in iterator(batch_size):
            images, actions = batch["observation"]["image_primary"], batch["action"]
            frames.extend(images[i].tobytes() + actions[i].tobytes() for i in range(len(actions)))
            yield batch

    def validating(update):
        inputs = []  # the model inputs of this rank's validation batches

        def preprocess(batch):
            inputs.append(TrainAgent.preprocess_batch(agent, batch))
            return inputs[-1]

        agent.preprocess_batch = preprocess
        try:
            result = validate(update)
        finally:
            del agent.preprocess_batch
        validations[update] = {"result": result, "inputs": _gather_objects(mesh, inputs)}
        return result

    agent.dataset.iterator, agent.validate = recording, validating
    agent.run()
    del agent.dataset.iterator, agent.validate
    saved = state_numpy(agent.state)
    _update_on_fresh_batch(agent)
    continued = state_numpy(agent.state)
    if mesh.rank == 0:
        os.makedirs(os.path.join(partial, "state"))
    torch.distributed.barrier()
    resumed = TrainAgent(resume_cfg, device=mesh.device)
    resumed_at, cnt_batch = resumed.state.step, resumed.cnt_batch
    _update_on_fresh_batch(resumed)
    return {
        "frames": _gather_objects(mesh, frames), "validations": validations, "saved": saved,
        "continued": continued, "resumed": state_numpy(resumed.state), "resumed_at": resumed_at,
        "cnt_batch": (agent.cnt_batch - agent.grad_accum, cnt_batch), "zero1": agent.zero1,
        "moment_bytes": _gather_objects(mesh, moment_bytes(agent.state.opt_state)),
    }


def restore_rank(mesh: Mesh, cfg) -> dict:
    """A TrainAgent that restores ``cfg``'s ``resume_checkpoint_path``:
    its state in the one-device layout and each rank's moment bytes."""
    from open_pi_zero_torch.agents.train import TrainAgent

    agent = TrainAgent(cfg, device=mesh.device)
    return {"state": state_numpy(agent.state), "zero1": agent.zero1,
            "moment_bytes": _gather_objects(mesh, moment_bytes(agent.state.opt_state))}


def latest_rank(mesh: Mesh, ckpt_dirs: List[str]) -> list:
    """Each rank's ``TrainAgent._latest_checkpoint`` when rank r looks in
    ``ckpt_dirs[r]``: rank 0's choice, broadcast."""
    import types

    from open_pi_zero_torch.agents.train import TrainAgent

    return _gather_objects(mesh, TrainAgent._latest_checkpoint(types.SimpleNamespace(ckpt_dir=ckpt_dirs[mesh.rank])))


# --------------------------------------------------------------------------- #
# chip_smoke.py dp-main and scripts/dp_probe.py: full-width DP on the card
# --------------------------------------------------------------------------- #


def _full_width_params(cfg: PiZeroConfig, seed: int, device: torch.device) -> dict:
    """A recipe's params from its seed on ``device``, fp32, with the
    config's NF4 bases."""
    return lora_lib.quantize_per_model_config(pizero.init_params(cfg, seed=seed, device=device), cfg)


def dp_updates(mesh: Mesh, cfg, batches: List[dict], zero1: bool, keep: bool = False,
               adam_eps: Optional[float] = None, params: Optional[dict] = None) -> dict:
    """``_updates`` of the recipe ``cfg`` (a loaded train config; its
    accumulation over this mesh) at full width, fp32, at Adam's
    ``adam_eps`` if given (the configs' loader keeps optax's default), from
    ``params`` or the recipe's seed: per update the loss, the grad norm, the
    update's and the all-reduce's ms and the kernels' launches; the peak
    memory and the optimizer-state bytes of this rank. With ``keep``, also
    the trained leaves and the optimizer state in the one-device layout, on
    the CPU."""
    import dataclasses

    from open_pi_zero_torch.config import pizero_config_from_dict, training_config_from_dict

    dev = mesh.device
    _exact_fp32()
    model_cfg, train_cfg = pizero_config_from_dict(cfg), training_config_from_dict(cfg)
    if adam_eps is not None:
        train_cfg = dataclasses.replace(train_cfg, adam_eps=adam_eps)
    seed = int(cfg.get("seed", 42))
    params = _full_width_params(model_cfg, seed, dev) if params is None else params
    accum = train_cfg.global_batch_size // (train_cfg.per_device_batch_size * mesh.n_data)
    state, _, record = _updates(mesh, model_cfg, train_cfg, params, batches, accum, zero1, seed)
    out = {**{k: record[k] for k in ("losses", "grad_norms", "update_ms", "allreduce_ms", "launches", "bwd_launches",
                                     "peak_gb")},
           "moment_bytes": moment_bytes(state.opt_state), "accum": accum}
    if keep:
        out["trained"] = [_host(x) for x in _trained(state.params)]
        out["opt"] = {"state": {i: {k: _host(v) for k, v in st.items()}
                                for i, st in state.opt_state.state_dict()["state"].items()}}
    return out


def dp_probe_rank(mesh: Mesh, cfg, batches: List[dict], zero1: bool) -> list:
    """``dp_updates`` on every rank; returns each rank's numbers."""
    got = dp_updates(mesh, cfg, batches, zero1)
    return _gather_objects(mesh, {**got, "rank": mesh.rank, "backend": mesh.backend, "device": str(mesh.device)})


def dp_reference_rank(mesh: Mesh, cfg, batches: List[dict], out_path: str, adam_eps: Optional[float] = None) -> dict:
    """One process alone (a world of one): the updates of ``dp_updates``
    on the whole global batches; the trained leaves saved to ``out_path``
    for the ranks to compare with. Returns the numbers."""
    got = dp_updates(mesh, cfg, batches, zero1=False, keep=True, adam_eps=adam_eps)
    torch.save(got.pop("trained"), out_path)
    got.pop("opt")
    return got


def _bitwise(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> bool:
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def dp_main_rank(mesh: Mesh, raw_cfg, raw_batches: List[dict], adam_eps: float, reference: str, agent_cfg,
                 resume_cfg) -> dict:
    """``chip_smoke.py``'s dp-main on this rank, at full width:
      1. the raw DP update of ``raw_cfg`` (at Adam's ``adam_eps``) on ``raw_batches`` with
         replicated moments, then from the same params with ZeRO-1:
         the two bitwise equal (trained leaves, moments in the one-device
         layout); rank 0 holds the replicated update against the one
         process's update in ``reference`` (``dp_reference_rank``);
      2. the TrainAgent of ``agent_cfg`` (ZeRO-1, data from cfg.data): its
         run (updates timed, a save at its last update), one more update
         on a fresh iterator's first batch; then a fresh agent of
         ``resume_cfg`` resumes from that save and takes the same update:
         bitwise the continued one.
    Returns every rank's numbers (rank order) and the comparisons."""
    import gc

    from open_pi_zero_torch.agents.train import TrainAgent
    from open_pi_zero_torch.config import pizero_config_from_dict, training_config_from_dict

    dev = mesh.device
    _exact_fp32()
    t0 = time.perf_counter()
    params = _full_width_params(pizero_config_from_dict(raw_cfg), int(raw_cfg.get("seed", 42)), dev)
    labels = opt_lib.build_optimizer(training_config_from_dict(raw_cfg), params).labels
    trained = [x for lab, x in zip(tree_leaves(labels), tree_leaves(params)) if lab != "frozen"]
    initial = [_host(x) for x in trained]
    raw = {}
    for zero1 in (False, True):
        with torch.no_grad():  # both updates start from the same params
            for x, x0 in zip(trained, initial):
                x.copy_(x0)
        raw[zero1] = dp_updates(mesh, raw_cfg, raw_batches, zero1, keep=True, adam_eps=adam_eps, params=params)
        gc.collect()
    del params, trained, initial
    rep, z1 = raw[False], raw[True]
    out = {
        "raw": {name: {k: v for k, v in r.items() if k not in ("trained", "opt")} for name, r in
                (("replicated", rep), ("zero1", z1))},
        "zero1_bitwise": _bitwise(rep["trained"], z1["trained"]) and _bitwise(_opt_tensors(rep["opt"]),
                                                                               _opt_tensors(z1["opt"])),
        "raw_s": time.perf_counter() - t0,
    }
    if mesh.rank == 0:
        want = torch.load(reference, weights_only=True)
        out["vs_reference_max_abs_diff"] = max(float((a - b).abs().max()) for a, b in zip(rep["trained"], want))
        out["trained_leaves"] = len(want)
    del raw, rep, z1
    gc.collect()

    t0 = time.perf_counter()
    _reset_peak(dev)
    agent = TrainAgent(agent_cfg, device=dev)
    build_s = time.perf_counter() - t0
    train_step, save = agent.train_step, agent.save
    timed, saves = _Timed(dev), []

    def timed_save(update):
        t = time.perf_counter()
        path = save(update)
        saves.append(time.perf_counter() - t)
        return path

    agent.train_step = lambda state, batch: timed.step(train_step, state, batch)
    agent.save = timed_save
    with timed:
        agent.run()
    agent.train_step, agent.save = train_step, save
    run = {"losses": timed.losses, "update_ms": timed.update_ms, "allreduce_ms": timed.allreduce_ms,
           "launches": timed.launches,
           "bwd_launches": timed.bwd_launches, "peak_gb": _peak_gb(dev), "save_s": saves, "build_s": build_s,
           "moment_bytes": moment_bytes(agent.state.opt_state), "zero1": agent.zero1, "accum": agent.grad_accum}
    _update_on_fresh_batch(agent)
    continued = ([_host(x) for x in _trained(agent.state.params)],
                 [_host(t) for t in _opt_tensors(agent.state.opt_state.state_dict())], agent.state.generator.get_state())
    saved_cnt = agent.cnt_batch - agent.grad_accum
    del agent, train_step, save
    gc.collect()
    _reset_peak(dev)

    t0 = time.perf_counter()
    resumed = TrainAgent(resume_cfg, device=dev)
    run["resume_s"] = time.perf_counter() - t0
    run["resumed_at"], run["resumed_cnt_batch"], run["saved_cnt_batch"] = resumed.state.step, resumed.cnt_batch, saved_cnt
    _update_on_fresh_batch(resumed)
    after = ([_host(x) for x in _trained(resumed.state.params)],
             [_host(t) for t in _opt_tensors(resumed.state.opt_state.state_dict())], resumed.state.generator.get_state())
    run["resume_bitwise"] = _bitwise(continued[0], after[0]) and _bitwise(continued[1], after[1]) and torch.equal(
        continued[2], after[2])
    run["resume_max_abs_diff"] = max(float((a.float() - b.float()).abs().max()) for a, b in
                                     zip(continued[0] + continued[1], after[0] + after[1]))
    run["resume_peak_gb"] = _peak_gb(dev)
    out["agent"] = run
    return {"ranks": _gather_objects(mesh, out), "backend": mesh.backend,
            "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}


# --------------------------------------------------------------------------- #
# training on a (data, model) mesh: the tests, dryrun_multichip, tp_probe,
# chip_smoke.py tp-train and phase 10
# --------------------------------------------------------------------------- #


def megatron_rank(mesh: Mesh, x: np.ndarray, w1: np.ndarray, w2: np.ndarray, g: np.ndarray) -> dict:
    """Megatron's MLP pair over the model group, on whole numpy inputs:
    ``sum_row_parallel(gelu(copy_to_model_group(x) @ w1[:, mine]) @ w2[mine])``
    with this rank's slice ``mine`` of the hidden width, and its VJP for the
    cotangent ``g``. Returns y, every rank's dx, and the grads of w1 and w2
    gathered whole."""
    dev, n, i = mesh.device, mesh.n_model, mesh.model_index
    full = w1.shape[1]
    width = full // n
    x_t = torch.from_numpy(x).to(dev).requires_grad_()
    w1_t = torch.from_numpy(w1[:, i * width : (i + 1) * width]).to(dev).requires_grad_()
    w2_t = torch.from_numpy(w2[i * width : (i + 1) * width]).to(dev).requires_grad_()
    hidden = torch.nn.functional.gelu(collectives.copy_to_model_group(x_t, width, full) @ w1_t)
    y = collectives.sum_row_parallel(hidden @ w2_t, width, full)
    dx, dw1, dw2 = torch.autograd.grad(y, (x_t, w1_t, w2_t), torch.from_numpy(g).to(dev))
    return {"y": _numpy(y), "dx": _gather_objects(mesh, _numpy(dx)),
            "dw1": _numpy(collectives.all_gather(dw1, mesh.model_group, dim=1)),
            "dw2": _numpy(collectives.all_gather(dw2, mesh.model_group, dim=0))}


def _updates(mesh: Optional[Mesh], cfg: PiZeroConfig, train_cfg: TrainingConfig, params: dict, batches: List[dict],
             accum: int, zero1: bool = False, seed: int = 0, grads: bool = False) -> tuple:
    """The TrainState of ``params`` (the train stream of ``seed``; ZeRO-1
    with ``zero1``) after an update on each global batch (numpy; a leading
    [accum] axis when ``accum`` > 1; optional ``t`` and ``x0`` inject the
    flow times and the noise): this rank's rows under ``mesh``, the whole
    batch with None (no mesh registered: one device's path). Returns the
    state, with ``grads`` the first update's grads (after the data group's
    all-reduce, before the surgery and the clip; else None), and the
    record: per update the loss, the grad norm, the ms, the data group's
    gradient all-reduce ms, the kernels' launches and, under a model axis,
    K1-shard's calls and the model group's all-reduce ms and count
    (``_Timed``); the peak memory."""
    dev = params["embed_tokens"].device
    optimizer = opt_lib.build_optimizer(train_cfg, params)
    state = init_train_state(params, optimizer, seeds.stream_generator(seed, seeds.TRAIN, device=dev), train_cfg)
    if zero1:
        state = shard_state_zero1(state, optimizer, mesh)
    step = make_train_step(cfg, train_cfg, optimizer, accum)
    first = {}
    if grads:
        update = optimizer.update

        def recording(tree, *args):
            if not first:
                first["grads"] = tree_map(lambda p: None if p.grad is None else p.grad.detach().clone(), tree)
            return update(tree, *args)

        optimizer.update = recording
    _reset_peak(dev)
    try:
        with _Timed(dev, mesh) as timed:
            for batch in batches:
                batch = _on(batch, dev)
                if mesh is not None:
                    batch = shard_batch(mesh, batch, axis=1 if accum > 1 else 0)
                timed.step(step, state, batch)
    finally:
        if grads:
            del optimizer.update  # the class's method again: no cycle through the wrapper keeps the grads
    record = {k: getattr(timed, k) for k in ("losses", "grad_norms", "update_ms", "allreduce_ms", "launches",
                                             "bwd_launches", "shard_calls", "model_allreduce_ms",
                                             "model_allreduce_calls")}
    record["peak_gb"] = _peak_gb(dev)
    return state, first.get("grads"), record


def _paths(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [item for k, v in tree.items() for item in _paths(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def _max_diffs(got: dict, want: dict) -> dict:
    """max|got - want| over the leaves of ``want`` (path -> tensor), and its
    largest ratio to a leaf's max|want| (a leaf of zeros counts its
    max|got|)."""
    got = dict(_paths(got))
    abs_err = rel_err = 0.0
    for path, w in want.items():
        err = float((got[path].detach().float().cpu() - w.float()).abs().max())
        scale = float(w.abs().max())
        abs_err, rel_err = max(abs_err, err), max(rel_err, err / scale if scale else err)
    return {"max_abs_diff": abs_err, "max_rel_diff": rel_err}


def _alike_over_model_group(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> bool:
    """Whether each tensor is bitwise the same on every rank of the model
    group (each gathered in turn; every rank compares), on every rank."""
    same = True
    for x in tensors:
        parts = collectives.all_gather(x[None], mesh.model_group, dim=0)
        same = same and all(torch.equal(part, x) for part in parts)
    flag = torch.tensor([float(same)], device=mesh.device)
    collectives.all_reduce(flag, op=torch.distributed.ReduceOp.MIN)
    return bool(flag[0])


def _replicated_bitwise(mesh: Mesh, params: dict, specs: dict) -> bool:
    """Whether every replicated trained leaf is bitwise the same on every
    rank of the model group. The frozen leaves, drawn alike and never
    updated, are not gathered (the NF4 bases are checked apart)."""
    spec_of = dict(_paths(specs))
    return _alike_over_model_group(mesh, [x for path, x in _paths(params) if not spec_of[path] and x.requires_grad])


def _nf4_leaves(params: dict) -> dict:
    """The NF4 bases' payloads and absmax by path."""
    return {path: x for path, x in _paths(params) if path.endswith(("/q4", "/absmax"))}


def _int8_moments_check(mesh: Mesh, opt_state) -> Optional[dict]:
    """The int8 moments of the rank's slices of split leaves (``AdamW8bit``
    under a model axis), gathered whole over the model group, against
    the whole-leaf blockwise quantization of their gathered fp32 values:
    the codes and the scales that differ (0 when the ranks coded their
    slices with the whole leaf's block maxima), and whether every rank
    holds the same scales. None without such moments."""
    if not isinstance(opt_state, quantized_adam.AdamW8bit) or not opt_state.slices:
        return None
    codes = scales = 0
    moments = []
    for p, blocks in opt_state.slices.items():
        st = opt_state.state[p]
        for m, power in (("mu", quantized_adam.M_POWER), ("nu", quantized_adam.V_POWER)):
            scale = st[f"{m}_scale"]
            moments.append(scale)
            whole = collectives.all_gather(st[m], mesh.model_group, dim=blocks.dim).reshape(-1)
            ids = torch.arange(whole.numel(), device=whole.device) // blocks.block
            values = dequantize_blocks(whole, scale.view(-1)[ids], power)
            want = quantize_blockwise(values, blocks.block, power)
            codes += int((want.q.view(-1)[: whole.numel()] != whole).sum())
            scales += int((want.scale != scale).sum())
    return {"leaves": len(opt_state.slices), "codes_differ": codes, "scales_differ": scales,
            "scales_alike": _alike_over_model_group(mesh, moments)}


def _one_process_updates(cfg: PiZeroConfig, train_cfg: TrainingConfig, params: dict, batches: List[dict],
                         accum: int, seed: int, everything: bool) -> dict:
    """The updates of ``_updates`` in this process alone (no mesh: one
    device's path) on the whole global batches. Returns the record and, on
    the CPU by path, the trained leaves of the params after the last update
    (with ``everything``, also of the first update's grads and of the
    average)."""
    state, grads, record = _updates(None, cfg, train_cfg, params, batches, accum, seed=seed, grads=everything)
    trained = [path for path, x in _paths(state.params) if x.requires_grad]
    trees = {"params": state.params}
    if everything:
        trees["grads"] = grads
        if state.avg is not None:
            trees["avg"] = avg_lib.gathered(state.avg, state.params)
    return {"record": record, **{name: {path: _host(x) for path, x in _paths(tree) if path in trained}
                                 for name, tree in trees.items()}}


def train_rank(mesh: Mesh, cfg: PiZeroConfig, train_cfg: TrainingConfig, batches: List[dict], accum: int = 1,
               zero1: bool = False, params_np: Optional[dict] = None, seed: int = 0,
               reference: Optional[str] = None, keep: bool = True) -> dict:
    """``_updates`` in fp32 on this rank's place in a (data, model) mesh:
    its TP shard of the params (``shard_params_tp``) when the model axis is
    above 1, ZeRO-1 with ``zero1``. The params are ``params_np`` (a JAX
    tree of numpy leaves) or drawn on the rank's device from ``seed``,
    quantized as ``cfg`` says. With ``reference`` (a device), rank 0 first
    takes the same updates alone on that device (the mesh cleared: one
    device's path) from the same params.

    Returns, on rank 0: its losses and grad norms; every rank's record
    (``_updates``) and optimizer-state bytes; the number of averaged
    updates; whether the replicated trained leaves are bitwise equal over
    each model group after the updates; with NF4 bases, whether every
    rank's are bitwise as drawn and alike over its model group (``nf4``);
    under a model axis, the int8 moments of the rank's slices gathered
    against the whole-leaf quantization of their values
    (``int8_moments``, None with fp32 moments); the reference's record and
    the params (and the LoRA adapters apart), gathered whole, against it;
    the program's seconds on rank 0, in
    all and in its parts (the reference, the updates, the checks). With
    ``keep``, also as numpy: the params, the first update's grads and the
    average gathered whole, the optimizer state (the one-device layout on a
    data mesh, the rank's shards under a model axis) and the reference's
    trained leaves by path."""
    dev = mesh.device
    _exact_fp32()
    t0 = time.perf_counter()
    tp = mesh.n_model > 1

    def fresh(device: torch.device) -> dict:
        params = params_from_jax(params_np, device=device) if params_np is not None else tree_map(
            lambda x: x.to(device), pizero.init_params(cfg, seed=seed, device=dev))
        return lora_lib.quantize_per_model_config(params, cfg)

    out, want = {}, None
    if reference is not None and mesh.rank == 0:
        threads = torch.get_num_threads()
        set_mesh(None)
        if torch.device(reference).type == "cpu":  # the other ranks wait at the barrier below meanwhile
            torch.set_num_threads(len(os.sched_getaffinity(0)))
        try:
            want = _one_process_updates(cfg, train_cfg, fresh(torch.device(reference)), batches, accum, seed, keep)
        finally:
            set_mesh(mesh)
            torch.set_num_threads(threads)
        out["reference"] = want.pop("record")
    if reference is not None:
        torch.distributed.barrier()  # the ranks start their updates together, after the reference
    t1 = time.perf_counter()
    params, specs = fresh(dev), None
    if tp:
        specs = tp_param_specs(params, cfg, mesh.n_model)
        params = shard_params_tp(params, cfg, mesh)
    nf4 = {path: x.clone() for path, x in _nf4_leaves(params).items()}
    state, grads, record = _updates(mesh, cfg, train_cfg, params, batches, accum, zero1, seed, grads=keep)
    t2 = time.perf_counter()

    def whole(tree):
        return gather_tp(tree, specs, mesh) if tp else tree

    out.update(losses=record["losses"], grad_norms=record["grad_norms"],
               ranks=_gather_objects(mesh, {**record, "rank": mesh.rank}),
               moment_bytes=_gather_objects(mesh, moment_bytes(state.opt_state)),
               n_averaged=None if state.avg is None else state.avg.n_averaged,
               replicated_bitwise=_replicated_bitwise(mesh, state.params, specs) if tp else True)
    if nf4:  # every rank's NF4 bases bitwise as drawn, and alike over each model group
        after = _nf4_leaves(state.params)
        unchanged = torch.tensor([float(all(torch.equal(x, after[path]) for path, x in nf4.items()))], device=dev)
        collectives.all_reduce(unchanged, op=torch.distributed.ReduceOp.MIN)
        out["nf4"] = {"leaves": len(nf4), "unchanged": bool(unchanged[0]),
                      "alike": _alike_over_model_group(mesh, list(after.values()))}
    if tp:
        out["int8_moments"] = _int8_moments_check(mesh, state.opt_state)
    trees = {"params": whole(state.params)} if reference is not None or keep else {}
    if keep:
        trees["grads"] = whole(grads)
        trees["avg"] = None if state.avg is None else whole(avg_lib.gathered(state.avg, state.params))
    if want is not None:
        out["vs_reference"] = {name: _max_diffs(trees[name], tree) for name, tree in want.items()}
        adapters = {path: x for path, x in want["params"].items() if "_lora/" in path}
        if adapters:
            out["vs_reference"]["adapters"] = _max_diffs(trees["params"], adapters)
    if keep:
        out.update({name: None if tree is None else tree_map(lambda x: None if x is None else _numpy(x), tree)
                    for name, tree in trees.items()})
        out["opt"] = opt_state_numpy(state.opt_state.state_dict())
        if want is not None:
            out.update({f"reference_{name}": {path: x.numpy() for path, x in tree.items()}
                        for name, tree in want.items()})
    t3 = time.perf_counter()
    out.update(backend=mesh.backend, card=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               seconds=t3 - t0, parts_s={"reference": t1 - t0, "updates": t2 - t1, "checks": t3 - t2})
    return out
