"""Rank programs: what ``parallel.run_ranks`` runs on every position of a
mesh, for the tests (on the CPU, over gloo) and for ``chip_smoke.py``
phases 9-11 (on the card). Each takes this rank's ``Mesh`` first and
returns, on rank 0, plain data on the CPU (numpy arrays, numbers).

They live in the package because a spawned process imports the function
it runs: none of them may pull in JAX.
"""

from __future__ import annotations

import statistics
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from open_pi_zero_torch.config import PiZeroConfig
from open_pi_zero_torch.models import pizero
from open_pi_zero_torch.models.from_jax import params_from_jax
from open_pi_zero_torch.models.tree import tree_map
from open_pi_zero_torch.ops import fused_attention as fa
from open_pi_zero_torch.ops.attention import mot_attention_ref
from open_pi_zero_torch.parallel import collectives
from open_pi_zero_torch.parallel.mesh import Mesh, set_mesh, shard_batch
from open_pi_zero_torch.parallel.sharding import shard_params_tp

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


def foreign_modules_rank(mesh: Mesh) -> list:
    """The modules of JAX or of the JAX package this rank has imported
    (none may be)."""
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
