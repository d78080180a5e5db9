"""The multi-rank dry run: data-parallel, DP x TP and serving phases on a
world of ranks (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

  python -m open_pi_zero_torch.scripts.dryrun_multichip [--device cuda|cpu] [--world N] [--tiny] [--workdir DIR]

One world of N ranks (4 by default, an even number of at least 4) runs the
phases one after the other, each on a mesh of its world: (N, 1) for data
parallelism, (N / 2, 2) for DP x TP. Rank 0 prints one ``DRYRUN_LEDGER
{json}`` line per phase. At the tiny config (``config.tiny_pizero_config``),
fp32, as the JAX function's phases:

  tiny_dp_step          one DP update (EMA on), one row per rank; the loss finite
  tiny_dp_tp_step       the same update on (N / 2, 2) with TP-sharded params:
                        its loss within 1e-3 of tiny_dp_step's
                        (``__graft_entry__.py:283``); the replicated leaves
                        bitwise equal over each model group
  tiny_dp_serving       the production layout (fused, int8 action expert,
                        W8A8 VLM and SigLIP) on the data mesh against one
                        device's chunk: max|diff| <= 1e-4
  tiny_fp32_tp_serving  fp32 TP = 2 serving (each model group serves the same
                        2 rows) against one device's chunk: <= 1e-4

then the multi-process check (``scripts/dryrun_multiprocess.py``: torchrun
ranks, ZeRO-1, a collective save and a resume), then at the full widths of
``config.bridge_width_dryrun_config`` (trunk 2048/16384, 8 Q / 1 KV heads of
256, expert 1024/4096, SigLIP 1152/4304, depth 2), where the JAX function
compiles some phases only, each executed:

  bridge_zero1_accum              ZeRO-1 and accumulation 2 on the data mesh
  bridge_tp_step                  DP x TP against the DP update: loss within 1e-3
  bridge_serving                  the production layout on the data mesh
                                  against one device's chunk: <= 1e-3
  bridge_fp32_tp_serving          fp32 TP = 2 against one device: <= 1e-3

(1e-3 at bridge widths: TP reassociates the row-parallel sums, and an int8
activation on a rounding tie may round the other way; phases 4b and 10 of
``chip_smoke.py`` hold the same layouts to it.) ``--tiny`` runs the tiny
phases only. A final line ``dryrun_multichip(N): COMPLETE {json}`` lists the
phases run. The ranks run on the card unless ``--device cpu`` (ranks that
share a card take gloo, a card each NCCL). A phase that fails ends the run
with an error; no phase is skipped. None imports JAX.
"""

from __future__ import annotations

import argparse
import datetime
import json
import tempfile
import time

import numpy as np
import torch

from open_pi_zero_torch.config import TrainingConfig, bridge_width_dryrun_config, tiny_pizero_config
from open_pi_zero_torch.models import fuse, pizero
from open_pi_zero_torch.parallel import collectives, ranks
from open_pi_zero_torch.parallel.mesh import Mesh, make_mesh, run_ranks, set_mesh, shard_batch
from open_pi_zero_torch.parallel.sharding import shard_params_tp
from open_pi_zero_torch.scripts.dp_probe import synthetic_batch

TIMEOUT_S = 600.0  # every collective of the world
TRAIN = dict(use_ema=True, ema_start=0)  # the JAX function's TrainingConfig
TIERS = dict(quantize_mixtures=("action",), w8a8_mixtures=("vlm",), w8a8_siglip=True)  # the production layout


def ledger(phase: str, status: str, t0: float, **kw) -> None:
    print("DRYRUN_LEDGER " + json.dumps({"phase": phase, "status": status, "elapsed_s": round(time.time() - t0, 1),
                                         **kw}), flush=True)


def example_batch(cfg, b: int, seed: int, accum: int = 0) -> dict:
    """``b`` rows of ``dp_probe.synthetic_batch`` (image tokens, <bos> and
    three text tokens; seeded pixels, proprio and actions, so that a wrong
    split of the rows moves the loss); with ``accum`` a leading
    accumulation axis."""
    batch = synthetic_batch(cfg, b, max(accum, 1), np.random.default_rng(seed))
    return batch if accum else {k: v[0] for k, v in batch.items()}


class World:
    """The meshes of one world of N ranks: ``dp`` (N, 1), the one ``run_ranks``
    made, and ``tp`` (N / 2, 2), made once on every rank; ``dp`` stays
    registered between the phases."""

    def __init__(self, dp: Mesh, timeout_s: float):
        self.dp = dp
        self.tp = make_mesh(dp.size // 2, 2, dp.device, datetime.timedelta(seconds=timeout_s))
        set_mesh(dp)

    def updates(self, mesh: Mesh, cfg, batch: dict, seed: int, accum: int = 1, zero1: bool = False) -> dict:
        """One update of ``cfg``'s params from ``seed`` under ``mesh``."""
        set_mesh(mesh)
        try:
            return ranks.train_rank(mesh, cfg, TrainingConfig(**TRAIN), [batch], accum, zero1, seed=seed, keep=False)
        finally:
            set_mesh(self.dp)

    def chunks(self, mesh: Mesh, cfg, params: dict, batch: dict, noise: np.ndarray) -> tuple:
        """(this mesh's chunk of ``batch`` gathered over the data ranks, one
        device's chunk on rank 0 (None elsewhere)). ``params`` are whole; under
        a model axis each rank keeps its TP shard."""
        dev = mesh.device
        inputs = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        x0 = torch.from_numpy(noise).to(dev)

        def infer(p, t, a0):
            return pizero.infer_action(p, cfg, None, t["input_ids"], t["pixel_values"], t["attention_mask"],
                                       t["proprios"], action0=a0)

        one = None
        set_mesh(None)
        try:
            if mesh.rank == 0:
                one = infer(params, inputs, x0).cpu().numpy()
        finally:
            set_mesh(mesh)
        try:
            if mesh.n_model > 1:
                params = shard_params_tp(params, cfg, mesh)
            rows = shard_batch(mesh, {**inputs, "x0": x0})
            chunk = infer(params, rows, rows["x0"])
            return collectives.all_gather(chunk, mesh.data_group, dim=0).cpu().numpy(), one
        finally:
            set_mesh(self.dp)


def _max_diff(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"chunk {got.shape} vs {want.shape}, or not finite")
    return float(np.abs(got - want).max())


def _check(name: str, ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"{name}: {what}")


def train_phases(world: World, cfg, prefix: str, seed: int) -> dict:
    """The DP update and the DP x TP update of one batch (one row per rank)
    from the same params: the losses within 1e-3."""
    n = world.dp.size
    batch = example_batch(cfg, n, seed)
    t0 = time.time()
    dp = world.updates(world.dp, cfg, batch, seed)
    loss = dp["ranks"][0]["losses"][0]
    _check(f"{prefix}_dp_step", np.isfinite(loss), f"loss {loss}")
    out = {"dp_loss": loss}
    if prefix == "tiny" and world.dp.rank == 0:
        ledger("tiny_dp_step", "ok", t0, loss=loss, mesh=[n, 1])
    t0 = time.time()
    tp = world.updates(world.tp, cfg, batch, seed)
    tp_loss = tp["ranks"][0]["losses"][0]
    name = f"{prefix}_dp_tp_step" if prefix == "tiny" else "bridge_tp_step"
    _check(name, abs(tp_loss - loss) < 1e-3, f"DP x TP loss {tp_loss} vs DP loss {loss} on the same params and batch")
    _check(name, tp["replicated_bitwise"], "the replicated leaves differ over a model group")
    _check(name, len({r["losses"][0] for r in tp["ranks"]}) == 1, "the ranks' losses differ")
    if world.dp.rank == 0:
        ledger(name, "ok", t0, loss=tp_loss, dp_loss=loss, loss_diff=abs(tp_loss - loss), mesh=[n // 2, 2],
               update_ms=[r["update_ms"][0] for r in tp["ranks"]])
    out["tp_loss"] = tp_loss
    return out


def serving_phases(world: World, cfg, prefix: str, seeds: tuple, tol: float) -> dict:
    """The production layout on the data mesh, then fp32 TP = 2 (each model
    group serving the same rows), each against one device's chunk."""
    dev, n = world.dp.device, world.dp.size
    t0 = time.time()
    sparams = fuse.prepare_for_serving(pizero.init_params(cfg, seed=seeds[0], device=dev), **TIERS)
    batch = example_batch(cfg, n, seeds[1])
    noise = np.random.default_rng(seeds[1]).normal(size=(n, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
    chunk, one = world.chunks(world.dp, cfg, sparams, batch, noise)
    del sparams
    out = {}
    name = f"{prefix}_dp_serving" if prefix == "tiny" else "bridge_serving"
    if world.dp.rank == 0:
        out[name] = err = _max_diff(chunk, one)
        _check(name, err <= tol, f"DP serving vs one device max|diff| {err} > {tol}")
        ledger(name, "ok", t0, max_diff=err, mesh=[n, 1])

    t0 = time.time()
    rows = 2 if prefix == "tiny" else 1  # the JAX function's batch for the phase
    params = pizero.init_params(cfg, seed=seeds[2], device=dev)
    batch = example_batch(cfg, rows, seeds[3])
    noise = np.random.default_rng(seeds[3]).normal(size=(rows, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
    tiled = {k: np.concatenate([v] * world.tp.n_data) for k, v in batch.items()}
    chunk, one = world.chunks(world.tp, cfg, params, tiled, np.concatenate([noise] * world.tp.n_data))
    name = f"{prefix}_fp32_tp_serving"
    if world.dp.rank == 0:
        out[name] = err = _max_diff(chunk, np.concatenate([one[:rows]] * world.tp.n_data))
        _check(name, err <= tol, f"fp32 TP = 2 serving vs one device max|diff| {err} > {tol}")
        ledger(name, "ok", t0, max_diff=err, mesh=[world.tp.n_data, 2])
    return out


def phases_rank(mesh: Mesh, tiny: bool, timeout_s: float) -> dict:
    """Every phase of the world on this rank (rank 0 prints the ledger);
    returns rank 0's results."""
    world = World(mesh, timeout_s)
    out = {"tiny": {**train_phases(world, tiny_pizero_config(), "tiny", 0),
                    **serving_phases(world, tiny_pizero_config(), "tiny", (2, 3, 8, 9), 1e-4)}}
    if tiny:
        return out
    bcfg = bridge_width_dryrun_config()
    t0 = time.time()
    accum = 2
    got = world.updates(mesh, bcfg, example_batch(bcfg, mesh.size, 5, accum), 4, accum, zero1=True)
    loss = got["ranks"][0]["losses"][0]
    _check("bridge_zero1_accum", np.isfinite(loss), f"loss {loss}")
    if mesh.rank == 0:
        ledger("bridge_zero1_accum", "ok", t0, loss=loss, accum=accum, mesh=[mesh.size, 1],
               update_ms=[r["update_ms"][0] for r in got["ranks"]])
    out["bridge"] = {"zero1_accum_loss": loss, **train_phases(world, bcfg, "bridge", 4),
                     **serving_phases(world, bcfg, "bridge", (6, 7, 8, 9), 1e-3)}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--world", type=int, default=4, help="ranks: an even number of at least 4")
    ap.add_argument("--tiny", action="store_true", help="the tiny phases only")
    ap.add_argument("--workdir", default=None, help="the multi-process check's logs and checkpoints")
    args = ap.parse_args(argv)
    if args.world < 4 or args.world % 2:
        raise SystemExit(f"dryrun_multichip: --world {args.world}: an even number of at least 4 ranks")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun_multichip: CUDA is not available; pass --device cpu to run on the CPU")
    t_start = time.time()
    n = args.world
    results = run_ranks(phases_rank, n, 1, args.tiny, TIMEOUT_S, device=args.device, timeout_s=TIMEOUT_S)
    phases = [f"tiny_{p}" for p in ("dp_step", "dp_tp_step", "dp_serving", "fp32_tp_serving")]
    if not args.tiny:
        from open_pi_zero_torch.scripts import dryrun_multiprocess

        t0 = time.time()
        mp = dryrun_multiprocess.run_parent(args.workdir or tempfile.mkdtemp(prefix="opz_multichip_"), args.device)
        ledger("multiprocess", "ok", t0, loss_diff=mp["loss_diff_vs_single"], n_processes=mp["n_processes"])
        phases += ["multiprocess", "bridge_zero1_accum", "bridge_tp_step", "bridge_serving", "bridge_fp32_tp_serving"]
    summary = {"n_ranks": n, "device": args.device, "total_s": round(time.time() - t_start, 1), "phases": phases,
               "results": results}
    print(f"dryrun_multichip({n}): COMPLETE " + json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
