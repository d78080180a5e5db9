"""Memory and time of tensor-parallel training: the fp32 full fine-tune of
``PiZeroConfig()`` at its full widths on a (1, 2) mesh of ranks
(``parallel/ranks.train_rank``), against rank 0's unsharded updates.

  python -m open_pi_zero_torch.scripts.tp_probe [--layers N] [--device cuda|cpu]

Both towers cut to ``--layers`` (0, the default, keeps the config's 18
and 27), remat, EMA from the first update, Adam's eps 1e-3 and the first
update at the full lr (``chip_smoke.py``'s phase 7 and tp-train), params
from seed 0 on each rank's device, UPDATES updates of BATCH x ACCUM
synthetic rows whose flow times and noise the train stream draws; rank 0
first takes them alone on its device. With a card per rank the ranks take
NCCL, on one card gloo. It prints one line, ``tp probe: {json}``: per rank
the update ms, the model group's all-reduce ms (CUDA events: the host does
not wait on them) and calls, the peak memory and the kernels' launches per
update; the unsharded updates' and the TP updates' losses, norms and
params against them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from open_pi_zero_torch.config import LRSchedulerConfig, PiZeroConfig, TrainingConfig
from open_pi_zero_torch.parallel import ranks, run_ranks
from open_pi_zero_torch.scripts.dp_probe import synthetic_batch

BATCH, ACCUM, UPDATES = 4, 2, 3


def probe_config(layers: int) -> PiZeroConfig:
    cfg = PiZeroConfig()
    if layers:
        cfg = dataclasses.replace(cfg, joint=dataclasses.replace(cfg.joint, num_hidden_layers=layers),
                                  siglip=dataclasses.replace(cfg.siglip, num_hidden_layers=layers))
    return dataclasses.replace(cfg, joint=dataclasses.replace(cfg.joint, remat=True))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=0, help="both towers' depth; 0 keeps the config's")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tp_probe: CUDA is not available; pass --device cpu to run on the CPU")
    cfg = probe_config(args.layers)
    sched = LRSchedulerConfig(warmup_steps=0)
    train_cfg = TrainingConfig(action_lr_scheduler=sched, vlm_lr_scheduler=sched, adam_eps=1e-3, use_ema=True,
                               ema_start=0)
    rng = np.random.default_rng(0)
    batches = [synthetic_batch(cfg, BATCH, ACCUM, rng) for _ in range(UPDATES)]
    got = run_ranks(ranks.train_rank, 1, 2, cfg, train_cfg, batches, ACCUM, False, None, 0, args.device, False,
                    device=args.device, timeout_s=1800)
    result = {
        "depth": {"joint": cfg.joint.num_hidden_layers, "siglip": cfg.siglip.num_hidden_layers},
        "batch": BATCH, "accum": ACCUM, "backend": got["backend"], "card": got["card"],
        "seconds": got["seconds"], "replicated_bitwise": got["replicated_bitwise"],
        "ranks": [{k: r[k] for k in ("rank", "losses", "grad_norms", "update_ms", "model_allreduce_ms",
                                     "model_allreduce_calls", "peak_gb", "launches", "bwd_launches", "shard_calls")}
                  for r in got["ranks"]],
        "reference": {k: got["reference"][k] for k in ("losses", "grad_norms", "update_ms", "peak_gb", "launches",
                                                       "bwd_launches")},
        "vs_reference": got["vs_reference"],
    }
    print("tp probe: " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
