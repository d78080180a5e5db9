"""Memory and time of tensor-parallel training: a recipe at its full widths
on a (1, 2) mesh of ranks (``parallel/ranks.train_rank``), against rank
0's unsharded updates.

  python -m open_pi_zero_torch.scripts.tp_probe [--layers N] [--device cuda|cpu]
  python -m open_pi_zero_torch.scripts.tp_probe --config configs/train/bridge.yaml \\
      quantize=true lora=true [key=value ...] [--layers N] [--device cuda|cpu]

The recipe is the fp32 full fine-tune of ``PiZeroConfig()`` with EMA from
the first update (the JAX package's TP recipe), or a train YAML's with
``--config`` (bridge.yaml with ``quantize=true lora=true`` is its QLoRA
recipe: NF4 trunk and SigLIP bases, LoRA r 32, int8 Adam moments). Both
towers cut to ``--layers`` (0, the default, keeps the config's 18 and
27), remat, Adam's eps 1e-3 and the first update at the full lr
(``chip_smoke.py``'s phase 7 and tp-train), params from seed 0 on each
rank's device (NF4 bases quantized there, before the split), UPDATES
updates of BATCH x ACCUM synthetic rows whose flow times and noise the
train stream draws; rank 0 first takes them alone on its device. With a
card per rank the ranks take NCCL, on one card gloo. It prints one line,
``tp probe: {json}``: per rank the update ms, the model group's
all-reduce ms (CUDA events: the host does not wait on them) and calls,
the peak memory and the kernels' launches per update; the unsharded
updates' and the TP updates' losses, norms and params against them (the
LoRA adapters apart); with NF4 bases and int8 moments, their checks
(``train_rank``'s ``nf4`` and ``int8_moments``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional

import numpy as np
import torch

from open_pi_zero_torch.config import (
    LRSchedulerConfig,
    PiZeroConfig,
    TrainingConfig,
    load_config,
    pizero_config_from_dict,
    training_config_from_dict,
)
from open_pi_zero_torch.parallel import ranks, run_ranks
from open_pi_zero_torch.scripts.dp_probe import synthetic_batch

BATCH, ACCUM, UPDATES = 4, 2, 3


def probe_config(layers: int, cfg: PiZeroConfig) -> PiZeroConfig:
    """``cfg`` with both towers cut to ``layers`` (0 keeps them) and remat."""
    if layers:
        cfg = dataclasses.replace(cfg, joint=dataclasses.replace(cfg.joint, num_hidden_layers=layers),
                                  siglip=dataclasses.replace(cfg.siglip, num_hidden_layers=layers))
    return dataclasses.replace(cfg, joint=dataclasses.replace(cfg.joint, remat=True))


def recipe(config: Optional[str], overrides: List[str]) -> tuple:
    """(model config, training config): the fp32 full fine-tune of
    ``PiZeroConfig()`` with EMA, or the train YAML ``config``'s recipe;
    either at Adam's eps 1e-3 with the first update at the full lr."""
    sched = LRSchedulerConfig(warmup_steps=0)
    if config is None:
        return PiZeroConfig(), TrainingConfig(action_lr_scheduler=sched, vlm_lr_scheduler=sched, adam_eps=1e-3,
                                              use_ema=True, ema_start=0)
    raw = load_config(config, overrides)
    train_cfg = training_config_from_dict(raw)
    return pizero_config_from_dict(raw), dataclasses.replace(
        train_cfg, adam_eps=1e-3, action_lr_scheduler=dataclasses.replace(train_cfg.action_lr_scheduler, warmup_steps=0),
        vlm_lr_scheduler=dataclasses.replace(train_cfg.vlm_lr_scheduler, warmup_steps=0))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=0, help="both towers' depth; 0 keeps the config's")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--config", help="a train YAML whose recipe to probe (default: the fp32 full fine-tune)")
    ap.add_argument("overrides", nargs="*", help="key=value overrides of --config")
    args = ap.parse_args(argv)
    if args.overrides and args.config is None:
        ap.error("key=value overrides need --config")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("tp_probe: CUDA is not available; pass --device cpu to run on the CPU")
    model_cfg, train_cfg = recipe(args.config, args.overrides)
    cfg = probe_config(args.layers, model_cfg)
    rng = np.random.default_rng(0)
    batches = [synthetic_batch(cfg, BATCH, ACCUM, rng) for _ in range(UPDATES)]
    got = run_ranks(ranks.train_rank, 1, 2, cfg, train_cfg, batches, ACCUM, False, None, 0, args.device, False,
                    device=args.device, timeout_s=1800)
    result = {
        "recipe": args.config or "fp32 full fine-tune", "overrides": args.overrides,
        "depth": {"joint": cfg.joint.num_hidden_layers, "siglip": cfg.siglip.num_hidden_layers},
        "batch": BATCH, "accum": ACCUM, "backend": got["backend"], "card": got["card"],
        "seconds": got["seconds"], "replicated_bitwise": got["replicated_bitwise"],
        "nf4": got.get("nf4"), "int8_moments": got.get("int8_moments"), "moment_bytes": got["moment_bytes"],
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
