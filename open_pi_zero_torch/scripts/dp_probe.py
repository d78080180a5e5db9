"""Memory and time of a training recipe on a data mesh of ranks: the train
step of a config at its full width, on synthetic batches, in spawned ranks
(``parallel.run_ranks``), with ZeRO-1 and with replicated moments.

  python -m open_pi_zero_torch.scripts.dp_probe --config configs/train/bridge_v5e.yaml \\
      --ranks 2 --updates 2 [--zero1 both|on|off] [--device cuda|cpu] [key=value ...]

Each mode runs in a world of its own: the params of the config's seed, its
optimizer (int8 moments with ``quantize``), and ``--updates`` updates of
``per_device_batch_size`` rows per rank and microbatch with the config's
accumulation (``global_batch_size // (per_device_batch_size * ranks)``).
It prints one line per mode, ``dp probe: {json}``: per rank the peak
memory (GB), the update and the gradient all-reduce ms, the
optimizer-state bytes, the kernels' launches per update; the backend and
the card. A mode whose world fails (say, out of memory) prints its error
in place of the numbers. Ranks on one card share it over gloo; with a card
per rank they take NCCL.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from open_pi_zero_torch.config import load_config, pizero_config_from_dict, training_config_from_dict
from open_pi_zero_torch.parallel import ranks, run_ranks


def synthetic_batch(cfg, rows: int, accum: int, rng: np.random.Generator) -> dict:
    """``accum`` microbatches of ``rows``: the image tokens, BOS and three
    text tokens, normalized pixels, proprio and actions drawn from ``rng``."""
    n_img = cfg.siglip.num_image_tokens
    ids = np.zeros((accum, rows, cfg.max_image_text_tokens), np.int32)
    ids[..., :n_img] = cfg.image_token_index
    ids[..., n_img : n_img + 4] = [2, 100, 101, 102]
    size = cfg.siglip.image_size
    return {
        "input_ids": ids,
        "pixel_values": rng.uniform(-1, 1, size=(accum, rows, size, size, 3)).astype(np.float32),
        "attention_mask": (ids != cfg.pad_token_id).astype(np.int32),
        "proprios": rng.normal(size=(accum, rows, cfg.cond_steps, cfg.proprio_dim)).astype(np.float32),
        "actions": rng.uniform(-1, 1, size=(accum, rows, cfg.horizon_steps, cfg.action_dim)).astype(np.float32),
    }


def probe(cfg, n_ranks: int, updates: int, zero1: bool, device: str, timeout_s: float = 1800) -> dict:
    """One mode's world; its numbers, or its error."""
    model_cfg, train_cfg = pizero_config_from_dict(cfg), training_config_from_dict(cfg)
    pbs = train_cfg.per_device_batch_size
    accum = train_cfg.global_batch_size // (pbs * n_ranks)
    rng = np.random.default_rng(0)
    batches = [synthetic_batch(model_cfg, pbs * n_ranks, accum, rng) for _ in range(updates)]
    head = {"zero1": zero1, "ranks": n_ranks, "per_device_batch_size": pbs, "accum": accum, "updates": updates}
    try:
        rows = run_ranks(ranks.dp_probe_rank, n_ranks, 1, cfg, batches, zero1, device=device, timeout_s=timeout_s)
    except Exception as e:  # noqa: BLE001 - the mode's result is its error
        return {**head, "error": f"{type(e).__name__}: {str(e)[-600:]}"}
    card = torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu"
    return {**head, "backend": rows[0]["backend"], "card": card, "per_rank": rows}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="a train YAML")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--updates", type=int, default=2)
    ap.add_argument("--zero1", choices=["both", "on", "off"], default="both")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dp_probe: CUDA is not available; pass --device cpu to run on the CPU")
    cfg = load_config(args.config, args.overrides)
    modes = {"both": (True, False), "on": (True,), "off": (False,)}[args.zero1]
    results = []
    for zero1 in modes:
        results.append(probe(cfg, args.ranks, args.updates, zero1, args.device))
        print("dp probe: " + json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
