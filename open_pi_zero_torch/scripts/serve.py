"""Action-chunk serving daemon (counterpart of the JAX package's
``scripts/serve.py``): loads a checkpoint in the production serving layout
(W8A8 VLM trunk, int8 action expert, fused bf16 SigLIP), captures every
batch bucket's chunk as a CUDA graph, warms every bucket, and serves
batched action inference over TCP (protocol in ``serving.py``).

  python -m open_pi_zero_torch.scripts.serve --config configs/eval/bridge.yaml \\
      checkpoint_path=/path/to/ckpt.pt [--host 0.0.0.0] [--port 7011] \\
      [--batch-sizes 1,4,8,16] [--window-ms 3] [--max-inflight 1]

``--random-init`` skips the checkpoint and builds the serving params with
the streaming builder (``fuse.build_serving_params``) from the config's
seed, for load tests and protocol work before real weights land.
``refine_from_prev=0.5`` (a config override) enables the refined
steady-state tier: requests with a ``prev_chunk`` field are served by
``infer_action_refined`` from t = 0.5. ``--port 0`` takes a free port; the
log names it ("serving on host:port"). On SIGINT or SIGTERM the daemon
logs how many requests it answered, how many of them refined, and stops.

On a card (``--device cuda``, the default) it always serves the compiled
chunk; ``--device cpu`` serves the eager chunk. ``checkpoint_path`` is a
reference ``.pt`` (through ``models/convert.py``) or a checkpoint
directory of the port's trainer (``training/checkpoint.py``: its eval
export); LoRA adapters are merged and NF4 bases decoded before the serving
layout, as the JAX package's EvalAgent does. An orbax directory of the JAX
package raises NotImplementedError with the command line of
``convert_jax_checkpoint.py`` (repository root), which converts it into the
port's format where JAX and orbax are installed.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal

import numpy as np
import torch

from open_pi_zero_torch import resolve_device, serving
from open_pi_zero_torch.config import load_config, pizero_config_from_dict
from open_pi_zero_torch.models import convert, fuse, pizero
from open_pi_zero_torch.ops import lora as lora_lib
from open_pi_zero_torch.training import checkpoint as ckpt_lib

log = logging.getLogger("serve")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7011)
    parser.add_argument(
        "--batch-sizes",
        type=lambda s: [int(x) for x in s.split(",")],
        default=[1, 4, 8, 16],
        help="comma-separated bucket sizes, one CUDA graph each (e.g. 1,4,8,16)",
    )
    parser.add_argument("--window-ms", type=float, default=3.0)
    parser.add_argument("--max-inflight", type=int, default=1,
                        help="device queue depth: 1 = accumulate the next batch for the whole"
                             " current device run (fullest buckets under closed-loop robot"
                             " clients); raise for open-loop streams")
    parser.add_argument("--random-init", action="store_true",
                        help="serve random weights (streaming builder): no checkpoint needed")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the compiled chunk) or cpu (the eager chunk)")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    return parser.parse_args(argv)


def abstract_params(model_cfg) -> dict:
    """The param tree of ``model_cfg`` as ``meta`` tensors (shapes and
    dtypes, no storage), with the config's NF4 bases: what a checkpoint
    directory of this config must hold."""
    tree = pizero.abstract_params(model_cfg)
    return lora_lib.quantize_per_model_config(tree, model_cfg)


def merge_and_decode(params: dict, model_cfg, dtype) -> dict:
    """Fold the LoRA adapters into their bases (each mixture at its own
    ``lora_scaling``, then SigLIP and the projector at SigLIP's) and decode
    any quantized base to ``dtype``: the float tree that the serving
    layout starts from (the JAX package's ``EvalAgent._load_params``)."""
    if lora_lib.has_lora(params):
        joint = {
            "mixtures": {
                name: lora_lib.merge_lora(m, model_cfg.joint.mixture(name).lora_scaling)
                for name, m in params["joint"]["mixtures"].items()
            }
        }
        params = {**params, "joint": joint}
        for key in ("siglip", "projector"):
            if lora_lib.has_lora(params.get(key, {})):
                params[key] = lora_lib.merge_lora(params[key], model_cfg.siglip.lora_scaling)
    if lora_lib.has_quantized_bases(params):
        params = lora_lib.dequantize_base_weights(params, dtype)
    return params


def load_params(cfg, model_cfg, dtype, device, random_init: bool) -> dict:
    """The serving params: random from the config's seed, or a checkpoint
    (a reference ``.pt`` converted, or a directory of the port's trainer)
    cast to ``dtype`` on ``device``, its adapters merged and its NF4 bases
    decoded; then the serving layout of the config's knobs
    (``fuse.serving_layout_kwargs``), as the JAX package's EvalAgent builds
    it."""
    knobs = fuse.serving_layout_kwargs(cfg)
    if random_init:
        return fuse.build_serving_params(
            model_cfg, seed=int(cfg.get("seed", 42)), device=device, dtype=dtype, **knobs
        )
    path = cfg.get("checkpoint_path")
    if not path:
        raise ValueError("checkpoint_path=... is required without --random-init")
    path = os.path.expanduser(str(path))
    if path.endswith(".pt"):
        params = convert.load_vla_checkpoint(path, model_cfg, dtype)
    elif ckpt_lib.is_checkpoint(path):
        params = ckpt_lib.restore_params(path, abstract_params(model_cfg), device)
    else:
        ckpt_lib.refuse_orbax(path)
        raise NotImplementedError(
            f"{path}: neither a .pt nor a checkpoint directory of the port's trainer (the JAX package's orbax "
            f"checkpoints convert into one: {ckpt_lib.convert_hint(path)})"
        )
    params = convert.to_dtype(params, dtype, device)
    return fuse.prepare_for_serving(merge_and_decode(params, model_cfg, dtype), **knobs)


def example_request(model_cfg) -> dict:
    """One observation: all image tokens, <bos> and 7 text tokens, the rest
    padding; a black image and zero proprio (the JAX daemon's warm-up
    batch, its text token kept inside a small vocabulary)."""
    ids = np.zeros((model_cfg.max_image_text_tokens,), np.int32)
    n_img = model_cfg.siglip.num_image_tokens
    ids[:n_img] = model_cfg.image_token_index
    ids[n_img] = 2  # <bos>
    ids[n_img + 1 : n_img + 8] = min(100, model_cfg.vocab_size - 1)
    size = model_cfg.siglip.image_size
    return {
        "input_ids": ids,
        "pixel_values": np.zeros((size, size, 3), np.float32),
        "attention_mask": (ids != model_cfg.pad_token_id).astype(np.int32),
        "proprios": np.zeros((model_cfg.cond_steps, model_cfg.proprio_dim), np.float32),
    }


def build_policy(args: argparse.Namespace) -> tuple:
    """(BatchingPolicy, PiZeroConfig) of the parsed arguments, neither
    started nor warmed: the params loaded or built, and on a card every
    bucket's chunk (and refined chunk) captured."""
    cfg = load_config(args.config, overrides=args.overrides)
    model_cfg = pizero_config_from_dict(cfg)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if bool(cfg.get("use_bf16", True)) else torch.float32
    params = load_params(cfg, model_cfg, dtype, device, args.random_init)
    seed = int(cfg.get("seed", 42))
    refine_t = float(cfg.get("refine_from_prev", 0.0))
    if device.type == "cuda":
        infer_fn, refine_fn = serving.make_compiled_infer_fn(
            params, model_cfg, args.batch_sizes, refine_t=refine_t, device=device, seed=seed
        )
    else:
        infer_fn = serving.make_infer_fn(params, model_cfg, device=device, seed=seed)
        refine_fn = (
            serving.make_infer_fn(params, model_cfg, device=device, seed=seed + 1, t_start=refine_t)
            if refine_t > 0.0 else None
        )
    policy = serving.BatchingPolicy(
        infer_fn, batch_sizes=args.batch_sizes, batch_window_ms=args.window_ms,
        max_inflight=args.max_inflight, refine_fn=refine_fn,
    )
    return policy, model_cfg


def _stop(signum, frame):
    raise KeyboardInterrupt


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = parse_args(argv)
    policy, model_cfg = build_policy(args)
    policy.warmup(example_request(model_cfg))
    log.info("all batch buckets warmed; accepting traffic")
    signal.signal(signal.SIGTERM, _stop)
    try:
        serving.serve_forever(args.host, args.port, policy)
    except KeyboardInterrupt:
        pass
    finally:
        policy.stop()
        log.info("stopped: %d requests answered, %d of them by refine_fn", policy.n_requests, policy.n_refined)


if __name__ == "__main__":
    main()
