"""Closed-loop success rate of every serving tier on a trained policy
(counterpart of the JAX package's ``scripts/e2e_tier_sweep.py``).

Each serving tier (bf16 fusion, int8 weight-only expert, W8A8 trunk, full
W8A8, NF4, midpoint integrator, refined warm-start) and each control
ablation is applied to the SAME trained checkpoint through
``EvalAgent._load_params`` (``scripts/serve.load_params``, the production
path) and scored on the SAME held-out episode layouts, from
``configs/eval/simpler_lite.yaml`` read through the port's YAML subset.

A 1.4M-param policy at 56x56 is not the 3B model: per-tier drift
magnitudes differ, but tier-vs-baseline success deltas on a real closed
loop are the evidence class the reference uses for its own bf16-vs-fp32
tables (reference README.md:90-114).

  python -m open_pi_zero_torch.scripts.e2e_tier_sweep \\
      --checkpoint build/opz_reach/train/checkpoint/ckpt_8000 \\
      --stats build/opz_reach/statistics.json --out E2E_TIER_SUCCESS_TORCH.json
"""

from __future__ import annotations

import argparse
import gc
import json
import os

import torch

TIERS = {
    # label -> config overrides on top of configs/eval/simpler_lite.yaml
    "fp32_fused": ["quantize=false"],
    "bf16_fused": ["quantize=false", "use_bf16=true"],
    "int8_expert": ["quantize=true", "w8a8=false"],
    "w8a8_default": ["quantize=true", "w8a8=true"],  # production default tier
    "w8a8_full": ["quantize=true", "w8a8=true", "w8a8_siglip=true"],
    "nf4_expert": ["quantize=true", "quantize_bits=4", "w8a8=false"],
    "midpoint3": ["quantize=false", "flow_integrator=midpoint",
                  "num_inference_steps=3"],
    "refined_t05": ["quantize=false", "refine_from_prev=0.5"],
    # control-sensitivity ablations (not serving tiers): how success
    # depends on re-planning frequency and flow integration depth
    "act_steps2": ["quantize=false", "act_steps=2"],
    "act_steps1": ["quantize=false", "act_steps=1"],
    "euler5": ["quantize=false", "num_inference_steps=5"],
    "euler3": ["quantize=false", "num_inference_steps=3"],
    "euler1": ["quantize=false", "num_inference_steps=1"],
}
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--stats", required=True)
    ap.add_argument("--n-episodes", type=int, default=40)
    ap.add_argument("--task", default="simpler_lite_reach",
                    help="env.task override — must match the checkpoint's task")
    ap.add_argument("--config", default="configs/eval/simpler_lite.yaml",
                    help="base eval config, relative to the repo's root (use "
                         "simpler_lite_drawer.yaml for the fractal-family drawer "
                         "task: EDR adapter, proprio_dim 8)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--tiers", default=None, help="comma list; default all")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    from open_pi_zero_torch.agents.eval import EvalAgent
    from open_pi_zero_torch.config import load_config
    from open_pi_zero_torch.scripts.demo_closed_loop import device_info

    device = torch.device(args.device)
    # the agents' log_dir beside the checkpoint, not the config's default
    log_dir = os.path.join(os.path.dirname(os.path.abspath(args.checkpoint)), "tier_sweep")
    results = {}
    names = args.tiers.split(",") if args.tiers else list(TIERS)
    for name in names:
        cfg = load_config(
            os.path.join(REPO, args.config),
            overrides=[
                f"checkpoint_path={args.checkpoint}",
                f"env.adapter.dataset_statistics_path={args.stats}",
                f"n_eval_episode={args.n_episodes}",
                f"env.task={args.task}",
                f"log_dir={log_dir}",
                *TIERS[name],
            ],
        )
        out = EvalAgent(cfg, device=device).run()
        results[name] = {
            "success_rate": out["success_rate"],
            "n_episodes": out["n_episodes"],
            "overrides": TIERS[name],
            "mean_inference_time_s": out["mean_inference_time_s"],
        }
        print(name, out["success_rate"], flush=True)
        gc.collect()  # the agent's graphs go with it, before the next capture

    payload = {
        "checkpoint": args.checkpoint,
        "task": args.task,
        "device": device_info(device),
        "note": (
            "closed-loop success per serving tier, same trained SimplerLite "
            "policy, same held-out layouts; a 1.4M-param model, so tier "
            "deltas, not absolute 3B drift, are the evidence"
        ),
        "tiers": results,
    }
    print(json.dumps(payload))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
    return payload


if __name__ == "__main__":
    main()
