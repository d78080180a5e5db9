"""Quick single-episode Simpler smoke with latency measurement
(counterpart of the JAX package's ``scripts/try_checkpoint_in_simpler.py``;
reference scripts/try_checkpoint_in_simpler.py: runs one task, prints the
per-chunk inference latency without the first chunk, :111-115,145).

  python -m open_pi_zero_torch.scripts.try_checkpoint_in_simpler \\
      --task simpler_lite_reach --checkpoint /path/to/ckpt \\
      --config configs/eval/simpler_lite.yaml [--device cpu]

Video (``--record_video``) needs ``imageio``, and a real Simpler task
``simpler_env``: where they are missing that raises ImportError.
"""

from __future__ import annotations

import argparse
import logging

from open_pi_zero_torch.agents.eval import EvalAgent
from open_pi_zero_torch.config import load_config


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="configs/eval/bridge.yaml")
    parser.add_argument("--task", default=None)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--n_episodes", type=int, default=1)
    parser.add_argument("--use_bf16", action="store_true")
    parser.add_argument("--record_video", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    overrides = [f"n_eval_episode={args.n_episodes}"]
    if args.task:
        overrides.append(f"env.task={args.task}")
    if args.checkpoint:
        overrides.append(f"checkpoint_path={args.checkpoint}")
    if args.use_bf16:
        overrides.append("use_bf16=true")
    overrides.append(f"record_video={'true' if args.record_video else 'false'}")

    cfg = load_config(args.config, overrides)
    result = EvalAgent(cfg, device=args.device).run()
    print(result)
    if result["mean_inference_time_s"] is not None:
        print(f"mean inference latency: {result['mean_inference_time_s'] * 1e3:.1f} ms")
    return result


if __name__ == "__main__":
    main()
