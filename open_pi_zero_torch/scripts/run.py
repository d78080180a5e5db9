"""Launcher (counterpart of the JAX package's ``scripts/run.py``; reference
scripts/run.py, hydra): loads a YAML experiment config with ``${...}``
interpolation and key=value overrides (``config.load_config``) and
dispatches to the TrainAgent or the EvalAgent.

  python -m open_pi_zero_torch.scripts.run --config configs/eval/simpler_lite.yaml \\
      [--mode train|eval] [--device cuda|cpu] [key=value ...]

The mode is ``--mode``, else the config's ``mode``, else eval if the
config has an ``env`` block and train if not. The agents run on the card
unless ``--device cpu``. ``train`` builds the port's TrainAgent, which
reads its datasets from the config's ``data`` block.

``--distributed`` trains on a data mesh of the processes that torchrun
started (``parallel.init_distributed``, the counterpart of
``jax.distributed.initialize``): one rank per process, a card each
(NCCL) or ranks sharing cards (gloo), or CPU ranks with ``--device cpu``;
rank 0 logs. For example, two ranks:

  python -m torch.distributed.run --nproc_per_node 2 -m open_pi_zero_torch.scripts.run \\
      --config configs/train/bridge.yaml --distributed [key=value ...]
"""

from __future__ import annotations

import argparse
import logging

import torch

from open_pi_zero_torch.config import load_config
from open_pi_zero_torch.parallel.mesh import init_distributed, shutdown_distributed
from open_pi_zero_torch.utils.monitor import MainRankFilter


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, help="YAML experiment config")
    parser.add_argument(
        "--mode", choices=["train", "eval"], default=None,
        help="override auto-detection (eval if the config has an env block, else train)",
    )
    parser.add_argument(
        "--distributed", action="store_true",
        help="train on the data mesh of a torchrun launch (the JAX package's jax.distributed.initialize)",
    )
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    return parser.parse_args(argv)


def main(argv=None):
    """Run the config's agent. Returns the eval result, or the trained
    state."""
    args = parse_args(argv)
    cfg = load_config(args.config, args.overrides)

    logging.basicConfig(
        level=logging.DEBUG if cfg.get("debug") else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("run")

    mode = args.mode or cfg.get("mode")
    if mode is None:
        mode = "eval" if cfg.get("env") is not None else "train"
    log.info("mode=%s config=%s device=%s", mode, args.config, args.device)

    if args.distributed:
        if mode != "train":
            raise ValueError("--distributed trains on a data mesh; evaluation runs in one process")
        mesh = init_distributed(torch.device(args.device).type)
        for handler in logging.getLogger().handlers:
            handler.addFilter(MainRankFilter())
        log.info("rank %d of %d on %s over %s", mesh.rank, mesh.size, mesh.device, mesh.backend)
    if mode == "train":
        from open_pi_zero_torch.agents.train import TrainAgent

        try:
            return TrainAgent(cfg, device=args.device).run()
        finally:
            if args.distributed:
                shutdown_distributed()

    from open_pi_zero_torch.agents.eval import EvalAgent

    result = EvalAgent(cfg, device=args.device).run()
    log.info("result: %s", result)
    return result


if __name__ == "__main__":
    main()
