"""Closed-loop eval of a demo_closed_loop checkpoint WITHOUT retraining
(counterpart of the JAX package's ``scripts/eval_scaleup_ckpt.py``).

Any ``ckpt_N/params`` export (the EMA-blended eval params that
``training/checkpoint.py:save_checkpoint`` writes beside the state) is
scored through the same ``run_eval`` path ``demo_closed_loop`` uses, so a
learning curve's intermediate checkpoints, or a run cut short, are
comparable with the full run's result. An orbax checkpoint of the JAX
package raises with the command line that converts it
(``training/checkpoint.refuse_orbax``).

  python -m open_pi_zero_torch.scripts.eval_scaleup_ckpt --workdir build/opz_reach \\
      --ckpt ckpt_4000 --hidden 96 --layers 3 --heads 4 --kv-heads 1 \\
      --n-eval-episodes 40 [--control] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="build/opz_demo")
    ap.add_argument("--ckpt", required=True, help="ckpt_N dir name under workdir/train/checkpoint")
    ap.add_argument("--task", default="reach", choices=["reach", "pick_place", "drawer"])
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=1)
    # same default as demo_closed_loop (0 -> max(16, hidden//4)) so the
    # geometry defaults stay in sync between the train and eval scripts
    ap.add_argument("--head-dim", type=int, default=0)
    ap.add_argument("--proprio-dim", type=int, default=0,
                    help="0 = infer from task family (8 for drawer/fractal, "
                         "7 for bridge); pass 8 explicitly for a bridge task "
                         "inside a cross-family checkpoint")
    ap.add_argument("--drawer-target", default=None, choices=["top", "middle", "bottom"])
    ap.add_argument("--n-eval-episodes", type=int, default=40)
    ap.add_argument("--eval-seed", type=int, default=1000)
    ap.add_argument("--control", action="store_true", help="also run the random-init control eval")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    from open_pi_zero_torch import resolve_device
    from open_pi_zero_torch.config import ConfigDict, pizero_config_from_dict
    from open_pi_zero_torch.models import pizero
    from open_pi_zero_torch.scripts.demo_closed_loop import fresh_tokenizer, model_geometry, run_eval
    from open_pi_zero_torch.training import checkpoint as ckpt_lib

    device = resolve_device(args.device)
    # mirror demo_closed_loop's per-task selection: fractal-family tasks use
    # 8-dim POS_QUAT proprio + the EDR sticky-gripper adapter; bridge tasks
    # inside a cross-family checkpoint pad 7-dim proprio to the model's 8
    # (pass --proprio-dim 8 for those)
    proprio_dim = args.proprio_dim or (8 if args.task == "drawer" else 7)
    geometry = model_geometry(args.hidden, args.layers, proprio_dim=proprio_dim,
                              heads=args.heads, kv_heads=args.kv_heads, head_dim=args.head_dim)
    cfg = pizero_config_from_dict(ConfigDict(geometry))
    ckpt_path = os.path.join(args.workdir, "train", "checkpoint", args.ckpt)
    params = ckpt_lib.restore_params(ckpt_path, pizero.abstract_params(cfg), device)
    # per-task statistics: demo_closed_loop writes statistics.json for the
    # mix's first dataset and statistics_<task>.json for the rest
    stats_path = os.path.join(args.workdir, f"statistics_{args.task}.json")
    if not os.path.exists(stats_path):
        stats_path = os.path.join(args.workdir, "statistics.json")
    kwargs = dict(
        task=args.task, adapter_name="edr" if args.task == "drawer" else "bridge",
        pad_proprio_to=args.proprio_dim if (args.proprio_dim and args.task != "drawer"
                                            and args.proprio_dim != 7) else None,
        env_task=f"drawer_{args.drawer_target}" if args.task == "drawer" and args.drawer_target else None,
        device=device, log_dir=os.path.join(args.workdir, "eval"),
    )

    result = {"ckpt": args.ckpt, "task": args.task, "n_eval_episodes": args.n_eval_episodes}
    result["trained"] = run_eval(geometry, params, stats_path, fresh_tokenizer(),
                                 args.n_eval_episodes, args.eval_seed, **kwargs)
    print("trained:", result["trained"])
    if args.control:
        rand = pizero.init_params(cfg, seed=123, device=device)
        result["control"] = run_eval(geometry, rand, stats_path, fresh_tokenizer(),
                                     args.n_eval_episodes, args.eval_seed, **kwargs)
        print("control:", result["control"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
