"""The reach recipe's seed study: a summary of several ``demo_closed_loop``
runs, merged into a result file under the key ``seed_study``.

Each run is the reach recipe (``demo_closed_loop --task reach`` at its
defaults) from one init: the port's ``--seed S`` or the JAX package's
``jax.random.key(K)`` through ``--init-params``. A run's result JSON is
named after its init, ``port_S.json`` or ``jax_K.json``. Per run the
summary keeps the loss per 50 updates, the first 50-update window whose
mean loss is under ``BREAK_LOSS`` (the "break"; JAX's loss breaks from
about 0.13 to 0.07), the success on the held-out layouts and the random-
init control's, the median update time and the card. The verdict counts
the runs that reach ``CRITERION`` (the JAX record's 0.85) per package.

  python -m open_pi_zero_torch.scripts.seed_study \\
      --into E2E_CLOSED_LOOP_TORCH.json runs/port_0.json runs/port_2.json ...
"""

from __future__ import annotations

import argparse
import json
import os
import re

BREAK_LOSS = 0.10
CRITERION = 0.85
WINDOW = 50  # updates per entry of a run's loss curve


def loss_break(curve: list):
    """[first, last] update of the first window whose mean loss is under
    BREAK_LOSS, or None."""
    for i, loss in enumerate(curve):
        if loss < BREAK_LOSS:
            return [i * WINDOW + 1, (i + 1) * WINDOW]
    return None


def summarize(result: dict) -> dict:
    curve = result["loss_per_50_updates"]
    return {
        "trained_success_rate": result["trained_success_rate"],
        "random_init_success_rate": result["random_init_success_rate"],
        "learned": result["trained_success_rate"] >= CRITERION,
        "loss_break_updates": loss_break(curve),
        "final_loss": curve[-1],
        "lowest_loss": min(curve),
        "update_ms": result["update_ms"],
        "timings_s": result["timings_s"],
        "device": result["device"],
        "loss_per_50_updates": curve,
    }


def run_name(path: str) -> str:
    name = os.path.splitext(os.path.basename(path))[0]
    if not re.fullmatch(r"(port|jax)_\d+", name):
        raise ValueError(f"{path}: a run's file is named port_<seed>.json or jax_<key>.json")
    return name


def study(paths: list) -> dict:
    runs = {}
    for path in paths:
        with open(path) as f:
            runs[run_name(path)] = summarize(json.load(f))
    learned = {pkg: [n for n, r in runs.items() if n.startswith(pkg) and r["learned"]] for pkg in ("port", "jax")}
    return {
        "recipe": "demo_closed_loop --task reach at its defaults (600 demos, 8,000 updates of B = 32, hidden 96, "
                  "3 layers, lr 1e-3); port_S: --seed S; jax_K: --init-params of jax.random.key(K)'s init",
        "criterion": CRITERION,
        "break_loss": BREAK_LOSS,
        "runs": runs,
        "learned": learned,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--into", required=True, help="the result JSON that takes the seed_study key")
    ap.add_argument("runs", nargs="+", help="run results, port_<seed>.json or jax_<key>.json")
    args = ap.parse_args(argv)
    summary = study(args.runs)
    with open(args.into) as f:
        result = json.load(f)
    result["seed_study"] = summary
    with open(args.into, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({n: {k: r[k] for k in ("trained_success_rate", "random_init_success_rate",
                                            "loss_break_updates", "update_ms")}
                      for n, r in summary["runs"].items()}))
    return summary


if __name__ == "__main__":
    main()
