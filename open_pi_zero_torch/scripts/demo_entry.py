"""One entry of ``E2E_CLOSED_LOOP_TORCH.json`` from a demonstration's
outputs: a ``demo_closed_loop`` result, the ``eval_scaleup_ckpt`` scores
of its intermediate checkpoints, the JAX package's entry for the same
recipe (``E2E_CLOSED_LOOP.json``) and the runs from other seeds; the
verdict against ``CRITERION`` is written from the numbers (and names the
init of a run that trained from another init than its seed's: the
``init`` that ``demo_closed_loop --init-params`` writes). With
``--by-n-demos`` instead of ``--run``: a data-efficiency entry from one
run per demo count, each rate beside JAX's ``success_by_n_demos``. With ``--tier-sweep`` instead: one
task's entry of ``E2E_TIER_SUCCESS_TORCH.json`` from an ``e2e_tier_sweep``
result, each tier beside JAX's rate on the same task
(``E2E_TIER_SUCCESS.json``, its ``tiers`` and ``control_ablations``) and
both packages' distance from ``fp32_fused``. Merge the entry with
``merge_e2e_entry``.

  python -m open_pi_zero_torch.scripts.demo_entry --run pick_place_s0.json \\
      --command "python -m open_pi_zero_torch.scripts.demo_closed_loop ..." \\
      --curve pp_ckpt_6000.json pp_ckpt_12000.json --jax-key pick_place \\
      --out pick_place_entry.json
  python -m open_pi_zero_torch.scripts.merge_e2e_entry --src pick_place_entry.json \\
      --dst E2E_CLOSED_LOOP_TORCH.json --key pick_place
  python -m open_pi_zero_torch.scripts.demo_entry --by-n-demos reach_100.json reach_300.json \\
      --command "python -m open_pi_zero_torch.scripts.demo_closed_loop ..." \\
      --jax-key data_efficiency_reach --out data_efficiency_reach.json
  python -m open_pi_zero_torch.scripts.demo_entry --tier-sweep tiers_pick_place.json \\
      --command "python -m open_pi_zero_torch.scripts.e2e_tier_sweep ..." --jax-key pick_place \\
      --out pick_place_tiers.json
"""

from __future__ import annotations

import argparse
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# a learned policy: JAX's reach record (0.95) less 0.10, and clear of its control
CRITERION = {"success": 0.85, "above_control": 0.5}
# a drawer leg is held to JAX's own rate, within about two standard errors
# of 40 episodes near 0.3, where JAX ran the drawer code the port copies
# (its round-4 expert and render: docs/DRAWER_INVESTIGATION.md); the drawer
# legs of its older entries are reported beside JAX's, not held
DRAWER_BAND = 0.15
DRAWER_HELD = ("tri_lever", "drawer_lever_solo_round5", "drawer_solo_round4")
# entries reported beside JAX's run, not held, and why
REPORTED = {
    "scale_up_reach": "JAX's run, which did not learn either",
    "drawer_single_task": "JAX's run on its round-3 drawer code (its expert and render changed since)",
}
# the JAX reach recipe's result keys at the root of E2E_CLOSED_LOOP.json
# (its other recipes are entries under their keys)
ROOT_KEYS = ("task", "n_demos", "n_updates", "n_eval_episodes", "expert_success_rate", "trained_success_rate",
             "random_init_success_rate", "success_at_8k_updates", "model", "timings_s", "devices")
# the serving tiers held within TIER_BAND of fp32_fused; the rest are reported
SERVING_TIERS = ("bf16_fused", "int8_expert", "w8a8_default", "w8a8_full", "nf4_expert", "midpoint3")
TIER_BAND = 0.10


def per_task(value, tasks: list) -> dict:
    """A rate of a run as {task: rate}: multi runs report dicts."""
    return value if isinstance(value, dict) else {tasks[0]: value}


def learning_curve(paths: list, multi: bool) -> dict:
    """{ckpt_N: score} from ``eval_scaleup_ckpt`` outputs (multi: {ckpt_N:
    {task: score}}), in update order."""
    curve = {}
    for path in paths:
        with open(path) as f:
            out = json.load(f)
        score = {k: out["trained"][k] for k in ("success_rate", "success_by_instruction")}
        if "control" in out:
            score["control_success_rate"] = out["control"]["success_rate"]
        if multi:
            curve.setdefault(out["ckpt"], {})[out["task"]] = score
        else:
            curve[out["ckpt"]] = score
    return dict(sorted(curve.items(), key=lambda kv: int(kv[0].split("_")[1])))


def criterion(jax_key: str) -> dict:
    """What an entry's legs are held to: CRITERION for the bridge legs,
    DRAWER_BAND of JAX's rate for a drawer leg of DRAWER_HELD, nothing
    where JAX's own run did not learn (REPORTED)."""
    if jax_key in REPORTED:
        return {"reported_beside_jax": True}
    if jax_key in DRAWER_HELD:
        return {**CRITERION, "drawer_within_jax": DRAWER_BAND}
    return CRITERION


def verdict(run: dict, jax: dict, jax_key: str = "") -> tuple:
    """(passed, text): each bridge leg at least CRITERION["success"] and
    CRITERION["above_control"] above its random-init control; a drawer leg
    (its task named so) within DRAWER_BAND of JAX's rate where the entry is
    in DRAWER_HELD, else reported; an entry in REPORTED is reported leg by
    leg beside JAX's."""
    trained = per_task(run["trained_success_rate"], [run["task"]])
    tasks = list(trained)
    control = per_task(run["random_init_success_rate"], tasks)
    jax_trained = per_task(jax["trained_success_rate"], tasks)
    jax_control = per_task(jax["random_init_success_rate"], tasks)
    parts, passed = [], True
    for t in tasks:
        if jax_key in REPORTED or ("drawer" in t and jax_key not in DRAWER_HELD):
            ok, how = None, "reported"
        elif "drawer" in t:
            ok = abs(trained[t] - jax_trained[t]) <= DRAWER_BAND + 1e-9
            how = f"{'within' if ok else 'outside'} {DRAWER_BAND} of JAX"
        else:
            ok = trained[t] >= CRITERION["success"] and trained[t] - control[t] >= CRITERION["above_control"]
            how = "passes" if ok else "misses"
        passed &= ok is not False
        parts.append(f"{t}: trained {trained[t]} (JAX {jax_trained[t]}), control {control[t]} "
                     f"(JAX {jax_control[t]}): {how}")
    if jax_key in REPORTED:
        head = f"REPORTED beside {REPORTED[jax_key]}"
    else:
        bar = f"at least {CRITERION['success']} and {CRITERION['above_control']} above the control"
        if jax_key in DRAWER_HELD:
            bar += f"; a drawer leg within {DRAWER_BAND} of JAX's rate"
        head = f"{'PASSED' if passed else 'MISSED'} ({bar})"
    init = f", init: {run['init']}" if run.get("init") else ""
    text = (f"{head} after {run['n_updates']} updates on {run['n_eval_episodes']} held-out layouts, seed "
            f"{run['seed']}{init}, on {run['device']}: " + "; ".join(parts))
    return passed, text


def jax_entry(doc: dict, key: str) -> dict:
    """The JAX package's entry ``key`` of E2E_CLOSED_LOOP.json; '' = the
    reach recipe's result at its root."""
    return doc[key] if key else {k: doc[k] for k in ROOT_KEYS}


def entry(run: dict, command: str, curve: dict, jax_key: str, jax: dict, others: list) -> dict:
    out = {"run": command, **run}
    if curve:
        model = run.get("model")
        at = f" at the run's geometry (hidden {model['hidden']}, {model['layers']} layers)" if model else ""
        out["learning_curve"] = {
            "by": f"open_pi_zero_torch/scripts/eval_scaleup_ckpt.py{at}: each checkpoint's params/ export (the EMA "
                  f"blend from half-way), {run['n_eval_episodes']} episodes at seed 1000", **curve}
        if "ckpt_12000" in curve and not isinstance(run["trained_success_rate"], dict):
            out["at_12k_updates"] = curve["ckpt_12000"]["success_rate"]
    where = f"[{jax_key!r}]" if jax_key else "'s root"
    out["jax_reference"] = {"source": f"E2E_CLOSED_LOOP.json{where}: the JAX package, JPEG frames", **jax}
    out["criterion"] = criterion(jax_key)
    out["verdict"] = verdict(run, jax, jax_key)[1]
    if others:
        out["other_seeds"] = {f"seed_{o['seed']}": {**{k: o[k] for k in (
            "trained_success_rate", "random_init_success_rate", "update_ms", "timings_s", "device",
            "loss_per_50_updates")}, "verdict": verdict(o, jax, jax_key)[1]} for o in others}
    return out


def n_demos_entry(runs: list, command: str, jax_key: str, jax: dict) -> dict:
    """A data-efficiency entry: one run per demo count, each rate beside
    JAX's ``success_by_n_demos``. A count where JAX's policy learned (at
    least ``CRITERION["success"]``) is held to CRITERION; one where it did
    not (reach's 100 demos, 0.225) is reported beside it."""
    runs = sorted(runs, key=lambda r: r["n_demos"])
    kept = ("trained_success_rate", "random_init_success_rate", "n_updates", "seed", "update_ms", "batch_wait_ms",
            "timings_s", "device", "loss_per_50_updates")
    by_n, parts, passed = {}, [], True
    for run in runs:
        n = str(run["n_demos"])
        rate, control = run["trained_success_rate"], run["random_init_success_rate"]
        theirs = jax["success_by_n_demos"].get(n)
        if theirs is None or theirs < CRITERION["success"]:
            ok, how = None, "reported (JAX's policy did not learn at this count)"
        else:
            ok = rate >= CRITERION["success"] and rate - control >= CRITERION["above_control"]
            how = "passes" if ok else "misses"
        passed &= ok is not False
        by_n[n] = {**{k: run[k] for k in kept if k in run}, "jax_success_rate": theirs}
        parts.append(f"{n} demos: trained {rate} (JAX {theirs}), control {control} after {run['n_updates']} "
                     f"updates: {how}")
    head = f"{'PASSED' if passed else 'MISSED'} (at least {CRITERION['success']} and {CRITERION['above_control']} " \
           f"above the control where JAX's policy learned)"
    first = runs[0]
    init = f", init: {first['init']}" if first.get("init") else ""
    return {"run": command, "task": first["task"], "n_eval_episodes": first["n_eval_episodes"],
            **({"init": first["init"]} if init else {}),
            "success_by_n_demos": {n: r["trained_success_rate"] for n, r in by_n.items()}, "runs": by_n,
            "jax_reference": {"source": f"E2E_CLOSED_LOOP.json[{jax_key!r}]: the JAX package, JPEG frames", **jax},
            "criterion": {**CRITERION, "held_where_jax_learned": True},
            "verdict": f"{head} on {first['n_eval_episodes']} held-out layouts, seed {first['seed']}{init}, on "
                       f"{first['device']}: " + "; ".join(parts)}


def tier_entry(sweep: dict, command: str, jax_key: str, jax_doc: dict) -> dict:
    """A sweep's tiers, each beside JAX's rate on the same task and both
    packages' distance from their ``fp32_fused``; the verdict holds the
    serving tiers within TIER_BAND of the port's ``fp32_fused``."""
    jax = {**jax_doc[jax_key]["tiers"], **jax_doc.get("control_ablations", {}).get(jax_key, {})}
    base, jax_base = sweep["tiers"]["fp32_fused"]["success_rate"], jax["fp32_fused"]["success_rate"]
    tiers = {}
    for name, tier in sweep["tiers"].items():
        theirs = jax.get(name, {}).get("success_rate")
        tiers[name] = {**tier, "minus_fp32_fused": round(tier["success_rate"] - base, 6), "jax_success_rate": theirs,
                       "jax_minus_fp32_fused": None if theirs is None else round(theirs - jax_base, 6)}
    out_of_band = {n: tiers[n]["success_rate"] for n in SERVING_TIERS
                   if n in tiers and abs(tiers[n]["minus_fp32_fused"]) > TIER_BAND + 1e-9}
    ok = not out_of_band and all(n in tiers for n in SERVING_TIERS)
    text = (f"{'PASSED' if ok else 'MISSED'}: fp32_fused {base} (JAX {jax_base}); serving tiers "
            + ", ".join(f"{n} {tiers[n]['success_rate']} (JAX {tiers[n]['jax_success_rate']})"
                        for n in SERVING_TIERS if n in tiers)
            + (f" within {TIER_BAND} of it" if ok else f"; outside {TIER_BAND} of it: {out_of_band}")
            + "; reported: " + ", ".join(f"{n} {t['success_rate']} (JAX {t['jax_success_rate']})"
                                         for n, t in tiers.items() if n not in SERVING_TIERS and n != "fp32_fused")
            + f"; {sweep['tiers']['fp32_fused']['n_episodes']} episodes per tier on {sweep['device']}")
    return {"run": command, **{k: v for k, v in sweep.items() if k != "tiers"},
            "jax_reference": f"E2E_TIER_SUCCESS.json[{jax_key!r}] (its tiers and control_ablations)",
            "tiers": tiers, "verdict": text}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--run", help="the demo_closed_loop result the entry is of")
    what.add_argument("--by-n-demos", nargs="+", help="demo_closed_loop results of one recipe at several "
                                                      "demo counts (a data-efficiency entry)")
    what.add_argument("--tier-sweep", help="the e2e_tier_sweep result the entry is of")
    ap.add_argument("--command", required=True, help="its command line, as run")
    ap.add_argument("--curve", nargs="*", default=[], help="eval_scaleup_ckpt outputs of its checkpoints")
    ap.add_argument("--jax-key", required=True, help="the JAX package's entry in its E2E file ('' = the "
                                                     "reach recipe's, at E2E_CLOSED_LOOP.json's root)")
    ap.add_argument("--jax-file", default=None, help="default: E2E_CLOSED_LOOP.json, or with --tier-sweep "
                                                     "E2E_TIER_SUCCESS.json, at the repo's root")
    ap.add_argument("--other-runs", nargs="*", default=[], help="demo_closed_loop results of other seeds")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    def load(path):
        with open(path) as f:
            return json.load(f)

    jax_file = args.jax_file or os.path.join(
        REPO, "E2E_TIER_SUCCESS.json" if args.tier_sweep else "E2E_CLOSED_LOOP.json")
    if args.tier_sweep:
        result = tier_entry(load(args.tier_sweep), args.command, args.jax_key, load(jax_file))
    elif args.by_n_demos:
        result = n_demos_entry([load(p) for p in args.by_n_demos], args.command, args.jax_key,
                               jax_entry(load(jax_file), args.jax_key))
    else:
        run = load(args.run)
        result = entry(run, args.command, learning_curve(args.curve, isinstance(run["trained_success_rate"], dict)),
                       args.jax_key, jax_entry(load(jax_file), args.jax_key), [load(p) for p in args.other_runs])
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(result["verdict"])
    return result


if __name__ == "__main__":
    main()
