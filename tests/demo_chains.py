"""Small runs of the port's demonstration chain on the CPU, shared by
``tests/test_torch_demo_drawer_chain.py`` and
``tests/test_torch_demo_tri_chain.py``: ``demo_closed_loop.main`` at
``tests/test_torch_demo_scripts.py``'s ``SMALL`` size, then
``eval_scaleup_ckpt`` on the run's final checkpoint, leg by leg.

What each chain must give is spelled out in ``CHAINS``, from the JAX
script's task lists (``scripts/demo_closed_loop.py``): the datasets the mix
trains on, the legs it scores, the statistics files, the demo directory's
name, and whether the JAX script reports one rate or one per leg.
"""

import json
import math
import os

from open_pi_zero_torch.config import ConfigDict, pizero_config_from_dict
from open_pi_zero_torch.models import pizero
from open_pi_zero_torch.models.tree import tree_leaves
from open_pi_zero_torch.scripts import demo_closed_loop, eval_scaleup_ckpt
from open_pi_zero_torch.training import checkpoint as ckpt_lib
from tests import demo_reference_inputs
from tests.test_torch_demo_scripts import JAX_KEYS, PORT_KEYS, SMALL

SCALE_UP = ["--heads", "8", "--kv-heads", "1", "--head-dim", "32"]  # the bridge recipe's 8:1, head dim 32
CHAINS = {
    # name: (flags, {dataset: demo task}, scored legs, per-leg rates, rlds dir)
    "drawer": (["--task", "drawer"], {"fractal20220817_data": "drawer"}, ["drawer"], False, "rlds_n4"),
    "drawer_lever": (["--task", "drawer_lever"],
                     {"fractal20220817_data": "drawer", "fractal_drawer_cov": "drawer_cov"},
                     ["drawer"], False, "rlds_n4_lever"),
    "multi_family": (["--task", "multi_family"], {"bridge_dataset": "reach", "fractal20220817_data": "drawer"},
                     ["reach", "drawer"], True, "rlds_n4"),
    "tri_family": (["--task", "tri_family"],
                   {"bridge_dataset": "reach", "simpler_lite_pp": "pick_place", "fractal20220817_data": "drawer"},
                   ["reach", "pick_place", "drawer"], True, "rlds_n4"),
    "tri_lever": (["--task", "tri_lever", "--drawer-n-demos", "6"],
                  {"bridge_dataset": "reach", "simpler_lite_pp": "pick_place", "fractal20220817_data": "drawer",
                   "fractal_drawer_cov": "drawer_cov"},
                  ["reach", "pick_place", "drawer"], True, "rlds_n4_lever_dn6"),
    "scale_up": (["--task", "reach", *SCALE_UP], {"bridge_dataset": "reach"}, ["reach"], False, "rlds_n4"),
}
CROSS_FAMILY = ("multi_family", "tri_family", "tri_lever")


def run_chain(name: str, work) -> dict:
    """``demo_closed_loop.main`` of chain ``name`` in ``work``, its
    statistics cache inside it."""
    cache = os.environ.get("XDG_CACHE_HOME")
    os.environ["XDG_CACHE_HOME"] = str(work / "cache")
    try:
        return demo_closed_loop.main([*CHAINS[name][0], "--workdir", str(work), "--out", str(work / "out.json"),
                                      *SMALL])
    finally:
        if cache is None:
            os.environ.pop("XDG_CACHE_HOME")
        else:
            os.environ["XDG_CACHE_HOME"] = cache


def geometry_flags(name: str) -> list:
    return ["--hidden", "32", "--layers", "1", *(SCALE_UP if name == "scale_up" else ["--heads", "4"])]


def check_result(name: str, work, result: dict) -> None:
    flags, datasets, legs, per_leg, rlds = CHAINS[name]
    assert set(result) == JAX_KEYS | PORT_KEYS
    assert json.loads((work / "out.json").read_text()) == json.loads(json.dumps(result))
    task = flags[1]
    assert result["task"] == f"simpler_lite_{task}" and result["device"] == "cpu"
    assert result["updates_this_run"] == [1, 4] and result["seed"] == 0 and result["init"] is None
    # every dataset's demos by the expert; one rate per scored leg, as the
    # JAX script's `rates` gives them (drawer_lever: the drawer's alone)
    tasks = sorted(datasets.values())
    if len(datasets) > 1:
        assert sorted(result["expert_success_rate"]) == tasks
        assert all(r == 1.0 for r in result["expert_success_rate"].values())
    else:
        assert result["expert_success_rate"] == 1.0
    for key in ("trained_success_rate", "random_init_success_rate"):
        rates = result[key]
        if per_leg:
            assert list(rates) == legs  # drawer_cov trained on, not scored
            rates = list(rates.values())
        else:
            assert isinstance(rates, float)
            rates = [rates]
        assert all(0.0 <= r <= 1.0 for r in rates)
    curve = result["loss_per_50_updates"]
    assert len(curve) == 1 and all(math.isfinite(x) for x in curve)
    assert result["k1_launches_per_update"] == result["bwd_launches_per_update"] == 0  # the plain versions run
    geometry = demo_closed_loop.model_geometry(32, 1, proprio_dim=7 if task == "reach" else 8,
                                               **({"heads": 8, "kv_heads": 1, "head_dim": 32}
                                                  if name == "scale_up" else {}))
    cfg = pizero_config_from_dict(ConfigDict(geometry))
    assert result["model"]["params"] == sum(x.numel() for x in tree_leaves(pizero.abstract_params(cfg)))
    assert ckpt_lib.is_checkpoint(str(work / "train" / "checkpoint" / "ckpt_4"))
    # the mix's first dataset's statistics, then one file per further
    # dataset (drawer_cov's too: the pipeline read it)
    first = next(iter(datasets.values()))
    stats = sorted(["statistics.json"] + [f"statistics_{t}.json" for t in datasets.values() if t != first])
    assert sorted(p.name for p in work.glob("statistics*.json")) == stats
    for t in datasets.values():
        loaded = json.loads((work / ("statistics.json" if t == first else f"statistics_{t}.json")).read_text())
        assert loaded.keys() == {"action", "proprio"}
        # a dataset's own proprio: bridge's 7 dims are padded to 8 after normalization
        assert len(loaded["proprio"]["mean"]) == (8 if t.startswith("drawer") else 7)
    assert sorted(p.name for p in (work / rlds).iterdir()) == sorted(datasets)
    if "fractal_drawer_cov" in datasets:
        drawer_n = 6 if name == "tri_lever" else 4
        counts = {d: json.loads((work / rlds / d / "dataset_info.json").read_text())["splits"][0]["shardLengths"]
                  for d in ("fractal20220817_data", "fractal_drawer_cov")}
        assert sum(map(int, counts["fractal20220817_data"])) == drawer_n
        assert sum(map(int, counts["fractal_drawer_cov"])) == drawer_n // 2


def check_scored_legs(name: str, work, result: dict) -> None:
    """``eval_scaleup_ckpt`` on the final checkpoint scores each leg as the
    run did: the drawer with ``--task drawer`` (the EDR adapter, 8-dim
    proprio), a bridge leg of a cross-family policy with ``--proprio-dim
    8``."""
    _, _, legs, per_leg, _ = CHAINS[name]
    for leg in legs:
        pad = ["--proprio-dim", "8"] if name in CROSS_FAMILY and leg != "drawer" else []
        out = eval_scaleup_ckpt.main(["--workdir", str(work), "--ckpt", "ckpt_4", "--task", leg, *geometry_flags(name),
                                      *pad, "--n-eval-episodes", "1", "--device", "cpu"])
        assert out["task"] == leg and out["trained"]["n_episodes"] == 1
        want = result["trained_success_rate"][leg] if per_leg else result["trained_success_rate"]
        assert out["trained"]["success_rate"] == want
        instructions = list(out["trained"]["success_by_instruction"])
        assert len(instructions) == 1
        assert ("drawer" in instructions[0]) == (leg == "drawer")


def check_jax_closed_loop(name: str, work, result: dict) -> None:
    """``tests/demo_reference_inputs.py --jax-eval`` scores the final
    checkpoint's export in the JAX package's closed loop, leg by leg, at the
    chain's geometry (the scale-up's heads; proprio 8 for a cross-family
    policy, its bridge legs padded) with the leg's statistics file: one
    episode on the layout the port's eval scores, the same instruction."""
    _, datasets, legs, _, _ = CHAINS[name]
    first = next(iter(datasets.values()))
    heads = SCALE_UP if name == "scale_up" else ["--heads", "4"]
    for leg in legs:
        stats = work / ("statistics.json" if leg == first else f"statistics_{leg}.json")
        proprio = "8" if name in CROSS_FAMILY or leg == "drawer" else "7"
        got = demo_reference_inputs.main(["--jax-eval", str(work / "train" / "checkpoint" / "ckpt_4"), "--stats",
                                          str(stats), "--task", leg, "--proprio-dim", proprio, "--hidden", "32",
                                          "--layers", "1", *heads, "--n-eval-episodes", "1"])
        pad = ["--proprio-dim", "8"] if name in CROSS_FAMILY and leg != "drawer" else []
        port = eval_scaleup_ckpt.main(["--workdir", str(work), "--ckpt", "ckpt_4", "--task", leg,
                                       *geometry_flags(name), *pad, "--n-eval-episodes", "1", "--device", "cpu"])
        assert got["n_episodes"] == 1 and 0.0 <= got["success_rate"] <= 1.0
        assert list(got["success_by_instruction"]) == list(port["trained"]["success_by_instruction"])
