"""The port's demonstration scripts (``open_pi_zero_torch/scripts/
demo_closed_loop.py``, ``eval_scaleup_ckpt.py``, ``e2e_tier_sweep.py``)
on the CPU.

- ``model_geometry`` and ``TIERS`` equal the JAX scripts' (loaded from
  ``scripts/`` by path; both import nothing of JAX at the top).
- A small run of the whole chain on ``--device cpu`` (4 demos, 4 updates
  of B = 4, 1 eval episode, hidden 32, 1 layer) for ``--task reach``,
  ``pick_place`` and ``multi`` (both tasks through the interleaved mix):
  its JSON holds the JAX script's keys and the port's own (the device, the
  update time, the batch wait, the card's utilization, the launches per
  update, the loss curve), the expert rate 1.0 (multi: per task, as are
  its rates), the model's param count, the final checkpoint with its
  ``params/`` export, each dataset's RLDS directory and statistics. Then
  ``eval_scaleup_ckpt`` scores that checkpoint on each task, with its
  control (multi's pick_place from ``statistics_pick_place.json``), and
  ``e2e_tier_sweep --tiers fp32_fused,int8_expert --n-episodes 1`` scores
  it through the config path (a YAML that takes
  ``configs/eval/simpler_lite.yaml`` as its base at the run's geometry).
  The scripts' results are counts and rates; no tolerance applies.
- Without a card, the default device raises before anything is written:
  there is no silent CPU path.
"""

import importlib.util
import json
import os
from pathlib import Path

import pytest
import torch

from open_pi_zero_torch.config import ConfigDict, pizero_config_from_dict
from open_pi_zero_torch.models import pizero
from open_pi_zero_torch.models.tree import tree_leaves
from open_pi_zero_torch.scripts import demo_closed_loop, e2e_tier_sweep, eval_scaleup_ckpt
from open_pi_zero_torch.training import checkpoint as ckpt_lib

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--n-demos", "4", "--n-updates", "4", "--n-eval-episodes", "1", "--hidden", "32", "--layers", "1",
         "--global-batch", "4", "--device", "cpu"]
# the JAX script's result keys (scripts/demo_closed_loop.py, `result`)
JAX_KEYS = {"task", "n_demos", "n_updates", "n_eval_episodes", "expert_success_rate", "trained_success_rate",
            "random_init_success_rate", "model", "timings_s", "devices"}
PORT_KEYS = {"device", "update_ms", "batch_wait_ms", "k1_launches_per_update", "bwd_launches_per_update",
             "loss_per_50_updates", "updates_this_run", "card_utilization", "seed", "init"}
# configs/eval/simpler_lite.yaml at model_geometry(32, 1)'s widths
SMALL_EVAL_YAML = """\
_base_: {base}
time_hidden_size: 32
mixture:
  vlm:
    hidden_size: 32
    intermediate_size: 64
  proprio:
    hidden_size: 16
    intermediate_size: 32
  action:
    hidden_size: 16
    intermediate_size: 32
vision:
  config:
    hidden_size: 16
    intermediate_size: 32
    num_hidden_layers: 1
vision_projector:
  config:
    vision_config:
      projection_dim: 32
joint:
  config:
    num_hidden_layers: 1
    head_dim: 16
"""


def jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kwargs", [
    dict(hidden=96, layers=3), dict(hidden=32, layers=1, proprio_dim=8),
    dict(hidden=256, layers=6, heads=8, kv_heads=1, head_dim=32),
])
def test_model_geometry_is_jax_s(kwargs):
    assert demo_closed_loop.model_geometry(**kwargs) == jax_script("demo_closed_loop").model_geometry(**kwargs)


def test_tiers_are_jax_s():
    assert e2e_tier_sweep.TIERS == jax_script("e2e_tier_sweep").TIERS


TASKS = ("reach", "pick_place", "multi")


def eval_tasks(task: str) -> tuple:
    """The tasks a run of ``--task`` is scored on: both of multi's."""
    return ("reach", "pick_place") if task == "multi" else (task,)


@pytest.fixture(scope="module", params=TASKS)
def demo_run(request, tmp_path_factory):
    """One small run of demo_closed_loop on the CPU per task, its
    statistics cache in its own directory."""
    task = request.param
    work = tmp_path_factory.mktemp(f"demo_{task}")
    cache = os.environ.get("XDG_CACHE_HOME")
    os.environ["XDG_CACHE_HOME"] = str(work / "cache")
    try:
        result = demo_closed_loop.main(["--task", task, "--workdir", str(work), "--out", str(work / "out.json"),
                                        *SMALL])
    finally:
        if cache is None:
            os.environ.pop("XDG_CACHE_HOME")
        else:
            os.environ["XDG_CACHE_HOME"] = cache
    return task, work, result


def test_demo_run_writes_jax_s_keys_and_the_port_s(demo_run):
    task, work, result = demo_run
    assert set(result) == JAX_KEYS | PORT_KEYS
    assert json.loads((work / "out.json").read_text()) == json.loads(json.dumps(result))
    assert result["task"] == f"simpler_lite_{task}"
    assert result["device"] == "cpu" and result["devices"] == 1 and result["updates_this_run"] == [1, 4]
    assert result["seed"] == 0
    if task == "multi":
        # per-task rates under the task names, as the JAX script's `rates`
        for key in ("expert_success_rate", "trained_success_rate", "random_init_success_rate"):
            assert set(result[key]) == {"reach", "pick_place"}
        rates = [result[k][t] for k in ("trained_success_rate", "random_init_success_rate") for t in eval_tasks(task)]
        assert result["expert_success_rate"] == {"reach": 1.0, "pick_place": 1.0}
    else:
        rates = [result["trained_success_rate"], result["random_init_success_rate"]]
        assert result["expert_success_rate"] == 1.0
    assert all(0.0 <= r <= 1.0 for r in rates)
    cfg = pizero_config_from_dict(ConfigDict(demo_closed_loop.model_geometry(32, 1)))
    assert result["model"] == {"hidden": 32, "layers": 1,
                               "params": sum(x.numel() for x in tree_leaves(pizero.abstract_params(cfg)))}
    assert len(result["loss_per_50_updates"]) == 1 and result["update_ms"] > 0
    assert result["batch_wait_ms"]["first"] >= result["batch_wait_ms"]["median_after_first"] >= 0
    # on the CPU the kernels' plain versions run: no launch is counted, and no card is sampled
    assert result["k1_launches_per_update"] == result["bwd_launches_per_update"] == 0
    assert result["card_utilization"] is None
    assert ckpt_lib.is_checkpoint(str(work / "train" / "checkpoint" / "ckpt_4"))
    assert (work / "train" / "checkpoint" / "ckpt_4" / ckpt_lib.PARAMS_DIR / ckpt_lib.PARAMS_FILE).exists()
    # the mix's first dataset's statistics, then one file per further task
    stats = ["statistics.json"] + (["statistics_pick_place.json"] if task == "multi" else [])
    assert sorted(p.name for p in work.glob("statistics*.json")) == stats
    for name in stats:
        assert json.loads((work / name).read_text()).keys() == {"action", "proprio"}
    datasets = ["bridge_dataset"] + (["simpler_lite_pp"] if task == "multi" else [])
    assert sorted(p.name for p in (work / "rlds_n4").iterdir()) == datasets
    for name in datasets:
        assert (work / "rlds_n4" / name / "features.json").exists()


def test_eval_scaleup_scores_the_run_s_checkpoint(demo_run):
    task, work, result = demo_run
    for t in eval_tasks(task):
        out = eval_scaleup_ckpt.main(["--workdir", str(work), "--ckpt", "ckpt_4", "--task", t, "--hidden", "32",
                                      "--layers", "1", "--heads", "4", "--n-eval-episodes", "1", "--control",
                                      "--device", "cpu", "--out", str(work / f"ckpt_4_{t}.json")])
        assert out["ckpt"] == "ckpt_4" and out["task"] == t and out["n_eval_episodes"] == 1
        for name in ("trained", "control"):
            assert out[name]["n_episodes"] == 1 and set(out[name]) >= {"success_rate", "success_by_instruction"}
        # the exported params on the same layouts and noise, with the
        # task's own statistics (statistics_<task>.json where the mix
        # wrote one): the run's own score
        run_rate = result["trained_success_rate"]
        assert out["trained"]["success_rate"] == (run_rate[t] if task == "multi" else run_rate)
        assert json.loads((work / f"ckpt_4_{t}.json").read_text()) == json.loads(json.dumps(out))


def test_tier_sweep_scores_the_run_s_checkpoint_per_tier(demo_run, tmp_path):
    task, work, _ = demo_run
    config = tmp_path / "simpler_lite_small.yaml"
    config.write_text(SMALL_EVAL_YAML.format(base=REPO / "configs" / "eval" / "simpler_lite.yaml"))
    env_task = eval_tasks(task)[-1]
    stats = "statistics_pick_place.json" if task == "multi" else "statistics.json"
    out = e2e_tier_sweep.main([
        "--checkpoint", str(work / "train" / "checkpoint" / "ckpt_4"), "--stats", str(work / stats),
        "--task", f"simpler_lite_{env_task}", "--config", str(config), "--tiers", "fp32_fused,int8_expert",
        "--n-episodes", "1", "--device", "cpu", "--out", str(tmp_path / "tiers.json"),
    ])
    assert list(out["tiers"]) == ["fp32_fused", "int8_expert"] and out["device"] == "cpu"
    assert out["task"] == f"simpler_lite_{env_task}"
    for name, tier in out["tiers"].items():
        assert tier["n_episodes"] == 1 and tier["overrides"] == e2e_tier_sweep.TIERS[name]
        assert 0.0 <= tier["success_rate"] <= 1.0
    assert json.loads((tmp_path / "tiers.json").read_text()) == json.loads(json.dumps(out))


def test_scripts_run_on_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((demo_closed_loop.main, ["--workdir", str(tmp_path / "demo")]),
                       (eval_scaleup_ckpt.main, ["--workdir", str(tmp_path / "demo"), "--ckpt", "ckpt_1"]),
                       (e2e_tier_sweep.main, ["--checkpoint", str(tmp_path / "ckpt"), "--stats", str(tmp_path),
                                              "--tiers", "fp32_fused"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert not any(tmp_path.iterdir())

