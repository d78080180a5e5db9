"""``open_pi_zero_torch/scripts/seed_study.py`` on made-up run results: the
loss break (the first 50-update window under 0.10), the criterion per
package, and the merge into a result file that keeps its other keys."""

import json

import pytest

from open_pi_zero_torch.scripts import seed_study


def run(success, curve):
    return {"trained_success_rate": success, "random_init_success_rate": 0.15, "loss_per_50_updates": curve,
            "update_ms": 101.0, "timings_s": {"train": 1.0}, "device": "cpu"}


def test_break_and_verdict_and_merge(tmp_path):
    assert seed_study.loss_break([1.0, 0.13, 0.11]) is None
    assert seed_study.loss_break([1.0, 0.13, 0.099, 0.2]) == [101, 150]
    paths = []
    for name, r in {"port_0": run(0.2, [1.0, 0.13]), "port_2": run(0.9, [1.0, 0.08]),
                    "jax_1": run(0.85, [0.5, 0.09])}.items():
        paths.append(tmp_path / f"{name}.json")
        paths[-1].write_text(json.dumps(r))
    into = tmp_path / "e2e.json"
    into.write_text(json.dumps({"task": "simpler_lite_reach"}))
    summary = seed_study.main(["--into", str(into), *map(str, paths)])
    assert summary["learned"] == {"port": ["port_2"], "jax": ["jax_1"]}
    assert summary["runs"]["port_2"]["loss_break_updates"] == [51, 100]
    assert summary["runs"]["port_0"]["loss_break_updates"] is None
    merged = json.loads(into.read_text())
    assert merged["task"] == "simpler_lite_reach" and merged["seed_study"] == json.loads(json.dumps(summary))


def test_refuses_a_run_named_otherwise(tmp_path):
    path = tmp_path / "seed0.json"
    path.write_text(json.dumps(run(0.2, [1.0])))
    with pytest.raises(ValueError):
        seed_study.study([str(path)])
