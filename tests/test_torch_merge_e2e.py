"""The port's ``scripts/merge_e2e_entry.py`` against the JAX package's
(``scripts/merge_e2e_entry.py``, loaded by path and run through its
``sys.argv``): on the same ``src`` and ``dst`` files each writes the same
bytes, keyed into an existing file, keyed into a missing one, replacing
the root, and with ``--extra`` fields. No tolerance applies: the files
are compared byte for byte."""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

from open_pi_zero_torch.scripts import merge_e2e_entry

REPO = Path(__file__).resolve().parent.parent
SRC = {"task": "simpler_lite_pick_place", "trained_success_rate": 0.975, "rates": {"reach": 1.0, "pick_place": 0.95},
       "loss": [1.0361728411912918, 0.2], "note": "ünïcode and \"quotes\"", "none": None}
DST = {"note": "existing file", "reach": {"trained_success_rate": 0.15}, "pick_place": {"old": True}}
MODES = {
    "keyed": ["--key", "pick_place"],
    "keyed_into_missing_dst": ["--key", "pick_place"],
    "root_replace": [],
    "extra": ["--key", "multi_task", "--extra", "seed=2", "run=a=b c", "note=overrides the src's"],
}


def jax_main():
    spec = importlib.util.spec_from_file_location("jax_merge_e2e_entry", REPO / "scripts" / "merge_e2e_entry.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


@pytest.mark.parametrize("mode", list(MODES))
def test_merge_writes_jax_s_bytes(mode, tmp_path, monkeypatch, capsys):
    src = tmp_path / "src.json"
    src.write_text(json.dumps(SRC))
    written = {}
    for side in ("jax", "port"):
        dst = tmp_path / side / "E2E.json"
        dst.parent.mkdir()
        if mode != "keyed_into_missing_dst":
            dst.write_text(json.dumps(DST, indent=1))
        argv = ["--src", str(src), "--dst", str(dst), *MODES[mode]]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["merge_e2e_entry.py", *argv])
            jax_main()()
        else:
            merge_e2e_entry.main(argv)
        written[side] = dst.read_bytes()
        out = capsys.readouterr().out
        assert out == f"merged {src} -> {dst}" + (f"[{MODES[mode][1]}]" if MODES[mode] else "") + "\n"
    assert written["port"] == written["jax"]
    merged = json.loads(written["port"])
    if mode == "root_replace":
        assert merged == SRC
    elif mode == "extra":
        assert merged["multi_task"] == {**SRC, "seed": "2", "run": "a=b c", "note": "overrides the src's"}
        assert {k: merged[k] for k in DST} == DST
    else:
        assert merged["pick_place"] == SRC
        assert {k: v for k, v in merged.items() if k != "pick_place"} == (
            {} if mode == "keyed_into_missing_dst" else {k: v for k, v in DST.items() if k != "pick_place"})


def demo_result(task, trained, control, seed=0):
    return {"task": f"simpler_lite_{task}", "n_demos": 800, "n_updates": 18000, "n_eval_episodes": 40,
            "trained_success_rate": trained, "random_init_success_rate": control, "seed": seed,
            "device": "NVIDIA H100 80GB HBM3, 700.00 W", "update_ms": 60.0, "timings_s": {"train": 1.0},
            "loss_per_50_updates": [1.0, 0.1]}


def scaleup_result(ckpt, task, rate, control=None):
    out = {"ckpt": ckpt, "task": task, "n_eval_episodes": 40,
           "trained": {"success_rate": rate, "success_by_instruction": {"x": "1/1"}, "n_episodes": 40}}
    if control is not None:
        out["control"] = {"success_rate": control}
    return out


JAX_INIT = "open_pi_zero_tpu init, jax.random.key(0)"  # demo_closed_loop.init_source of the JAX init export


def filed_entry(task, write, tmp_path):
    """(key, entry) of the entries that file JAX's data-efficiency sweeps,
    the drawer's single-task control and the runs from JAX's init, each
    checked against its JAX key."""
    from open_pi_zero_torch.scripts import demo_entry

    jax = json.loads((REPO / "E2E_CLOSED_LOOP.json").read_text())
    out_path = str(tmp_path / "entry.json")
    if task.startswith("data_efficiency"):
        leg = task.removeprefix("data_efficiency_")
        rates = {100: 0.3, 300: 0.95} if leg == "reach" else {400: 0.8}
        runs = []
        for n, rate in rates.items():
            run = {**demo_result(leg, rate, 0.25 if leg == "reach" else 0.0), "n_demos": n,
                   "n_updates": 12000 if leg == "reach" else 18000, "init": None if leg == "reach" else JAX_INIT}
            runs.append(write(f"run_{n}.json", run))
        out = demo_entry.main(["--by-n-demos", *runs[::-1], "--command", "demo_closed_loop ...", "--jax-key", task,
                               "--out", out_path])
        assert out["success_by_n_demos"] == {str(n): r for n, r in rates.items()}
        assert out["jax_reference"]["success_by_n_demos"] == jax[task]["success_by_n_demos"]
        assert out["runs"][str(next(iter(rates)))]["jax_success_rate"] == jax[task]["success_by_n_demos"][
            str(next(iter(rates)))]
        if leg == "reach":  # JAX's 100-demo policy did not learn: reported; 300 held
            assert out["verdict"].startswith("PASSED") and "init" not in out
            assert "100 demos: trained 0.3 (JAX 0.225), control 0.25 after 12000 updates: reported" in out["verdict"]
            assert "300 demos: trained 0.95 (JAX 1.0), control 0.25 after 12000 updates: passes" in out["verdict"]
        else:
            assert out["verdict"].startswith("MISSED")
            assert "400 demos: trained 0.8 (JAX 1.0), control 0.0 after 18000 updates: misses" in out["verdict"]
            assert f"seed 0, init: {JAX_INIT}, on NVIDIA H100" in out["verdict"]
        return task, out
    if task == "drawer_single_task":
        run = write("run.json", demo_result("drawer", 0.3, 0.05))
        out = demo_entry.main(["--run", run, "--command", "demo_closed_loop ...", "--jax-key", task, "--out", out_path])
        assert out["verdict"].startswith("REPORTED beside JAX's run on its round-3 drawer code")
        assert "simpler_lite_drawer: trained 0.3 (JAX 0.325), control 0.05 (JAX 0.05): reported" in out["verdict"]
        assert out["criterion"] == {"reported_beside_jax": True}
        return task, out
    jax_key = task.removesuffix("_from_jax_init")
    if jax_key == "tri_lever":
        run = demo_result(jax_key, {"reach": 0.95, "pick_place": 0.9, "drawer": 0.1},
                          {"reach": 0.25, "pick_place": 0.0, "drawer": 0.0})
    else:
        run = demo_result(jax_key, 0.4, 0.0)
    run["init"] = JAX_INIT
    out = demo_entry.main(["--run", write("run.json", run), "--command", "demo_closed_loop --init-params ...",
                           "--jax-key", jax_key if jax_key == "tri_lever" else "drawer_lever_solo_round5",
                           "--out", out_path])
    assert out["init"] == JAX_INIT and f"seed 0, init: {JAX_INIT}, on NVIDIA H100" in out["verdict"]
    assert out["criterion"]["drawer_within_jax"] == demo_entry.DRAWER_BAND
    if jax_key == "tri_lever":
        assert out["verdict"].startswith("PASSED") and "drawer: trained 0.1 (JAX 0.0)" in out["verdict"]
    else:
        assert out["verdict"].startswith("MISSED") and "trained 0.4 (JAX 0.025)" in out["verdict"]
    return task, out


@pytest.mark.parametrize("task", ["pick_place", "multi", "reach", "data_efficiency_reach", "data_efficiency_pick_place",
                                  "drawer_single_task", "tri_lever_from_jax_init", "drawer_lever_from_jax_init"])
def test_demo_entry_is_merged_with_its_verdict(task, tmp_path, capsys):
    """``demo_entry`` assembles a run's entry (learning curve, JAX's
    entry, the verdict from the numbers, the other seeds' runs) and the
    port's ``merge_e2e_entry`` files it under its key. JAX's reach recipe
    is the root of its file (``--jax-key ''``). The data-efficiency
    entries (``--by-n-demos``), the drawer's single-task control (reported)
    and the runs from JAX's init (their ``init``, held as their JAX keys)
    are filed alike (``filed_entry``)."""
    from open_pi_zero_torch.scripts import demo_entry

    def write(name, obj):
        (tmp_path / name).write_text(json.dumps(obj))
        return str(tmp_path / name)

    if task not in ("pick_place", "multi", "reach"):
        key, out = filed_entry(task, write, tmp_path)
        capsys.readouterr()
        dst = tmp_path / "E2E.json"
        dst.write_text(json.dumps({"reach": {"trained_success_rate": 0.15}}))
        merge_e2e_entry.main(["--src", str(tmp_path / "entry.json"), "--dst", str(dst), "--key", key])
        assert json.loads(dst.read_text()) == {"reach": {"trained_success_rate": 0.15}, key: out}
        return
    if task == "multi":
        run = write("run.json", demo_result(task, {"reach": 0.95, "pick_place": 0.9},
                                            {"reach": 0.25, "pick_place": 0.0}))
        other = write("other.json", demo_result(task, {"reach": 0.95, "pick_place": 0.3},
                                                {"reach": 0.25, "pick_place": 0.0}, seed=2))
        curve = [write(f"c{i}.json", scaleup_result(c, t, r)) for i, (c, t, r) in enumerate(
            [("ckpt_14000", "reach", 0.5), ("ckpt_7000", "pick_place", 0.1), ("ckpt_7000", "reach", 0.2)])]
        key = "multi_task"
    elif task == "reach":
        run = write("run.json", demo_result(task, 1.0, 0.15, seed=2))
        other = write("other.json", demo_result(task, 0.2, 0.15))
        curve, key = [], ""
    else:
        run = write("run.json", demo_result(task, 0.95, 0.0, seed=2))
        other = write("other.json", demo_result(task, 0.5, 0.0))
        curve = [write("c12.json", scaleup_result("ckpt_12000", task, 0.6, 0.0)),
                 write("c6.json", scaleup_result("ckpt_6000", task, 0.2))]
        key = "pick_place"
    out = demo_entry.main(["--run", run, "--command", "demo_closed_loop ...", "--curve", *curve, "--jax-key", key,
                           "--other-runs", other, "--out", str(tmp_path / "entry.json")])
    assert out["verdict"].startswith("PASSED") and capsys.readouterr().out == out["verdict"] + "\n"
    jax = json.loads((REPO / "E2E_CLOSED_LOOP.json").read_text())
    assert out["jax_reference"]["trained_success_rate"] == (jax[key] if key else jax)["trained_success_rate"]
    (name, seed_run), = out["other_seeds"].items()
    assert seed_run["verdict"].startswith("MISSED")
    if task == "reach":
        assert out["jax_reference"]["success_at_8k_updates"] == jax["success_at_8k_updates"]
        assert "learning_curve" not in out and "pick_place" not in out["jax_reference"]
        key = "reach_seed2"
    elif task == "multi":
        assert name == "seed_2" and "at_12k_updates" not in out
        assert list(out["learning_curve"]) == ["by", "ckpt_7000", "ckpt_14000"]
        assert set(out["learning_curve"]["ckpt_7000"]) == {"reach", "pick_place"}
        assert "pick_place: trained 0.3 (JAX 0.975), control 0.0 (JAX 0.0): misses" in seed_run["verdict"]
    else:
        assert name == "seed_0" and out["seed"] == 2 and out["at_12k_updates"] == 0.6
        assert list(out["learning_curve"]) == ["by", "ckpt_6000", "ckpt_12000"]
        assert out["learning_curve"]["ckpt_12000"]["control_success_rate"] == 0.0
    dst = tmp_path / "E2E.json"
    dst.write_text(json.dumps({"reach": {"trained_success_rate": 0.15}}))
    merge_e2e_entry.main(["--src", str(tmp_path / "entry.json"), "--dst", str(dst), "--key", key])
    assert json.loads(dst.read_text()) == {"reach": {"trained_success_rate": 0.15}, key: out}


@pytest.mark.parametrize("w8a8_full", [0.85, 0.8])
def test_tier_entry_sets_each_tier_beside_jax_s(w8a8_full, tmp_path):
    """``demo_entry --tier-sweep``: every tier beside JAX's rate on the same
    task and both distances from fp32_fused; the verdict holds the six
    serving tiers within 0.10 of the port's fp32_fused (0.85, at 0.10,
    is; 0.8 is not)."""
    from open_pi_zero_torch.scripts import demo_entry, e2e_tier_sweep

    rates = {name: 0.95 for name in e2e_tier_sweep.TIERS}
    rates.update(w8a8_full=w8a8_full, refined_t05=0.5)
    sweep = {"checkpoint": "ckpt_18000", "task": "simpler_lite_pick_place", "device": "cpu",
             "tiers": {n: {"success_rate": r, "n_episodes": 40, "overrides": e2e_tier_sweep.TIERS[n]}
                       for n, r in rates.items()}}
    (tmp_path / "sweep.json").write_text(json.dumps(sweep))
    out = demo_entry.main(["--tier-sweep", str(tmp_path / "sweep.json"), "--command", "e2e_tier_sweep ...",
                           "--jax-key", "pick_place", "--out", str(tmp_path / "entry.json")])
    jax = json.loads((REPO / "E2E_TIER_SUCCESS.json").read_text())
    assert list(out["tiers"]) == list(e2e_tier_sweep.TIERS) and out["checkpoint"] == "ckpt_18000"
    assert out["tiers"]["refined_t05"]["jax_success_rate"] == jax["pick_place"]["tiers"]["refined_t05"]["success_rate"]
    assert out["tiers"]["euler1"]["jax_success_rate"] == \
        jax["control_ablations"]["pick_place"]["euler1"]["success_rate"]
    assert out["tiers"]["refined_t05"]["minus_fp32_fused"] == -0.45
    assert out["tiers"]["fp32_fused"]["jax_minus_fp32_fused"] == 0.0
    assert out["verdict"].startswith("PASSED" if w8a8_full == 0.85 else "MISSED")
    assert json.loads((tmp_path / "entry.json").read_text()) == out
