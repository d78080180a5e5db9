"""The port's QLoRA fine-tuning demonstration (``open_pi_zero_torch/scripts/
demo_qlora_finetune.py``) on the CPU, held against the JAX package's
``scripts/demo_qlora_finetune.py`` (loaded from ``scripts/`` by path).

- The train config: the JAX script's ``main`` runs with the same flags
  until it builds its TrainAgent (a stub takes the config and stops it;
  its demos stand in as existing, ``jax.device_count`` is 1, the one card's
  batch); the port's ``train_config`` equals it key for key, and the mix
  it trains on has the same datasets, weights and transforms. The port's
  OXE tables are as before once ``retention_mix`` is left.
- ``quantized_payloads`` finds the same leaves as JAX's on the same tree:
  JAX's init at the reach geometry (hidden 96, 3 layers) with the QLoRA
  flags, quantized per config by each package (26 leaves, bitwise).
- A tiny end-to-end run (4 demos, 4 updates of B = 4, hidden 32, 1 layer,
  1 episode per eval, ``--device cpu``) on a base written from the port's
  init: the payloads bitwise unchanged, the JAX script's JSON keys and the
  port's own. Its results are counts and rates; no tolerance applies.
"""

import importlib.util
import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest

from open_pi_zero_torch.config import ConfigDict, pizero_config_from_dict
from open_pi_zero_torch.data import oxe as t_oxe
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models.from_jax import params_from_jax
from open_pi_zero_torch.ops import lora as t_lora
from open_pi_zero_torch.scripts import demo_qlora_finetune as t_demo
from open_pi_zero_torch.training import checkpoint as t_ckpt
from open_pi_zero_tpu.config import ConfigDict as JConfigDict
from open_pi_zero_tpu.config import pizero_config_from_dict as j_config_from_dict
from open_pi_zero_tpu.data import oxe as j_oxe
from open_pi_zero_tpu.models import pizero as j_pizero
from open_pi_zero_tpu.ops import lora as j_lora

REPO = Path(__file__).resolve().parent.parent
# the recipe behind E2E_QLORA.json
RECIPE = ["--n-updates", "14000", "--retention-weight", "0.5", "--save-freq", "2000"]
# the JAX script's result keys (scripts/demo_qlora_finetune.py, `result`)
JAX_KEYS = {"proof", "base_checkpoint", "held_out_task", "n_demos", "n_updates", "n_eval_episodes",
            "expert_success_rate", "lora_r", "frozen_nf4_payloads_bitwise_unchanged", "n_frozen_payload_leaves",
            "new_task_success", "old_task_success", "retention_weight", "param_groups_B", "timings_s", "devices"}
PORT_KEYS = {"device", "update_ms", "batch_wait_ms", "loss_per_50_updates", "k1_launches_per_update",
             "bwd_launches_per_update", "updates_this_run"}


def jax_script():
    path = REPO / "scripts" / "demo_qlora_finetune.py"
    spec = importlib.util.spec_from_file_location("jax_demo_qlora_finetune", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def restore_registries():
    """Both packages' OXE tables as they were before the test."""
    saved = [(mod, name, dict(getattr(mod, name))) for mod in (t_oxe, j_oxe)
             for name in ("REGISTRY", "STANDARDIZE_FNS", "MIXES")]
    yield
    for mod, name, table in saved:
        getattr(mod, name).clear()
        getattr(mod, name).update(table)


def plain(x):
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


class Captured(Exception):
    pass


def jax_train_config(tmp_path, monkeypatch, flags):
    """The ConfigDict the JAX script hands its TrainAgent, and the data dir."""
    base = tmp_path / "base"
    (base / "train" / "checkpoint" / "ckpt_8000").mkdir(parents=True)
    work = tmp_path / "work"
    data_dir = work / "rlds_n600"
    for name in ("bridge_dataset", t_demo.REPLAY_DATASET):  # demos stand in as written
        (data_dir / name).mkdir(parents=True)
        (data_dir / name / "features.json").write_text("{}")

    def stop(cfg, *a, **k):
        raise Captured(cfg)

    from open_pi_zero_tpu.agents import train as j_train

    monkeypatch.setattr(j_train, "TrainAgent", stop)
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    monkeypatch.setattr(sys, "argv", ["demo_qlora_finetune.py", "--base-workdir", str(base),
                                      "--workdir", str(work), *flags])
    with pytest.raises(Captured) as got:
        jax_script().main()
    return got.value.args[0], base, work, str(data_dir)


def kwargs_view(kwargs_list):
    return [{k: (v.__name__ if callable(v) else v) for k, v in kw.items()} for kw in kwargs_list]


@pytest.mark.parametrize("flags", [RECIPE, []], ids=["retention", "new-task-only"])
def test_train_config_and_mix_are_jax_s(tmp_path, monkeypatch, restore_registries, flags):
    j_cfg, base, work, data_dir = jax_train_config(tmp_path, monkeypatch, flags)
    args = t_demo.parse_args(["--base-workdir", str(base), "--workdir", str(work), *flags])
    base_ckpt = t_demo.latest_ckpt(str(base / "train" / "checkpoint"))
    assert base_ckpt == j_cfg["base_params_checkpoint"]
    before = {name: dict(getattr(t_oxe, name)) for name in ("REGISTRY", "STANDARDIZE_FNS", "MIXES")}
    with t_demo.retention_mix(args.retention_weight) as mix:
        t_cfg = t_demo.train_config(args, base_ckpt, mix, data_dir)
        t_mix = t_oxe.make_oxe_dataset_kwargs_and_weights(mix, data_dir)
    assert plain(t_cfg) == plain(j_cfg)
    j_mix = j_oxe.make_oxe_dataset_kwargs_and_weights(j_cfg["data"]["train"]["dataset_mix"], data_dir)
    assert t_mix[1] == j_mix[1]
    assert kwargs_view(t_mix[0]) == kwargs_view(j_mix[0])
    assert {name: dict(getattr(t_oxe, name)) for name in before} == before


def test_quantized_payloads_are_jax_s_at_the_reach_geometry():
    args = t_demo.parse_args([])
    geometry = t_demo.qlora_geometry(args)
    j_cfg = j_config_from_dict(JConfigDict(geometry))
    j_tree = jax.tree.map(np.asarray, j_pizero.init_params(jax.random.key(0), j_cfg))
    j_payloads = jax_script().quantized_payloads(j_lora.quantize_per_model_config(j_tree, j_cfg))
    t_cfg = pizero_config_from_dict(ConfigDict(geometry))
    t_payloads = t_demo.quantized_payloads(t_lora.quantize_per_model_config(params_from_jax(j_tree, device="cpu"), t_cfg))
    assert len(t_payloads) == len(j_payloads) == 26
    assert t_payloads.keys() == j_payloads.keys()
    for k in j_payloads:
        assert np.array_equal(t_payloads[k], j_payloads[k]), k


def test_tiny_run_keeps_the_payloads_and_writes_jax_s_keys(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    from open_pi_zero_torch.scripts.demo_closed_loop import model_geometry

    base = tmp_path / "base" / "train" / "checkpoint" / "ckpt_4"
    params = t_pizero.init_params(pizero_config_from_dict(ConfigDict(model_geometry(32, 1))), seed=0, device="cpu")
    (base / t_ckpt.PARAMS_DIR).mkdir(parents=True)
    t_ckpt._save(params, str(base / t_ckpt.PARAMS_DIR / t_ckpt.PARAMS_FILE))
    t_ckpt._write_meta(str(base), {"source": "the port's init, seed 0"})
    out = tmp_path / "qlora.json"
    saved_mixes = dict(t_oxe.MIXES)
    result = t_demo.main([
        "--base-workdir", str(tmp_path / "base"), "--workdir", str(tmp_path / "work"), "--out", str(out),
        "--n-demos", "4", "--n-updates", "4", "--n-eval-episodes", "1", "--hidden", "32", "--layers", "1",
        "--global-batch", "4", "--retention-weight", "0.5", "--device", "cpu",
    ])
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    assert JAX_KEYS | PORT_KEYS <= set(result)
    assert result["frozen_nf4_payloads_bitwise_unchanged"] is True
    assert result["n_frozen_payload_leaves"] == 26
    assert result["expert_success_rate"] == 1.0
    assert result["updates_this_run"] == [1, 4]
    assert set(result["param_groups_B"]) == {"action", "vlm", "frozen"}
    assert result["device"] == "cpu" and result["devices"] == 1
    assert t_oxe.MIXES == saved_mixes
    ckpt = tmp_path / "work" / "train" / "checkpoint" / "ckpt_4"
    assert t_ckpt.is_checkpoint(str(ckpt))
