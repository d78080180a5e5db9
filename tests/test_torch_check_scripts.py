"""The port's checking scripts, each through its ``main(argv)`` on the CPU:
``model_memory`` (the bytes of every serving tier, from ``meta`` tensors,
equal to the JAX package's ``scripts/model_memory.py``: its printed lines
and its exact counts from ``jax.eval_shape``, at ``--tiny`` and at full
width), ``check_sampling --n 5000``, ``check_data`` on a small bridge
dataset that the JAX package's RLDS writer writes (shapes, ranges, the
frames written as PNG and read back), and ``verify_checkpoint``: its
``--self-test --device cpu`` passes load through drift, as the JAX
package's ``tests/test_scripts.py`` asks of its own script, and a
checkpoint directory of the port's trainer passes load, oracle and drift
at the tiny geometry."""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from open_pi_zero_torch.config import load_config, pizero_config_from_dict
from open_pi_zero_torch.data.images import decode_png
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.scripts import check_data, check_sampling, model_memory, verify_checkpoint
from open_pi_zero_torch.training import checkpoint as t_ckpt
from open_pi_zero_tpu import config as j_config
from open_pi_zero_tpu.data import rlds as j_rlds
from open_pi_zero_tpu.models import fuse as j_fuse
from open_pi_zero_tpu.models import pizero as j_pizero
from tests.test_torch_convert import fixture_cfg
from tests.test_torch_data_pipeline import bridge_episodes, bridge_leaves
from tests.test_torch_train_agent_card import TINY_YAML

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tier_bytes(cfg) -> dict:
    def build(kwargs):
        params = j_pizero.init_params(jax.random.key(0), cfg, dtype=jnp.bfloat16)
        return j_fuse.prepare_for_serving(params, **kwargs)

    return {name: sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(jax.eval_shape(lambda: build(kw))))
            for name, kw in model_memory.TIERS.items()}


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
def test_model_memory_prints_jax_s_bytes(tiny, capsys, monkeypatch):
    argv = ["--tiny"] if tiny else []
    got = model_memory.main(argv)
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["model_memory.py", *argv])
    runpy.run_path(os.path.join(ROOT, "scripts", "model_memory.py"), run_name="__main__")
    theirs = capsys.readouterr().out
    assert ours.splitlines() == theirs.splitlines() and len(ours.splitlines()) == 5
    cfg = j_config.tiny_pizero_config() if tiny else j_config.PiZeroConfig()
    assert got == jax_tier_bytes(cfg)
    assert got["NF4 whole trunk (memory tier)"] < got["bf16 fused"]


def test_check_sampling_runs(capsys):
    results = check_sampling.main(["--n", "5000"])
    out = capsys.readouterr().out
    assert "sampling distributions ok" in out and out.count("mean=") == 2
    assert {k: v.shape for k, v in results.items()} == {"uniform": (5000,), "beta": (5000,)}


def test_check_sampling_plot_names_matplotlib(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on a host without it
    with pytest.raises(ImportError, match="--plot needs matplotlib"):
        check_sampling.main(["--n", "1000", "--plot", str(tmp_path / "s.png")])


def test_check_data_on_a_jax_written_dataset(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    root = tmp_path / "data"
    j_rlds.write_rlds_dataset(str(root / "bridge_dataset"), "bridge_dataset", bridge_episodes(np.random.default_rng(0), 5),
                              bridge_leaves(j_rlds), shards=2)
    dump = tmp_path / "frames"
    out = check_data.main(["--data_path", str(root), "--mix", "bridge", "--n_batches", "2", "--batch_size", "4",
                           "--dump_dir", str(dump)])
    text = capsys.readouterr().out
    img = out["first"]["observation"]["image_primary"]
    assert img.shape == (4, 1, 224, 224, 3) and img.dtype == np.uint8
    assert f"image {img.shape} uint8" in text and "proprio (4, 1, 7)" in text and "action (4, 1, 4, 7)" in text
    assert out["frames"] == 8 and out["frames_per_s"] > 0 and "frames/s" in text
    assert sorted(os.listdir(dump)) == [f"frame_{j}.png" for j in range(4)]
    for j in range(4):
        assert np.array_equal(decode_png((dump / f"frame_{j}.png").read_bytes()), img[j, 0])


def test_verify_checkpoint_self_test_passes(capsys):
    assert verify_checkpoint.selftest_config() == fixture_cfg(lm_head=True)
    result = verify_checkpoint.main(["--self-test", "--device", "cpu"])
    out = capsys.readouterr().out
    assert result["ok"] and "ALL STAGES PASSED" in out, out
    for stage in ("load", "textgen", "parity", "oracle", "drift"):
        assert f"[{stage:9s}] PASS" in out, out
    assert "[episodes ] SKIP" in out


def test_verify_checkpoint_on_a_port_checkpoint(tmp_path, capsys):
    yml = tmp_path / "tiny.yaml"
    yml.write_text(TINY_YAML.format(log_dir=tmp_path / "log", quantize="false", lora="false"))
    cfg = pizero_config_from_dict(load_config(str(yml)))
    t_ckpt.save_params(str(tmp_path / "ckpt"), t_pizero.init_params(cfg, seed=0, device="cpu"))
    result = verify_checkpoint.main([str(tmp_path / "ckpt"), "--config", str(yml), "--device", "cpu"])
    out = capsys.readouterr().out
    for stage in ("load", "oracle", "drift", "refine"):
        assert f"[{stage:9s}] PASS" in out, out
    assert "[textgen  ] SKIP" in out and result["ok"]
    assert set(result["seconds"]) == {"load", "textgen", "oracle", "drift", "refine", "episodes"}
    text_cfg = verify_checkpoint.selftest_config()
    with pytest.raises(NotImplementedError, match="transformers"):
        verify_checkpoint.stage_textgen(t_pizero.init_params(text_cfg, seed=0, device="cpu"), text_cfg, None,
                                        tokenizer=str(tmp_path))
