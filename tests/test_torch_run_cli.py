"""The port's launcher (``scripts/run.py``) and single-episode smoke
(``scripts/try_checkpoint_in_simpler.py``) on the CPU.

configs/eval/simpler_lite.yaml evaluates a checkpoint directory written by
the port's ``training/checkpoint.save_checkpoint`` at that geometry (the
eval export a TrainAgent writes), with a statistics file written here: the
launcher returns the eval result, and its per-chunk actions are bitwise
those of an EvalAgent built in this process on the same params (both load
through ``scripts/serve.load_params``; the noise comes from CPU
generators seeded alike). ``train`` mode without data raises before any
params are built (tests/test_torch_data_pipeline.py trains from
``cfg.data``), and ``--distributed`` joins a torchrun world before the
agent (tests/test_torch_dp_agent.py trains on one).
"""

import os
import socket

import numpy as np
import pytest
import torch

from open_pi_zero_torch.agents import eval as t_eval
from open_pi_zero_torch.config import load_config, pizero_config_from_dict, training_config_from_dict
from open_pi_zero_torch.models import pizero
from open_pi_zero_torch.parallel.mesh import get_mesh
from open_pi_zero_torch.scripts import run, serve, try_checkpoint_in_simpler
from open_pi_zero_torch.training import checkpoint as ckpt_lib
from open_pi_zero_torch.training import optimizer as opt_lib
from open_pi_zero_torch.training import train_step
from tests.test_torch_eval import write_statistics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIMPLER_LITE = os.path.join(ROOT, "configs/eval/simpler_lite.yaml")
TRAIN_BRIDGE = os.path.join(ROOT, "configs/train/bridge.yaml")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def demo_dir(tmp_path, monkeypatch):
    """A directory in the layout simpler_lite.yaml reads through
    OPZ_DEMO_DIR: ``statistics.json`` and ``train/checkpoint/ckpt_1500``,
    a checkpoint of random params at the config's geometry; VLA_LOG_DIR
    points the eval's log_dir under it."""
    cfg = load_config(SIMPLER_LITE)
    model_cfg = pizero_config_from_dict(cfg)
    params = pizero.init_params(model_cfg, seed=4, device="cpu", dtype=torch.float32)
    train_cfg = training_config_from_dict(cfg)
    state = train_step.init_train_state(params, opt_lib.build_optimizer(train_cfg, params), torch.Generator(),
                                        train_cfg)
    ckpt_lib.save_checkpoint(str(tmp_path / "train/checkpoint/ckpt_1500"), state, eval_params=params)
    write_statistics(tmp_path / "statistics.json")
    monkeypatch.setenv("OPZ_DEMO_DIR", str(tmp_path))
    monkeypatch.setenv("VLA_LOG_DIR", str(tmp_path / "log"))
    return tmp_path


def record_chunks(monkeypatch) -> list:
    """Every EvalAgent.act's chunk, in order."""
    chunks, act = [], t_eval.EvalAgent.act

    def recorded(self, inputs):
        out = act(self, inputs)
        chunks.append(out)
        return out

    monkeypatch.setattr(t_eval.EvalAgent, "act", recorded)
    return chunks


def test_run_cli_evaluates_a_port_checkpoint(demo_dir, monkeypatch):
    chunks = record_chunks(monkeypatch)
    overrides = ["n_eval_episode=1"]
    result = run.main(["--config", SIMPLER_LITE, "--device", "cpu", *overrides])
    assert result["n_episodes"] == 1 and len(chunks) == 15  # 60 steps, 4 per chunk
    assert 0.0 <= result["success_rate"] <= 1.0 and result["mean_inference_time_s"] > 0
    assert sum(int(v.split("/")[1]) for v in result["success_by_instruction"].values()) == 1
    assert os.path.isdir(demo_dir / "log")  # the config's log_dir
    launched = list(chunks)
    chunks.clear()

    # the same eval from an agent built here on the same params
    cfg = load_config(SIMPLER_LITE, overrides)
    model_cfg = pizero_config_from_dict(cfg)
    params = serve.load_params(cfg, model_cfg, torch.float32, torch.device("cpu"), random_init=False)
    assert "qkv" in params["joint"]["mixtures"]["vlm"]["layers"]["attn"]  # the fused serving layout
    again = t_eval.EvalAgent(cfg, params=params, device="cpu").run()
    assert again == {**result, "mean_inference_time_s": again["mean_inference_time_s"]}
    assert len(chunks) == len(launched)
    for a, b in zip(chunks, launched):
        np.testing.assert_array_equal(a, b)


def test_run_cli_mode_detection_and_refusals(demo_dir, monkeypatch):
    # train mode builds the datasets from cfg.data before any params: with
    # no dataset under VLA_DATA_DIR, or no data block (simpler_lite.yaml is
    # an eval config), the agent raises before it builds them
    built = []
    monkeypatch.setattr(pizero, "init_params", lambda *a, **k: built.append(1))
    monkeypatch.setenv("VLA_DATA_DIR", str(demo_dir / "no_data"))
    with pytest.raises(FileNotFoundError, match="no_data"):
        run.main(["--config", TRAIN_BRIDGE, "--device", "cpu"])
    with pytest.raises(ValueError, match="no data"):
        run.main(["--config", SIMPLER_LITE, "--mode", "train", "--device", "cpu"])
    assert built == []
    # --distributed joins the world torchrun describes (here a world of one
    # on the CPU) and trains on its mesh: the agent then refuses the eval
    # config's missing data, and the process group is left on the way out
    port = _free_port()
    for key, value in dict(RANK=0, LOCAL_RANK=0, WORLD_SIZE=1, MASTER_ADDR="localhost", MASTER_PORT=port).items():
        monkeypatch.setenv(key, str(value))
    with pytest.raises(ValueError, match="no data"):
        run.main(["--config", SIMPLER_LITE, "--mode", "train", "--distributed", "--device", "cpu"])
    assert not torch.distributed.is_initialized() and get_mesh() is None
    # an orbax directory (neither .pt nor the port's format) names its queue item
    orbax = demo_dir / "orbax_ckpt"
    orbax.mkdir()
    with pytest.raises(NotImplementedError, match="orbax checkpoints"):
        run.main(["--config", SIMPLER_LITE, "--device", "cpu", f"checkpoint_path={orbax}"])
    with pytest.raises(ValueError, match="checkpoint_path"):
        run.main(["--config", SIMPLER_LITE, "--device", "cpu", "checkpoint_path="])


def test_run_cli_defaults_to_the_card(demo_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--config", SIMPLER_LITE, "n_eval_episode=1"])


def test_try_checkpoint_runs_one_episode(demo_dir, capsys, monkeypatch):
    chunks = record_chunks(monkeypatch)
    result = try_checkpoint_in_simpler.main([
        "--config", SIMPLER_LITE, "--task", "simpler_lite_reach_multi", "--device", "cpu",
        "--checkpoint", str(demo_dir / "train/checkpoint/ckpt_1500"),
    ])
    assert result["n_episodes"] == 1 and len(chunks) == 24  # the multi-subtask reach: 96 steps
    out = capsys.readouterr().out
    assert "mean inference latency:" in out and "'n_episodes': 1" in out
