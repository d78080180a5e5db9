"""The TrainAgent on a data mesh of ranks (``agents/train.py``,
``agents/dataset.py``, ``training/checkpoint.py`` under ZeRO-1,
``scripts/run.py --distributed``, ``scripts/dryrun_multiprocess.py``) on
the CPU, at the tiny geometry of ``tests/test_torch_train_agent_card.py``,
on a bridge-like PNG dataset that the port's writer makes.

The ranks run in spawned processes over gloo (``parallel.run_ranks``; the
rank programs are ``parallel/ranks.agent_rank``, ``restore_rank`` and
``latest_rank``), or under torchrun (``python -m torch.distributed.run``),
or as the dryrun's processes. The torchrun and dryrun processes find a
``jax`` and an ``open_pi_zero_tpu`` package that raise on import first on
their path: a rank that imported either would fail.

Checked: the ranks' shards of the frame stream are disjoint and together
are its first frames; a ZeRO-1 save and a resume on 2 ranks are bitwise a
continued run; the 2-rank validation is one rank's over the global
validation batch (within 1e-6: the same rows in batches of another size);
a checkpoint of 2 ranks restores on 1 and one of 1 rank on 2, bitwise; the
checkpoint to resume is rank 0's choice and skips a partial one; the
dryrun meets the JAX dryrun's limits (``loss_diff_vs_single < 5e-5``).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from open_pi_zero_torch.agents import dataset as t_dataset
from open_pi_zero_torch.agents import train as t_agent
from open_pi_zero_torch.config import load_config
from open_pi_zero_torch.data import images
from open_pi_zero_torch.data import rlds as data_rlds
from open_pi_zero_torch.models import pizero
from open_pi_zero_torch.parallel import ranks, run_ranks
from open_pi_zero_torch.training import averaging as avg_lib
from open_pi_zero_torch.training import seeds
from open_pi_zero_torch.utils.metric import get_action_accuracy, l1_loss
from tests.test_torch_data_pipeline import DATA_BLOCK, frame_image
from tests.test_torch_dp_training import _assert_bitwise
from tests.test_torch_train_agent_card import TINY_YAML

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
PBS = 2  # frames per rank and microbatch
# 2 ranks x 2 frames x accumulation 2; ZeRO-1 with EMA; validation and a
# save at update 2
OVERRIDES = ["global_batch_size=8", "zero1=true", "use_ema=true", "ema_start=0", "save_model_freq=2"]
INSTRUCTIONS = (b"pick up the spoon", b"open the drawer", b"put the carrot on the plate")


def write_bridge(root: str, n_episodes: int = 8) -> None:
    """A bridge-like RLDS dataset through the port's writer: 28² PNG
    ``image_0``, 7-dim ``state`` and ``action``, an instruction,
    ``is_first``; two shards."""
    rng = np.random.default_rng(5)
    leaf = data_rlds.LeafSpec
    leaves = [leaf("steps/observation/image_0", "uint8", (28, 28, 3), "image", True, "png"),
              leaf("steps/observation/state", "float32", (7,), "tensor", True),
              leaf("steps/action", "float32", (7,), "tensor", True),
              leaf("steps/language_instruction", "string", (), "text", True),
              leaf("steps/is_first", "bool", (), "tensor", True)]
    episodes = []
    for i in range(n_episodes):
        t = int(rng.integers(5, 9))
        gripper = rng.choice([0.0, 1.0], size=(t, 1))
        episodes.append({"steps": {
            "observation": {"image_0": [images.encode_png(frame_image(rng)) for _ in range(t)],
                            "state": rng.normal(size=(t, 7)).astype(np.float32)},
            "action": np.concatenate([rng.normal(size=(t, 6)), gripper], 1).astype(np.float32),
            "language_instruction": [INSTRUCTIONS[i % 3]] * t,
            "is_first": np.asarray([1] + [0] * (t - 1), bool),
        }})
    data_rlds.write_rlds_dataset(os.path.join(root, "bridge_dataset"), "bridge_dataset", episodes, leaves, shards=2)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_data")
    write_bridge(str(root))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XDG_CACHE_HOME", str(root / "cache"))  # the statistics cache; the ranks inherit it
        yield str(root)


def agent_config(data_dir: str, log_dir: str, overrides=()):
    path = os.path.join(log_dir, "train.yaml")
    os.makedirs(log_dir, exist_ok=True)
    with open(path, "w") as f:
        f.write(TINY_YAML.format(log_dir=log_dir, quantize="false", lora="false") + DATA_BLOCK.format(data_path=data_dir))
    return load_config(path, overrides=OVERRIDES + list(overrides))


@pytest.fixture(scope="module")
def single(data_dir, tmp_path_factory):
    """One process: 2 updates of the same recipe (global batch 8 = 2 x 4),
    ckpt_2 saved."""
    log_dir = str(tmp_path_factory.mktemp("single"))
    agent = t_agent.TrainAgent(agent_config(data_dir, log_dir), device="cpu")
    agent.run()
    return {"ckpt": os.path.join(agent.ckpt_dir, "ckpt_2"), "state": ranks.state_numpy(agent.state)}


@pytest.fixture(scope="module")
def world(data_dir, single, tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("ranks"))
    cfg = agent_config(data_dir, log_dir)
    resume = agent_config(data_dir, log_dir, ["resume_checkpoint_path=auto", "n_updates=3"])
    from_single = agent_config(data_dir, str(tmp_path_factory.mktemp("from_single")),
                               [f"resume_checkpoint_path={single['ckpt']}"])
    partial = os.path.join(log_dir, "checkpoint", "ckpt_99")
    lonely = str(tmp_path_factory.mktemp("lonely"))  # rank 1 looks here: nothing complete, a later ckpt_7 partial
    os.makedirs(os.path.join(lonely, "ckpt_7", "state"))
    calls = [
        (ranks.agent_rank, (cfg, resume, partial)),
        (ranks.restore_rank, (from_single,)),
        (ranks.latest_rank, ([os.path.join(log_dir, "checkpoint"), lonely],)),
    ]
    agent, restored, latest = run_ranks(ranks.sequence, 2, 1, calls, device="cpu", timeout_s=TIMEOUT_S)
    return {"cfg": cfg, "log_dir": log_dir, "agent": agent, "restored": restored, "latest": latest,
            "lonely": lonely}


def _frames_of(batch) -> list:
    images_, actions = batch["observation"]["image_primary"], batch["action"]
    return [images_[i].tobytes() + actions[i].tobytes() for i in range(len(actions))]


def test_the_ranks_train_on_disjoint_shards_of_the_stream(world, data_dir):
    """Each rank read 2 updates x 2 microbatches x 2 frames of its shard;
    the shards are disjoint and together are the stream's first 16 frames
    (a multiset; the frames bitwise)."""
    rank0, rank1 = world["agent"]["frames"]
    assert len(rank0) == len(rank1) == 8
    assert not set(rank0) & set(rank1)
    dataset = t_dataset.RLDSInterleavedDataset(world["cfg"].data.train, train=True, seed=0)
    it = dataset.iterator(PBS, shard_per_process=False)
    try:
        whole = [f for _ in range(8) for f in _frames_of(next(it))]
    finally:
        it.close()
    assert sorted(rank0 + rank1) == sorted(whole)
    assert rank0 == whole[0::2] and rank1 == whole[1::2]


def test_zero1_save_and_resume_on_two_ranks_is_bitwise(world):
    """A fresh agent resumes from ckpt_2 (``auto``, over the partial
    ckpt_99) at update 2 with the saved cnt_batch, and its update 3 is
    bitwise the continued agent's: params, moments, EMA, generator."""
    got = world["agent"]
    assert got["zero1"] and got["resumed_at"] == 2
    assert got["cnt_batch"][0] == got["cnt_batch"][1] == 4
    _assert_bitwise(got["continued"], got["resumed"], "state")
    assert got["continued"]["step"] == 3 and got["continued"]["n_averaged"] == 3
    meta = json.loads(open(os.path.join(world["log_dir"], "checkpoint", "ckpt_2", "meta.json")).read())
    assert meta["world_size"] == 2
    total = sum(v.nbytes for st in got["saved"]["opt"]["state"].values() for v in st.values())
    held = got["moment_bytes"]
    assert total <= sum(held) <= 1.02 * total and max(held) < 0.75 * total


def test_validation_on_two_ranks_is_one_ranks_over_the_global_batch(world, data_dir):
    """The ranks' validation at update 2 (one batch of 2 frames each) gave
    the metrics of one device over the global batch: the ranks' model
    inputs in rank order (each rank's own tokenization: the stand-in
    tokenizer numbers words as a process meets them), the eval params of
    ckpt_2, the validation stream's noise drawn for all 4 rows."""
    got = world["agent"]["validations"][2]
    (rank0,), (rank1,) = got["inputs"]
    cfg = agent_config(data_dir, world["log_dir"], [f"resume_checkpoint_path={world['log_dir']}/checkpoint/ckpt_2"])
    agent = t_agent.TrainAgent(cfg, device="cpu")
    batch = agent.to_device({k: np.concatenate([rank0[k], rank1[k]]) for k in rank0})
    gt = batch.pop("actions")
    params = avg_lib.eval_params(agent.state.avg, agent.state.params)
    pred = pizero.infer_action(params, agent.model_cfg, seeds.stream_generator(0, seeds.VALIDATION, 2),
                               batch["input_ids"], batch["pixel_values"], batch["attention_mask"], batch["proprios"])
    np.testing.assert_allclose(got["result"]["l1"], float(l1_loss(gt, pred)), rtol=1e-6)
    want = get_action_accuracy(gt, pred, agent.eval_thresholds).numpy()
    np.testing.assert_allclose(list(got["result"]["accuracy"].values()), want, rtol=0, atol=1e-6)


def test_a_two_rank_checkpoint_restores_on_one_rank(world, data_dir, tmp_path):
    """ckpt_2 of the 2-rank ZeRO-1 run, restored by one process (where
    zero1 is a no-op): the gathered state that the ranks held, bitwise."""
    ckpt = os.path.join(world["log_dir"], "checkpoint", "ckpt_2")
    agent = t_agent.TrainAgent(agent_config(data_dir, str(tmp_path), [f"resume_checkpoint_path={ckpt}"]),
                               device="cpu")
    assert not agent.zero1
    _assert_bitwise(ranks.state_numpy(agent.state), world["agent"]["saved"], "state")


def test_a_one_rank_checkpoint_restores_on_two_ranks(world, single):
    """ckpt_2 of the one-process run, restored on 2 ranks with ZeRO-1: each
    rank keeps its slices, and gathered they are the saved state, bitwise."""
    got = world["restored"]
    assert got["zero1"]
    _assert_bitwise(got["state"], single["state"], "state")
    total = sum(v.nbytes for st in single["state"]["opt"]["state"].values() for v in st.values())
    assert max(got["moment_bytes"]) < 0.75 * total


def test_the_checkpoint_to_resume_is_rank_0s_choice(world):
    """Rank 0 saw ckpt_2 and a partial ckpt_99, rank 1 only a partial
    ckpt_7 in its own directory: both take ckpt_2 (a path in their own
    directories, as the JAX agent builds it)."""
    rank0, rank1 = world["latest"]
    assert rank0 == os.path.join(world["log_dir"], "checkpoint", "ckpt_2")
    assert rank1 == os.path.join(world["lonely"], "ckpt_2")


# --------------------------------------------------------------------------- #
# processes of their own: the dryrun and torchrun
# --------------------------------------------------------------------------- #


def _without_jax(tmp_path) -> dict:
    """An environment whose first path entries hold a ``jax``, ``jaxlib``
    and ``open_pi_zero_tpu`` that raise on import."""
    block = tmp_path / "no_jax"
    for name in ("jax", "jaxlib", "open_pi_zero_tpu"):
        (block / name).mkdir(parents=True)
        (block / name / "__init__.py").write_text(f"raise ImportError('a rank imported {name}')\n")
    path = os.pathsep.join([str(block), REPO])
    return {**os.environ, "PYTHONPATH": path, "XDG_CACHE_HOME": str(tmp_path / "cache")}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_dryrun_multiprocess_meets_the_jax_dryruns_limits(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "open_pi_zero_torch.scripts.dryrun_multiprocess", "--device", "cpu",
         "--workdir", str(tmp_path / "mp")],
        cwd=REPO, env=_without_jax(tmp_path), capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("multiprocess dryrun:"))
    result = json.loads(line.split(":", 1)[1])
    assert result["ok"] and result["loss_diff_vs_single"] < 5e-5
    assert result["agent"] == {"resumed_at": 2, "final_step": 4, "zero1_sharded": True}


def test_torchrun_trains_on_two_cpu_ranks(data_dir, tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    open_pi_zero_torch.scripts.run ... --distributed --device cpu``: two
    ranks take 2 updates on their shards, validate, and save ckpt_2 with
    the world size; rank 0 logs the updates."""
    cfg_path = tmp_path / "log" / "train.yaml"
    agent_config(data_dir, str(tmp_path / "log"))  # writes the YAML
    overrides = OVERRIDES
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2", "--master_addr", "localhost",
         "--master_port", str(_free_port()), "-m", "open_pi_zero_torch.scripts.run", "--config", str(cfg_path),
         "--distributed", "--device", "cpu", *overrides],
        cwd=REPO, env=_without_jax(tmp_path), capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    meta = json.loads((tmp_path / "log" / "checkpoint" / "ckpt_2" / "meta.json").read_text())
    assert meta["world_size"] == 2
    updates = [ln for ln in proc.stderr.splitlines() if "| loss" in ln]
    assert len(updates) == 2, proc.stderr[-3000:]  # logged once each, on rank 0
    saved = torch.load(tmp_path / "log" / "checkpoint" / "ckpt_2" / "state" / "state.pt", weights_only=True)
    assert saved["step"] == 2 and all(torch.isfinite(p).all() for p in saved["params"]["action_decoder"].values())


def test_monitor_helpers_act_on_rank_0_only(monkeypatch, tmp_path):
    """``MainRankFilter`` and ``main_process_only`` decide by the process's
    rank at each call (here torchrun's RANK, with no process group);
    ``profile_trace`` writes the rank's Chrome trace."""
    import logging

    from open_pi_zero_torch.utils import monitor

    record = logging.LogRecord("opz", logging.INFO, __file__, 1, "update 1", None, None)
    calls = []
    only = monitor.main_process_only(lambda: calls.append(1) or "done")
    rank_filter = monitor.MainRankFilter()  # made before the rank is known
    for rank, main in (("1", False), ("0", True)):
        monkeypatch.setenv("RANK", rank)
        assert rank_filter.filter(record) is main
        assert only() == ("done" if main else None)
    assert calls == [1]
    with monitor.profile_trace(str(tmp_path / "trace")) as trace:
        torch.ones(64).cumsum(0)
    assert trace.path.endswith("trace_rank0.json")
    assert json.loads(open(trace.path).read())["traceEvents"]
