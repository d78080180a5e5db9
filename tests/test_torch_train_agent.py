"""The port's TrainAgent (``agents/train.py``), its processor
(``processing.py``), metrics (``utils/metric.py``) and the serve CLI's
checkpoint loading (``scripts/serve.load_params``) on the CPU at the tiny
geometry, against the JAX package where it has a counterpart: the JAX
agent's batch preprocessing and metrics on the same numpy frames, and
its EvalAgent's load arithmetic (to_dtype, merge_lora per mixture,
dequantize, the serving layout) on the same tree.

The data is an in-memory dataset of seeded frame batches in the RLDS
layout (``Frames``); the agent built from ``cfg.data`` is tested in
tests/test_torch_data_pipeline.py. Tolerances: preprocessing and the accuracies exactly
(the same numpy / fp32 arithmetic), the l1 mean 1e-6 relative (its sum
taken in another order); the merged float trees 1e-6 (A @ B summed
in another order); agent runs against hand-driven steps bitwise (the same
ops on the same numbers)."""

import json
import logging
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pi_zero_torch import processing as t_proc
from open_pi_zero_torch.agents import train as t_agent
from open_pi_zero_torch.config import load_config, pizero_config_from_dict
from open_pi_zero_torch.models.tree import tree_leaves
from open_pi_zero_torch.ops import lora as t_lora
from open_pi_zero_torch.scripts import serve
from open_pi_zero_torch.training import checkpoint as t_ckpt
from open_pi_zero_torch.training import optimizer as t_opt
from open_pi_zero_torch.training import seeds as t_seeds
from open_pi_zero_torch.training import train_step as t_train
from open_pi_zero_torch.utils import metric as t_metric
from open_pi_zero_tpu import config as j_config
from open_pi_zero_tpu import processing as j_proc
from open_pi_zero_tpu.agents.train import TrainAgent as JaxTrainAgent
from open_pi_zero_tpu.models import convert as j_convert
from open_pi_zero_tpu.models import fuse as j_fuse
from open_pi_zero_tpu.ops import lora as j_lora
from open_pi_zero_tpu.utils import metric as j_metric
from tests.test_torch_train_agent_card import Frames, tiny_config
from tests.test_torch_training import _leaves_with_paths

def test_preprocess_batch_is_the_jax_agents(tmp_path):
    cfg, path = tiny_config(tmp_path)
    agent = t_agent.TrainAgent(cfg, dataset=Frames(0), device="cpu")
    jcfg = j_config.pizero_config_from_dict(j_config.load_config(path))
    j_processor = j_proc.VLAProcessor(
        j_proc.FakeTokenizer(image_token_id=jcfg.image_token_index),
        num_image_tokens=jcfg.siglip.num_image_tokens, max_seq_len=jcfg.max_image_text_tokens,
    )
    jax_agent = types.SimpleNamespace(processor=j_processor)
    for frames in (next(Frames(0).iterator(3)), next(Frames(1).iterator(2))):
        got = agent.preprocess_batch(frames)
        want = JaxTrainAgent.preprocess_batch(jax_agent, frames)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["input_ids"][:, :4] == jcfg.image_token_index).all() and got["pixel_values"].shape == (2, 28, 28, 3)


def test_processing_copies_and_refuses_the_real_tokenizer(tmp_path):
    images = np.random.default_rng(0).integers(0, 256, size=(2, 28, 28, 3), dtype=np.uint8)
    np.testing.assert_array_equal(t_proc.process_images(images), j_proc.process_images(images))
    assert t_proc.add_image_tokens_to_prompt("hi", "<bos>", 3) == j_proc.add_image_tokens_to_prompt("hi", "<bos>", 3)
    with pytest.raises(ValueError, match="uint8"):
        t_proc.process_images(images.astype(np.float32))
    with pytest.raises(NotImplementedError, match="PaliGemma tokenizer is not queued"):
        t_proc.load_paligemma_tokenizer(str(tmp_path))
    (tmp_path / "weights").mkdir()
    cfg, _ = tiny_config(tmp_path, overrides=[f"pretrained_model_path={tmp_path / 'weights'}"])
    with pytest.raises(NotImplementedError, match="PaliGemma tokenizer is not queued"):
        t_agent.TrainAgent(cfg, dataset=Frames(0), device="cpu")


@pytest.mark.parametrize("thresholds", [(0.1, 0.2), (0.05, 0.1, 0.2, 0.3, 0.5)])
def test_metrics_equal_jax(thresholds):
    rng = np.random.default_rng(1)
    gt = rng.uniform(-1, 1, size=(5, 4, 7)).astype(np.float32)
    pred = (gt + rng.normal(size=gt.shape) * 0.1).astype(np.float32)
    got = t_metric.get_action_accuracy(torch.from_numpy(gt), torch.from_numpy(pred), thresholds)
    want = j_metric.get_action_accuracy(jnp.asarray(gt), jnp.asarray(pred), thresholds)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(  # a mean summed in another order: fp32 rounding
        float(t_metric.l1_loss(torch.from_numpy(gt), torch.from_numpy(pred))),
        float(j_metric.l1_loss(jnp.asarray(gt), jnp.asarray(pred))), rtol=1e-6)


def test_run_saves_and_resumes(tmp_path, caplog):
    """Two updates (validating at the second), ckpt_2 with its metadata,
    then an agent resuming from it to update 3."""
    cfg, _ = tiny_config(tmp_path)
    agent = t_agent.TrainAgent(cfg, dataset=Frames(0), val_dataset=Frames(1), device="cpu")
    assert agent.grad_accum == 2 and agent.step_batch_size == 2
    with caplog.at_level(logging.INFO, logger=t_agent.__name__):
        state = agent.run()
    assert state.step == 2 and agent.cnt_batch == 4
    assert any("eval @ 2 | l1" in r.getMessage() for r in caplog.records)
    ckpt = os.path.join(agent.ckpt_dir, "ckpt_2")
    assert json.loads(open(os.path.join(ckpt, "meta.json")).read()) == {
        "cnt_batch": 4, "wandb_id": None, "quant_layout_version": 2}

    cfg2, _ = tiny_config(tmp_path, overrides=[f"resume_checkpoint_path={ckpt}", "n_updates=3"])
    agent2 = t_agent.TrainAgent(cfg2, dataset=Frames(0), device="cpu")
    assert agent2.state.step == 2 and agent2.cnt_batch == 4
    for a, b in zip(tree_leaves(agent2.state.params), tree_leaves(state.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    resumed = agent2.state.opt_state
    moments = [st[m] for st in resumed.state.values() for m in ("mu", "nu")]
    assert isinstance(resumed, t_opt.AdamW8bit) and moments and all(m.dtype == torch.int8 for m in moments)
    assert agent2.run().step == 3 and os.path.isdir(os.path.join(agent2.ckpt_dir, "ckpt_3"))


def test_validate_reports_l1_and_accuracy(tmp_path):
    cfg, _ = tiny_config(tmp_path, overrides=["eval_size=4"])
    agent = t_agent.TrainAgent(cfg, dataset=Frames(0), val_dataset=Frames(1), device="cpu")
    result = agent.validate(0)
    assert set(result["accuracy"]) == {0.05, 0.1, 0.2, 0.3, 0.5} and np.isfinite(result["l1"])
    assert all(0.0 <= a <= 1.0 for a in result["accuracy"].values())


def test_auto_resume_skips_a_partial_checkpoint_and_keeps_wandb_id(tmp_path):
    cfg, _ = tiny_config(tmp_path, quantize=False, lora=False, overrides=["resume_checkpoint_path=auto"])
    fresh = t_agent.TrainAgent(cfg, dataset=Frames(0), device="cpu")  # nothing to resume from
    assert fresh.state.step == 0 and fresh._latest_checkpoint() is None
    fresh._wandb_id = "run-abc"
    fresh.run()
    os.makedirs(os.path.join(fresh.ckpt_dir, "ckpt_99", t_ckpt.STATE_DIR))  # a save cut short: no meta.json
    os.makedirs(os.path.join(fresh.ckpt_dir, "not_a_ckpt_7", t_ckpt.STATE_DIR))
    again = t_agent.TrainAgent(cfg, dataset=Frames(0), device="cpu")
    assert again._latest_checkpoint().endswith("ckpt_2")
    assert again.state.step == 2 and again._wandb_id == "run-abc" and again.cnt_batch == 4


def test_agent_refuses_what_is_not_ported(tmp_path, monkeypatch):
    # the data comes from cfg.data; a mix that no registry holds, and no
    # data at all, are refused
    cfg, _ = tiny_config(tmp_path, overrides=[f"data={{train: {{dataset_mix: no_such_mix, data_path: {tmp_path}}}}}"])
    with pytest.raises(ValueError, match="unknown mix 'no_such_mix'"):
        t_agent.TrainAgent(cfg, device="cpu")
    cfg, _ = tiny_config(tmp_path)
    with pytest.raises(ValueError, match="no data"):
        t_agent.TrainAgent(cfg, device="cpu")
    cfg, _ = tiny_config(tmp_path, overrides=["global_batch_size=5"])
    with pytest.raises(ValueError, match="not divisible"):
        t_agent.TrainAgent(cfg, dataset=Frames(0), device="cpu")
    # a world of 2 processes: the batch math counts its ranks (6 frames do
    # not split into 2 per device x 2 ranks), and a world that did not join
    # its process group is told to (tests/test_torch_dp_agent.py trains on one)
    monkeypatch.setenv("WORLD_SIZE", "2")
    cfg, _ = tiny_config(tmp_path, overrides=["global_batch_size=6"])
    with pytest.raises(ValueError, match="per_device 2 x devices 2"):
        t_agent.TrainAgent(cfg, dataset=Frames(0), device="cpu")
    cfg, _ = tiny_config(tmp_path)
    with pytest.raises(RuntimeError, match="init_distributed"):
        t_agent.TrainAgent(cfg, dataset=Frames(0), device="cpu")


@pytest.mark.parametrize("recipe", ["qlora", "float"])
def test_first_update_equals_the_hand_driven_step(tmp_path, recipe):
    """The agent's update from its seed equals init_params + the config's
    quantization + build_optimizer + make_train_step driven by hand with the
    train stream's generator (``training/seeds.py``), on the same
    preprocessed batch."""
    qlora = recipe == "qlora"
    cfg, _ = tiny_config(tmp_path, quantize=qlora, lora=qlora, overrides=["n_updates=1"])
    agent = t_agent.TrainAgent(cfg, dataset=Frames(0), device="cpu")
    assert isinstance(agent.state.opt_state, t_opt.AdamW8bit if qlora else torch.optim.AdamW)
    agent.run()

    from open_pi_zero_torch.models import pizero

    model_cfg = pizero_config_from_dict(cfg)
    params = t_lora.quantize_per_model_config(pizero.init_params(model_cfg, seed=0, device="cpu"), model_cfg)
    optimizer = t_opt.build_optimizer(agent.train_cfg, params)
    state = t_train.init_train_state(params, optimizer, t_seeds.stream_generator(0, t_seeds.TRAIN), agent.train_cfg)
    step = t_train.make_train_step(model_cfg, agent.train_cfg, optimizer, grad_accum=2)
    it = Frames(0).iterator(2)
    micro = [agent.preprocess_batch(next(it)) for _ in range(2)]
    step(state, {k: torch.from_numpy(np.stack([m[k] for m in micro])) for k in micro[0]})
    for (path, a), b in zip(_leaves_with_paths(agent.state.params), tree_leaves(state.params)):
        assert torch.equal(a, b), path


def _jax_eval_load(params_np, jcfg, knobs):
    """The JAX EvalAgent._load_params arithmetic on a restored tree: cast,
    merge the adapters per mixture (then SigLIP and the projector), decode
    the NF4 bases, and the serving layout."""
    params = j_convert.to_dtype(jax.tree.map(jnp.asarray, params_np), jnp.float32)
    params = dict(params)
    params["joint"] = {"mixtures": {
        name: j_lora.merge_lora(m, jcfg.joint.mixture(name).lora_scaling)
        for name, m in params["joint"]["mixtures"].items()}}
    for key in ("siglip", "projector"):
        if j_lora.has_lora(params.get(key, {})):
            params[key] = j_lora.merge_lora(params[key], jcfg.siglip.lora_scaling)
    if j_lora.has_quantized_bases(params):
        params = j_lora.dequantize_base_weights(params, jnp.float32)
    return params, j_fuse.prepare_for_serving(params, **knobs)


@pytest.mark.parametrize("quantize", [False, True])
def test_serve_load_params_on_the_agents_checkpoint_equals_jax(tmp_path, quantize):
    cfg, path = tiny_config(tmp_path, quantize=quantize, lora=True, overrides=["n_updates=1", "lora_alpha=8"])
    agent = t_agent.TrainAgent(cfg, dataset=Frames(0), device="cpu")
    agent.run()
    ckpt = os.path.join(agent.ckpt_dir, "ckpt_1")
    model_cfg = pizero_config_from_dict(cfg)
    assert model_cfg.joint.mixture("vlm").lora_scaling == 2.0

    restored = t_ckpt.restore_params(ckpt, serve.abstract_params(model_cfg), device="cpu")
    merged = serve.merge_and_decode(restored, model_cfg, torch.float32)
    assert not t_lora.has_lora(merged) and not t_lora.has_quantized_bases(merged)
    jcfg = j_config.pizero_config_from_dict(j_config.load_config(path, overrides=["lora_alpha=8"]))
    np_tree = jax.tree.map(lambda t: t.detach().numpy(), restored)
    want_merged, want_served = _jax_eval_load(np_tree, jcfg, j_fuse.serving_layout_kwargs(cfg))
    want = dict(_leaves_with_paths(jax.tree.map(np.asarray, want_merged)))
    got = dict(_leaves_with_paths(merged))
    assert set(got) == set(want)
    for p, x in got.items():
        np.testing.assert_allclose(x.numpy(), want[p], rtol=0, atol=1e-6, err_msg=p)

    serve_cfg = load_config(path, overrides=[f"checkpoint_path={ckpt}", "lora_alpha=8"])
    served = serve.load_params(serve_cfg, model_cfg, torch.float32, torch.device("cpu"), random_init=False)
    shapes = lambda tree: {p: tuple(np.shape(x)) for p, x in _leaves_with_paths(tree)}  # noqa: E731
    assert shapes(served) == shapes(jax.tree.map(np.asarray, want_served))
    qkv = served["joint"]["mixtures"]["vlm"]["layers"]["attn"]["qkv"]
    # the config's quantize knob picks the layout: production (W8A8 trunk) or fused float
    assert ("qa" in qkv) if quantize else torch.is_tensor(qkv)


def test_monitor_helpers(caplog):
    from open_pi_zero_torch.utils import monitor

    timer = monitor.Timer()
    assert 0.0 <= timer() < 5.0 and timer(reset=False) >= 0.0
    log = logging.getLogger("opz_monitor_test")

    @monitor.log_execution_time(log)
    def twice(x):
        return 2 * x

    with caplog.at_level(logging.INFO, logger="opz_monitor_test"):
        assert twice(3) == 6
    assert any("twice took" in r.getMessage() for r in caplog.records)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with monitor.annotate("opz_test_range"):
            torch.ones(4).sum()
    assert any(e.key == "opz_test_range" for e in prof.key_averages())
