"""The port's checkpoints (``training/checkpoint.py``, torch.save in the
JAX package's layout: ``state/``, ``params/``, ``meta.json`` last), with
the JAX package's checkpoint tests as the model
(tests/test_config_and_checkpoint.py:130-250): the round trip, resume
equivalence (bitwise: the same ops on the same numbers), the eval-params
export, the quant-layout stamp. The steps draw their flow times and noise
from the state's generator, so a resume that lost the generator's state
would take another update."""

import json
import shutil

import numpy as np
import pytest
import torch

from open_pi_zero_torch import config as t_config
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models.tree import tree_leaves
from open_pi_zero_torch.ops import lora as t_lora
from open_pi_zero_torch.ops.quantization import QUANT_LAYOUT_VERSION
from open_pi_zero_torch.training import averaging as t_avg
from open_pi_zero_torch.training import checkpoint as t_ckpt
from open_pi_zero_torch.training import optimizer as t_opt
from open_pi_zero_torch.training import train_step as t_train
from tests.test_torch_lora import lora_config


def _cfgs(recipe: str):
    cfg = t_config.tiny_pizero_config()
    if recipe == "qlora":
        cfg = lora_config(cfg, quantize=True)
    sched = t_config.LRSchedulerConfig(warmup_steps=0)
    train_cfg = t_config.TrainingConfig(
        action_lr=1e-3, vlm_lr=1e-3, action_lr_scheduler=sched, vlm_lr_scheduler=sched, use_ema=True, ema_start=0,
        quantize_optimizer_states=recipe == "qlora", lora=recipe == "qlora",
    )
    return cfg, train_cfg


def _params(cfg, seed=0):
    return t_lora.quantize_per_model_config(t_pizero.init_params(cfg, seed=seed, device="cpu"), cfg)


def _new_state(cfg, train_cfg, seed=0):
    params = _params(cfg)
    optimizer = t_opt.build_optimizer(train_cfg, params)
    state = t_train.init_train_state(params, optimizer, torch.Generator().manual_seed(seed), train_cfg)
    return state, t_train.make_train_step(cfg, train_cfg, optimizer)


def _batch(cfg):
    rng = np.random.default_rng(0)
    n_img = cfg.siglip.num_image_tokens
    ids = np.zeros((2, cfg.max_image_text_tokens), np.int32)
    ids[:, :n_img] = cfg.image_token_index
    ids[:, n_img] = 9
    size = cfg.siglip.image_size
    return {
        "input_ids": torch.from_numpy(ids),
        "pixel_values": torch.from_numpy(rng.normal(size=(2, size, size, 3)).astype(np.float32)),
        "attention_mask": torch.from_numpy((ids != 0).astype(np.int32)),
        "proprios": torch.from_numpy(rng.normal(size=(2, cfg.cond_steps, cfg.proprio_dim)).astype(np.float32)),
        "actions": torch.from_numpy(rng.normal(size=(2, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)),
    }


@pytest.mark.parametrize("recipe", ["float", "qlora"])
def test_trainstate_round_trip_and_resume_equivalence(tmp_path, recipe):
    cfg, train_cfg = _cfgs(recipe)
    state, step = _new_state(cfg, train_cfg)
    batch = _batch(cfg)
    step(state, batch)
    t_ckpt.save_checkpoint(str(tmp_path / "ckpt"), state, extra={"cnt_batch": 7})
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta == ({"cnt_batch": 7, "quant_layout_version": 2} if recipe == "qlora" else {"cnt_batch": 7})

    live = [step(state, batch) for _ in range(2)]

    restored, step2 = _new_state(cfg, train_cfg, seed=99)  # another generator: restored from the file
    restored, extra = t_ckpt.restore_checkpoint(str(tmp_path / "ckpt"), restored)
    assert extra == meta and restored.step == 1 and restored.avg.n_averaged == 1
    resumed = [step2(restored, batch) for _ in range(2)]
    assert restored.step == state.step == 3
    for a, b in zip(live, resumed):
        assert float(a["loss"]) == float(b["loss"]) and float(a["grad_norm"]) == float(b["grad_norm"])
    for a, b in zip(tree_leaves(state.params), tree_leaves(restored.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(tree_leaves(state.avg.avg_params), tree_leaves(restored.avg.avg_params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # torch.equal promotes its operands: the dtypes are compared apart, so
    # that int8 moments come back int8
    sa, sb = state.opt_state.state_dict()["state"], restored.opt_state.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        assert sa[i].keys() == sb[i].keys()
        assert all(sa[i][k].dtype == sb[i][k].dtype and torch.equal(sa[i][k], sb[i][k]) for k in sa[i])
    if recipe == "qlora":
        assert all(sb[i][m].dtype == torch.int8 for i in sb for m in ("mu", "nu"))


def test_restore_refuses_another_tree(tmp_path):
    cfg, train_cfg = _cfgs("float")
    state, _ = _new_state(cfg, train_cfg)
    t_ckpt.save_checkpoint(str(tmp_path / "ckpt"), state)
    other_cfg, other_train = _cfgs("qlora")
    other, _ = _new_state(other_cfg, other_train)
    with pytest.raises(ValueError, match="checkpoint tree"):
        t_ckpt.restore_checkpoint(str(tmp_path / "ckpt"), other)


def _save_params_only(path, params, train_cfg):
    """A checkpoint directory holding only the eval export (a serving
    deployment ships ``params/`` and ``meta.json`` without ``state/``)."""
    state = t_train.init_train_state(params, t_opt.build_optimizer(train_cfg, params), torch.Generator(), train_cfg)
    t_ckpt.save_checkpoint(str(path), state, eval_params=params)
    shutil.rmtree(path / t_ckpt.STATE_DIR)


def test_params_only_round_trip(tmp_path):
    cfg, train_cfg = _cfgs("float")
    params = t_pizero.init_params(cfg, seed=3, device="cpu")
    _save_params_only(tmp_path / "p", params, train_cfg)
    out = t_ckpt.restore_params(str(tmp_path / "p"), t_pizero.abstract_params(cfg), device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(out)):
        assert torch.equal(a, b)
    assert t_ckpt.is_checkpoint(str(tmp_path / "p")) and not t_ckpt.is_checkpoint(str(tmp_path))


def test_train_checkpoint_carries_eval_params(tmp_path):
    """One directory feeds both resuming (the TrainState) and serving
    (restore_params); a state-only directory fails restore_params with a
    pointer to the eval-params export."""
    cfg, train_cfg = _cfgs("float")
    state, step = _new_state(cfg, train_cfg)
    step(state, _batch(cfg))
    ev = t_avg.eval_params(state.avg, state.params)
    t_ckpt.save_checkpoint(str(tmp_path / "full"), state, eval_params=ev)
    out = t_ckpt.restore_params(str(tmp_path / "full"), state.params, device="cpu")
    for a, b in zip(tree_leaves(ev), tree_leaves(out)):
        assert torch.equal(a, b)

    t_ckpt.save_checkpoint(str(tmp_path / "legacy"), state)
    with pytest.raises(FileNotFoundError, match="eval-params export"):
        t_ckpt.restore_params(str(tmp_path / "legacy"), state.params, device="cpu")


def test_quant_layout_version_stamped_and_checked(tmp_path):
    """4-bit payloads save with the packing-layout version in meta.json; an
    absent or other version fails at restore; float trees carry no
    no stamp and restore without the check."""
    cfg, train_cfg = _cfgs("qlora")
    params = _params(cfg, seed=3)
    _save_params_only(tmp_path / "q", params, train_cfg)
    meta = json.loads((tmp_path / "q" / "meta.json").read_text())
    assert meta["quant_layout_version"] == QUANT_LAYOUT_VERSION
    out = t_ckpt.restore_params(str(tmp_path / "q"), params, device="cpu")
    assert "q4" in out["joint"]["mixtures"]["vlm"]["layers"]["attn"]["q"]

    (tmp_path / "q" / "meta.json").write_text("{}")
    with pytest.raises(ValueError, match="packing layout"):
        t_ckpt.restore_params(str(tmp_path / "q"), params, device="cpu")
    (tmp_path / "q" / "meta.json").write_text(json.dumps({"quant_layout_version": 1}))
    with pytest.raises(ValueError, match="packing layout"):
        t_ckpt.restore_params(str(tmp_path / "q"), params, device="cpu")

    fcfg, ftrain_cfg = _cfgs("float")
    fparams = t_pizero.init_params(fcfg, seed=4, device="cpu")
    _save_params_only(tmp_path / "f", fparams, ftrain_cfg)
    assert json.loads((tmp_path / "f" / "meta.json").read_text()) == {}
    t_ckpt.restore_params(str(tmp_path / "f"), fparams, device="cpu")
