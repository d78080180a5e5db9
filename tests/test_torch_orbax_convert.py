"""``convert_jax_checkpoint.py`` (repository root): tiny checkpoints that
the JAX package's ``training/checkpoint.save_params`` writes (fp32, bf16,
and QLoRA: NF4 bases with LoRA adapters) are converted into the port's
format and served by the port's ``scripts/serve.load_params`` on the CPU.

Each chunk is held against the JAX package's own load of the unconverted
checkpoint (its ``restore_params``, then its EvalAgent's steps to the
config's serving layout) and its ``infer_action`` on the same inputs with the same injected ``action0``: within 1e-4 in float32
(the bf16 checkpoint is restored to float32 on both sides, which is
exact); the bf16 checkpoint served in bf16 (``use_bf16``) within 2e-2 of
JAX's bf16 chunk (bf16 matmul inputs; the tolerance is
``tests/test_torch_bf16.py``'s order). Also checked: the EvalAgent's load
and the TrainAgent's ``base_params_checkpoint`` read a converted
directory; a directory with only ``state/`` raises the JAX package's
FileNotFoundError; every port loader refuses an unconverted orbax
directory with the converter's command line."""

import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import convert_jax_checkpoint as converter
from open_pi_zero_torch.agents import eval as t_eval
from open_pi_zero_torch.agents import train as t_agent
from open_pi_zero_torch.config import load_config as t_load_config
from open_pi_zero_torch.config import pizero_config_from_dict as t_model_cfg
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models.tree import tree_leaves
from open_pi_zero_torch.scripts import eval_scaleup_ckpt, serve
from open_pi_zero_torch.scripts import verify_checkpoint as t_verify
from open_pi_zero_torch.training import checkpoint as t_ckpt
from open_pi_zero_tpu.config import load_config as j_load_config
from open_pi_zero_tpu.config import pizero_config_from_dict as j_model_cfg
from open_pi_zero_tpu.models import convert as j_convert
from open_pi_zero_tpu.models import fuse as j_fuse
from open_pi_zero_tpu.models import pizero as j_pizero
from open_pi_zero_tpu.ops import lora as j_lora
from open_pi_zero_tpu.training import checkpoint as j_ckpt
from tests.test_torch_train_agent_card import TINY_YAML, Frames

CASES = {  # name: (quantize and lora, stored dtype)
    "fp32": (False, jnp.float32),
    "bf16": (False, jnp.bfloat16),
    "qlora": (True, jnp.float32),
}


def yaml_path(root, qlora: bool, lora: bool = None) -> str:
    lora = qlora if lora is None else lora
    path = root / f"tiny_q{int(qlora)}_l{int(lora)}.yaml"
    path.write_text(TINY_YAML.format(log_dir=root / "log", quantize=str(qlora).lower(), lora=str(lora).lower()))
    return str(path)


def lively_adapters(tree, rng):
    """The adapters' B made nonzero (at init they are 0 and merge to
    nothing)."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k.endswith("_lora"):
            out[k] = {**v, "b": jnp.asarray(rng.normal(0, 0.05, v["b"].shape), v["b"].dtype)}
        else:
            out[k] = lively_adapters(v, rng)
    return out


def jax_params(cfg, qlora: bool, dtype):
    params = jax.jit(lambda key: j_pizero.init_params(key, cfg))(jax.random.key(3))
    if qlora:
        quantized = jax.jit(lambda p: j_lora.quantize_per_model_config(p, cfg))(params)
        params = lively_adapters(quantized, np.random.default_rng(0))
    return j_convert.to_dtype(params, dtype) if dtype != jnp.float32 else params


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    n_img = cfg.siglip.num_image_tokens
    ids = np.zeros((2, cfg.max_image_text_tokens), np.int32)
    ids[:, :n_img] = cfg.image_token_index
    ids[:, n_img] = 2
    ids[0, n_img + 1: n_img + 4] = [10, 11, 12]
    ids[1, n_img + 1] = 13
    am = (ids != cfg.pad_token_id).astype(np.int32)
    img = rng.normal(size=(2, cfg.siglip.image_size, cfg.siglip.image_size, 3)).astype(np.float32)
    prop = rng.normal(size=(2, cfg.cond_steps, cfg.proprio_dim)).astype(np.float32)
    a0 = rng.normal(size=(2, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
    return ids, img, am, prop, a0


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """{case: (yaml, the JAX directory, the converted directory, meta)}."""
    root = tmp_path_factory.mktemp("orbax")
    out = {}
    for name, (qlora, dtype) in CASES.items():
        yml = yaml_path(root, qlora)
        cfg = j_model_cfg(j_load_config(yml))
        src, dst = str(root / f"jax_{name}"), str(root / f"port_{name}")
        j_ckpt.save_params(src, jax_params(cfg, qlora, dtype))
        meta = converter.convert(src, dst, yml)
        out[name] = (yml, src, dst, meta)
    return out


def jax_serving_params(yml, src, dtype):
    """The JAX package's load of its own checkpoint, as its EvalAgent's
    ``_load_params`` runs it (restore, cast, merge the adapters, decode the
    NF4 bases, the config's serving layout), under one ``jax.jit``."""
    cfg_dict = j_load_config(yml)
    cfg = j_model_cfg(cfg_dict)
    params = j_ckpt.restore_params(src, converter.abstract_params(cfg))

    def load(params):
        params = j_convert.to_dtype(params, dtype)
        if j_lora.has_lora(params):
            joint = {"mixtures": {n: j_lora.merge_lora(m, cfg.joint.mixture(n).lora_scaling)
                                  for n, m in params["joint"]["mixtures"].items()}}
            params = {**params, "joint": joint}
            for key in ("siglip", "projector"):
                if j_lora.has_lora(params.get(key, {})):
                    params[key] = j_lora.merge_lora(params[key], cfg.siglip.lora_scaling)
        if j_lora.has_quantized_bases(params):
            params = j_lora.dequantize_base_weights(params, dtype)
        return j_fuse.prepare_for_serving(params, **j_fuse.serving_layout_kwargs(cfg_dict))

    return cfg, jax.jit(load)(params)


def jax_chunk(yml, src, bf16=False):
    dt = jnp.bfloat16 if bf16 else jnp.float32
    cfg, params = jax_serving_params(yml, src, dt)
    ids, img, am, prop, a0 = inputs(cfg)
    infer = jax.jit(lambda p, *args: j_pizero.infer_action(p, cfg, jax.random.key(0), *args[:4], action0=args[4]))
    out = infer(params, jnp.asarray(ids), jnp.asarray(img, dt), jnp.asarray(am), jnp.asarray(prop, dt),
                jnp.asarray(a0, dt))
    return np.asarray(out.astype(jnp.float32))


def port_chunk(params, yml, bf16=False):
    cfg = t_model_cfg(t_load_config(yml))
    ids, img, am, prop, a0 = inputs(cfg)
    dt = torch.bfloat16 if bf16 else torch.float32
    with torch.no_grad():
        out = t_pizero.infer_action(params, cfg, None, torch.from_numpy(ids), torch.from_numpy(img).to(dt),
                                    torch.from_numpy(am), torch.from_numpy(prop).to(dt),
                                    action0=torch.from_numpy(a0).to(dt))
    return out.float().numpy()


def served(yml, dst, bf16=False):
    cfg = t_load_config(yml, [f"checkpoint_path={dst}"] + (["use_bf16=true"] if bf16 else []))
    dtype = torch.bfloat16 if bf16 else torch.float32
    return serve.load_params(cfg, t_model_cfg(cfg), dtype, "cpu", random_init=False)


@pytest.mark.parametrize("name", list(CASES))
def test_converted_checkpoint_serves_jax_s_chunk(converted, name):
    yml, src, dst, meta = converted[name]
    assert t_ckpt.is_checkpoint(dst) and not t_ckpt.is_orbax_checkpoint(dst)
    assert t_ckpt.is_orbax_checkpoint(src)
    qlora = CASES[name][0]
    assert meta == ({"quant_layout_version": t_ckpt.QUANT_LAYOUT_VERSION} if qlora else {})
    stored = [p for p, _ in _leaves(torch.load(f"{dst}/{t_ckpt.PARAMS_DIR}/{t_ckpt.PARAMS_FILE}", weights_only=True))]
    assert any(p.endswith("/q4") for p in stored) == qlora and any("_lora/" in p for p in stored) == qlora
    got, want = port_chunk(served(yml, dst), yml), jax_chunk(yml, src)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= 1e-4, f"{name}: max|diff| {err:.2e}"
    if name == "bf16":
        got, want = port_chunk(served(yml, dst, bf16=True), yml, bf16=True), jax_chunk(yml, src, bf16=True)
        err = np.abs(got - want).max()
        assert err <= 2e-2, f"bf16 served in bf16: max|diff| {err:.2e}"


def test_eval_agent_and_base_params_read_a_converted_directory(converted, tmp_path):
    yml, _, dst, _ = converted["qlora"]
    cfg = t_load_config(yml, [f"checkpoint_path={dst}"])
    agent = t_eval.EvalAgent(cfg, env=object(), adapter=object(), device="cpu")
    want = served(yml, dst)
    assert [p for p, _ in _leaves(agent.params)] == [p for p, _ in _leaves(want)]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_leaves(agent.params), _leaves(want)))

    yml, _, dst, _ = converted["fp32"]  # a float tree without adapters: a base for QLoRA
    base = t_ckpt.restore_params(dst, device="cpu")
    cfg = t_load_config(yaml_path(tmp_path, False, lora=True), [f"base_params_checkpoint={dst}"])
    agent = t_agent.TrainAgent(cfg, dataset=Frames(0), device="cpu")
    params = t_agent._strip_lora(agent.state.params)
    assert [p for p, _ in _leaves(params)] == [p for p, _ in _leaves(base)]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_leaves(params), _leaves(base)))
    assert len(tree_leaves(agent.state.params)) > len(tree_leaves(params))  # fresh adapters kept


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def test_a_state_only_directory_raises_jax_s_error(converted, tmp_path):
    yml, src, _, _ = converted["fp32"]
    shutil.copytree(f"{src}/params", tmp_path / "jax" / "state")
    with pytest.raises(FileNotFoundError, match="no eval-params export"):
        converter.convert(str(tmp_path / "jax"), str(tmp_path / "out"), yml)
    assert not (tmp_path / "out").exists()


def test_every_loader_refuses_an_orbax_directory_with_the_command(converted, tmp_path):
    yml, src, _, _ = converted["qlora"]
    command = re.escape("convert_jax_checkpoint.py " + src)
    cfg = t_load_config(yml, [f"checkpoint_path={src}"])
    with pytest.raises(NotImplementedError, match=command):
        serve.load_params(cfg, t_model_cfg(cfg), torch.float32, "cpu", random_init=False)
    with pytest.raises(NotImplementedError, match=command):
        t_eval.EvalAgent(cfg, env=object(), adapter=object(), device="cpu")
    with pytest.raises(NotImplementedError, match=command):
        t_agent.TrainAgent(t_load_config(yml, [f"base_params_checkpoint={src}"]), dataset=Frames(0), device="cpu")
    with pytest.raises(NotImplementedError, match=command):
        t_ckpt.restore_params(src, device="cpu")
    with pytest.raises(NotImplementedError, match="orbax checkpoint"):
        t_verify.stage_load(src, t_model_cfg(cfg), torch.float32, "cpu")
    work = tmp_path / "work"
    shutil.copytree(src, work / "train" / "checkpoint" / "ckpt_1")
    with pytest.raises(NotImplementedError, match="convert_jax_checkpoint.py"):
        eval_scaleup_ckpt.main(["--workdir", str(work), "--ckpt", "ckpt_1", "--device", "cpu"])
    # the item alone (params/), as a JAX user may pass it
    with pytest.raises(NotImplementedError, match="convert_jax_checkpoint.py"):
        t_ckpt.restore_params(f"{src}/params", device="cpu")
