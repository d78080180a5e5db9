"""The port's checkpoint converters (``open_pi_zero_torch/models/convert.py``)
against the JAX package's (``open_pi_zero_tpu/models/convert.py``) on the
reference's own state dicts in the golden fixtures: bitwise, leaf by leaf,
through ``params_from_jax`` of JAX's tree; ``load_vla_checkpoint`` on
``.pt`` files written here; the safetensors reader against the
``safetensors`` package; and the reference's recorded chunk replayed
through the port's converter alone (no JAX on that path)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pi_zero_torch import config as t_config
from open_pi_zero_torch.models import convert as t_convert
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models.from_jax import params_from_jax
from open_pi_zero_torch.models.tree import tree_leaves
from open_pi_zero_tpu.models import convert as j_convert
from tests import golden
from tests import test_reference_parity as joint_parity
from tests import test_reference_parity_pizero as pizero_parity
from tests.test_torch_models import torch_cfg


def leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_with_paths(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def assert_trees_bitwise(got: dict, want: dict):
    """Same keys, and every leaf the same dtype, shape and bits; ``want`` is
    the JAX converter's tree through ``params_from_jax``."""
    g, w = leaves_with_paths(got), leaves_with_paths(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.is_contiguous(), path
        assert torch.equal(a, b), path


def jax_tree(tree) -> dict:
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def fixture_cfg(lm_head: bool = False) -> t_config.PiZeroConfig:
    """The port's config of the reference fixtures' geometry, built from the
    parity suite's plain dicts (no JAX config on this path)."""
    g, j, v, m = pizero_parity.GEOM, pizero_parity.JOINT, pizero_parity.VIS, pizero_parity.MIX
    mix_keys = ("hidden_size", "intermediate_size", "use_final_norm", "cache", "rope_theta")
    mixtures = tuple(t_config.MixtureConfig(**{k: mx[k] for k in mix_keys}) for mx in m.values())
    if lm_head:
        mixtures = (dataclasses.replace(mixtures[0], use_final_norm=True),) + mixtures[1:]
    joint = t_config.JointConfig(
        time_hidden_size=g["time_hidden_size"], mixtures=mixtures, tie_proprio=False, **j
    )
    siglip = t_config.SiglipConfig(
        **{k: v[k] for k in ("hidden_size", "intermediate_size", "num_hidden_layers", "num_attention_heads",
                             "image_size", "patch_size", "num_image_tokens")},
        projection_dim=m["vlm"]["hidden_size"],
    )
    geom = {k: g[k] for k in g if k != "action_expert_adaptive_mode"}
    return t_config.PiZeroConfig(**geom, siglip=siglip, joint=joint, use_lm_head=lm_head)


def test_fixture_cfg_is_the_parity_suites():
    assert fixture_cfg() == torch_cfg(pizero_parity.build_our_cfg())
    assert fixture_cfg(lm_head=True) == torch_cfg(pizero_parity.build_our_cfg(lm_head=True))


@pytest.mark.parametrize("name,lm_head", [("pizero_infer_action", False), ("verify_selftest", True)])
def test_convert_vla_state_dict_bitwise(name, lm_head):
    state = golden.load_fixture_or_skip(name)["state"]
    jcfg = pizero_parity.build_our_cfg(lm_head=lm_head)
    got = t_convert.convert_vla_state_dict(state, fixture_cfg(lm_head))
    assert_trees_bitwise(got, jax_tree(j_convert.convert_vla_state_dict(dict(state), jcfg)))
    assert "proprio" in got["joint"]["mixtures"]  # tie_proprio=False: its own weights


def test_convert_siglip_bitwise():
    state = golden.load_fixture_or_skip("siglip_tower")["state"]
    scfg = joint_parity._siglip_config()

    class _C:
        siglip = scfg

    class _T:
        siglip = torch_cfg(scfg)

    assert_trees_bitwise(t_convert.convert_siglip(state, _T), jax_tree(j_convert.convert_siglip(state, _C)))


def test_convert_gemma_mixture_bitwise():
    """The reference's JointModel state of the cached-step fixture (the
    mixtures' layers; ``gemma_modules.npz`` holds no state dict)."""
    state = golden.load_fixture_or_skip("joint_cached_action_step")["state"]
    jcfg = joint_parity._our_joint_config()

    class _C:
        joint = jcfg

    class _T:
        joint = torch_cfg(jcfg)

    for i, name in enumerate(("vlm", "proprio", "action")):
        final = jcfg.mixtures[i].use_final_norm
        got = t_convert.convert_gemma_mixture(state, _T, f"mixtures.{name}.", final)
        want = j_convert.convert_gemma_mixture(state, _C, f"mixtures.{name}.", final)
        assert_trees_bitwise(got, jax_tree(want))


def test_convert_paligemma_bitwise():
    """HF PaliGemma keys, made from the fixture's VLA state (the same tensors
    under the PaliGemma names)."""
    state = golden.load_fixture_or_skip("pizero_infer_action")["state"]
    hf = {}
    for k, v in state.items():
        if k.startswith("joint_model.mixtures.vlm."):
            hf["language_model.model." + k[len("joint_model.mixtures.vlm."):]] = v
        elif k == "embed_tokens.weight":
            hf["language_model.model.embed_tokens.weight"] = v
        elif k.startswith(("vision_tower.", "multi_modal_projector.")):
            hf[k] = v
    got = t_convert.convert_paligemma(hf, fixture_cfg())
    assert_trees_bitwise(got, jax_tree(j_convert.convert_paligemma(hf, pizero_parity.build_our_cfg())))


@pytest.mark.parametrize("wrap", ["bare", "model", "ema_compiled"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_vla_checkpoint_bitwise(tmp_path, wrap, dtype):
    """A .pt from torch.save, bare or as the trainer writes it ({"model":
    ...}, with EMA's ``module.`` and torch.compile's ``_orig_mod.``
    prefixes and ``n_averaged``), loaded and cast by ``to_dtype``."""
    state = golden.load_fixture_or_skip("pizero_infer_action")["state"]
    tensors = {k: torch.from_numpy(v) for k, v in state.items()}
    if wrap == "ema_compiled":
        tensors = {f"module._orig_mod.{k}": v for k, v in tensors.items()}
        tensors["n_averaged"] = torch.tensor(3)
    payload = tensors if wrap == "bare" else {"model": tensors, "step": 7}
    path = tmp_path / "ckpt.pt"
    torch.save(payload, path)
    got = t_convert.load_vla_checkpoint(str(path), fixture_cfg(), getattr(torch, dtype))
    want = j_convert.to_dtype(j_convert.convert_vla_state_dict(dict(state), pizero_parity.build_our_cfg()),
                              getattr(jnp, dtype))
    assert_trees_bitwise(got, jax_tree(want))
    assert {x.dtype for x in tree_leaves(got)} == {getattr(torch, dtype)}


def test_to_dtype_keeps_quantized_payloads_and_moves_leaves():
    tree = {
        "k": torch.ones(2, 3),
        "int8": {"q": torch.ones(2, 3, dtype=torch.int8), "scale": torch.ones(3)},
        "nf4": {"q4": torch.ones(2, 2, dtype=torch.uint8), "absmax": torch.ones(2, 1)},
    }
    out = t_convert.to_dtype(tree, torch.bfloat16, torch.device("cpu"))
    assert out["k"].dtype == torch.bfloat16
    assert out["int8"]["q"].dtype == torch.int8 and out["int8"]["scale"].dtype == torch.float32
    assert out["nf4"]["q4"].dtype == torch.uint8 and out["nf4"]["absmax"].dtype == torch.float32


def test_merge_pretrained_overlays_and_checks_shapes():
    cfg = fixture_cfg()
    state = golden.load_fixture_or_skip("pizero_infer_action")["state"]
    base = t_pizero.init_params(cfg, seed=0, device="cpu")
    pre = {"embed_tokens": state["embed_tokens.weight"]}
    got = t_convert.merge_pretrained(base, pre)
    np.testing.assert_array_equal(got["embed_tokens"].numpy(), state["embed_tokens.weight"])
    assert got["projector"] is base["projector"]
    with pytest.raises(ValueError, match="shape mismatch"):
        t_convert.merge_pretrained(base, {"embed_tokens": state["embed_tokens.weight"][:3]})


SAFETENSORS_DTYPES = ["float32", "float16", "bfloat16", "int32", "int64"]


def test_safetensors_reader_matches_the_package(tmp_path):
    st = pytest.importorskip("safetensors")
    from safetensors.torch import save_file

    rng = np.random.default_rng(0)
    files = {
        "model-00001-of-00002.safetensors": {
            f"a.{d}": torch.from_numpy(rng.normal(size=(3, 5)) * 100).to(getattr(torch, d)) for d in SAFETENSORS_DTYPES
        },
        "model-00002-of-00002.safetensors": {
            "b.scalar": torch.tensor(2.5), "b.empty": torch.zeros(0, 4), "b.vec": torch.arange(7, dtype=torch.int32),
        },
    }
    for fname, tensors in files.items():
        save_file(tensors, str(tmp_path / fname), metadata={"format": "pt"})
    (tmp_path / "config.json").write_text("{}")  # other files are left alone
    got = t_convert.load_safetensors_dir(str(tmp_path))
    want = {}
    for fname in files:
        with st.safe_open(str(tmp_path / fname), framework="pt") as f:
            want.update({k: f.get_tensor(k) for k in f.keys()})
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def test_safetensors_reader_refuses_bad_files(tmp_path):
    with pytest.raises(FileNotFoundError):
        t_convert.load_safetensors_dir(str(tmp_path))
    (tmp_path / "x.safetensors").write_bytes((100).to_bytes(8, "little") + b"{}")
    with pytest.raises(ValueError, match="header length"):
        t_convert.load_safetensors_dir(str(tmp_path))
    header = b'{"w": {"dtype": "F32", "shape": [4], "data_offsets": [0, 8]}}'
    (tmp_path / "x.safetensors").write_bytes(len(header).to_bytes(8, "little") + header + bytes(8))
    with pytest.raises(ValueError, match="data_offsets"):
        t_convert.load_safetensors_dir(str(tmp_path))


def test_golden_infer_action_through_the_ports_converter():
    """The reference's recorded chunk, from its state dict through the
    port's converter alone, fp32 on the CPU: rtol 2e-4, atol 2e-5, the JAX
    replay's tolerance."""
    payload = golden.load_fixture_or_skip("pizero_infer_action")
    cfg = fixture_cfg()
    params = t_convert.to_dtype(t_convert.convert_vla_state_dict(payload["state"], cfg), torch.float32)
    got = t_pizero.infer_action(
        params, cfg, None,
        torch.from_numpy(payload["ids"].astype(np.int32)),
        torch.from_numpy(np.ascontiguousarray(payload["pix"].transpose(0, 2, 3, 1))),  # NHWC
        torch.from_numpy(payload["am"].astype(np.int32)),
        torch.from_numpy(payload["prop"]),
        action0=torch.from_numpy(payload["a0"]),
    )
    np.testing.assert_allclose(got.numpy(), payload["want"], rtol=2e-4, atol=2e-5)
