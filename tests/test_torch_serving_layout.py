"""The serving layout in the port (open_pi_zero_torch/ops/quantization.py,
ops/lora.py, ops/linear.py, models/fuse.py and the NF4 hoist of
models/pizero.py) against the JAX package on the CPU: the same numpy
inputs from a seed, JAX's params converted with ``params_from_jax``.

Tolerances, with their reasons:
- the quantizers, the tree transforms and the fused and quantized trees:
  bitwise. They are the same fp32 elementwise ops in the same order
  (divide, round half to even, clamp; midpoint comparisons in fp32; the
  NF4 table gathered where JAX selects).
- ``linear`` W8A8: bitwise in fp32 and bf16. The int32 product is exact
  and its epilogue (times the token's, then the channel's scale, plus the
  bias, then one cast) is JAX's order.
- ``linear`` weight-only int8 and NF4: fp32 within 1e-5 relative (another
  summation order); in bf16 at most 0.1% of the elements differ, each by
  one bf16 ulp (as tests/test_torch_bf16.py).
- the fused float chunk against the unfused one, fp32: 1e-6 absolute, as
  JAX's ``test_fused_infer_action_identical`` (concatenated columns change
  no dot product, only the blocking of the sums).
- ``infer_action`` on the serving layouts against JAX's, fp32: 1e-4, as
  tests/test_torch_models.py. A W8A8 activation that sits on an int8
  rounding tie could round the other way on one side; none does here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pi_zero_torch import config as t_config
from open_pi_zero_torch.models import fuse as t_fuse
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models.from_jax import params_from_jax
from open_pi_zero_torch.models.tree import tree_leaves
from open_pi_zero_torch.ops import linear as t_lin
from open_pi_zero_torch.ops import lora as t_lora
from open_pi_zero_torch.ops import quantization as t_quant
from open_pi_zero_torch.parallel.mesh import Mesh
from open_pi_zero_torch.parallel.sharding import shard_params_tp, tp_param_specs
from open_pi_zero_tpu.config import tiny_pizero_config
from open_pi_zero_tpu.models import fuse as j_fuse
from open_pi_zero_tpu.models import pizero as j_pizero
from open_pi_zero_tpu.ops import linear as j_lin
from open_pi_zero_tpu.ops import lora as j_lora
from open_pi_zero_tpu.ops import quantization as j_quant
from tests.test_torch_bf16 import assert_rounds_once
from tests.test_torch_models import example_inputs, torch_cfg

PRODUCTION = dict(quantize_mixtures=("action",), bits=8, w8a8_mixtures=("vlm",), w8a8_siglip=False)
LAYOUTS = {
    "production": PRODUCTION,
    "nf4_expert": {**PRODUCTION, "bits": 4},
    "w8a8_siglip": {**PRODUCTION, "w8a8_siglip": True},
}


def flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def assert_trees_bitwise(got: dict, want: dict) -> None:
    """Same keys, every leaf of the same dtype and bits (the key order of a
    converted tree is ``jax.tree.map``'s, which sorts them)."""
    g, w = flat(got), {k: np.asarray(v) for k, v in flat(want).items()}
    assert sorted(g) == sorted(w)
    for path, leaf in g.items():
        assert str(leaf.dtype).removeprefix("torch.") == w[path].dtype.name, path
        if leaf.dtype == torch.bfloat16:  # compared as bit patterns
            leaf, w[path] = leaf.view(torch.int16), w[path].view(np.int16)
        np.testing.assert_array_equal(leaf.numpy(), w[path], err_msg=path)


def jax_to_port(tree) -> dict:
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_pizero_config()
    jparams = j_pizero.init_params(jax.random.key(0), jcfg)
    return jcfg, torch_cfg(jcfg), jparams, jax_to_port(jparams)


# --------------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mse_scale", [False, True])
@pytest.mark.parametrize("shape", [(64, 96), (3, 48, 40)])
def test_quantize_int8_rowwise_matches_jax(shape, mse_scale):
    """2-D directly; a stacked 3-D kernel layer by layer, through the tree
    walk that quantizes it."""
    w = (np.random.default_rng(0).normal(size=shape) * 0.05).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero channel takes scale 1
    if len(shape) == 2:
        got = t_quant.quantize_int8_rowwise(torch.from_numpy(w), mse_scale=mse_scale)
        want = j_quant.quantize_int8_rowwise(jnp.asarray(w), mse_scale=mse_scale)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    else:
        got = t_lora.quantize_base_weights({"gate": torch.from_numpy(w)}, mse_scale=mse_scale)
        want = j_lora.quantize_base_weights({"gate": jnp.asarray(w)}, mse_scale=mse_scale)
        assert_trees_bitwise(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_per_token_matches_jax(dtype):
    x = np.random.default_rng(1).normal(size=(2, 5, 64)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero token
    x[0, 1, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]  # scale 1: ties round half to even
    x[0, 1, 6:] = 0.0
    got = t_quant.quantize_act_per_token(torch.from_numpy(x).to(getattr(torch, dtype)))
    want = j_quant.quantize_act_per_token(jnp.asarray(x).astype(dtype))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0][0, 1, :6].numpy(), [127, 0, 2, 2, 0, -2])


@pytest.mark.parametrize("shape", [(64, 128), (3, 16, 96), (8, 40)])
def test_nf4_matches_jax(shape):
    """Quantize and dequantize (fp32 and bf16); 96 and 40 are not multiples
    of 64, so the block shrinks to 32 and 8."""
    w = (np.random.default_rng(2).normal(size=shape) * 0.05).astype(np.float32)
    w[..., :8] = 0.0  # an all-zero block takes absmax 1
    got = t_quant.quantize_kernel_nf4(torch.from_numpy(w))
    want = j_quant.quantize_kernel_nf4(jnp.asarray(w))
    assert_trees_bitwise(got, want)
    assert got["q4"].dtype == torch.uint8 and got["q4"].shape[-1] == shape[-1] // 2
    for dtype in ("float32", "bfloat16"):
        np.testing.assert_array_equal(
            t_quant.dequantize_kernel_nf4(got, getattr(torch, dtype)).float().numpy(),
            np.asarray(j_quant.dequantize_kernel_nf4(want, jnp.dtype(dtype)), np.float32),
        )


def test_quant_constants_match_jax():
    assert t_quant.NF4_CODE == j_quant.NF4_CODE
    assert t_quant.QUANT_LAYOUT_VERSION == j_quant.QUANT_LAYOUT_VERSION == 2
    assert t_lora.QUANTIZE_KEYS == j_lora.QUANTIZE_KEYS
    np.testing.assert_array_equal(
        np.asarray(t_quant.MSE_SCALE_FACTORS, np.float32), np.asarray(jnp.linspace(0.75, 1.0, 11))
    )


@pytest.mark.parametrize("tier", [dict(bits=8), dict(bits=4), dict(w8a8=True)])
def test_quantize_base_weights_matches_jax(tiny, tier):
    """A tiny mixture, unfused and fused: every key and leaf bitwise; a
    second walk changes nothing; the dequantized tree bitwise JAX's."""
    _, _, jparams, tparams = tiny
    for j_mix, t_mix in (
        (jparams["joint"]["mixtures"]["vlm"], tparams["joint"]["mixtures"]["vlm"]),
        (j_fuse.fuse_for_serving(jparams)["joint"]["mixtures"]["action"],
         t_fuse.fuse_for_serving(tparams)["joint"]["mixtures"]["action"]),
    ):
        got = t_lora.quantize_base_weights(t_mix, **tier)
        want = j_lora.quantize_base_weights(j_mix, **tier)
        assert_trees_bitwise(got, want)
        again = t_lora.quantize_base_weights(got, **tier)
        assert all(a is b for a, b in zip(tree_leaves(again), tree_leaves(got)))
        assert t_lora.has_quantized_bases(got) and not t_lora.has_quantized_bases(t_mix)
        assert t_lora.is_quantized_base(got["layers"]["mlp"]["down"])
        assert not t_lora.is_quantized_base(got["layers"]["attn"])
        if tier.get("w8a8"):  # each layer's payload column-major, as _int_mm reads it fastest
            assert got["layers"]["mlp"]["down"]["qa"][0].stride() == (1, t_mix["layers"]["mlp"]["down"].shape[1])
        for dtype in ("float32", "bfloat16"):
            assert_trees_bitwise(
                t_lora.dequantize_base_weights(got, getattr(torch, dtype)),
                j_lora.dequantize_base_weights(want, jnp.dtype(dtype)),
            )


def test_quantize_per_model_config_matches_jax(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    action_q = lambda cfg, mod: mod.dataclass_replace(  # noqa: E731
        cfg, joint=mod.dataclass_replace(cfg.joint, mixtures=tuple(
            mod.dataclass_replace(m, use_quantize=(i == 2)) for i, m in enumerate(cfg.joint.mixtures)
        )),
    )
    from open_pi_zero_tpu import config as j_config

    jq = j_lora.quantize_per_model_config(jparams, action_q(jcfg, j_config))
    tq = t_lora.quantize_per_model_config(tparams, torch_cfg(action_q(jcfg, j_config)))
    assert_trees_bitwise(tq, jq)
    assert "q4" in tq["joint"]["mixtures"]["action"]["layers"]["mlp"]["down"]


# --------------------------------------------------------------------------- #
# linear per tier
# --------------------------------------------------------------------------- #


def _tier_kernel(tier: str, w: np.ndarray):
    if tier == "nf4":
        jk = j_quant.quantize_kernel_nf4(jnp.asarray(w))
    else:
        q, s = j_quant.quantize_int8_rowwise(jnp.asarray(w))
        jk = {"qa" if tier == "w8a8" else "q": q, "scale": s}
    return jk, jax_to_port(jk)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tier", ["w8a8", "int8", "nf4"])
def test_linear_tier_matches_jax(tier, dtype, bias):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 24, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 192)) / 16).astype(np.float32)
    b = (0.1 * rng.normal(size=192)).astype(np.float32) if bias else None
    jk, tk = _tier_kernel(tier, w)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    jb = None if b is None else jnp.asarray(b).astype(dtype)
    tb = None if b is None else torch.from_numpy(b).to(getattr(torch, dtype))
    got, want = t_lin.linear(tx, tk, tb), j_lin.linear(jx, jk, jb)
    assert got.dtype == tx.dtype
    if tier == "w8a8":
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    elif dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    else:
        assert_rounds_once(got, want)
    # proj and base_matmul take the same tiers
    np.testing.assert_array_equal(
        t_lin.proj({"w": tk}, "w", tx).float().numpy(), t_lin.linear(tx, tk).float().numpy()
    )


def test_int8_matmul_refuses_card_shapes_only_on_a_card():
    """On the CPU any shape runs (exact int32); the card's limits are checked
    on a card (tests/test_torch_serving_card.py)."""
    a = torch.randint(-127, 128, (3, 7), dtype=torch.int8)
    b = torch.randint(-127, 128, (7, 5), dtype=torch.int8)
    assert torch.equal(t_lin.int8_matmul(a, b), a.int() @ b.int())


# --------------------------------------------------------------------------- #
# fusion
# --------------------------------------------------------------------------- #


def test_fuse_for_serving_matches_jax(tiny):
    _, _, jparams, tparams = tiny
    got = t_fuse.fuse_for_serving(tparams)
    assert_trees_bitwise(got, j_fuse.fuse_for_serving(jparams))
    assert "q" in tparams["joint"]["mixtures"]["vlm"]["layers"]["attn"]  # input unchanged


def test_fused_infer_action_identical(tiny):
    _, tcfg, _, tparams = tiny
    ids, pix, am, prop, a0 = (torch.from_numpy(x) for x in example_inputs(tiny[0]))
    want = t_pizero.infer_action(tparams, tcfg, None, ids, pix, am, prop, action0=a0)
    got = t_pizero.infer_action(t_fuse.fuse_for_serving(tparams), tcfg, None, ids, pix, am, prop, action0=a0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_fusion_refuses_lora_and_quantized(tiny):
    _, _, _, tparams = tiny
    layers = tparams["joint"]["mixtures"]["vlm"]["layers"]
    q = layers["attn"]["q"]
    lora = {**layers, "attn": {**layers["attn"], "q_lora": {"a": q[..., :2], "b": q[:, :2]}}}
    with pytest.raises(ValueError, match="LoRA"):
        t_fuse.fuse_mixture_layers(lora)
    for tier in (dict(bits=8), dict(bits=4), dict(w8a8=True)):
        with pytest.raises(ValueError, match="quantized"):
            t_fuse.fuse_mixture_layers(t_lora.quantize_base_weights(layers, **tier))
    with pytest.raises(ValueError, match="quantized"):
        sig = tparams["siglip"]["layers"]
        t_fuse.fuse_siglip_layers({**sig, "attn": t_lora.quantize_base_weights(sig["attn"], keys=("kernel",))})


# --------------------------------------------------------------------------- #
# the slice: the serving layouts through infer_action
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def served(tiny):
    """{layout: (JAX's serving tree, the port's from the same float params)}."""
    _, _, jparams, tparams = tiny
    return {
        name: (j_fuse.prepare_for_serving(jparams, **kw), t_fuse.prepare_for_serving(tparams, **kw))
        for name, kw in LAYOUTS.items()
    }


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_prepare_for_serving_matches_jax(served, layout):
    jtree, ttree = served[layout]
    assert_trees_bitwise(ttree, jtree)
    mixtures = ttree["joint"]["mixtures"]
    assert "qa" in mixtures["vlm"]["layers"]["attn"]["qkv"]
    assert ("q4" if layout == "nf4_expert" else "q") in mixtures["action"]["layers"]["mlp"]["gateup"]
    sig = ttree["siglip"]["layers"]["attn"]["qkv"]["kernel"]
    assert isinstance(sig, dict) == (layout == "w8a8_siglip")
    assert torch.is_tensor(ttree["siglip"]["embeddings"]["patch"]["kernel"])


@pytest.mark.parametrize(
    "layout, seed", [("production", 0), ("production", 1), ("production", 2), ("nf4_expert", 0), ("w8a8_siglip", 0)]
)
def test_serving_infer_action_matches_jax(tiny, served, layout, seed):
    jcfg, tcfg, _, _ = tiny
    jtree, ttree = served[layout]
    ids, pix, am, prop, a0 = example_inputs(jcfg, seed=seed)
    want = j_pizero.infer_action(
        jtree, jcfg, jax.random.key(0), *(jnp.asarray(x) for x in (ids, pix, am, prop)), action0=jnp.asarray(a0)
    )
    got = t_pizero.infer_action(
        ttree, tcfg, None, *(torch.from_numpy(x) for x in (ids, pix, am, prop)), action0=torch.from_numpy(a0)
    )
    assert got.shape == (2, jcfg.horizon_steps, jcfg.action_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_hoist_4bit_matches_jax(served):
    jtree, ttree = served["nf4_expert"]
    got = t_pizero._hoist_4bit(ttree["joint"])
    assert_trees_bitwise(got, j_pizero._hoist_4bit(jtree["joint"]))
    assert not any("q4" in k for k in flat(got))


# --------------------------------------------------------------------------- #
# the streaming build and the knobs
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kw", [PRODUCTION, {}], ids=["production", "fused_bf16"])
def test_build_serving_params_bitwise_matches_two_step(kw):
    cfg = t_config.tiny_pizero_config()
    want = t_fuse.prepare_for_serving(t_pizero.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16), **kw)
    got = t_fuse.build_serving_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16, **kw)
    assert list(flat(got)) == list(flat(want))
    for path, leaf in flat(got).items():
        assert leaf.dtype == flat(want)[path].dtype and torch.equal(leaf, flat(want)[path]), path


@pytest.mark.parametrize(
    "knobs",
    [{}, {"w8a8_siglip": True}, {"w8a8": False, "w8a8_siglip": True}, {"quantize": False},
     {"quantize_bits": 4}, {"quantize_mixtures": ["action", "proprio"]}],
)
def test_serving_layout_kwargs_resolution(knobs):
    """JAX's knobs but ``code``, whose one legal value (NF4) the port's
    builders take as a constant."""
    want = {k: v for k, v in j_fuse.serving_layout_kwargs(knobs).items() if k != "code"}
    assert t_fuse.serving_layout_kwargs(knobs) == want
    if not knobs:
        assert t_fuse.serving_layout_kwargs(knobs) == PRODUCTION


def test_serving_layout_kwargs_refuses_other_codes():
    assert t_fuse.serving_layout_kwargs({"quantize_code": "nf4"}) == PRODUCTION
    with pytest.raises(ValueError, match="NF4 only"):
        t_fuse.serving_layout_kwargs({"quantize_code": "fp4"})


def test_params_from_jax_keeps_quantization_scales_fp32(served):
    jtree, _ = served["nf4_expert"]
    tree = params_from_jax(jax.tree.map(np.asarray, jtree), device="cpu", dtype=torch.bfloat16)
    mixtures = tree["joint"]["mixtures"]
    assert mixtures["vlm"]["layers"]["attn"]["qkv"]["scale"].dtype == torch.float32
    qa = mixtures["vlm"]["layers"]["attn"]["qkv"]["qa"]
    assert qa.dtype == torch.int8 and qa[0].stride() == (1, qa.shape[1])  # the port's W8A8 layout
    assert mixtures["action"]["layers"]["mlp"]["down"]["absmax"].dtype == torch.float32
    assert mixtures["action"]["layers"]["mlp"]["down"]["q4"].dtype == torch.uint8
    assert tree["siglip"]["layers"]["ln1"]["scale"].dtype == torch.bfloat16  # a LayerNorm scale
    assert tree["siglip"]["layers"]["attn"]["qkv"]["kernel"].dtype == torch.bfloat16


def _cpu_mesh() -> Mesh:
    return Mesh(1, 2, 0, 0, None, None, "gloo", torch.device("cpu"))


def test_shard_params_tp_refuses_fused_layout(tiny, served):
    _, tcfg, _, tparams = tiny
    for tree in (t_fuse.fuse_for_serving(tparams), served["production"][1]):
        with pytest.raises(ValueError, match="canonical layout"):
            shard_params_tp(tree, tcfg, _cpu_mesh())
    with pytest.raises(ValueError, match="canonical layout"):  # SigLIP's fused {kernel, bias}
        tp_param_specs({"siglip": t_fuse.fuse_for_serving(tparams)["siglip"]}, tcfg, 2)


def test_shard_params_tp_refuses_quantized_trees(tiny):
    """Unfused trees with quantized kernels: a payload under ``q`` is not
    taken for the query kernel."""
    _, tcfg, _, tparams = tiny
    joint = t_lora.quantize_base_weights(tparams["joint"])
    with pytest.raises(NotImplementedError, match="quantized"):
        shard_params_tp({**tparams, "joint": joint}, tcfg, _cpu_mesh())
    siglip = {**tparams["siglip"], "layers": t_lora.quantize_base_weights(
        tparams["siglip"]["layers"], keys=("kernel",), w8a8=True)}
    with pytest.raises(NotImplementedError, match="quantized"):
        tp_param_specs({"siglip": siglip}, tcfg, 2)
