"""The port's ops (open_pi_zero_torch/ops) against the JAX package's, on the
CPU: the same numpy inputs through both, compared at a stated tolerance.

fp32 ops agree to 1e-5 (both sides compute in fp32; only the order of the
sums and libm's last bits differ). Masks and position ids agree exactly.
The plain MoT attention is held against the XLA einsum path and against
the Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pi_zero_torch.ops import attention as t_att
from open_pi_zero_torch.ops import embeddings as t_emb
from open_pi_zero_torch.ops import fused_attention as t_fused
from open_pi_zero_torch.ops import linear as t_lin
from open_pi_zero_torch.ops import masks as t_masks
from open_pi_zero_torch.ops import norms as t_norms
from open_pi_zero_torch.ops import rope as t_rope
from open_pi_zero_tpu.ops import attention as j_att
from open_pi_zero_tpu.ops import embeddings as j_emb
from open_pi_zero_tpu.ops import linear as j_lin
from open_pi_zero_tpu.ops import lora as j_lora
from open_pi_zero_tpu.ops import masks as j_masks
from open_pi_zero_tpu.ops import norms as j_norms
from open_pi_zero_tpu.ops import rope as j_rope
from open_pi_zero_tpu.ops.pallas_attention import mot_attention_fused as j_fused

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------------- #
# masks and positions: exact
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_causal_mask_and_split_exact(dtype):
    cnt = np.array([5, 12, 0, 9], np.int32)
    args = (12, 1, 4)
    jm = j_masks.build_block_causal_mask(jnp.asarray(cnt), *args, dtype=getattr(jnp, dtype))
    tm = t_masks.build_block_causal_mask(_t(cnt), *args, dtype=getattr(torch, dtype))
    np.testing.assert_array_equal(_np(tm), _np(jm))
    for jp, tp in zip(
        j_masks.split_prefix_and_action_masks(jm, *args),
        t_masks.split_prefix_and_action_masks(tm, *args),
    ):
        np.testing.assert_array_equal(_np(tp), _np(jp))
    assert t_masks.MASK_NEG == j_masks.MASK_NEG


def test_position_ids_exact():
    np.testing.assert_array_equal(
        t_masks.vlm_position_ids(276).numpy(), np.asarray(j_masks.vlm_position_ids(276))
    )
    np.testing.assert_array_equal(
        t_masks.proprio_position_ids(1).numpy(), np.asarray(j_masks.proprio_position_ids(1))
    )
    np.testing.assert_array_equal(
        t_masks.action_position_ids(1, 4).numpy(),
        np.asarray(j_masks.action_position_ids(1, 4)),
    )


# --------------------------------------------------------------------------- #
# elementwise / small ops: fp32 at 1e-5
# --------------------------------------------------------------------------- #


def _case_rope(rng):
    pos = np.arange(1, 10, dtype=np.int32)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    jc, js = j_rope.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    tc, ts = t_rope.rope_cos_sin(_t(pos), 16, 10000.0)
    np.testing.assert_allclose(_np(tc), _np(jc), **TOL)
    np.testing.assert_allclose(_np(ts), _np(js), **TOL)
    return j_rope.apply_rope(jnp.asarray(x), jc, js), t_rope.apply_rope(_t(x), tc, ts)


def _case_rms_norm(rng):
    x = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3
    w = rng.normal(size=(32,)).astype(np.float32)
    return j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w)), t_norms.rms_norm(_t(x), _t(w))


def _case_layer_norm(rng):
    x = rng.normal(size=(2, 5, 24)).astype(np.float32) * 2 + 1
    s = rng.normal(size=(24,)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    return (
        j_norms.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)),
        t_norms.layer_norm(_t(x), _t(s), _t(b)),
    )


def _case_time_embedding(rng):
    t = rng.uniform(size=(3,)).astype(np.float32)
    return (
        j_emb.sinusoidal_time_embedding(jnp.asarray(t), 64, 100.0),
        t_emb.sinusoidal_time_embedding(_t(t), 64, 100.0),
    )


def _case_linear(rng):
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    w = rng.normal(size=(24, 40)).astype(np.float32) * 0.2
    b = rng.normal(size=(40,)).astype(np.float32)
    return (
        j_lin.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)),
        t_lin.linear(_t(x), _t(w), _t(b)),
    )


def _case_lora_proj(rng):
    x = rng.normal(size=(2, 5, 24)).astype(np.float32)
    lp = {
        "q": rng.normal(size=(24, 40)).astype(np.float32) * 0.2,
        "q_lora": {
            "a": rng.normal(size=(24, 4)).astype(np.float32) * 0.2,
            "b": rng.normal(size=(4, 40)).astype(np.float32) * 0.2,
        },
    }
    jlp = jax.tree.map(jnp.asarray, lp)
    tlp = {"q": _t(lp["q"]), "q_lora": {k: _t(v) for k, v in lp["q_lora"].items()}}
    return j_lora.proj(jlp, "q", jnp.asarray(x), 0.5), t_lin.proj(tlp, "q", _t(x), 0.5)


OP_CASES = {
    "rope": _case_rope,
    "rms_norm": _case_rms_norm,
    "layer_norm": _case_layer_norm,
    "time_embedding": _case_time_embedding,
    "linear": _case_linear,
    "lora_proj": _case_lora_proj,
}


@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_op_matches_jax_fp32(name):
    want, got = OP_CASES[name](np.random.default_rng(0))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_linear_refuses_quantized_kernel():
    """The quantized tiers are ported (tests/test_torch_serving_layout.py);
    a dict of another format raises, as JAX's ``linear`` does."""
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="unsupported quantized kernel"):
        t_lin.linear(x, {"q8": torch.zeros(4, 4, dtype=torch.int8), "scale": torch.ones(4)})


# --------------------------------------------------------------------------- #
# MoT attention: plain version vs XLA path and vs the Pallas kernel
# --------------------------------------------------------------------------- #


def _attn_inputs(rng, b, lq, lkv, hq, hkv, d, mask_p=0.3):
    q = rng.normal(size=(b, lq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, lkv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, lkv, hkv, d)).astype(np.float32)
    mask = np.where(rng.random((b, 1, lq, lkv)) > mask_p, 0.0, j_masks.MASK_NEG).astype(
        np.float32
    )
    mask[..., 0] = 0.0
    return q, k, v, mask


# the Pallas kernel tests' geometries (tests/test_pallas_attention.py)
GEOMETRIES = [
    (2, 281, 281, 8, 1, 32),
    (1, 4, 281, 8, 1, 32),
    (1, 1, 300, 8, 2, 32),
    (2, 7, 9, 4, 4, 16),
]


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_mot_attention_ref_matches_xla_and_pallas_fp32(geom):
    q, k, v, mask = _attn_inputs(np.random.default_rng(sum(geom)), *geom)
    got = t_att.mot_attention_ref(_t(q), _t(k), _t(v), _t(mask), 50.0)
    jargs = [jnp.asarray(x) for x in (q, k, v, mask)]
    np.testing.assert_allclose(
        _np(got), _np(j_att.mot_attention_xla(*jargs, 50.0)), rtol=2e-5, atol=2e-5
    )
    np.testing.assert_allclose(
        _np(got), _np(j_fused(*jargs, 50.0, interpret=True)), rtol=2e-5, atol=2e-5
    )


def test_mot_attention_ref_matches_xla_bf16():
    q, k, v, mask = _attn_inputs(np.random.default_rng(7), 1, 37, 53, 8, 1, 64)
    q, k, v = (x.astype(jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (_t(x.astype(np.float32)).to(torch.bfloat16) for x in (q, k, v))
    got = t_att.mot_attention_ref(tq, tk, tv, _t(mask), 50.0)
    assert got.dtype == torch.bfloat16
    want = j_att.mot_attention_xla(*(jnp.asarray(x) for x in (q, k, v, mask)), 50.0)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def test_mot_attention_ref_no_softcap():
    q, k, v, mask = _attn_inputs(np.random.default_rng(11), 1, 12, 20, 4, 1, 16)
    got = t_att.mot_attention_ref(_t(q), _t(k), _t(v), _t(mask), None)
    want = j_att.mot_attention_xla(*(jnp.asarray(x) for x in (q, k, v, mask)), None)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_mot_attention_ref_fully_masked_rows_finite():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(1, 9, 1, 16)).astype(np.float32)
    q = torch.ones(1, 5, 8, 16)
    mask = torch.full((1, 1, 5, 9), t_masks.MASK_NEG)
    out = t_att.mot_attention_ref(q, torch.ones(1, 9, 1, 16), _t(v), mask, 50.0)
    assert torch.isfinite(out).all()
    # a fully masked row is the uniform average of the V rows, as in JAX
    np.testing.assert_allclose(
        _np(out), np.broadcast_to(v.mean(axis=1, keepdims=True), (1, 5, 8, 16)), atol=1e-6
    )


def test_mha_attention_matches_jax():
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, 9, 4, 8)).astype(np.float32) for _ in range(3))
    got = t_att.mha_attention(_t(q), _t(k), _t(v))
    want = j_att.mha_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_cpu_dispatch_takes_plain_version_and_counts_no_launch():
    q, k, v, mask = (_t(x) for x in _attn_inputs(np.random.default_rng(2), 1, 4, 21, 8, 1, 32))
    before = t_fused.launches
    want = t_att.mot_attention_ref(q, k, v, mask)
    torch.testing.assert_close(t_att.mot_attention(q, k, v, mask), want, rtol=0, atol=0)
    # the kernel's wrapper takes CUDA tensors only: it raises, never falls back
    with pytest.raises(ValueError, match="CUDA"):
        t_fused.mot_attention_fused(q, k, v, mask)
    assert t_fused.launches == before
