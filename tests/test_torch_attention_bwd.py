"""K1-vjp's backward kernels on the CPU: their arithmetic in plain PyTorch
(``fused_attention.mot_attention_bwd_ref``) against ``jax.vjp`` through
the JAX package's Pallas kernel in interpret mode and through
``mot_attention_xla``, and against plain autograd through the port's
``mot_attention_ref``; and the kernels' shared-memory plan and launch
geometry, which the wrapper computes in Python.

Inputs come from numpy with a seed and are rounded through torch to the
working dtype, so that every side sees the same values. Tolerances: fp32
2e-5 (the same arithmetic, sums in another order); bf16 2e-2, as the JAX
package's Pallas kernel tests (p and dP are rounded to bf16 at the same
points on every side, but a sum taken in another order can move a rounding
by one bf16 step). A fully masked row is held against plain autograd only:
the Pallas kernel averages its padded columns too (``ROADMAP.md`` §3)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pi_zero_torch.ops import fused_attention as fa
from open_pi_zero_torch.ops.attention import mot_attention_ref
from open_pi_zero_torch.ops.masks import MASK_NEG
from open_pi_zero_tpu.ops.attention import mot_attention_xla
from open_pi_zero_tpu.ops.pallas_attention import mot_attention_fused as j_fused

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5), "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
B, LQ, D = 2, 5, 32
MASKED_ROW = 2  # query position of batch row 0 whose every key is masked


@functools.lru_cache(maxsize=None)
def _case(dtype: str, group: int, hkv: int, lkv: int, softcap, fully_masked: bool = False):
    """q, k, v, mask, g in ``dtype`` (torch) and the backward's grads as
    float32 numpy arrays from the reference, plain autograd, and, unless a
    row is fully masked, JAX's VJPs through the Pallas kernel and XLA."""
    rng = np.random.default_rng(1000 * group + 10 * hkv + lkv)
    hq = group * hkv
    q, k, v, g = (
        rng.normal(size=s).astype(np.float32)
        for s in ((B, LQ, hq, D), (B, lkv, hkv, D), (B, lkv, hkv, D), (B, LQ, hq, D))
    )
    mask = np.where(rng.random((B, 1, LQ, lkv)) > 0.3, 0.0, MASK_NEG).astype(np.float32)
    mask[..., 0] = 0.0
    if fully_masked:
        mask[0, :, MASKED_ROW] = MASK_NEG
    t_dtype, j_dtype, _ = DTYPES[dtype]
    tq, tk, tv, tg = (torch.from_numpy(x).to(t_dtype) for x in (q, k, v, g))
    tmask = torch.from_numpy(mask)
    grads = {"reference": fa.mot_attention_bwd_ref(tq, tk, tv, tmask, softcap, tg)}
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    grads["autograd"] = torch.autograd.grad(mot_attention_ref(*leaves, tmask, softcap), leaves, tg)
    if not fully_masked:
        jq, jk, jv, jg = (jnp.asarray(x.float().numpy(), j_dtype) for x in (tq, tk, tv, tg))
        functions = {
            "pallas": lambda a, b, c, m: j_fused(a, b, c, m, softcap, True),
            "xla": lambda a, b, c, m: mot_attention_xla(a, b, c, m, softcap),
        }
        for name, fn in functions.items():
            grads[name] = _jax_vjp(fn)(jq, jk, jv, jnp.asarray(mask), jg)
    return {name: [np.asarray(jnp.asarray(x, jnp.float32)) if not torch.is_tensor(x) else x.float().numpy()
                   for x in gs] for name, gs in grads.items()}, (tq, tk, tv, tmask, tg)


def _jax_vjp(fn):
    """dq, dk, dv of ``fn`` for a cotangent, jitted (one compile costs less
    than the eager ops' first calls)."""
    def vjp(q, k, v, mask, g):
        return jax.vjp(lambda a, b, c: fn(a, b, c, mask), q, k, v)[1](g)
    return jax.jit(vjp)


def _assert_grads_close(got, want, tol, label):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=f"{label} {name}")


# (G, Hkv, Lkv, softcap): each group size (1, 4, 8), kv head count (1, 2)
# and length (one key tile, the training length, past it), and no softcap
CASES = [(8, 1, 281, 50.0), (1, 2, 281, 50.0), (4, 2, 300, 50.0), (8, 1, 9, 50.0), (4, 1, 281, None)]


@pytest.mark.parametrize("against", ["pallas", "xla", "autograd"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("group,hkv,lkv,softcap", CASES)
def test_bwd_reference_matches_jax_and_autograd(group, hkv, lkv, softcap, dtype, against):
    grads, inputs = _case(dtype, group, hkv, lkv, softcap)
    tol = DTYPES[dtype][2]
    assert all(x.shape == y.shape for x, y in zip(grads["reference"], inputs[:3]))
    _assert_grads_close(grads["reference"], grads[against], tol, f"vs {against}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("group,hkv", [(8, 1), (4, 2)])
def test_bwd_reference_with_a_fully_masked_row(group, hkv, dtype):
    """The row's p is uniform and its dS still flows through (1 - t^2):
    the same grads as plain autograd, not zeros."""
    grads, (q, k, v, mask, g) = _case(dtype, group, hkv, 281, 50.0, fully_masked=True)
    tol = DTYPES[dtype][2]
    _assert_grads_close(grads["reference"], grads["autograd"], tol, "vs autograd")
    # the masked row has a non-zero dq of its own
    assert np.abs(grads["reference"][0][0, MASKED_ROW]).max() > 1e-3


def test_bwd_reference_rounds_at_the_forward_cast_points():
    """In bf16, dv comes from p rounded to bf16 and dq from fp32 dS: both
    differ from the fp32 backward on the same (bf16-exact) inputs by about
    a bf16 step, not more."""
    grads16, (q, k, v, mask, g) = _case("bfloat16", 8, 1, 281, 50.0)
    got32 = fa.mot_attention_bwd_ref(q.float(), k.float(), v.float(), mask, 50.0, g.float())
    for a, b in zip(grads16["reference"], got32):
        np.testing.assert_allclose(a, b.numpy(), rtol=2e-2, atol=2e-2)
    assert all(x.dtype == torch.bfloat16 for x in fa.mot_attention_bwd_ref(q, k, v, mask, 50.0, g))


# (B, Lq, Lkv, Hq, Hkv, D) of every path that runs the backward: the
# training shape and K1-shard's at TP = 2
TRAIN_SHAPES = {"train": (16, 281, 281, 8, 1, 256), "shard_train": (16, 281, 281, 4, 1, 256)}
SMS = {"h100_sxm": 132, "h100_pcie": 114}


@pytest.mark.parametrize("name", sorted(TRAIN_SHAPES))
def test_bwd_geometry_covers_the_card_within_shared_memory(name):
    b, lq, lkv, hq, hkv, d = shape = TRAIN_SHAPES[name]
    row_blocks, d_tile, key_blocks = fa.bwd_launch_geometry(*shape)
    assert row_blocks == b * hkv * -(-(hq // hkv) * lq // fa.BWD_ROWS)
    assert d_tile == 64 and key_blocks == b * hkv * -(-lkv // fa.KEYS_PER_TILE) * (d // d_tile) * 2
    assert min(row_blocks, key_blocks) >= max(SMS.values())  # every SM of either card has a block
    for size in (2, 4):
        assert max(fa.bwd_smem_bytes(size, d, lkv, d_tile)) <= fa.MAX_SMEM_BYTES


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_bwd_lkv_limit_fits_and_holds_the_training_length(d):
    limit = fa.bwd_max_lkv(d)
    d_tile = fa.bwd_launch_geometry(1, 4, limit, 8, 1, d)[1]
    assert limit >= 281 and limit % fa.KEYS_PER_TILE == 0 and d_tile == min(64, d)
    for size in (2, 4):
        assert max(fa.bwd_smem_bytes(size, d, limit, d_tile)) <= fa.MAX_SMEM_BYTES
    # the next key tile would not fit an fp32 row block
    assert fa.bwd_smem_bytes(4, d, limit + 1, d_tile)[0] > fa.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="backward kernel's limit"):
        fa.bwd_launch_geometry(1, 4, limit + 1, 8, 1, d)


@pytest.mark.parametrize("d", [8, 24])
def test_bwd_reference_on_zero_padded_inputs_is_exact(d):
    """The arithmetic of the card's backward at a head dim between the
    kernels' (the fixtures' 8, SimplerLite's 24): q, k, v and the cotangent
    zero-padded up to the next head dim, scaled by the true head dim's
    sqrt, give the unpadded grads in their first columns and zeros past
    them. Zero columns add exact zeros, so only the sums' blocking can move
    a last bit: 1e-6."""
    b, lq, lkv, hq, hkv = 2, 7, 9, 4, 1
    run_d = {8: 16, 24: 32}[d]
    rng = np.random.default_rng(d)
    q, k, v, g = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((b, lq, hq, d), (b, lkv, hkv, d), (b, lkv, hkv, d), (b, lq, hq, d)))
    mask = torch.from_numpy(np.where(rng.random((b, 1, lq, lkv)) > 0.3, 0.0, MASK_NEG).astype(np.float32))
    mask[..., 0] = 0.0
    want = fa.mot_attention_bwd_ref(q, k, v, mask, 50.0, g)
    padded, true_d = fa._pad_head_dim(q, k, v, g)
    assert true_d == d and all(x.shape[-1] == run_d for x in padded)
    got = fa.mot_attention_bwd_ref(*padded[:3], mask, 50.0, padded[3], scale=1.0 / d**0.5)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a[..., :d], w, rtol=0, atol=1e-6, msg=lambda m, n=name: f"{n}: {m}")
        assert torch.equal(a[..., d:], torch.zeros_like(a[..., d:])), name
