"""K1's Lkv split over a thread block cluster, on the CPU: the kernel's
arithmetic in plain PyTorch (``fused_attention.mot_attention_split_ref``)
against the JAX package's Pallas kernel in interpret mode and against the
plain version, and the launch geometry the wrapper picks.

Tolerances: fp32 2e-5 (the same arithmetic, the sums split and taken in
another order); bf16 2e-2, as the JAX package's Pallas kernel tests (p and
the output are rounded to bf16, and a sum taken in another order can move
a rounding by one bf16 step). A fully masked row is the mean of V over the
real Lkv (1e-5 in fp32); the Pallas kernel pads Lkv to 128 and averages
over the padding too (``ROADMAP.md`` §3), so such rows are left out of the
comparison with it."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pi_zero_torch.ops import fused_attention as fa
from open_pi_zero_torch.ops.attention import mot_attention_ref
from open_pi_zero_torch.ops.masks import MASK_NEG
from open_pi_zero_tpu.ops.pallas_attention import mot_attention_fused as j_fused

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5), "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
B, LQ, HQ, HKV, D = 1, 4, 8, 1, 32
MASKED_ROW = 1  # query position whose every key is masked


@functools.lru_cache(maxsize=None)
def _case(dtype: str, lkv: int):
    """Inputs in ``dtype`` (numpy fp32 rounded through torch) with a random
    mask, one fully masked query row, and the Pallas kernel's output."""
    rng = np.random.default_rng(lkv)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((B, LQ, HQ, D), (B, lkv, HKV, D), (B, lkv, HKV, D)))
    mask = np.where(rng.random((B, 1, LQ, lkv)) > 0.3, 0.0, MASK_NEG).astype(np.float32)
    mask[..., 0] = 0.0
    mask[:, :, MASKED_ROW] = MASK_NEG
    t_dtype, j_dtype, _ = DTYPES[dtype]
    tq, tk, tv = (torch.from_numpy(x).to(t_dtype) for x in (q, k, v))
    want = j_fused(*(jnp.asarray(x.float().numpy(), j_dtype) for x in (tq, tk, tv)), jnp.asarray(mask), 50.0,
                   interpret=True)
    return tq, tk, tv, torch.from_numpy(mask), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("lkv", [9, 277, 281, 300])
@pytest.mark.parametrize("parts", [1, 3, 8])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_matches_pallas_and_plain(dtype, parts, lkv):
    q, k, v, mask, pallas = _case(dtype, lkv)
    tol = DTYPES[dtype][2]
    got = fa.mot_attention_split_ref(q, k, v, mask, 50.0, parts)
    assert got.dtype == q.dtype and got.shape == q.shape
    got = got.float()
    torch.testing.assert_close(got, mot_attention_ref(q, k, v, mask, 50.0).float(), rtol=tol, atol=tol)
    rows = [i for i in range(LQ) if i != MASKED_ROW]
    np.testing.assert_allclose(got[:, rows].numpy(), pallas[:, rows], rtol=tol, atol=tol)
    # the fully masked row: the uniform average over the real Lkv
    mean = v.float().mean(dim=1).expand(B, HQ, D)
    torch.testing.assert_close(got[:, MASKED_ROW], mean, rtol=max(tol, 1e-5), atol=max(tol, 1e-5))


def test_split_with_a_wholly_masked_slice():
    """One slice sees only masked keys: its exps are 0 and the others are
    normalised by the global sum, as in one piece."""
    q, k, v, mask, _ = _case("float32", 281)
    mask = mask.clone()
    mask[..., 36:72] = MASK_NEG  # the second of 8 slices of 36 keys
    got = fa.mot_attention_split_ref(q, k, v, mask, 50.0, 8)
    torch.testing.assert_close(got, mot_attention_ref(q, k, v, mask, 50.0), rtol=2e-5, atol=2e-5)


# (B, Lq, Lkv, Hq, Hkv, D) of every path that launches K1, at B = 1 where
# the batch is the caller's choice
MAIN_PATH_SHAPES = {
    "prefill": (1, 277, 277, 8, 1, 256),
    "euler": (1, 4, 281, 8, 1, 256),
    "decode": (1, 1, 277, 8, 1, 256),
    "shard_prefill": (1, 277, 277, 4, 1, 256),
    "shard_euler": (1, 4, 281, 4, 1, 256),
    "train": (16, 281, 281, 8, 1, 256),
    "shard_train": (16, 281, 281, 4, 1, 256),
}
# (SMs, shared memory per SM, threads per SM), as ``fa.card_limits`` reads
# them: the H100 SXM and the H100 PCIe
CARDS = {"h100_sxm": (132, 233472, 2048), "h100_pcie": (114, 233472, 2048)}


@pytest.mark.parametrize("card", sorted(CARDS))
@pytest.mark.parametrize("element_size", [2, 4])
@pytest.mark.parametrize("name", sorted(MAIN_PATH_SHAPES))
def test_launch_geometry_fills_16_sms_within_shared_memory(name, element_size, card):
    b, lq, lkv, hq, hkv, d = shape = MAIN_PATH_SHAPES[name]
    limits = CARDS[card]
    rows, split = fa.launch_geometry(*shape, element_size, limits)
    assert rows in (16, 64) and split in (1, 2, 4, 8, 16) and rows % split == 0
    blocks = b * hkv * -(-(hq // hkv) * lq // rows) * split
    assert blocks >= 16
    smem = fa.smem_bytes(element_size, d, rows, -(-lkv // split))
    assert smem <= fa.MAX_SMEM_BYTES
    if split > 1:  # a split is taken only where the grid stays one wave
        assert blocks <= limits[0] * fa.blocks_per_sm(smem, rows, element_size, limits)
    if name in ("euler", "shard_euler", "decode"):
        assert split == 16  # the latency-bound shapes take the largest cluster


def test_max_lkv_holds_the_old_limit_and_fits():
    assert fa.max_lkv(256) >= 2336
    for d in fa.HEAD_DIMS:
        lkv = fa.max_lkv(d)
        for size in (2, 4):
            for b, lq in ((1, 1), (1, 4), (1, 277), (16, 281)):
                rows, split = fa.launch_geometry(b, lq, lkv, 8, 1, d, size, CARDS["h100_sxm"])
                assert fa.smem_bytes(size, d, rows, -(-lkv // split)) <= fa.MAX_SMEM_BYTES
