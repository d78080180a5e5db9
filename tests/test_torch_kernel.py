"""The Hopper MoT-attention kernel and its autograd Function (K1-vjp)
against the plain version, on the card.

Marked ``cuda``: each test asks the ``cuda`` fixture for the device and
skips when there is no card (the CPU run never reaches the kernel; the
CPU-side dispatch is tested in tests/test_torch_ops.py). Run on a machine
with a card: ``python -m pytest tests/test_torch_kernel.py -q``.

Tolerances: fp32 1e-4 (same arithmetic, another summation order); bf16
2e-2, as the JAX package's Pallas kernel tests (each side rounds p and the
output to bf16 at its own point). The Function's backward launches the two
backward kernels (``csrc/mot_attention_bwd.cu``), held here against their
arithmetic in plain PyTorch (``mot_attention_bwd_ref``) and against plain
autograd through the plain version, at the same tolerances."""

import numpy as np
import pytest
import torch

from open_pi_zero_torch import config as cfg_lib
from open_pi_zero_torch.models import pizero
from open_pi_zero_torch.ops import fused_attention as fa
from open_pi_zero_torch.ops.attention import mot_attention, mot_attention_ref
from open_pi_zero_torch.ops.masks import MASK_NEG

pytestmark = pytest.mark.cuda

GEOMETRIES = [
    # (B, Lq, Lkv, Hq, Hkv, D)
    (1, 277, 277, 8, 1, 256),  # prefill
    (1, 4, 281, 8, 1, 256),  # Euler step
    (1, 1, 277, 8, 1, 256),  # text decode
    (2, 281, 281, 8, 1, 32),
    (1, 1, 300, 8, 2, 32),
    (2, 7, 9, 4, 4, 16),
    (2, 7, 9, 4, 1, 8),  # the reference fixtures' head dim: zero-padded to 16 by the wrapper
    (1, 4, 25, 4, 1, 24),  # SimplerLite's (configs/eval/simpler_lite.yaml): zero-padded to 32
    (16, 281, 281, 8, 1, 256),  # training: 576 blocks of 64 rows, no split
    (1, 4, 281, 4, 1, 256),  # K1-shard's Euler step: one cell over 16 blocks
    (1, 4, fa.max_lkv(256), 8, 1, 256),  # the longest K/V the kernel takes
    (4, 64, fa.max_lkv(256), 8, 1, 256),  # the same with the largest blocks
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(device, b, lq, lkv, hq, hkv, d, dtype, seed=0, mask_p=0.3):
    rng = np.random.default_rng(seed)
    q, k, v = (
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device, dtype)
        for s in ((b, lq, hq, d), (b, lkv, hkv, d), (b, lkv, hkv, d))
    )
    mask = np.where(rng.random((b, 1, lq, lkv)) > mask_p, 0.0, MASK_NEG).astype(np.float32)
    mask[..., 0] = 0.0
    return q, k, v, torch.from_numpy(mask).to(device)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("geom", GEOMETRIES)
def test_kernel_matches_plain(cuda, geom, dtype, tol):
    q, k, v, mask = _inputs(cuda, *geom, dtype)
    before = fa.launches
    got = fa.mot_attention_fused(q, k, v, mask, 50.0)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got, mot_attention_ref(q, k, v, mask, 50.0), rtol=tol, atol=tol)


SHARD_GEOMETRIES = [
    # one rank's shard at TP = 2: 4 of the 8 query heads, the one K/V head
    (1, 277, 277, 4, 1, 256),  # prefill: 70 blocks of 16 folded rows
    (1, 4, 281, 4, 1, 256),  # Euler step: 1 block
    (2, 4, 281, 4, 1, 256),
    (16, 281, 281, 4, 1, 256),  # training
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("geom", SHARD_GEOMETRIES)
def test_kernel_matches_plain_at_the_shard_shapes(cuda, geom, dtype, tol):
    q, k, v, mask = _inputs(cuda, *geom, dtype, seed=3)
    got = fa.mot_attention_fused(q, k, v, mask, 50.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, mot_attention_ref(q, k, v, mask, 50.0), rtol=tol, atol=tol)


def test_k1_shard_in_two_ranks_matches_plain(cuda):
    """K1-shard in a (data=1, model=2) world of spawned ranks sharing the
    card: each rank's out, dq and its all-reduced dk, dv against the plain
    version on the whole inputs."""
    from open_pi_zero_torch.parallel import ranks, run_ranks

    q, k, v, mask = (x.cpu().numpy() for x in _inputs("cpu", 2, 37, 41, 8, 1, 256, torch.float32, seed=4))
    g = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    case = dict(name="mqa", q=q, k=k, v=v, mask=mask, g=g, softcap=50.0, dtype="float32", tol=1e-4)
    (row,) = run_ranks(ranks.attention_rank, 1, 2, [case], device="cuda", timeout_s=300)
    for part in ("out", "dq", "dk", "dv"):
        assert row[f"not_close_{part}"] == 0, (part, row[f"max_abs_err_{part}"])


def test_k1_shard_vjp_at_the_training_shape_in_two_ranks(cuda):
    """K1-shard's VJP at the fp32 training shape with replicated K/V (one
    KV head) in a (data=1, model=2) world sharing the card: each rank's out
    and dq (its 4 query heads) and dk, dv after the sum over the model
    ranks against plain autograd on the whole inputs; each rank launches
    both backward kernels once."""
    from open_pi_zero_torch.parallel import ranks, run_ranks

    q, k, v, mask, g = (x.cpu().numpy() for x in _training_inputs("cpu", torch.float32))
    case = dict(name="train", q=q, k=k, v=v, mask=mask, g=g, softcap=50.0, dtype="float32", tol=1e-4)
    (row,) = run_ranks(ranks.attention_rank, 1, 2, [case], device="cuda", timeout_s=300)
    assert row["bwd_launches"] == 2
    for part in ("out", "dq", "dk", "dv"):
        assert row[f"not_close_{part}"] == 0, (part, row[f"max_abs_err_{part}"])


def test_kernel_no_softcap_and_fully_masked_rows(cuda):
    q, k, v, mask = _inputs(cuda, 1, 4, 281, 8, 1, 256, torch.float32)
    torch.testing.assert_close(
        fa.mot_attention_fused(q, k, v, mask, None),
        mot_attention_ref(q, k, v, mask, None), rtol=1e-4, atol=1e-4,
    )
    full = torch.full_like(mask, MASK_NEG)
    out = fa.mot_attention_fused(q, k, v, full, 50.0)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, v.mean(dim=1, keepdim=True).expand_as(out), rtol=1e-5, atol=1e-5)


def test_kernel_takes_strided_mask_views(cuda):
    q, k, v, mask = _inputs(cuda, 2, 4, 281, 8, 1, 256, torch.bfloat16)
    big = torch.zeros(2, 1, 290, 290, device=cuda)
    big[..., -4:, :281] = mask
    view = big[..., -4:, :281]
    torch.testing.assert_close(
        fa.mot_attention_fused(q, k, v, view), mot_attention_ref(q, k, v, mask), rtol=2e-2, atol=2e-2
    )


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, mask = _inputs(cuda, 1, 4, 33, 8, 1, 256, torch.float32)
    with pytest.raises(ValueError, match="grad"):
        fa.mot_attention_fused(q, k, v, mask.requires_grad_())
    mask = mask.detach()
    with pytest.raises(ValueError, match="float32"):
        fa.mot_attention_fused(q, k, v, mask.half())
    with pytest.raises(ValueError, match="contiguous"):
        fa.mot_attention_fused(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, mask)
    # above the largest head dim (between two, the wrapper zero-pads up)
    wide_q, wide_kv = torch.zeros(1, 4, 8, 320, device=cuda), torch.zeros(1, 33, 1, 320, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.mot_attention_fused(wide_q, wide_kv, wide_kv, mask)
    long_kv = torch.zeros(1, fa.max_lkv(256) + 4, 1, 256, device=cuda)
    with pytest.raises(ValueError, match="limit"):
        fa.mot_attention_fused(q, long_kv, long_kv, torch.zeros(1, 1, 4, long_kv.shape[1], device=cuda))


@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_kernel_refuses_misaligned_inputs(cuda, name):
    """A contiguous view that starts 4 bytes into its storage: the kernel's
    16-byte copies would fault, so the wrapper raises first."""
    inputs = dict(zip("qkv", _inputs(cuda, 1, 4, 33, 8, 1, 256, torch.float32)))
    x = inputs[name]
    inputs[name] = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape).copy_(x)
    assert inputs[name].is_contiguous()
    with pytest.raises(ValueError, match="aligned"):
        fa.mot_attention_fused(inputs["q"], inputs["k"], inputs["v"], torch.zeros(1, 1, 4, 33, device=cuda))


def _training_inputs(device, dtype, fully_masked_row=False):
    """The training path's attention at full width: B=16, Lq=Lkv=281, 8 Q /
    1 KV heads of 256, the block-causal training mask."""
    cfg = cfg_lib.PiZeroConfig()
    am = torch.zeros(16, cfg.max_image_text_tokens, dtype=torch.int32, device=device)
    for i in range(16):
        am[i, : 257 + i] = 1
    full, _, _, _ = pizero.prepare_action_inputs(cfg, am)
    if fully_masked_row:
        full = full.clone()
        full[0, 0, 3] = MASK_NEG
    q, k, v, _ = _inputs(device, 16, 281, 281, 8, 1, 256, dtype, seed=5)
    g = torch.randn(q.shape, generator=torch.Generator(device).manual_seed(6), device=device).to(dtype)
    return q, k, v, full, g


def _out_and_grads(attention, q, k, v, mask, g):
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = attention(q, k, v, mask, 50.0)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), g))


@pytest.mark.parametrize("fully_masked_row", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_vjp_matches_plain_autograd_at_training_shape(cuda, dtype, tol, fully_masked_row):
    q, k, v, mask, g = _training_inputs(cuda, dtype, fully_masked_row)
    before, bwd_before = fa.launches, fa.bwd_launches
    got = _out_and_grads(mot_attention, q, k, v, mask, g)
    torch.cuda.synchronize()
    assert fa.launches == before + 1  # K1's forward
    assert fa.bwd_launches == bwd_before + 2  # the row and key sides of the backward
    want = _out_and_grads(mot_attention_ref, q, k, v, mask, g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_kernel_with_one_cluster_block_wholly_masked(cuda, dtype, tol):
    """The Euler shape splits Lkv over a cluster: mask the whole slice of
    the cluster's second block. Its p is 0 and the others' sum stays
    exact."""
    geom = (1, 4, 281, 8, 1, 256)
    q, k, v, mask = _inputs(cuda, *geom, dtype, seed=7)
    _, split = fa.launch_geometry(*geom, q.element_size(), fa.card_limits(q.device))
    size = -(-281 // split)
    assert split > 1
    mask[..., size : 2 * size] = MASK_NEG
    got = fa.mot_attention_fused(q, k, v, mask, 50.0)
    torch.testing.assert_close(got, mot_attention_ref(q, k, v, mask, 50.0), rtol=tol, atol=tol)
    torch.testing.assert_close(got, fa.mot_attention_split_ref(q.cpu(), k.cpu(), v.cpu(), mask.cpu(), 50.0, split).to(cuda),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("geom", [(1, 4, 281, 8, 1, 256), (1, 277, 277, 8, 1, 256), (16, 281, 281, 8, 1, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_bitwise_deterministic(cuda, geom, dtype):
    """The cluster sums in rank order, no atomics: two calls agree bitwise."""
    q, k, v, mask = _inputs(cuda, *geom, dtype, seed=8)
    first = fa.mot_attention_fused(q, k, v, mask, 50.0)
    second = fa.mot_attention_fused(q, k, v, mask, 50.0)
    assert torch.equal(first, second)


def test_smem_mirror_matches_the_source(cuda):
    """``fused_attention.smem_bytes``, which picks the launch geometry,
    gives the source's shared-memory plan."""
    lib = fa._library()
    for size in (2, 4):
        for d in fa.HEAD_DIMS:
            for rows in (16, 64):
                for slice_len in (1, 18, 70, 281, 352):
                    assert lib.opz_mot_attention_smem_bytes(size, d, rows, slice_len) == fa.smem_bytes(
                        size, d, rows, slice_len), (size, d, rows, slice_len)


# (B, Lq, Lkv, Hq, Hkv, D) of the backward kernels
BWD_GEOMETRIES = [
    (16, 281, 281, 8, 1, 256),  # training
    (16, 281, 281, 4, 1, 256),  # K1-shard's training shard at TP = 2
    (2, 9, 9, 8, 1, 256),  # one key tile, part of it past Lkv
    (2, 300, 300, 8, 1, 256),  # 10 key tiles, the last one 12 keys
    (1, 37, fa.bwd_max_lkv(256), 8, 2, 256),  # the longest K/V the backward takes
    (2, 7, 45, 4, 4, 16),  # G = 1, the smallest head dim
    (2, 7, 9, 4, 1, 8),  # the reference fixtures' head dim: zero-padded to 16 by the wrapper
    (1, 4, 25, 4, 1, 24),  # SimplerLite's: zero-padded to 32
]


def _bwd_inputs(device, geom, dtype, fully_masked_row=False, seed=10):
    q, k, v, mask = _inputs(device, *geom, dtype, seed=seed)
    if fully_masked_row:
        mask[0, 0, 3 % geom[1]] = MASK_NEG
    g = torch.randn(q.shape, generator=torch.Generator(device).manual_seed(seed + 1), device=device).to(dtype)
    return q, k, v, mask, g


@pytest.mark.parametrize("fully_masked_row", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("geom", BWD_GEOMETRIES)
def test_bwd_kernels_match_their_reference_and_plain_autograd(cuda, geom, dtype, tol, fully_masked_row):
    q, k, v, mask, g = _bwd_inputs(cuda, geom, dtype, fully_masked_row)
    before = fa.bwd_launches
    got = fa._launch_bwd(q, k, v, mask, 50.0, g)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 2
    ref = fa.mot_attention_bwd_ref(q, k, v, mask, 50.0, g)
    plain = _out_and_grads(mot_attention_ref, q, k, v, mask, g)[1:]
    for name, a, r, p in zip(("dq", "dk", "dv"), got, ref, plain):
        assert a.dtype == dtype and a.shape == r.shape and torch.isfinite(a).all(), name
        torch.testing.assert_close(a, r, rtol=tol, atol=tol, msg=lambda m, n=name: f"{n} vs reference: {m}")
        torch.testing.assert_close(a, p, rtol=tol, atol=tol, msg=lambda m, n=name: f"{n} vs autograd: {m}")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("geom", [(2, 7, 9, 4, 1, 8), (1, 4, 25, 4, 1, 24)])
def test_vjp_at_padded_head_dims_matches_plain_autograd(cuda, geom, dtype, tol):
    """K1 zero-pads a head dim between its sizes; its backward pads q, k, v
    and the cotangent alike, scales by the true head dim and slices dq, dk
    and dv back."""
    q, k, v, mask, g = _bwd_inputs(cuda, geom, dtype)
    before, bwd_before = fa.launches, fa.bwd_launches
    got = _out_and_grads(fa.mot_attention_fused, q, k, v, mask, g)
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_launches) == (before + 1, bwd_before + 2)
    want = _out_and_grads(mot_attention_ref, q, k, v, mask, g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == dtype and torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=tol, atol=tol, msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernels_without_softcap(cuda, dtype):
    q, k, v, mask, g = _bwd_inputs(cuda, (2, 37, 41, 8, 1, 256), dtype)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, r in zip(fa._launch_bwd(q, k, v, mask, None, g), fa.mot_attention_bwd_ref(q, k, v, mask, None, g)):
        torch.testing.assert_close(a, r, rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["transposed", "expanded", "misaligned"])
def test_vjp_takes_a_cotangent_that_is_a_view(cuda, kind):
    """Autograd may hand the backward a strided or expanded cotangent; the
    wrapper copies it to a contiguous, aligned tensor first."""
    q, k, v, mask, g = _bwd_inputs(cuda, (2, 37, 41, 8, 1, 256), torch.float32)
    if kind == "transposed":
        view = g.transpose(1, 2).contiguous().transpose(1, 2)
    elif kind == "expanded":
        g = g[:, :1].expand_as(g).contiguous()
        view = g[:, :1].expand_as(g)
    else:
        view = torch.empty(g.numel() + 1, device=cuda)[1:].view(g.shape).copy_(g)
    assert not view.is_contiguous() or view.data_ptr() % 16
    want = fa._launch_bwd(q, k, v, mask, 50.0, g)
    for a, b in zip(fa._launch_bwd(q, k, v, mask, 50.0, view), want):
        assert torch.equal(a, b)
    # through autograd, the output's grad is the view
    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
    out = fa.mot_attention_fused(qq, kk, vv, mask, 50.0)
    for a, b in zip(torch.autograd.grad(out, (qq, kk, vv), view), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("geom", [(16, 281, 281, 8, 1, 256), (16, 281, 281, 4, 1, 256)])
def test_two_vjps_are_bitwise_equal(cuda, geom, dtype):
    """No atomics, fixed sum orders: two backward calls agree bitwise."""
    q, k, v, mask, g = _bwd_inputs(cuda, geom, dtype, seed=12)
    first = _out_and_grads(fa.mot_attention_fused, q, k, v, mask, g)
    second = _out_and_grads(fa.mot_attention_fused, q, k, v, mask, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bwd_refuses_what_it_does_not_take(cuda):
    q, k, v, mask, g = _bwd_inputs(cuda, (1, 4, 33, 8, 1, 256), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        fa._launch_bwd(q.cpu(), k.cpu(), v.cpu(), mask.cpu(), 50.0, g.cpu())
    with pytest.raises(ValueError, match="cotangent"):
        fa._launch_bwd(q, k, v, mask, 50.0, g[:, :2])
    lkv = fa.bwd_max_lkv(256) + 1
    long_kv = torch.zeros(1, lkv, 1, 256, device=cuda)
    with pytest.raises(ValueError, match="backward kernel's limit"):
        fa._launch_bwd(q, long_kv, long_kv, torch.zeros(1, 1, 4, lkv, device=cuda), 50.0, g)
    # through autograd: K1 takes the long K/V, the backward refuses it
    qq = q.detach().requires_grad_()
    out = fa.mot_attention_fused(qq, long_kv, long_kv, torch.zeros(1, 1, 4, lkv, device=cuda))
    with pytest.raises(ValueError, match="backward kernel's limit"):
        out.backward(g)


@pytest.mark.parametrize("name", ["q", "k", "v"])
def test_bwd_refuses_misaligned_inputs(cuda, name):
    inputs = dict(zip("qkv", _bwd_inputs(cuda, (1, 4, 33, 8, 1, 256), torch.float32)))
    g = torch.zeros_like(inputs["q"])
    x = inputs[name]
    inputs[name] = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape).copy_(x)
    with pytest.raises(ValueError, match="aligned"):
        fa._launch_bwd(inputs["q"], inputs["k"], inputs["v"], torch.zeros(1, 1, 4, 33, device=cuda), 50.0, g)


def test_bwd_smem_mirror_matches_the_source(cuda):
    """``fused_attention.bwd_smem_bytes``, which sets the Lkv limit, gives
    the source's shared-memory plans."""
    lib = fa._bwd_library()
    for size in (2, 4):
        for d in fa.HEAD_DIMS:
            for lkv in (1, 9, 33, 281, 300, 352):
                assert lib.opz_mot_attention_bwd_smem_bytes(0, size, d, lkv) == fa.bwd_smem_bytes(size, d, lkv, 16)[0]
            for d_tile in (16, 32, 64):
                assert lib.opz_mot_attention_bwd_smem_bytes(1, size, d, d_tile) == fa.bwd_smem_bytes(size, d, 1, d_tile)[1]
