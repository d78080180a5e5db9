"""Wrapper of the Hopper MoT-attention kernel (``csrc/mot_attention.cu``),
the counterpart of ``mot_attention_fused`` in the JAX package's
``ops/pallas_attention.py``, with its custom VJP.

``ops/attention.mot_attention`` is the one dispatcher: it sends a CPU
tensor to the plain version and a CUDA tensor here, whether or not it
requires grad. The wrapper checks what the kernel takes, allocates the
output, launches on the current stream and raises if the launch was
refused. It never falls back: an input the kernel does not take (a CPU
tensor included) raises.

Autograd (``MotAttention``, the counterpart of ``_vjp_fwd``/``_vjp_bwd``,
``pallas_attention.py:165-178``): the forward launches the kernel and
saves q, k and v; on a CUDA tensor the backward launches the two kernels
of ``csrc/mot_attention_bwd.cu`` (``_launch_bwd``): the row side
recomputes each row's scores and softmax, writes p and dS to a scratch
that lives only inside the call and returns dq; the key side reduces
dk = dS^T q and dv = p^T g over all folded rows, with no atomics. On a
CPU tensor (the CPU tests, K1-shard's CPU ranks) it recomputes through
the plain version ``mot_attention_ref`` and returns ``torch.autograd.grad``
of it, as the JAX VJP does through ``mot_attention_xla``.
``mot_attention_bwd_ref`` is the backward kernels' arithmetic in plain
PyTorch, for the tests and ``chip_smoke.py``. The mask takes no grad.

Launch geometry (``launch_geometry``, chosen here so that the CPU tests
reach it): blocks of 16 or 64 folded query rows, and the Lkv axis split
over a thread block cluster of up to 16 blocks, so that the latency-bound
Euler step runs on 32 SMs instead of 2; the card's SM count and shared
memory are read at launch (``card_limits``). ``smem_bytes`` mirrors the
source's shared-memory plan, and ``mot_attention_split_ref`` repeats the
kernel's split arithmetic in plain PyTorch for the tests.

``launches`` counts the kernel's launches (a forward that a rematerialized
layer runs again counts again), and ``bwd_launches`` the backward
kernels' (two per VJP), so that a run can show that its main path went
through them.

K1-shard (``mot_attention_fused_sharded``, the counterpart of
``pallas_attention.py:185-247``) is K1 on one rank's shard under a
(data, model) mesh of processes: the rank's batch rows and its query
heads, with K/V either its own heads (Hkv % tp == 0) or every rank's
replicated single head (Hkv == 1, the MoT trunk). JAX wraps the kernel in
``shard_map``, whose transpose sums the replicated K/V's cotangents over
``model``; here each rank already holds its shard (``parallel/``), and
the same ``MotAttention`` launches K1 on it, given the model group to sum
dk and dv over when K/V are replicated. Under a registered mesh the
dispatcher sends every call here, so ``launches`` counted in a rank are
K1-shard's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from open_pi_zero_torch.ops import _build
from open_pi_zero_torch.ops.attention import mot_attention_ref
from open_pi_zero_torch.parallel import collectives
from open_pi_zero_torch.parallel.mesh import get_mesh

SOURCE = "mot_attention"
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SMEM_BYTES = 232448  # dynamic shared memory one block may use on Hopper (kMaxSmem)
BLOCK_SMEM_RESERVED = 1024  # shared memory the runtime reserves per block
KEYS_PER_TILE = 32  # kKeys: K/V rows per ring stage
MAX_SPLIT = 16  # blocks per cluster (16 is the non-portable size)
MAX_LKV_SPLIT = 8  # the split that max_lkv's slices assume

BWD_SOURCE = "mot_attention_bwd"
BWD_ROWS = 32  # kRows: folded rows per row-side block
BWD_ROW_WARPS_N = 4  # kWarpsN: score-tile warps over a ring tile's keys
BWD_STAGE_ROWS = 64  # kStageRows: folded rows per key-side stage
BWD_KEY_WARPS = 4  # kKeyWarps
BWD_KEY_STAGES = 2  # kKeyStages
BWD_D_TILE = 64  # D columns of a key-side block (all of D where D is smaller)

launches = 0
bwd_launches = 0

_lib: Optional[ctypes.CDLL] = None
_bwd_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE)
        lib.opz_mot_attention_fwd.argtypes = [
            ctypes.c_int,
            *[ctypes.c_void_p] * 5,  # q, k, v, mask, out
            *[ctypes.c_int] * 6,  # batch, lq, lkv, hq, hkv, head_dim
            ctypes.c_longlong, ctypes.c_longlong,  # mask batch / row strides
            ctypes.c_float, ctypes.c_float,  # scale, softcap
            ctypes.c_int, ctypes.c_int,  # rows per block, split
            ctypes.c_void_p,  # stream
        ]
        lib.opz_mot_attention_fwd.restype = ctypes.c_int
        lib.opz_empty_launch.argtypes = [ctypes.c_void_p]
        lib.opz_empty_launch.restype = ctypes.c_int
        lib.opz_mot_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.opz_mot_attention_smem_bytes.restype = ctypes.c_int
        lib.opz_cuda_error_string.argtypes = [ctypes.c_int]
        lib.opz_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load(BWD_SOURCE)
        lib.opz_mot_attention_bwd_rows.argtypes = [
            ctypes.c_int,
            *[ctypes.c_void_p] * 8,  # q, k, v, mask, g, dq, p, ds
            *[ctypes.c_int] * 6,  # batch, lq, lkv, hq, hkv, head_dim
            ctypes.c_longlong, ctypes.c_longlong,  # mask batch / row strides
            ctypes.c_float, ctypes.c_float,  # scale, softcap
            ctypes.c_void_p,  # stream
        ]
        lib.opz_mot_attention_bwd_rows.restype = ctypes.c_int
        lib.opz_mot_attention_bwd_keys.argtypes = [
            ctypes.c_int,
            *[ctypes.c_void_p] * 6,  # q, g, p, ds, dk, dv
            *[ctypes.c_int] * 7,  # batch, lq, lkv, hq, hkv, head_dim, d_tile
            ctypes.c_void_p,  # stream
        ]
        lib.opz_mot_attention_bwd_keys.restype = ctypes.c_int
        lib.opz_mot_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.opz_mot_attention_bwd_smem_bytes.restype = ctypes.c_int
        lib.opz_bwd_error_string.argtypes = [ctypes.c_int]
        lib.opz_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def smem_bytes(element_size: int, head_dim: int, rows: int, slice_len: int) -> int:
    """Dynamic shared memory of one block: ``make_plan`` in the source. q
    rows of stride D + 16 B; a ring of 2 stages of 32 K/V rows of stride
    D + 8, or the fp32 partial out [rows, D + 4] if larger; fp32 scores
    [rows, round32(slice) + 4]; bf16 p [rows, round32(slice) + 8] (bf16
    only); the rows' max and sum."""
    slice_pad = -(-slice_len // KEYS_PER_TILE) * KEYS_PER_TILE
    q_bytes = rows * (head_dim + 16 // element_size) * element_size
    ring = 2 * KEYS_PER_TILE * (head_dim + 8) * element_size
    partial_out = rows * (head_dim + 4) * 4  # overlays q and the ring at the end
    scores = rows * (slice_pad + 4) * 4
    p_bytes = rows * (slice_pad + 8) * 2 if element_size == 2 else 0
    return max(q_bytes + ring, partial_out) + scores + p_bytes + 2 * rows * 4


def block_threads(rows: int, element_size: int) -> int:
    """Threads of a block (``Cfg::kThreads``): 4 warps for 16 rows; for
    64 rows, 8 in bf16 and 16 in fp32."""
    return 128 if rows == 16 else (256 if element_size == 2 else 512)


def blocks_per_sm(smem: int, rows: int, element_size: int, card: tuple) -> int:
    """Blocks that one SM of ``card`` holds at once: its shared memory,
    BLOCK_SMEM_RESERVED of it per block, and its threads."""
    _, sm_smem, sm_threads = card
    return min(sm_smem // (smem + BLOCK_SMEM_RESERVED), sm_threads // block_threads(rows, element_size))


@functools.lru_cache(maxsize=None)
def card_limits(device: torch.device) -> tuple:
    """(SMs, shared memory per SM, threads per SM) of a CUDA device, which
    ``launch_geometry`` fills."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.shared_memory_per_multiprocessor, props.max_threads_per_multi_processor


@functools.lru_cache(maxsize=None)
def max_lkv(head_dim: int) -> int:
    """Longest K/V sequence the kernel takes at ``head_dim`` (2816 at
    D = 256): MAX_LKV_SPLIT slices of the longest slice whose block fits
    the shared memory in both dtypes and both row tiles."""
    longest = min(
        max(s for s in range(KEYS_PER_TILE, 8192, KEYS_PER_TILE)
            if smem_bytes(size, head_dim, rows, s) <= MAX_SMEM_BYTES)
        for size in (2, 4) for rows in (16, 64)
    )
    return MAX_LKV_SPLIT * longest


@functools.lru_cache(maxsize=None)
def launch_geometry(batch: int, lq: int, lkv: int, hq: int, hkv: int, head_dim: int,
                    element_size: int, card: tuple) -> tuple:
    """(rows per block, split) of a launch on ``card`` (``card_limits``). A
    cell is 64 folded rows of one (batch, kv head) where there are 128 or
    more, else 16. The cell's Lkv is split over a cluster of ``split``
    blocks: doubled while the doubled grid still fits the card at once (one
    wave) and each block keeps 16 keys or more, and while a block's shared
    memory does not fit."""
    rows_total = (hq // hkv) * lq
    rows = 64 if rows_total >= 128 else 16
    cells = batch * hkv * -(-rows_total // rows)

    def smem(s):
        return smem_bytes(element_size, head_dim, rows, -(-lkv // s))

    def one_wave(s):
        return cells * s <= card[0] * blocks_per_sm(smem(s), rows, element_size, card)

    split = 1
    while split < MAX_SPLIT and lkv >= 32 * split and one_wave(2 * split):
        split *= 2
    while split < MAX_SPLIT and smem(split) > MAX_SMEM_BYTES:
        split *= 2
    if smem(split) > MAX_SMEM_BYTES:
        raise ValueError(f"Lkv={lkv} exceeds the kernel's shared memory at D={head_dim}")
    return rows, split


def mot_attention_split_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    softcap: Optional[float] = 50.0, parts: int = 1,
) -> torch.Tensor:
    """The kernel's arithmetic over an Lkv split into ``parts`` slices of
    ceil(Lkv / parts) keys, in plain PyTorch, for the tests. Each slice b:
    fp32 scores s, their max m_b, e = exp(s - m_b) and l_b = sum e. Then
    M = max m_b and L = sum_b l_b exp(m_b - M) in slice order; p =
    e exp(m_b - M) / L, rounded to V's dtype only now; each slice's fp32
    p v; the partials summed in slice order from zero; the output rounded
    to q's dtype."""
    b, lq, hq, d = q.shape
    _, lkv, hkv, _ = k.shape
    g = hq // hkv
    qf = q.float().reshape(b, lq, hkv, g, d)
    size = -(-lkv // parts)
    bounds = [(min(r * size, lkv), min((r + 1) * size, lkv)) for r in range(parts)]
    bounds = [(lo, hi) for lo, hi in bounds if hi > lo]  # an empty slice adds nothing
    stats = []
    for lo, hi in bounds:
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k[:, lo:hi].float()) * (1.0 / d**0.5)
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        s = s + mask[:, :, None, :, lo:hi].float()
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        stats.append((m, e, e.sum(-1, keepdim=True)))
    gmax = torch.stack([m for m, _, _ in stats]).amax(0)
    gsum = torch.zeros_like(gmax)
    for m, _, l in stats:
        gsum = gsum + l * torch.exp(m - gmax)
    out = torch.zeros(b, hkv, g, lq, d)
    for (m, e, _), (lo, hi) in zip(stats, bounds):
        p = (e * torch.exp(m - gmax) / gsum).to(v.dtype).float()
        out = out + torch.einsum("bhgqk,bkhd->bhgqd", p, v[:, lo:hi].float())
    return out.permute(0, 3, 1, 2, 4).reshape(b, lq, hq, d).to(q.dtype)


def _check(q, k, v, mask) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {q.device}")
    for name, x in (("k", k), ("v", v), ("mask", mask)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"q/k/v must share a dtype in {list(DTYPE_CODES)}, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if mask.dtype != torch.float32:
        raise ValueError(f"mask must be float32, got {mask.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, lq, hq, d = q.shape
    _, lkv, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if lq == 0 or lkv == 0 or b == 0:
        raise ValueError("empty attention")
    if lkv > max_lkv(d):
        raise ValueError(f"Lkv={lkv} exceeds the kernel's limit {max_lkv(d)} at D={d}")
    if tuple(mask.shape) != (b, 1, lq, lkv) or mask.stride(-1) != 1:
        raise ValueError(
            f"mask must be [B,1,Lq,Lkv]={(b, 1, lq, lkv)} with unit last stride, "
            f"got {tuple(mask.shape)} strides {mask.stride()}"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:  # the kernel copies q, k and v in 16-byte pieces
            raise ValueError(f"{name} must start at a 16-byte aligned address")
    if mask.requires_grad:
        raise ValueError("the mask takes no grad")


def _pad_head_dim(*xs: torch.Tensor) -> tuple:
    """``xs`` zero-padded on their last dim up to the kernels' next head dim,
    and the true head dim. Between the kernels' head dims (the reference
    fixtures' 8, SimplerLite's 24), zero columns add exact zeros to every
    q.k, and give zero columns of the output, of dq, dk and dv; the scale
    stays that of the true head dim. Past the largest, nothing is padded
    and ``_check`` refuses the head dim."""
    true_d = xs[0].shape[-1]
    run_d = next((h for h in HEAD_DIMS if h >= true_d), true_d)
    if 0 < true_d < run_d:
        xs = tuple(F.pad(x, (0, run_d - true_d)) for x in xs)
    return xs, true_d


def _launch(q, k, v, mask, softcap: Optional[float]) -> torch.Tensor:
    global launches
    (q, k, v), true_d = _pad_head_dim(q, k, v)
    _check(q, k, v, mask)
    b, lq, hq, d = q.shape
    _, lkv, hkv, _ = k.shape
    rows, split = launch_geometry(b, lq, lkv, hq, hkv, d, q.element_size(), card_limits(q.device))
    out = torch.empty_like(q)
    lib = _library()
    err = lib.opz_mot_attention_fwd(
        DTYPE_CODES[q.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, lq, lkv, hq, hkv, d,
        mask.stride(0), mask.stride(2),
        1.0 / (true_d**0.5), 0.0 if softcap is None else float(softcap),
        rows, split,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"mot_attention kernel launch failed: {lib.opz_cuda_error_string(err).decode()}"
        )
    launches += 1
    return out if d == true_d else out[..., :true_d].contiguous()


def empty_launch(device: torch.device) -> None:
    """Launch an empty kernel on ``device``'s current stream: the launch
    floor that ``chip_smoke.py`` times beside K1."""
    lib = _library()
    err = lib.opz_empty_launch(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: {lib.opz_cuda_error_string(err).decode()}")


# --------------------------------------------------------------------------- #
# K1-vjp's backward kernels (csrc/mot_attention_bwd.cu)
# --------------------------------------------------------------------------- #


def bwd_smem_bytes(element_size: int, head_dim: int, lkv: int, d_tile: int) -> tuple:
    """Dynamic shared memory of one block of each backward kernel
    (``make_row_plan``, ``make_key_plan`` in the source): (row side, key
    side). Row side: q and g rows of stride D + 16 B; a ring of 2 tiles of
    32 K/V rows of stride D + 8; two fp32 rows of round32(Lkv) + 4 per
    folded row; the D halves' 32 x 36 fp32 exchange tile; delta's partials.
    Key side: 2 stages of 64 rows of 32 + 8 fp32 columns and D-tile + 8
    columns of the inputs' dtype, or the 4 warps' fp32 sums if larger."""
    rows, keys = BWD_ROWS, KEYS_PER_TILE
    lkv_pad = -(-lkv // keys) * keys
    row_side = (
        2 * rows * (head_dim + 16 // element_size) * element_size
        + 2 * keys * (head_dim + 8) * element_size
        + 2 * rows * (lkv_pad + 4) * 4
        + rows * (keys + 4) * 4
        + BWD_ROW_WARPS_N * rows * 4
    )
    stage = BWD_STAGE_ROWS * (keys + 8) * 4 + BWD_STAGE_ROWS * (d_tile + 8) * element_size
    key_side = max(BWD_KEY_STAGES * stage, BWD_KEY_WARPS * keys * (d_tile + 4) * 4)
    return row_side, key_side


@functools.lru_cache(maxsize=None)
def bwd_max_lkv(head_dim: int) -> int:
    """Longest K/V sequence the backward kernels take at ``head_dim`` (352
    at D = 256): the longest multiple of 32 whose row block fits the shared
    memory in both dtypes."""
    return min(
        max(lkv for lkv in range(KEYS_PER_TILE, 8192, KEYS_PER_TILE)
            if bwd_smem_bytes(size, head_dim, lkv, 16)[0] <= MAX_SMEM_BYTES)
        for size in (2, 4)
    )


def bwd_launch_geometry(batch: int, lq: int, lkv: int, hq: int, hkv: int, head_dim: int) -> tuple:
    """(row-side blocks, key-side D tile, key-side blocks) of a backward.
    The row side takes 32 folded rows of one (batch, kv head) per block;
    the key side 32 keys x a D tile x dk or dv. Raises a ValueError past
    the Lkv limit."""
    if lkv > bwd_max_lkv(head_dim):
        raise ValueError(
            f"Lkv={lkv} exceeds the backward kernel's limit {bwd_max_lkv(head_dim)} at D={head_dim}"
        )
    cells = batch * hkv
    d_tile = min(BWD_D_TILE, head_dim)
    key_blocks = cells * -(-lkv // KEYS_PER_TILE) * (head_dim // d_tile) * 2
    return cells * -(-(hq // hkv) * lq // BWD_ROWS), d_tile, key_blocks


def mot_attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
    softcap: Optional[float], g: torch.Tensor, scale: Optional[float] = None,
) -> tuple:
    """dq, dk, dv of ``mot_attention_ref`` for the cotangent ``g``, by the
    backward kernels' arithmetic in plain PyTorch, for the tests. Row side,
    in fp32: x = q k^T scale, t = tanh(x / softcap), s = t softcap + mask;
    the exact softmax p = exp(s - max) / sum; dP = g v^T, rounded once to
    V's dtype; delta = sum_j p dP; dS = (p (1 - t^2)) (dP - delta) scale;
    dq = dS k. Key side: dv = p~^T g, p~ being p rounded to V's dtype, and
    dk = dS^T q, each one sum over the G Lq folded rows of its kv head.
    p, p~ and dS are materialised as the kernels' scratch is; the sums
    inside a product run in the library's order, not the tensor cores'.
    ``scale`` defaults to 1 / sqrt(D); inputs zero-padded past their true
    head dim pass that dim's (``_launch_bwd``)."""
    b, lq, hq, d = q.shape
    _, lkv, hkv, _ = k.shape
    scale = 1.0 / d**0.5 if scale is None else scale
    qf = q.float().reshape(b, lq, hkv, hq // hkv, d)
    gf = g.float().reshape(b, lq, hkv, hq // hkv, d)
    kf, vf = k.float(), v.float()
    x = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    if softcap is None:
        s, slope = x, torch.ones_like(x)
    else:
        t = torch.tanh(x / softcap)
        s, slope = t * softcap, 1.0 - t * t
    s = s + mask[:, :, None].float()
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", gf, vf).to(v.dtype).float()
    delta = (p * dp).sum(-1, keepdim=True)
    ds = (p * slope) * (dp - delta) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf)
    p_cast = p.to(v.dtype).float()
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p_cast, gf)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    return dq.reshape(b, lq, hq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _launch_bwd(q, k, v, mask, softcap: Optional[float], grad: torch.Tensor) -> tuple:
    """dq, dk, dv through the two backward kernels, for the cotangent
    ``grad`` (made contiguous and 16-byte aligned here if it is not: the
    one autograd hands over may be a strided or expanded view)."""
    global bwd_launches
    if grad.shape != q.shape or grad.dtype != q.dtype or grad.device != q.device:
        raise ValueError(f"cotangent {tuple(grad.shape)} {grad.dtype} on {grad.device} does not match q")
    (q, k, v, grad), true_d = _pad_head_dim(q, k, v, grad)
    _check(q, k, v, mask)
    if not grad.is_contiguous() or grad.data_ptr() % 16:
        grad = grad.clone(memory_format=torch.contiguous_format)
    b, lq, hq, d = q.shape
    _, lkv, hkv, _ = k.shape
    _, d_tile, _ = bwd_launch_geometry(b, lq, lkv, hq, hkv, d)
    ld = -(-lkv // KEYS_PER_TILE) * KEYS_PER_TILE
    scratch = (b, hkv, hq // hkv * lq, ld)
    probs = torch.empty(scratch, dtype=q.dtype, device=q.device)
    dscores = torch.empty(scratch, dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _bwd_library()
    code = DTYPE_CODES[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.opz_mot_attention_bwd_rows(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), grad.data_ptr(),
        dq.data_ptr(), probs.data_ptr(), dscores.data_ptr(),
        b, lq, lkv, hq, hkv, d, mask.stride(0), mask.stride(2),
        1.0 / (true_d**0.5), 0.0 if softcap is None else float(softcap), stream,
    )
    if err != 0:
        raise RuntimeError(f"mot_attention_bwd_rows launch failed: {lib.opz_bwd_error_string(err).decode()}")
    bwd_launches += 1
    err = lib.opz_mot_attention_bwd_keys(
        code, q.data_ptr(), grad.data_ptr(), probs.data_ptr(), dscores.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, lq, lkv, hq, hkv, d, d_tile, stream,
    )
    if err != 0:
        raise RuntimeError(f"mot_attention_bwd_keys launch failed: {lib.opz_bwd_error_string(err).decode()}")
    bwd_launches += 1
    if d == true_d:
        return dq, dk, dv
    return tuple(x[..., :true_d].contiguous() for x in (dq, dk, dv))


def _recompute_grads(q, k, v, mask, softcap, grad):
    """dq, dk, dv through the plain version, as ``_vjp_bwd`` recomputes
    through ``mot_attention_xla``."""
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_() for x in (q, k, v)]
        out = mot_attention_ref(*inputs, mask, softcap)
        return torch.autograd.grad(out, inputs, grad)


class MotAttention(torch.autograd.Function):
    """The kernel under autograd: forward through the kernel; backward
    through the backward kernels on a CUDA tensor, by recomputing through
    the plain version on a CPU tensor (the JAX package's custom VJP).

    ``kv_group``: the process group whose ranks hold the same K/V (K1-shard
    with replicated K/V); the backward sums dk and dv over it, as
    shard_map's transpose psums them. None on one card. ``plain``: the
    forward goes through the plain version, for K1-shard on a CPU tensor."""

    @staticmethod
    def forward(ctx, q, k, v, mask, softcap, kv_group=None, plain=False):
        ctx.save_for_backward(q, k, v, mask)
        ctx.softcap, ctx.kv_group = softcap, kv_group
        if plain:
            return mot_attention_ref(q, k, v, mask, softcap)
        return _launch(q, k, v, mask, softcap)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, mask = ctx.saved_tensors
        backward = _recompute_grads if q.device.type == "cpu" else _launch_bwd
        dq, dk, dv = backward(q, k, v, mask, ctx.softcap, grad)
        if ctx.kv_group is not None:
            dk, dv = collectives.all_reduce(dk, ctx.kv_group), collectives.all_reduce(dv, ctx.kv_group)
        return dq, dk, dv, None, None, None, None


def mot_attention_fused(
    q: torch.Tensor,  # [B, Lq, Hq, D]
    k: torch.Tensor,  # [B, Lkv, Hkv, D]
    v: torch.Tensor,  # [B, Lkv, Hkv, D]
    mask: torch.Tensor,  # [B, 1, Lq, Lkv] additive fp32
    softcap: Optional[float] = 50.0,
) -> torch.Tensor:
    """Softcapped masked GQA attention through the Hopper kernel, with the
    VJP above. Same contract as ``mot_attention_ref``; returns
    [B, Lq, Hq, D]."""
    return MotAttention.apply(q, k, v, mask, softcap, None, False)


# --------------------------------------------------------------------------- #
# K1-shard: K1 on one rank's shard under a mesh
# --------------------------------------------------------------------------- #


def shardable_attention(q: torch.Tensor, k: torch.Tensor, kv_replicated: bool = False) -> bool:
    """True if the rank's shard is one K1-shard takes: a mesh of more than
    one rank is registered, q's local heads group evenly over k's, and
    replicated K/V are a single head. The TP rules
    (``parallel.sharding.attention_split``) only ever make such shards:
    where JAX's ``shardable_attention`` is false, they leave q whole, so
    the rank holds every head and K1 runs on all of them."""
    mesh = get_mesh()
    if mesh is None or mesh.size == 1:
        return False
    hq, hkv = q.shape[2], k.shape[2]
    return q.shape[0] == k.shape[0] and hq % hkv == 0 and (hkv == 1 or not kv_replicated)


def mot_attention_fused_sharded(
    q: torch.Tensor,  # [B / dp, Lq, Hq / tp, D]: this rank's rows and query heads
    k: torch.Tensor,  # [B / dp, Lkv, Hkv / tp or 1, D]
    v: torch.Tensor,
    mask: torch.Tensor,  # [B / dp, 1, Lq, Lkv] additive fp32
    softcap: Optional[float] = 50.0,
    kv_replicated: bool = False,  # K/V are the same on every rank of the model group
) -> torch.Tensor:
    """K1-shard: attention of one rank's shard under the registered mesh,
    through K1 on a CUDA tensor (the plain version on a CPU tensor), with
    ``MotAttention``'s VJP, whose dk and dv are summed over the model group
    when K/V are replicated. Returns the rank's [B / dp, Lq, Hq / tp, D]."""
    mesh = get_mesh()
    if not shardable_attention(q, k, kv_replicated):
        raise ValueError(
            f"not a shard K1-shard takes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"kv_replicated={kv_replicated}, mesh {None if mesh is None else mesh.shape}"
        )
    group = mesh.model_group if kv_replicated else None
    return MotAttention.apply(q, k, v, mask, softcap, group, q.device.type == "cpu")
