"""Weight and activation quantization for the serving tiers (counterpart of
the model-kernel part of the JAX package's ``ops/quantization.py``).

Three payload dicts replace a float ``[(L,) in, out]`` kernel:
  {q: int8 [..., in, out], scale: fp32 [..., out]}   weight-only int8, one
      symmetric scale per output channel (``quantize_int8_rowwise``)
  {qa: int8, scale: fp32}                            the same payload for
      W8A8, whose activations are quantized per token at each call
      (``quantize_act_per_token``)
  {q4: uint8 [..., in, out/2], absmax: fp32 [..., in, out/block]}  NF4 in
      blocks along the last dim (``quantize_kernel_nf4``)

The arithmetic is the JAX package's, op for op in fp32, so that a kernel
quantized here is bitwise the one JAX makes from the same weights.

The 8-bit optimizer states (``training/quantized_adam.py``) use the
blockwise int8 format ``QTensor``: the flattened tensor, zero-padded to
whole blocks of 2048, one fp32 absmax scale per block, and a power-law
code (``quantize_blockwise``). The JAX package's ``Q4Tensor`` (a flat
4-bit tensor) is not ported: no path of the port uses it.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# QLoRA's NF4 code (bitsandbytes ``functional.quantize_4bit``); index = the
# stored nibble
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)
DEFAULT_BLOCK_4BIT = 64  # bnb Linear4bit's block size

# The 4-bit payload's layout version: v2 packs HALVES (low nibbles hold
# columns [0, N/2), high nibbles [N/2, N)); v1 packed neighbouring pairs. A
# checkpoint stamps it so that a payload of the other layout fails loudly.
QUANT_LAYOUT_VERSION = 2

# The shrink factors that ``mse_scale`` tries per channel: the fp32 values
# of the JAX package's ``jnp.linspace(0.75, 1.0, 11)`` as XLA on the CPU
# computes it outside ``jit``. Its 0.9749999642372131 is one ulp below the
# correctly rounded 0.975 that ``torch.linspace`` (and XLA under ``jit``)
# gives, so the table is kept as JAX's numbers.
MSE_SCALE_FACTORS = (
    0.75, 0.7749999761581421, 0.800000011920929, 0.824999988079071,
    0.8500000238418579, 0.875, 0.8999999761581421, 0.925000011920929,
    0.949999988079071, 0.9749999642372131, 1.0,
)


def int8_scale(absmax: torch.Tensor) -> torch.Tensor:
    """absmax / 127 (1 / 127 for an all-zero channel or token), divided as
    JAX divides. CUDA divides by a Python scalar as a product with its
    reciprocal, which rounds otherwise, so the divisor is a tensor on the
    same device."""
    return torch.where(absmax == 0, 1.0, absmax) / absmax.new_full((), 127.0)


def quantize_int8_rowwise(w: torch.Tensor, mse_scale: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of a kernel [in, out]: (int8 [in,
    out], fp32 scale [out]). ``mse_scale`` shrinks each channel's absmax
    scale by the candidate factor with the least reconstruction error (the
    first of equal ones), at quantize time only."""
    w32 = w.to(torch.float32)
    scale = int8_scale(w32.abs().amax(dim=0))
    if mse_scale:
        factors = torch.tensor(MSE_SCALE_FACTORS, dtype=torch.float32, device=w.device)
        errs = torch.stack([  # one candidate's [in, out] residual at a time
            torch.square(w32 - torch.clamp(torch.round(w32 / (scale * f)), -127, 127) * (scale * f)).sum(dim=0)
            for f in factors
        ])
        scale = scale * factors[torch.argmin(errs, dim=0)]
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def int8_mm_layout(q: torch.Tensor) -> torch.Tensor:
    """A W8A8 payload [..., K, N] with each [K, N] matrix stored column-major
    (same shape and values). In that layout ``torch._int_mm`` on the card
    takes cuBLAS's int8 tensor-core kernel; a row-major one falls to an
    sm80 WMMA kernel that is several times slower on an H100."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_act_per_token(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token symmetric int8 for W8A8: (int8 [..., K], fp32 scale
    [..., 1]) with x ~= q * scale. ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    xf = x.to(torch.float32)
    scale = int8_scale(xf.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_kernel_nf4(w: torch.Tensor, block: int = DEFAULT_BLOCK_4BIT) -> dict:
    """NF4 with blocks along the last dim: {q4: uint8 [..., in, out/2],
    absmax: fp32 [..., in, out/block]}; a stacked [L, in, out] kernel keeps
    its leading dims. The block shrinks to gcd(block, out) for narrow or
    fused widths. Each value takes the nearest code entry by midpoint
    binning (compared in fp32), and the nibbles pack in halves."""
    block = math.gcd(block, w.shape[-1])
    if w.shape[-1] % 2:
        raise ValueError(f"last dim {w.shape[-1]} must be even to pack nibbles")
    lead = w.shape[:-1]
    blocks = w.to(torch.float32).reshape(*lead, -1, block)
    absmax = blocks.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0, 1.0, absmax)
    normed = blocks / scale
    mids = [(NF4_CODE[i] + NF4_CODE[i + 1]) / 2.0 for i in range(15)]
    idx = torch.zeros(normed.shape, dtype=torch.uint8, device=w.device)
    for m in torch.tensor(mids, dtype=torch.float32, device=w.device):  # ~3x the weights live, not 16x
        idx += (normed >= m).to(torch.uint8)
    idx = idx.reshape(*lead, -1)
    n = idx.shape[-1]
    packed = (idx[..., n // 2 :] << 4) | idx[..., : n // 2]
    return {"q4": packed, "absmax": scale[..., 0]}


@functools.lru_cache(maxsize=None)
def _nf4_table(device: torch.device) -> torch.Tensor:
    """NF4_CODE as an fp32 tensor on ``device``, made once per device: the
    host-to-device copy that makes it cannot run inside a CUDA graph's
    capture, and the first decode runs before any capture (the warm-up)."""
    return torch.tensor(NF4_CODE, dtype=torch.float32, device=device)


def dequantize_kernel_nf4(d: dict, dtype=torch.float32) -> torch.Tensor:
    """{q4, absmax} -> the float kernel in ``dtype`` (code value times its
    block's absmax in fp32, then one cast). A gather into the 16-entry
    table: the JAX package's select tree is a TPU workaround with the same
    numbers."""
    lo = d["q4"] & 0x0F
    hi = d["q4"] >> 4
    idx = torch.cat([lo, hi], dim=-1).long()  # halves packing
    g = d["absmax"].shape[-1]
    vals = _nf4_table(idx.device)[idx].reshape(*idx.shape[:-1], g, -1) * d["absmax"][..., None]
    return vals.reshape(idx.shape).to(dtype)


# --------------------------------------------------------------------------- #
# blockwise int8 (the 8-bit optimizer states)
# --------------------------------------------------------------------------- #

DEFAULT_BLOCK = 2048  # bitsandbytes' blockwise default


@dataclass
class QTensor:
    """Blockwise int8 tensor: payload ``q`` int8 [n_blocks, block] and one
    fp32 absmax ``scale`` [n_blocks, 1] per block of the flattened,
    zero-padded tensor; ``shape`` restores the original layout. ``power``
    selects the code: 1 is linear symmetric int8, p > 1 the power-law code
    q = 127 (|x| / absmax)^(1/p), which keeps small optimizer moments off
    zero."""

    q: torch.Tensor
    scale: torch.Tensor
    shape: Tuple[int, ...]
    power: int = 1


def _pow_root(frac: torch.Tensor, power: int) -> torch.Tensor:
    """frac^(1/power) in fp32 as XLA computes ``frac ** (1.0 / power)``:
    the exponent rounded to fp32 first, the power taken in float64 and
    rounded once. torch's fp32 ``pow`` is a last-ulp approximation that
    differs from XLA's on about 2% of values, this on about 0.06%."""
    exponent = float(np.float32(1.0 / power))
    return torch.exp(torch.log(frac.to(torch.float64)) * exponent).to(torch.float32)


def _integer_pow(x: torch.Tensor, power: int) -> torch.Tensor:
    """x^power by the products JAX's ``lax.integer_pow`` takes (square and
    multiply from the lowest bit: x^3 = x * x^2, x^4 = x^2 * x^2)."""
    acc = None
    while power > 0:
        if power & 1:
            acc = x if acc is None else acc * x
        power >>= 1
        if power:
            x = x * x
    return acc


def block_scale(absmax: torch.Tensor) -> torch.Tensor:
    """A block's scale from its absmax: 1 for an all-zero block."""
    return torch.where(absmax == 0, 1.0, absmax)


def quantize_scaled(x: torch.Tensor, scale: torch.Tensor, power: int = 1) -> torch.Tensor:
    """fp32 values -> their int8 codes, each by its block's ``scale``
    (broadcast against ``x``): elementwise, so a value's code does not
    depend on where the rest of its block lies."""
    frac = x.abs() / scale
    if power != 1:
        frac = _pow_root(frac, power)
    return torch.clamp(torch.round(torch.sign(x) * frac * 127.0), -127, 127).to(torch.int8)


def quantize_blocks(blocks: torch.Tensor, power: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 [n_blocks, block] -> (int8 payload, fp32 scale [n_blocks, 1]),
    each block by its own absmax (1 for an all-zero block)."""
    scale = block_scale(blocks.abs().amax(dim=1, keepdim=True))
    return quantize_scaled(blocks, scale, power), scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor, power: int = 1) -> torch.Tensor:
    """The inverse of ``quantize_blocks``: fp32 [n_blocks, block] (or any
    payload, ``scale`` broadcast against it: elementwise)."""
    qf = q.to(torch.float32)
    # a device tensor as divisor: CUDA divides by a Python scalar as a
    # product with its reciprocal, which rounds otherwise than JAX
    frac = qf.abs() / qf.new_full((), 127.0)
    if power != 1:
        frac = _integer_pow(frac, power)
    return torch.sign(qf) * frac * scale


def quantize_blockwise(x: torch.Tensor, block: int = DEFAULT_BLOCK, power: int = 1) -> QTensor:
    """Any tensor -> its ``QTensor`` (the JAX package's arithmetic; the
    payload bitwise JAX's on the same fp32 input but where XLA's ``pow``
    and this one's round a code's argument to either side of a half)."""
    flat = x.to(torch.float32).reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)
    q, scale = quantize_blocks(blocks, power)
    return QTensor(q, scale, tuple(x.shape), power)


def dequantize_blockwise(qt: QTensor) -> torch.Tensor:
    """``QTensor`` -> the fp32 tensor of its shape."""
    n = math.prod(qt.shape)
    return dequantize_blocks(qt.q, qt.scale, qt.power).reshape(-1)[:n].reshape(qt.shape)


@dataclass(frozen=True)
class SliceBlocks:
    """Where one rank's slice of a leaf split along one dim over ``count``
    ranks falls among the whole leaf's blocks of ``block`` (its flat order,
    as ``quantize_blockwise`` cuts it). In the whole leaf the slice is
    ``runs`` contiguous runs of ``run`` elements, ``stride`` apart, the
    first at ``offset``; in the slice's own flat order they follow one
    another. A whole-leaf block may lie in one rank's slice (a column split
    whose width per rank is a multiple of the block) or straddle several
    ranks' (a narrower one)."""

    dim: int  # the split dim, counted from the front
    run: int
    stride: int
    offset: int
    n_blocks: int  # the whole leaf's
    block: int = DEFAULT_BLOCK

    @classmethod
    def of(cls, shape, dim: int, index: int, count: int, block: int = DEFAULT_BLOCK) -> "SliceBlocks":
        """Rank ``index``'s slice of ``shape`` (the slice's shape) along
        ``dim`` (counted from the front)."""
        inner = math.prod(shape[dim + 1 :])
        run = shape[dim] * inner
        return cls(dim, run, run * count, index * run, -(-math.prod(shape) * count // block), block)

    def ids(self, lo: int, hi: int, device) -> torch.Tensor:
        """The whole-leaf block of each element ``lo:hi`` of the slice's
        flat order (int64)."""
        i = torch.arange(lo, hi, device=device)
        return (i + (i // self.run) * (self.stride - self.run) + self.offset) // self.block

    def absmax_(self, out: torch.Tensor, x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """``out`` [n_blocks], raised in place to the absmax of the slice's
        values ``x`` (flat, at ``ids``) in each block: this rank's part of
        the blocks' maxima, whose MAX over the ranks (zeros elsewhere) is
        the whole leaf's."""
        return out.scatter_reduce_(0, ids, x.abs(), "amax")
