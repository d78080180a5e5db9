"""Dense layers: ``linear`` and the LoRA-aware projection (counterparts of
the JAX package's ``ops/linear.py`` and of ``ops/lora.py::proj``,
``base_matmul`` and ``lora_delta``).

Kernels are stored ``[in, out]``. A kernel is a float tensor or one of the
quantized dicts of ``ops/quantization.py``:
  {q, scale}     weight-only int8: x @ q.to(x.dtype) as an fp32 product,
                 times the per-channel scale
  {qa, scale}    W8A8: x quantized per token, an int8 x int8 -> int32
                 product (``torch._int_mm``), times the token's scale, times
                 the channel's scale
  {q4, absmax}   NF4: dequantized to x.dtype, then an fp32 product
The epilogue is JAX's, in its order: the fp32 product, times the scales,
plus the bias in fp32, then one cast to x.dtype. A bf16 product is taken
in fp32 with one rounding at the end (``matmul_f32``).

An unbiased float ``linear`` and a float ``proj`` without an adapter are
one ``torch.matmul``: on bf16 inputs it accumulates in fp32 and rounds the
result once, which is the same arithmetic.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from open_pi_zero_torch.ops.quantization import dequantize_kernel_nf4, quantize_act_per_token
from open_pi_zero_torch.utils.monitor import annotate


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [in, out] as an fp32 product. In fp32 one matmul. In
    bf16 on a card the product stays on the bf16 tensor cores with an fp32
    output (``torch.mm(..., out_dtype=torch.float32)``); on the CPU both
    operands are widened to fp32 first, which is the same arithmetic, since
    a product of two bf16 values is exact in fp32."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.device.type == "cuda":
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


_INT_MM_MIN_ROWS = 17  # torch._int_mm on a card takes more than 16 rows


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 [..., K] @ int8 [K, N] -> the exact int32 product. On a card
    ``torch._int_mm`` takes more than 16 rows and K, N multiples of 8: fewer
    rows (a decode step's B rows) are padded with zero rows up to 17, on
    every device, and the product's padding rows dropped (exact: a zero row
    gives a zero row of the product); K or N off the multiple raise on a
    card, where the W8A8 tier would otherwise fail inside cuBLAS. ``wq`` is
    read in its own layout: column-major is the fast one
    (``quantization.int8_mm_layout``)."""
    x2d = xq.reshape(-1, xq.shape[-1])
    m, (k, n) = x2d.shape[0], wq.shape
    if xq.device.type == "cuda" and (k % 8 or n % 8):
        raise ValueError(f"W8A8 on a card needs K and N multiples of 8; got K={k}, N={n}")
    if m < _INT_MM_MIN_ROWS:
        x2d = F.pad(x2d, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    return torch._int_mm(x2d, wq)[:m].reshape(*xq.shape[:-1], n)


def base_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w against a float kernel or a quantized dict, returned in fp32."""
    if not isinstance(w, dict):
        return matmul_f32(x, w)
    if "q4" in w:
        with annotate("opz_nf4_dequant"):  # the NF4 layer's range in a profiler trace
            kernel = dequantize_kernel_nf4(w, x.dtype)
        return matmul_f32(x, kernel)
    if "q" in w:
        return matmul_f32(x, w["q"].to(x.dtype)) * w["scale"].to(torch.float32)
    if "qa" in w:
        xq, sx = quantize_act_per_token(x)
        return int8_matmul(xq, w["qa"]).to(torch.float32) * sx * w["scale"].to(torch.float32)
    raise ValueError(
        f"unsupported quantized kernel format {sorted(w)}: the port takes {{q4, absmax}} NF4, "
        "{q, scale} weight-only int8 and {qa, scale} W8A8"
    )


def out_features(w) -> int:
    """A kernel's output columns: a float kernel's last dim; a quantized
    dict's, from its payload (NF4 packs two columns in a byte)."""
    if not isinstance(w, dict):
        return w.shape[-1]
    if "q4" in w:
        return 2 * w["q4"].shape[-1]
    return (w["q"] if "q" in w else w["qa"]).shape[-1]


def linear(x: torch.Tensor, kernel, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., in] @ kernel [in, out] (+ bias), in x.dtype."""
    if bias is None and not isinstance(kernel, dict):
        return torch.matmul(x, kernel)
    out = base_matmul(x, kernel)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def lora_delta(x: torch.Tensor, lora: dict, scaling: float) -> torch.Tensor:
    """scaling * (x @ A) @ B, returned in fp32. x [..., in] -> [..., out]."""
    h = torch.matmul(x, lora["a"])
    return torch.matmul(h, lora["b"]).to(torch.float32) * scaling


def proj(lp: dict, name: str, x: torch.Tensor, scaling: float = 1.0) -> torch.Tensor:
    """LoRA-aware projection: base matmul + optional ``<name>_lora`` delta,
    cast back to x.dtype."""
    w, lora = lp[name], lp.get(f"{name}_lora")
    if lora is None and not isinstance(w, dict):
        return torch.matmul(x, w)
    out = base_matmul(x, w)
    if lora is not None:
        out = out + lora_delta(x, lora, scaling)
    return out.to(x.dtype)
