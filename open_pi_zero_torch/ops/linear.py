"""Dense layers: ``linear`` and the float path of the LoRA-aware projection
(counterparts of the JAX package's ``ops/linear.py`` and the float branch
of ``ops/lora.py::proj``/``base_matmul``/``lora_delta``).

Kernels are stored ``[in, out]``. ``torch.matmul`` on bf16 inputs
accumulates in fp32 and rounds the result to bf16; fp32 inputs stay
fp32 (TF32 is off by default for matmuls). The quantized tiers
(``{q, scale}``, ``{qa, scale}``, ``{q4, absmax}``) are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def _float_kernel(kernel) -> torch.Tensor:
    if isinstance(kernel, dict):
        raise NotImplementedError(
            f"quantized kernel {sorted(kernel)}: the port has the float path only"
        )
    return kernel


def linear(
    x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """x [..., in] @ kernel [in, out] (+ bias), in x.dtype."""
    out = torch.matmul(x, _float_kernel(kernel))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def lora_delta(x: torch.Tensor, lora: dict, scaling: float) -> torch.Tensor:
    """scaling * (x @ A) @ B, returned in fp32. x [..., in] -> [..., out]."""
    h = torch.matmul(x, lora["a"])
    return torch.matmul(h, lora["b"]).to(torch.float32) * scaling


def base_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w against a float kernel, returned in fp32."""
    return torch.matmul(x, _float_kernel(w)).to(torch.float32)


def proj(lp: dict, name: str, x: torch.Tensor, scaling: float = 1.0) -> torch.Tensor:
    """LoRA-aware projection: base matmul + optional ``<name>_lora`` delta,
    cast back to x.dtype."""
    lora = lp.get(f"{name}_lora")
    if lora is None:
        return torch.matmul(x, _float_kernel(lp[name]))
    return (base_matmul(x, lp[name]) + lora_delta(x, lora, scaling)).to(x.dtype)
