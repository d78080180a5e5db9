"""Attention ops (counterpart of the JAX package's ``ops/attention.py``).

``mot_attention`` is the joint mixture-of-transformers attention with
Gemma tanh soft-capping and an additive block mask. It dispatches by the
registered mesh and the tensor's device, as the JAX package's ``:40-48``:
under a mesh of more than one rank (``parallel.make_mesh``) every call
goes to K1-shard on the rank's shard (``ops/fused_attention.py``), which
launches K1 on a CUDA tensor or raises; without one, a CPU tensor goes to
the plain version ``mot_attention_ref`` and a CUDA tensor to the Hopper
kernel, whether or not it requires grad: the kernel's autograd Function
launches or raises, and its backward recomputes through
``mot_attention_ref`` as the JAX package's custom VJP does.

Precision contract:
  - QK^T accumulated in fp32
  - softcap + mask + softmax in fp32
  - probs cast back to the value dtype before the PV matmul, which
    accumulates in fp32; the output is cast to q's dtype

Layout: q [B, Lq, Hq, D]; k, v [B, Lkv, Hkv, D]; GQA by folding the group
axis into the matmul (no materialized repeat of K/V).
"""

from __future__ import annotations

from typing import Optional

import torch


def mot_attention(
    q: torch.Tensor,  # [B, Lq, Hq, D]
    k: torch.Tensor,  # [B, Lkv, Hkv, D]
    v: torch.Tensor,  # [B, Lkv, Hkv, D]
    mask: torch.Tensor,  # [B, 1, Lq, Lkv] additive (0 / MASK_NEG)
    softcap: Optional[float] = 50.0,
    kv_replicated: bool = False,  # under a mesh: K/V whole while q holds a head slice
) -> torch.Tensor:
    """Dispatch: a registered mesh of more than one rank -> K1-shard;
    else a CPU tensor -> ``mot_attention_ref``, a CUDA tensor -> the Hopper
    kernel and its VJP."""
    from open_pi_zero_torch.ops import fused_attention as fa
    from open_pi_zero_torch.parallel.mesh import get_mesh

    mesh = get_mesh()
    if mesh is not None and mesh.size > 1:
        return fa.mot_attention_fused_sharded(q, k, v, mask, softcap, kv_replicated)
    if q.device.type == "cpu":
        return mot_attention_ref(q, k, v, mask, softcap)
    return fa.mot_attention_fused(q, k, v, mask, softcap)


def mot_attention_ref(
    q: torch.Tensor,  # [B, Lq, Hq, D]
    k: torch.Tensor,  # [B, Lkv, Hkv, D]
    v: torch.Tensor,  # [B, Lkv, Hkv, D]
    mask: torch.Tensor,  # [B, 1, Lq, Lkv] additive (0 / MASK_NEG)
    softcap: Optional[float] = 50.0,
) -> torch.Tensor:
    """Softcapped masked attention with grouped queries, in plain PyTorch.
    Returns [B, Lq, Hq, D]."""
    b, lq, hq, d = q.shape
    _, lkv, hkv, _ = k.shape
    group = hq // hkv
    qg = q.reshape(b, lq, hkv, group, d)

    scores = torch.einsum(
        "bqhgd,bkhd->bhgqk", qg.to(torch.float32), k.to(torch.float32)
    )  # [B, Hkv, G, Lq, Lkv] fp32
    scores = scores * (1.0 / (d**0.5))
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    scores = scores + mask[:, :, None, :, :].to(torch.float32)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)

    out = torch.einsum(
        "bhgqk,bkhd->bqhgd", probs.to(torch.float32), v.to(torch.float32)
    ).to(q.dtype)
    return out.reshape(b, lq, hq, d)


def mha_attention(
    q: torch.Tensor,  # [B, L, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain softmax MHA for the SigLIP tower (no mask, no softcap), fp32
    softmax. Written out rather than calling a fused attention so that the
    cast points are those of the JAX package."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, L, D]
    # fp32 operands: the scores keep fp32 precision (a bf16 matmul would
    # round them to bf16 before the softmax)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, vh).transpose(1, 2).to(q.dtype)
