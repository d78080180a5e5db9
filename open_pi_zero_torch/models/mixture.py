"""Per-expert (mixture) layer ops (counterpart of the JAX package's
``models/mixture.py``).

One mixture is a PaliGemma-layout transformer expert: RMSNorm -> GQA
attention -> RMSNorm -> geglu MLP, with optional adaLN(-Zero) time
conditioning, and an optional final RMSNorm.
Projections carry no bias and are stored [in, out]; activations keep the
[B, S, H, D] layout.

Param tree for one mixture (L = num layers, D = hidden, I = intermediate,
Hq/Hkv = query/kv heads, Dh = head_dim):
  layers:
    input_norm:  {weight [L, D]}                      (or adaLN: gamma/beta)
    attn: {q [L, D, Hq*Dh], k [L, D, Hkv*Dh], v [L, D, Hkv*Dh], o [L, Hq*Dh, D]}
    post_norm:   {weight [L, D]}                      (or adaLN)
    mlp: {gate [L, D, I], up [L, D, I], down [L, I, D]}
    post_scale / final_scale: {kernel [L, Dc, D], bias [L, D]}  (adaLN-Zero only)
  final_norm: {weight [D]} | adaLN variant | absent (vlm w/o lm head)
An adaLN norm holds {gamma_kernel [(L,) Dc, D], gamma_bias [(L,) D],
beta_kernel [(L,) Dc, D]}, Dc = ``JointConfig.time_hidden_size``.
The fused serving layout (models/fuse.py) holds attn qkv [L, D, (Hq+2Hkv)*Dh]
and mlp gateup [L, D, 2I] instead; any kernel may be a quantized dict
(ops/linear.py).

Under tensor parallelism (``parallel/sharding.py``) a rank holds a slice
of the heads and of the MLP width: q/k/v reshape by their own width, and
the row-parallel o and down all-reduce their partial sums over the model
group (``parallel.collectives.sum_row_parallel``). Under autograd the input
of each projection that is split on the rank (q; k/v only when their heads
split; gate/up) sums its gradient over the model group
(``copy_to_model_group``): replicated K/V (one KV head) take none, since
K1-shard's VJP sums dk and dv over the group already and one more sum
would count their input gradient tp times. A LoRA adapter follows its
base: a split q/k/v/gate/up adds ``(x @ a) @ b_local`` to its columns, a
split o/down adds ``(x_local @ a_local) @ b`` to the partial sum before
the reduce. A QLoRA NF4 base stays whole on every rank; a split
projection multiplies by its rank's slice of the decoded kernel
(``parallel/sharding.rank_kernel``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from open_pi_zero_torch.config import JointConfig, MixtureConfig
from open_pi_zero_torch.ops.linear import out_features, proj
from open_pi_zero_torch.ops.norms import adaptive_layerscale, adaptive_rms_norm, rms_norm
from open_pi_zero_torch.ops.rope import apply_rope
from open_pi_zero_torch.parallel.collectives import copy_to_model_group, sum_row_parallel
from open_pi_zero_torch.parallel.sharding import attention_split, model_ranks, rank_kernel


def norm(
    lp_norm: dict, mix: MixtureConfig, eps: float, x: torch.Tensor, time_cond: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The mixture's norm: adaLN on ``time_cond`` [B, Dc] for an adaptive
    mixture, else Gemma's (1 + w) RMSNorm (``time_cond`` unused)."""
    if mix.adaptive_mode is not None:
        return adaptive_rms_norm(
            x, time_cond, lp_norm["gamma_kernel"], lp_norm["gamma_bias"], lp_norm["beta_kernel"], eps
        )
    return rms_norm(x, lp_norm["weight"], eps)


def adaptive_scale(
    lp: dict, mix: MixtureConfig, stage: str, x: torch.Tensor, time_cond: Optional[torch.Tensor]
) -> torch.Tensor:
    """adaLN-Zero's residual gate ``stage`` ("post_scale" | "final_scale");
    the identity otherwise."""
    if mix.adaptive_mode != "adaLN-Zero":
        return x
    return adaptive_layerscale(x, time_cond, lp[stage]["kernel"], lp[stage]["bias"])


def _heads_split(joint: JointConfig) -> Tuple[bool, bool]:
    """(q/o split, k/v split) over the registered mesh's model ranks."""
    return attention_split(joint.num_attention_heads, joint.num_key_value_heads, model_ranks())


def _rank(lp: dict, names: Tuple[str, ...], dim: int, split: bool, dtype) -> dict:
    """``lp`` with the kernels of ``names`` as this rank multiplies by them
    (``rank_kernel``: a whole NF4 base of a split projection decoded and
    cut to the rank's slice)."""
    ranked = {n: rank_kernel(lp[n], dim, split, dtype) for n in names}
    return lp if all(ranked[n] is lp[n] for n in names) else {**lp, **ranked}


def q_proj(lp_attn: dict, joint: JointConfig, x: torch.Tensor, scaling: float = 1.0) -> torch.Tensor:
    b, s, _ = x.shape
    lp_attn = _rank(lp_attn, ("q",), -1, _heads_split(joint)[0], x.dtype)
    x = copy_to_model_group(x, out_features(lp_attn["q"]), joint.num_attention_heads * joint.head_dim)
    return proj(lp_attn, "q", x, scaling).reshape(b, s, -1, joint.head_dim)


def kv_proj(
    lp_attn: dict, joint: JointConfig, x: torch.Tensor, scaling: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    shape = (b, s, -1, joint.head_dim)
    lp_attn = _rank(lp_attn, ("k", "v"), -1, _heads_split(joint)[1], x.dtype)
    x = copy_to_model_group(x, out_features(lp_attn["k"]), joint.num_key_value_heads * joint.head_dim)  # k and v split alike
    return (
        proj(lp_attn, "k", x, scaling).reshape(shape),
        proj(lp_attn, "v", x, scaling).reshape(shape),
    )


def qkv_proj(
    lp_attn: dict, joint: JointConfig, x: torch.Tensor, scaling: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q, k, v): one fused projection split at Hq*Dh and Hq*Dh + Hkv*Dh in
    the serving layout (models/fuse.py), else separate LoRA-aware ones."""
    if "qkv" in lp_attn:
        b, s, _ = x.shape
        nq = joint.num_attention_heads * joint.head_dim
        nkv = joint.num_key_value_heads * joint.head_dim
        qkv = proj(lp_attn, "qkv", x)
        return tuple(
            part.reshape(b, s, -1, joint.head_dim) for part in qkv.split([nq, nkv, nkv], dim=-1)
        )
    return (q_proj(lp_attn, joint, x, scaling), *kv_proj(lp_attn, joint, x, scaling))


def o_proj(lp_attn: dict, joint: JointConfig, x: torch.Tensor, scaling: float = 1.0) -> torch.Tensor:
    """x: [B, S, Hq*Dh] (this rank's heads) -> [B, S, D]. The adapter's
    delta joins the rank's partial sum before the reduce."""
    lp_attn = _rank(lp_attn, ("o",), -2, _heads_split(joint)[0], x.dtype)
    out = proj(lp_attn, "o", x, scaling)
    return sum_row_parallel(out, x.shape[-1], joint.num_attention_heads * joint.head_dim)


def mlp(lp_mlp: dict, mix: MixtureConfig, x: torch.Tensor, scaling: float = 1.0) -> torch.Tensor:
    """geglu: down(gelu_tanh(gate(x)) * up(x)), the gelu in fp32; one fused
    gate+up projection split in half in the serving layout."""
    split = mix.intermediate_size % model_ranks() == 0
    if "gateup" in lp_mlp:
        gate, up = proj(lp_mlp, "gateup", x).chunk(2, dim=-1)
    else:
        lp_mlp = _rank(lp_mlp, ("gate", "up"), -1, split, x.dtype)
        x = copy_to_model_group(x, out_features(lp_mlp["gate"]), mix.intermediate_size)  # gate and up split alike
        gate = proj(lp_mlp, "gate", x, scaling)
        up = proj(lp_mlp, "up", x, scaling)
    h = F.gelu(gate.to(torch.float32), approximate="tanh").to(x.dtype) * up
    lp_mlp = _rank(lp_mlp, ("down",), -2, split, x.dtype)
    return sum_row_parallel(proj(lp_mlp, "down", h, scaling), h.shape[-1], mix.intermediate_size)


def rope_qk(
    q: torch.Tensor, k: Optional[torch.Tensor], cos: torch.Tensor, sin: torch.Tensor
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    q = apply_rope(q, cos, sin)
    if k is not None:
        k = apply_rope(k, cos, sin)
    return q, k


def final_norm(
    params: dict, mix: MixtureConfig, eps: float, x: torch.Tensor, time_cond: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mixture-level final norm (present only when use_final_norm)."""
    return norm(params["final_norm"], mix, eps, x, time_cond)
