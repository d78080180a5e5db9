"""Joint mixture-of-transformers trunk (counterpart of the JAX package's
``models/joint.py``: the training forward and the two cached inference
modes).

Each expert ("mixture") has its own weights; experts interact only through
one global softcapped attention per layer over the concatenated sequence,
under a block-causal mask.

  joint_forward       training: any set of active experts, full-sequence
                      attention, no cache; each layer rematerialized in the
                      backward pass when ``JointConfig.remat``
  joint_prefill       run vlm+proprio once, emit K/V for all layers as a
                      stacked [L, B, S, Hkv, Dh] cache
  joint_action_step   action expert only; K/V = cached prefix + fresh action K/V

All three split the stacked layer params into per-layer views once per call
(``tree.layer_split``), walk them with a Python loop and run every layer
uniformly, the last included, as the JAX package does (its final-layer
outputs that nothing consumes are computed and dropped). The proprio
expert shares the action expert's weights when ``JointConfig.tie_proprio``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from open_pi_zero_torch.config import JointConfig
from open_pi_zero_torch.models import mixture as mx
from open_pi_zero_torch.models.tree import layer_split
from open_pi_zero_torch.ops.attention import mot_attention
from open_pi_zero_torch.ops.rope import rope_cos_sin

Tensor = torch.Tensor


def param_key(cfg: JointConfig, name: str) -> str:
    return "action" if (name == "proprio" and cfg.tie_proprio) else name


def _mixture_params(params: dict, cfg: JointConfig, name: str) -> dict:
    return params["mixtures"][param_key(cfg, name)]


def _scale_embeds(x: Tensor, hidden_size: int) -> Tensor:
    # embeds *= sqrt(hidden), the constant rounded to x's dtype as in JAX,
    # made on the device by a fill kernel (a CUDA graph can hold no host copy)
    return x * torch.full((), hidden_size**0.5, dtype=x.dtype, device=x.device)


def _rope_tables(cfg: JointConfig, names, position_ids: Dict[str, Tensor]):
    """cos/sin per mixture, once per call (positions are layer-invariant)."""
    return {
        n: rope_cos_sin(position_ids[n], cfg.head_dim, cfg.mixture(n).rope_theta)
        for n in names
    }


def _layer(
    cfg: JointConfig,
    names: Tuple[str, ...],
    lps: Dict[str, dict],  # per-layer param slices per mixture
    hiddens: Dict[str, Tensor],
    ropes: Dict[str, Tuple[Tensor, Tensor]],
    mask: Tensor,  # [B, 1, sum(Lq), Lkv_total]
    cached_kv: Optional[Tuple[Tensor, Tensor]] = None,  # prefix K/V [B, S, Hkv, Dh]
):
    """One trunk layer over the active mixtures. Returns (new_hiddens,
    (k_new, v_new) of the active mixtures)."""
    eps = cfg.rms_norm_eps
    qs, ks, vs = [], [], []
    for n in names:
        mcfg = cfg.mixture(n)
        h = mx.norm(lps[n]["input_norm"], mcfg, eps, hiddens[n])
        q, k, v = mx.qkv_proj(lps[n]["attn"], cfg, h, mcfg.lora_scaling)
        q, k = mx.rope_qk(q, k, *ropes[n])
        qs.append(q)
        ks.append(k)
        vs.append(v)

    k_new = torch.cat(ks, dim=1)
    v_new = torch.cat(vs, dim=1)
    if cached_kv is not None:
        k_all = torch.cat([cached_kv[0], k_new], dim=1)
        v_all = torch.cat([cached_kv[1], v_new], dim=1)
    else:
        k_all, v_all = k_new, v_new

    q_all = torch.cat(qs, dim=1)
    # under TP with one replicated kv head, q holds this rank's heads only
    kv_replicated = q_all.shape[2] < cfg.num_attention_heads and k_all.shape[2] == cfg.num_key_value_heads
    attn = mot_attention(q_all, k_all, v_all, mask, cfg.attn_softclamp, kv_replicated)
    b, lq = attn.shape[:2]
    attn = attn.reshape(b, lq, -1)

    out, off = {}, 0
    for n in names:
        mcfg = cfg.mixture(n)
        lp = lps[n]
        ln = hiddens[n].shape[1]
        x = hiddens[n] + mx.o_proj(lp["attn"], cfg, attn[:, off : off + ln], mcfg.lora_scaling)
        off += ln
        h = mx.norm(lp["post_norm"], mcfg, eps, x)
        out[n] = x + mx.mlp(lp["mlp"], mcfg, h, mcfg.lora_scaling)
    return out, (k_new, v_new)


def _layer_params(params: dict, cfg: JointConfig, names) -> list:
    """Per-layer param views ``[{name: layer tree}] * L`` of the active
    mixtures. Each stacked tree is split once, so a tied proprio expert
    shares the action expert's views and its grads meet theirs before the
    one ``stack`` of the backward pass."""
    keys = {param_key(cfg, n) for n in names}
    split = {
        key: layer_split(params["mixtures"][key]["layers"], cfg.num_hidden_layers)
        for key in keys
    }
    return [
        {n: split[param_key(cfg, n)][i] for n in names} for i in range(cfg.num_hidden_layers)
    ]


def joint_forward(
    params: dict,
    cfg: JointConfig,
    embeds: Dict[str, Tensor],  # in canonical order, e.g. vlm, proprio, action
    position_ids: Dict[str, Tensor],
    mask: Tensor,  # [B, 1, T, T]
    final_skip: Tuple[str, ...] = ("vlm", "proprio"),
) -> Dict[str, Tensor]:
    """Full-sequence forward, no cache (training). Returns final-normed
    hidden states for every active mixture not in ``final_skip``.

    With ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
    (non-reentrant): only the layer boundaries are kept, and the backward
    pass runs each layer's forward again, the attention kernel included,
    so a forward and backward launch it 2 * L times."""
    names = tuple(embeds.keys())
    ropes = _rope_tables(cfg, names, position_ids)
    hiddens = {n: _scale_embeds(embeds[n], cfg.mixture(n).hidden_size) for n in names}

    def one_layer(hiddens, lps):
        return _layer(cfg, names, lps, hiddens, ropes, mask)[0]

    for lps in _layer_params(params, cfg, names):
        if cfg.remat:
            hiddens = checkpoint(one_layer, hiddens, lps, use_reentrant=False)
        else:
            hiddens = one_layer(hiddens, lps)

    out = {}
    for n in names:
        if n in final_skip:
            continue
        mcfg = cfg.mixture(n)
        mp = _mixture_params(params, cfg, n)
        out[n] = mx.final_norm(mp, mcfg, cfg.rms_norm_eps, hiddens[n]) if mcfg.use_final_norm else hiddens[n]
    return out


def joint_prefill(
    params: dict,
    cfg: JointConfig,
    embeds: Dict[str, Tensor],  # {"vlm": [B,I,Dv], "proprio": [B,P,Dp]}
    position_ids: Dict[str, Tensor],
    mask: Tensor,  # [B, 1, I+P, I+P]
) -> Tuple[Tensor, Tensor]:
    """Run the prefix mixtures once and return stacked K/V caches
    [L, B, I+P, Hkv, Dh]."""
    names = tuple(embeds.keys())
    ropes = _rope_tables(cfg, names, position_ids)
    hiddens = {n: _scale_embeds(embeds[n], cfg.mixture(n).hidden_size) for n in names}
    k_cache = v_cache = None
    for i, lps in enumerate(_layer_params(params, cfg, names)):
        hiddens, (k_new, v_new) = _layer(cfg, names, lps, hiddens, ropes, mask)
        if k_cache is None:  # sized from the rank's K/V heads
            k_cache = k_new.new_empty((cfg.num_hidden_layers, *k_new.shape))
            v_cache = torch.empty_like(k_cache)
        k_cache[i] = k_new
        v_cache[i] = v_new
    return k_cache, v_cache


def joint_action_step(
    params: dict,
    cfg: JointConfig,
    action_embeds: Tensor,  # [B, A, Da]
    kv_cache: Tuple[Tensor, Tensor],  # [L, B, I+P, Hkv, Dh] each
    action_position_ids: Tensor,
    mask: Tensor,  # [B, 1, A, T]
) -> Tensor:
    """One denoising step of the action expert against the cached prefix.
    Returns final-normed action hiddens [B, A, Da]."""
    name = "action"
    mcfg = cfg.mixture(name)
    ropes = _rope_tables(cfg, (name,), {name: action_position_ids})
    hidden = _scale_embeds(action_embeds, mcfg.hidden_size)
    mp = _mixture_params(params, cfg, name)
    k_cache, v_cache = kv_cache
    for i, lps in enumerate(_layer_params(params, cfg, (name,))):
        new, _ = _layer(
            cfg, (name,), lps, {name: hidden}, ropes, mask, cached_kv=(k_cache[i], v_cache[i]),
        )
        hidden = new[name]
    return mx.final_norm(mp, mcfg, cfg.rms_norm_eps, hidden)
