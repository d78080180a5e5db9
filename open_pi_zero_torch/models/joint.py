"""Joint mixture-of-transformers trunk (counterpart of the JAX package's
``models/joint.py``: the training forward, the two cached inference modes
and the text path).

Each expert ("mixture") has its own weights; experts interact only through
one global softcapped attention per layer over the concatenated sequence,
under a block-causal mask.

  joint_forward       training: any set of active experts, full-sequence
                      attention, no cache; each layer rematerialized in the
                      backward pass when ``JointConfig.remat``
  joint_prefill       run vlm+proprio once, emit K/V for all layers as a
                      stacked [L, B, S, Hkv, Dh] cache
  joint_action_step   action expert only; K/V = cached prefix + fresh action K/V
  joint_text_forward  PaliGemma text path: vlm mixture only, K/V written in
                      place into a static [L, B, T_max, Hkv, Dh] cache
                      (``init_text_cache``) at an offset

All of them split the stacked layer params into per-layer views once per
call (``tree.layer_split``), walk them with a Python loop and run every
layer uniformly, the last included, as the JAX package does (its
final-layer outputs that nothing consumes are computed and dropped). The
proprio expert shares the action expert's weights when
``JointConfig.tie_proprio``. An adaLN mixture takes its time conditioning
from ``time_cond``: one [B, Dc] tensor for every mixture, or a dict per
mixture (inference conditions the cached prefix at t = 0, see
``pizero.infer_action``).
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


def _as_time_conds(time_cond, names) -> Dict[str, Tensor]:
    """None -> {}, one tensor -> the same cond for every mixture (training),
    a dict -> per-mixture conds (inference)."""
    if time_cond is None:
        return {}
    if isinstance(time_cond, dict):
        return time_cond
    return {n: time_cond for n in names}


def _layer(
    cfg: JointConfig,
    names: Tuple[str, ...],
    lps: Dict[str, dict],  # per-layer param slices per mixture
    hiddens: Dict[str, Tensor],
    ropes: Dict[str, Tuple[Tensor, Tensor]],
    mask: Tensor,  # [B, 1, sum(Lq), Lkv_total]
    time_conds: Dict[str, Tensor],  # per-mixture adaLN cond [B, Dc]
    cached_kv: Optional[Tuple[Tensor, Tensor]] = None,  # prefix K/V [B, S, Hkv, Dh]
):
    """One trunk layer over the active mixtures. Returns (new_hiddens,
    (k_new, v_new) of the active mixtures)."""
    eps = cfg.rms_norm_eps
    qs, ks, vs = [], [], []
    for n in names:
        mcfg = cfg.mixture(n)
        h = mx.norm(lps[n]["input_norm"], mcfg, eps, hiddens[n], time_conds.get(n))
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
    # under TP with one replicated kv head, q holds this rank's heads only;
    # K1-shard's VJP then sums dk and dv over the model group, which is why
    # k/v's input takes no copy_to_model_group (models/mixture.py)
    kv_replicated = q_all.shape[2] < cfg.num_attention_heads and k_all.shape[2] == cfg.num_key_value_heads
    attn = mot_attention(q_all, k_all, v_all, mask, cfg.attn_softclamp, kv_replicated)
    b, lq = attn.shape[:2]
    attn = attn.reshape(b, lq, -1)

    out, off = {}, 0
    for n in names:
        mcfg = cfg.mixture(n)
        lp = lps[n]
        tc = time_conds.get(n)
        ln = hiddens[n].shape[1]
        o = mx.o_proj(lp["attn"], cfg, attn[:, off : off + ln], mcfg.lora_scaling)
        off += ln
        x = hiddens[n] + mx.adaptive_scale(lp, mcfg, "post_scale", o, tc)
        h = mx.norm(lp["post_norm"], mcfg, eps, x, tc)
        h = mx.mlp(lp["mlp"], mcfg, h, mcfg.lora_scaling)
        out[n] = x + mx.adaptive_scale(lp, mcfg, "final_scale", h, tc)
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
    time_cond=None,  # adaLN: [B, Dc] for every mixture, or a dict per mixture
    final_skip: Tuple[str, ...] = ("vlm", "proprio"),
) -> Dict[str, Tensor]:
    """Full-sequence forward, no cache (training). Returns final-normed
    hidden states for every active mixture not in ``final_skip``.

    With ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
    (non-reentrant): only the layer boundaries are kept, and the backward
    pass runs each layer's forward again, the attention kernel included,
    so a forward and backward launch it 2 * L times. Under tensor
    parallelism the rerun makes the layer's forward all-reduces again;
    every rank walks the same graph, so its collectives come in one order
    on every rank of the model group."""
    names = tuple(embeds.keys())
    time_conds = _as_time_conds(time_cond, names)
    ropes = _rope_tables(cfg, names, position_ids)
    hiddens = {n: _scale_embeds(embeds[n], cfg.mixture(n).hidden_size) for n in names}

    def one_layer(hiddens, lps):
        return _layer(cfg, names, lps, hiddens, ropes, mask, time_conds)[0]

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
        out[n] = (
            mx.final_norm(mp, mcfg, cfg.rms_norm_eps, hiddens[n], time_conds.get(n))
            if mcfg.use_final_norm else hiddens[n]
        )
    return out


def joint_prefill(
    params: dict,
    cfg: JointConfig,
    embeds: Dict[str, Tensor],  # {"vlm": [B,I,Dv], "proprio": [B,P,Dp]}
    position_ids: Dict[str, Tensor],
    mask: Tensor,  # [B, 1, I+P, I+P]
    time_cond=None,
) -> Tuple[Tensor, Tensor]:
    """Run the prefix mixtures once and return stacked K/V caches
    [L, B, I+P, Hkv, Dh]."""
    names = tuple(embeds.keys())
    time_conds = _as_time_conds(time_cond, names)
    ropes = _rope_tables(cfg, names, position_ids)
    hiddens = {n: _scale_embeds(embeds[n], cfg.mixture(n).hidden_size) for n in names}
    k_cache = v_cache = None
    for i, lps in enumerate(_layer_params(params, cfg, names)):
        hiddens, (k_new, v_new) = _layer(cfg, names, lps, hiddens, ropes, mask, time_conds)
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
    time_cond=None,
) -> Tensor:
    """One denoising step of the action expert against the cached prefix.
    Returns final-normed action hiddens [B, A, Da]."""
    name = "action"
    mcfg = cfg.mixture(name)
    time_conds = _as_time_conds(time_cond, (name,))
    ropes = _rope_tables(cfg, (name,), {name: action_position_ids})
    hidden = _scale_embeds(action_embeds, mcfg.hidden_size)
    mp = _mixture_params(params, cfg, name)
    k_cache, v_cache = kv_cache
    for i, lps in enumerate(_layer_params(params, cfg, (name,))):
        new, _ = _layer(
            cfg, (name,), lps, {name: hidden}, ropes, mask, time_conds,
            cached_kv=(k_cache[i], v_cache[i]),
        )
        hidden = new[name]
    return mx.final_norm(mp, mcfg, cfg.rms_norm_eps, hidden, time_conds.get(name))


# --------------------------------------------------------------------------- #
# text generation: the vlm mixture against a static cache
# --------------------------------------------------------------------------- #


def init_text_cache(
    cfg: JointConfig, batch: int, max_len: int, dtype=torch.float32, device=None
) -> Tuple[Tensor, Tensor]:
    """Zeroed K and V caches [L, B, T_max, Hkv, Dh]."""
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim)
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def _write_at(buf: Tensor, new: Tensor, offset) -> None:
    """buf[:, offset : offset + Q] = new along the sequence axis, in place.
    ``offset`` is a Python int or a 0-d int64 device tensor, which is read
    on the device (no host sync, so a CUDA graph can hold the write)."""
    buf.index_copy_(1, offset + torch.arange(new.shape[1], device=buf.device), new)


def joint_text_forward(
    params: dict,
    cfg: JointConfig,
    embeds: Tensor,  # [B, Q, Dv]
    position_ids: Tensor,  # [B, Q]
    mask: Tensor,  # [B, 1, Q, T_max] additive fp32
    cache: Tuple[Tensor, Tensor],  # static [L, B, T_max, Hkv, Dh] each
    offset,  # a Python int or a 0-d int64 device tensor: the write index
) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """PaliGemma's text path: the vlm mixture alone, each layer's K/V
    written in place into the cache at ``offset`` (JAX's
    ``dynamic_update_slice``; ``offset + Q`` must fit in T_max), then
    attention over the whole cache under ``mask``, and the vlm final norm
    when the config has one. Returns (hidden [B, Q, Dv], the same cache)."""
    name = "vlm"
    mcfg = cfg.mixture(name)
    eps = cfg.rms_norm_eps
    cos, sin = _rope_tables(cfg, (name,), {name: position_ids})[name]
    hidden = _scale_embeds(embeds, mcfg.hidden_size)
    k_cache, v_cache = cache
    for i, lps in enumerate(_layer_params(params, cfg, (name,))):
        lp = lps[name]
        h = mx.norm(lp["input_norm"], mcfg, eps, hidden)
        q, k, v = mx.qkv_proj(lp["attn"], cfg, h, mcfg.lora_scaling)
        q, k = mx.rope_qk(q, k, cos, sin)
        # each layer's slice of the [L, ...] buffer is contiguous and
        # aligned, as the kernel needs; a view along T would not be
        _write_at(k_cache[i], k, offset)
        _write_at(v_cache[i], v, offset)
        attn = mot_attention(q, k_cache[i], v_cache[i], mask, cfg.attn_softclamp)
        b, lq = attn.shape[:2]
        x = hidden + mx.o_proj(lp["attn"], cfg, attn.reshape(b, lq, -1), mcfg.lora_scaling)
        h = mx.norm(lp["post_norm"], mcfg, eps, x)
        hidden = x + mx.mlp(lp["mlp"], mcfg, h, mcfg.lora_scaling)
    if mcfg.use_final_norm:
        hidden = mx.final_norm(_mixture_params(params, cfg, name), mcfg, eps, hidden)
    return hidden, (k_cache, v_cache)
