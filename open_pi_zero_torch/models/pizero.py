"""PiZero: the full π0 VLA model (counterpart of the JAX package's
``models/pizero.py``: init, encoders, KV-cached action inference, the
flow-matching training loss and the PaliGemma text path).

Everything is a plain function over a params tree + a static
``PiZeroConfig``. ``infer_action`` prefills the VLM/proprio prefix once
into a stacked [L, B, I+P, Hkv, Dh] K/V cache, then runs the Euler (or
midpoint) steps of the action expert against it in a Python loop.
``flow_matching_loss`` runs the whole sequence through ``joint_forward``
with no cache. With ``action_expert_adaptive_mode`` (adaLN, adaLN-Zero)
the flow time conditions the action expert's norms and gates instead of
being concatenated into the action encoder's input. ``generate_text``
decodes greedily (or top-p) against a static text cache through
``TextDecode``, whose greedy step ``models/compiled.CompiledDecode``
holds as a CUDA graph.

Param tree (the JAX package's layout, so ``params_from_jax`` is a
leaf-by-leaf copy):
  embed_tokens: [V, Dv]
  siglip: {...}                 (models/siglip.py)
  projector: {kernel, bias}
  joint: {mixtures: {vlm, action[, proprio]}}  (models/joint.py)
  action_encoder: {linear_1, linear_2, linear_3}
  proprio_encoder: {kernel, bias}
  action_decoder: {kernel, bias}
The serving layout of ``models/fuse.py`` (fused qkv and gate/up kernels,
quantized tiers) runs through the same functions; ``infer_action`` decodes
an NF4 expert once per call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from open_pi_zero_torch import resolve_device
from open_pi_zero_torch.config import PiZeroConfig
from open_pi_zero_torch.models import joint as joint_lib
from open_pi_zero_torch.models import siglip as siglip_lib
from open_pi_zero_torch.ops import lora as lora_lib
from open_pi_zero_torch.ops.embeddings import sinusoidal_time_embedding
from open_pi_zero_torch.ops.linear import linear, matmul_f32
from open_pi_zero_torch.ops.masks import (
    MASK_NEG,
    action_position_ids,
    build_block_causal_mask,
    proprio_position_ids,
    split_prefix_and_action_masks,
    vlm_position_ids,
)
from open_pi_zero_torch.ops.quantization import dequantize_kernel_nf4, int8_scale
from open_pi_zero_torch.parallel.mesh import get_mesh

Tensor = torch.Tensor


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #


class _Init:
    """Draws the params on the device with one ``torch.Generator``, with the
    JAX package's distributions (torch ``nn.Linear``/``nn.Embedding``
    defaults, zero-init Gemma norm weights). The numbers differ from JAX's:
    tests that compare the two packages copy JAX's params instead."""

    def __init__(self, seed: int, device: torch.device, dtype: torch.dtype):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device, self.dtype = device, dtype

    def uniform(self, shape, bound: float) -> Tensor:
        x = torch.empty(shape, dtype=self.dtype, device=self.device)
        return x.uniform_(-bound, bound, generator=self.gen)

    def normal(self, shape, std: float = 1.0) -> Tensor:
        x = torch.empty(shape, dtype=self.dtype, device=self.device)
        return x.normal_(0.0, std, generator=self.gen)

    def full(self, shape, value: float) -> Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)

    def linear(self, din: int, dout: int, stack: int = 0) -> dict:
        """U(+-1/sqrt(fan_in)) kernel [in, out] and bias, optionally stacked."""
        lead = (stack,) if stack else ()
        bound = 1.0 / din**0.5
        return {
            "kernel": self.uniform((*lead, din, dout), bound),
            "bias": self.uniform((*lead, dout), bound),
        }

    def lora(self, din: int, dout: int, r: int, stack: int = 0) -> dict:
        """A LoRA adapter {a, b} (``ops/lora.lora_init``) from the one generator."""
        return lora_lib.lora_init(self.gen, din, dout, r, self.dtype, stack)


def _add_adapters(init: _Init, layers: dict, dims: dict, r: int, stack: int) -> None:
    """``<name>_lora`` beside each kernel ``dims[group][name] = (in, out)``,
    in place, in JAX's key order."""
    for group, named in dims.items():
        for n, (din, dout) in named.items():
            layers[group][f"{n}_lora"] = init.lora(din, dout, r, stack)


def _init_siglip(init: _Init, cfg) -> dict:
    L, D, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    patch_in = cfg.patch_size * cfg.patch_size * cfg.num_channels
    ln = lambda: {"scale": init.full((L, D), 1.0), "bias": init.full((L, D), 0.0)}  # noqa: E731
    params = {
        "embeddings": {
            "patch": init.linear(patch_in, D),
            "position": init.normal((cfg.num_patches, D), 0.02),
        },
        "layers": {
            "ln1": ln(),
            "ln2": ln(),
            "attn": {n: init.linear(D, D, stack=L) for n in ("q", "k", "v", "o")},
            "mlp": {"fc1": init.linear(D, I, stack=L), "fc2": init.linear(I, D, stack=L)},
        },
        "post_layernorm": {"scale": init.full((D,), 1.0), "bias": init.full((D,), 0.0)},
    }
    if cfg.use_lora:  # beside every encoder projection, like the trunk's
        dims = {"attn": {n: (D, D) for n in ("q", "k", "v", "o")}, "mlp": {"fc1": (D, I), "fc2": (I, D)}}
        _add_adapters(init, params["layers"], dims, cfg.lora.r, L)
    return params


def _init_projector(init: _Init, cfg) -> dict:
    """The multimodal projector, with ``kernel_lora`` when SigLIP is LoRA."""
    params = init.linear(cfg.hidden_size, cfg.projection_dim)
    if cfg.use_lora:
        params["kernel_lora"] = init.lora(cfg.hidden_size, cfg.projection_dim, cfg.lora.r)
    return params


def _init_mixture(init: _Init, joint, mix) -> dict:
    """One mixture's params in JAX's layout and distributions: Gemma norm
    weights at 0, or adaLN norms U(+-1/sqrt(Dc)); adaLN-Zero gates with
    kernel 0 and bias -2; with ``use_lora`` an adapter beside each of q, k,
    v, o, gate, up and down."""
    L, D, I = joint.num_hidden_layers, mix.hidden_size, mix.intermediate_size
    Dc = joint.time_hidden_size
    q_out = joint.num_attention_heads * joint.head_dim
    kv_out = joint.num_key_value_heads * joint.head_dim

    def kernel(din, dout):
        return init.uniform((L, din, dout), 1.0 / din**0.5)

    def norm(*lead):
        if mix.adaptive_mode is None:
            return {"weight": init.full((*lead, D), 0.0)}
        bound = 1.0 / Dc**0.5
        return {
            "gamma_kernel": init.uniform((*lead, Dc, D), bound),
            "gamma_bias": init.uniform((*lead, D), bound),
            "beta_kernel": init.uniform((*lead, Dc, D), bound),
        }

    params = {
        "layers": {
            "input_norm": norm(L),
            "attn": {
                "q": kernel(D, q_out),
                "k": kernel(D, kv_out),
                "v": kernel(D, kv_out),
                "o": kernel(q_out, D),
            },
            "post_norm": norm(L),
            "mlp": {"gate": kernel(D, I), "up": kernel(D, I), "down": kernel(I, D)},
        }
    }
    if mix.use_lora:
        dims = {
            "attn": {"q": (D, q_out), "k": (D, kv_out), "v": (D, kv_out), "o": (q_out, D)},
            "mlp": {"gate": (D, I), "up": (D, I), "down": (I, D)},
        }
        _add_adapters(init, params["layers"], dims, mix.lora.r, L)
    if mix.adaptive_mode == "adaLN-Zero":
        for stage in ("post_scale", "final_scale"):
            params["layers"][stage] = {"kernel": init.full((L, Dc, D), 0.0), "bias": init.full((L, D), -2.0)}
    if mix.use_final_norm:
        params["final_norm"] = norm()
    return params


def init_params(
    cfg: PiZeroConfig, *, seed: int = 0, device="cuda", dtype=torch.float32
) -> dict:
    """Random params in the JAX package's tree layout, drawn on ``device``
    (CUDA by default; raises without a card unless ``device='cpu'``)."""
    return _draw_params(cfg, _Init(seed, resolve_device(device), dtype))


class _AbstractInit(_Init):
    """``_Init``'s shapes and dtypes as ``meta`` tensors: no storage, no draw."""

    def __init__(self, dtype: torch.dtype):
        self.device, self.dtype = torch.device("meta"), dtype

    def _empty(self, shape, *_) -> Tensor:
        return torch.empty(shape, dtype=self.dtype, device=self.device)

    uniform = normal = full = _empty

    def lora(self, din: int, dout: int, r: int, stack: int = 0) -> dict:
        lead = (stack,) if stack else ()
        return {"a": self._empty((*lead, din, r)), "b": self._empty((*lead, r, dout))}


def abstract_params(cfg: PiZeroConfig, dtype=torch.float32) -> dict:
    """``init_params``' tree as ``meta`` tensors: its structure, shapes and
    dtypes, for checking a loaded checkpoint, at no memory."""
    return _draw_params(cfg, _AbstractInit(dtype))


def _draw_params(cfg: PiZeroConfig, init: _Init, mixture_fn=None, siglip_fn=None) -> dict:
    """The param tree drawn from ``init``'s one generator in a fixed order:
    the token embedding, the mixtures, SigLIP, the projector, the action
    encoder, the proprio encoder, the action decoder. ``mixture_fn(name,
    params)`` and ``siglip_fn(params)`` replace each such module as soon as
    it is drawn (``models/fuse.build_serving_params``), so that its float
    copy is freed before the next one is drawn."""
    vlm_hidden = cfg.mixture("vlm").hidden_size
    action_hidden = cfg.mixture("action").hidden_size
    embed = init.normal((cfg.vocab_size, vlm_hidden))
    embed[cfg.pad_token_id] = 0.0  # nn.Embedding padding_idx row
    joint = cfg.joint
    mixtures = {}
    for n in joint.mixture_names:
        if joint_lib.param_key(joint, n) == n:
            mixtures[n] = _init_mixture(init, joint, joint.mixture(n))
            if mixture_fn is not None:
                mixtures[n] = mixture_fn(n, mixtures[n])
    siglip = _init_siglip(init, cfg.siglip)
    if siglip_fn is not None:
        siglip = siglip_fn(siglip)
    return {
        "embed_tokens": embed,
        "siglip": siglip,
        "projector": _init_projector(init, cfg.siglip),
        "joint": {"mixtures": mixtures},
        "action_encoder": {
            "linear_1": init.linear(cfg.action_dim, action_hidden),
            # the flow time is concatenated into this input unless adaLN takes it
            "linear_2": init.linear(action_hidden if cfg.action_expert_adaptive_mode else 2 * action_hidden,
                                    action_hidden),
            "linear_3": init.linear(action_hidden, action_hidden),
        },
        "proprio_encoder": init.linear(cfg.proprio_dim, cfg.mixture("proprio").hidden_size),
        "action_decoder": init.linear(action_hidden, cfg.action_dim),
    }


# --------------------------------------------------------------------------- #
# encoders
# --------------------------------------------------------------------------- #


def time_embedding(cfg: PiZeroConfig, t: Tensor, dtype) -> Tensor:
    """[B] -> [B, W]: sinusoidal flow-time embedding, W the action width, or
    ``time_hidden_size`` when adaLN conditions on it."""
    dim = cfg.time_hidden_size if cfg.action_expert_adaptive_mode else cfg.mixture("action").hidden_size
    return sinusoidal_time_embedding(t, dim, cfg.time_max_period, dtype)


def encode_action(
    params: dict, cfg: PiZeroConfig, action: Tensor, time_emb: Optional[Tensor]
) -> Tensor:
    """[B, A, act_dim] (+ [B, W] time, concatenated first; None under adaLN)
    -> [B, A, W]."""
    p = params["action_encoder"]
    emb = linear(action, p["linear_1"]["kernel"], p["linear_1"]["bias"])
    if cfg.action_expert_adaptive_mode is None:
        tfull = time_emb[:, None, :].to(emb.dtype).expand(emb.shape[0], emb.shape[1], -1)
        emb = torch.cat([tfull, emb], dim=-1)
    emb = F.silu(linear(emb, p["linear_2"]["kernel"], p["linear_2"]["bias"]))
    return linear(emb, p["linear_3"]["kernel"], p["linear_3"]["bias"])


def encode_proprio(params: dict, proprios: Tensor) -> Tensor:
    p = params["proprio_encoder"]
    return linear(proprios, p["kernel"], p["bias"])


def decode_action(params: dict, hidden: Tensor) -> Tensor:
    p = params["action_decoder"]
    return linear(hidden, p["kernel"], p["bias"])


def embed_image_text(
    params: dict, cfg: PiZeroConfig, input_ids: Tensor, pixel_values: Tensor
) -> Tensor:
    """Merge text embeddings and projected SigLIP features into one
    [B, S, Dv] sequence: the i-th image token slot receives the i-th image
    feature; padding slots are zero vectors."""
    input_ids = input_ids.long()
    text_embeds = params["embed_tokens"][input_ids]  # [B, S, Dv]
    feats = siglip_lib.forward(params["siglip"], cfg.siglip, pixel_values)
    feats = siglip_lib.project(params["projector"], feats, cfg.siglip.lora_scaling)
    vlm_hidden = cfg.mixture("vlm").hidden_size
    # a device scalar made by a fill kernel, not copied from the host (a CUDA
    # graph can hold no host copy); CUDA divides by a Python scalar through
    # its reciprocal, which rounds otherwise than JAX
    feats = feats / torch.full((), vlm_hidden**0.5, dtype=feats.dtype, device=feats.device)

    image_mask = input_ids == cfg.image_token_index  # [B, S]
    text_mask = (input_ids != cfg.image_token_index) & (input_ids != cfg.pad_token_id)
    slot = (torch.cumsum(image_mask, dim=1) - 1).clamp(0, feats.shape[1] - 1)
    img_at_slot = torch.gather(feats, 1, slot[:, :, None].expand(-1, -1, feats.shape[-1]))

    out = torch.where(image_mask[:, :, None], img_at_slot, 0.0)
    out = torch.where(text_mask[:, :, None], text_embeds, out)
    return out.to(text_embeds.dtype)


# --------------------------------------------------------------------------- #
# masks & positions
# --------------------------------------------------------------------------- #


def prepare_action_inputs(cfg: PiZeroConfig, attention_mask: Tensor):
    """attention_mask: [B, S] binary over image+text tokens -> (full_mask,
    prefix_mask, action_mask, pos_ids dict)."""
    device = attention_mask.device
    cnt = attention_mask.sum(dim=1)
    full = build_block_causal_mask(
        cnt, cfg.max_image_text_tokens, cfg.num_proprio_tokens, cfg.num_action_tokens
    )
    prefix, action = split_prefix_and_action_masks(
        full, cfg.max_image_text_tokens, cfg.num_proprio_tokens, cfg.num_action_tokens
    )
    positions = {
        "vlm": vlm_position_ids(cfg.max_image_text_tokens, device),
        "proprio": proprio_position_ids(cfg.num_proprio_tokens, device),
        "action": action_position_ids(cfg.num_proprio_tokens, cfg.num_action_tokens, device),
    }
    return full, prefix, action, positions


# --------------------------------------------------------------------------- #
# inference
# --------------------------------------------------------------------------- #


def _requant_int8(w: Tensor) -> dict:
    """fp32 [..., K, N] -> the weight-only int8 {q, scale per column} that
    ``base_matmul`` streams."""
    scale = int8_scale(w.abs().amax(dim=-2))
    q = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def _hoist_4bit(tree):
    """Every NF4 {q4, absmax} replaced by a weight-only int8 copy decoded
    once (a no-op for float, int8 and W8A8 trees): the Euler steps then
    stream int8 while the params at rest stay 4-bit. Eager PyTorch runs
    the decode once, before the loop, with no barrier needed."""
    if isinstance(tree, dict):
        if "q4" in tree and "absmax" in tree:
            return _requant_int8(dequantize_kernel_nf4(tree))
        return {k: _hoist_4bit(v) for k, v in tree.items()}
    return tree


def _time_inputs(cfg: PiZeroConfig, t: Tensor, dtype):
    """(the action encoder's time input, the action expert's adaLN cond) at
    flow times ``t`` [B]: the time embedding goes to one of the two."""
    t_emb = time_embedding(cfg, t, dtype)
    return (None, t_emb) if cfg.action_expert_adaptive_mode else (t_emb, None)


def _prefix_cond(cfg: PiZeroConfig, b: int, device, dtype) -> Optional[dict]:
    """adaLN: the proprio expert's cond at t = 0. This defines the model, so
    that the cached prefix (computed once, before any flow step) equals what
    the naive path recomputes at every step; the reference leaves the
    adaptive cached path undefined. None without adaLN."""
    if not cfg.action_expert_adaptive_mode:
        return None
    return {"proprio": time_embedding(cfg, torch.zeros((b,), dtype=dtype, device=device), dtype)}


def _noise(generator: Optional[torch.Generator], b: int, shape, device, dtype) -> Tensor:
    """Standard normal noise [b, *shape] from ``generator``. Under a
    registered mesh every rank draws the whole batch's noise (from a
    generator seeded alike on every rank) and keeps its data rank's rows, so
    the rows are those of the single-device draw."""
    mesh = get_mesh()
    n_data, row0 = (1, 0) if mesh is None else (mesh.n_data, mesh.data_index * b)
    return torch.randn((n_data * b, *shape), generator=generator, device=device, dtype=dtype)[row0 : row0 + b]


@torch.no_grad()
def infer_action(
    params: dict,
    cfg: PiZeroConfig,
    generator: Optional[torch.Generator],
    input_ids: Tensor,  # [B, S] int
    pixel_values: Tensor,  # [B, H, W, C] normalized
    attention_mask: Tensor,  # [B, S] binary (image+text valid)
    proprios: Tensor,  # [B, P, proprio_dim]
    action0: Optional[Tensor] = None,  # inject initial noise (tests/parity)
    t_start: float = 0.0,  # resume the flow from this time
    t_end: float = 1.0,  # stop early
) -> Tensor:
    """KV-cached action inference: one prefix prefill, then the flow steps.
    Returns [B, A, act_dim]. The noise comes from ``generator`` (on the
    inputs' device) unless ``action0`` is given.

    Under a registered mesh (``parallel.make_mesh``) the inputs, and an
    injected ``action0``, are this data rank's rows and the params its TP
    shard; every rank draws the whole batch's noise from its generator
    (seeded alike on every rank) and keeps its rows, so the rows of a
    sharded chunk are those of the single-device chunk of the same seed.

    ``t_start``/``t_end`` integrate a segment of the flow on the grid of the
    full run (round(num_inference_steps * (t_end - t_start)) steps)."""
    dtype = pixel_values.dtype
    device = pixel_values.device
    b = input_ids.shape[0]
    params = {**params, "joint": _hoist_4bit(params["joint"])}  # NF4: decode once per call
    _, prefix_mask, action_mask, pos = prepare_action_inputs(cfg, attention_mask)

    inputs_embeds = embed_image_text(params, cfg, input_ids, pixel_values)
    proprio_embeds = encode_proprio(params, proprios).to(dtype)
    kv_cache = joint_lib.joint_prefill(
        params["joint"],
        cfg.joint,
        {"vlm": inputs_embeds, "proprio": proprio_embeds},
        {"vlm": pos["vlm"], "proprio": pos["proprio"]},
        prefix_mask,
        time_cond=_prefix_cond(cfg, b, device, dtype),
    )

    if action0 is None:
        action0 = _noise(generator, b, (cfg.horizon_steps, cfg.action_dim), device, dtype)
    action = action0.to(device=device, dtype=dtype)
    n_steps = max(1, round(cfg.num_inference_steps * (t_end - t_start)))
    delta_t = (t_end - t_start) / n_steps

    def vel_at(action, t):
        t_emb, cond = _time_inputs(cfg, t, dtype)
        action_embeds = encode_action(params, cfg, action, t_emb)
        hidden = joint_lib.joint_action_step(
            params["joint"], cfg.joint, action_embeds, kv_cache, pos["action"], action_mask,
            time_cond=None if cond is None else {"action": cond},
        )
        return decode_action(params, hidden)

    t = torch.full((b,), t_start, dtype=dtype, device=device)
    for _ in range(n_steps):
        if cfg.flow_integrator == "midpoint":
            half = action + 0.5 * delta_t * vel_at(action, t)
            vel = vel_at(half, t + 0.5 * delta_t)
        else:
            vel = vel_at(action, t)
        action = action + delta_t * vel
        t = t + delta_t
    if t_end >= 1.0 and cfg.final_action_clip_value is not None:
        c = cfg.final_action_clip_value
        action = action.clamp(-c, c)
    return action


def renoise_chunk(
    cfg: PiZeroConfig,
    generator: Optional[torch.Generator],
    prev_chunk: Tensor,  # [B, A, act_dim]
    t_start: float,
    x0: Optional[Tensor] = None,  # inject the fresh noise (tests/parity)
) -> Tensor:
    """Re-noise a previous action chunk to flow time ``t_start`` with the
    training interpolant ``psi_t``: fresh noise x0 (from ``generator``
    unless given), the cached chunk as x1. Integrating the learned field
    from (x_t, t_start) refines the cached chunk with only (1 - t_start) of
    the velocity evals: the training-free action caching of steady-state
    control loops, where consecutive chunks are strongly correlated."""
    if x0 is None:
        x0 = _noise(generator, prev_chunk.shape[0], prev_chunk.shape[1:], prev_chunk.device, prev_chunk.dtype)
    t = torch.full((prev_chunk.shape[0],), t_start, dtype=prev_chunk.dtype, device=prev_chunk.device)
    return psi_t(cfg, x0.to(prev_chunk.dtype), prev_chunk, t)


@torch.no_grad()
def infer_action_refined(
    params: dict,
    cfg: PiZeroConfig,
    generator: Optional[torch.Generator],
    input_ids: Tensor,
    pixel_values: Tensor,
    attention_mask: Tensor,
    proprios: Tensor,
    prev_chunk: Tensor,  # [B, A, act_dim]: the previous control step's chunk
    t_start: float = 0.5,  # cache strength (higher = fewer evals)
    x0: Optional[Tensor] = None,  # inject the re-noising noise (tests/parity)
) -> Tensor:
    """Warm-start the flow from the re-noised previous chunk and integrate
    only [t_start, 1]: round(num_inference_steps * (1 - t_start)) velocity
    evals instead of num_inference_steps. The serving layer's steady-state
    tier; the first chunk of an episode runs the full flow. One noise draw
    from ``generator``: the re-noising's (the flow then starts from it)."""
    action_t = renoise_chunk(cfg, generator, prev_chunk, t_start, x0=x0)
    return infer_action(
        params, cfg, generator, input_ids, pixel_values, attention_mask, proprios,
        action0=action_t, t_start=t_start,
    )


@torch.no_grad()
def infer_action_naive(
    params: dict,
    cfg: PiZeroConfig,
    generator: Optional[torch.Generator],
    input_ids: Tensor,
    pixel_values: Tensor,
    attention_mask: Tensor,
    proprios: Tensor,
    action0: Optional[Tensor] = None,  # inject the initial noise (tests/parity)
) -> Tensor:
    """No-cache oracle: ``joint_forward`` over the whole sequence at every
    velocity eval, which computes what the cached path computes (its K/V
    cache holds the values recomputation gives). The tests bound the cached
    path's drift with it."""
    dtype = pixel_values.dtype
    device = pixel_values.device
    b = input_ids.shape[0]
    full_mask, _, _, pos = prepare_action_inputs(cfg, attention_mask)
    prefix_cond = _prefix_cond(cfg, b, device, dtype)  # as the cached path's

    inputs_embeds = embed_image_text(params, cfg, input_ids, pixel_values)
    proprio_embeds = encode_proprio(params, proprios).to(dtype)
    if action0 is None:
        action0 = _noise(generator, b, (cfg.horizon_steps, cfg.action_dim), device, dtype)
    action = action0.to(device=device, dtype=dtype)
    delta_t = 1.0 / cfg.num_inference_steps

    def vel_at(action, t):
        t_emb, cond = _time_inputs(cfg, t, dtype)
        action_embeds = encode_action(params, cfg, action, t_emb)
        hidden = joint_lib.joint_forward(
            params["joint"],
            cfg.joint,
            {"vlm": inputs_embeds, "proprio": proprio_embeds, "action": action_embeds},
            pos,
            full_mask,
            time_cond=None if cond is None else {**prefix_cond, "action": cond},
        )["action"]
        return decode_action(params, hidden)

    t = torch.zeros((b,), dtype=dtype, device=device)
    for _ in range(cfg.num_inference_steps):
        if cfg.flow_integrator == "midpoint":
            half = action + 0.5 * delta_t * vel_at(action, t)
            vel = vel_at(half, t + 0.5 * delta_t)
        else:
            vel = vel_at(action, t)
        action = action + delta_t * vel
        t = t + delta_t
    if cfg.final_action_clip_value is not None:
        c = cfg.final_action_clip_value
        action = action.clamp(-c, c)
    return action


# --------------------------------------------------------------------------- #
# flow-matching training loss
# --------------------------------------------------------------------------- #


def psi_t(cfg: PiZeroConfig, x0: Tensor, x1: Tensor, t: Tensor) -> Tensor:
    """Conditional flow interpolant (reference pizero.py:597-605)."""
    t = t[:, None, None]
    return (1 - (1 - cfg.flow_sig_min) * t) * x0 + t * x1


def flow_matching_loss(
    params: dict,
    cfg: PiZeroConfig,
    generator: Optional[torch.Generator],
    input_ids: Tensor,  # [B, S] int
    pixel_values: Tensor,  # [B, H, W, C] normalized
    attention_mask: Tensor,  # [B, S] binary
    proprios: Tensor,  # [B, P, proprio_dim]
    actions: Tensor,  # [B, A, act_dim] ground truth
    t: Tensor,  # [B] flow times in (0, 1)
    x0: Optional[Tensor] = None,  # inject the noise (tests/parity)
) -> Tensor:
    """MSE between the predicted velocity and x1 - (1-σmin)·x0 (reference
    pizero.py:607-661), no KV cache. Runs in ``pixel_values``' dtype; the
    noise comes from ``generator`` (on the inputs' device) unless ``x0`` is
    given."""
    dtype = pixel_values.dtype
    full_mask, _, _, pos = prepare_action_inputs(cfg, attention_mask)

    if x0 is None:
        x0 = torch.randn(actions.shape, generator=generator, device=t.device, dtype=t.dtype)
    x1 = actions.to(t.dtype)
    xt = psi_t(cfg, x0, x1, t).to(dtype)

    inputs_embeds = embed_image_text(params, cfg, input_ids, pixel_values)
    proprio_embeds = encode_proprio(params, proprios).to(dtype)
    # adaLN: every mixture takes the flow time t (the vlm ignores it), as in
    # the reference's training forward
    t_emb, cond = _time_inputs(cfg, t, dtype)
    action_embeds = encode_action(params, cfg, xt, t_emb)
    hidden = joint_lib.joint_forward(
        params["joint"],
        cfg.joint,
        {"vlm": inputs_embeds, "proprio": proprio_embeds, "action": action_embeds},
        pos,
        full_mask,
        time_cond=cond,
    )["action"]
    v_psi = decode_action(params, hidden).to(torch.float32)
    d_psi = (x1 - (1 - cfg.flow_sig_min) * x0).to(torch.float32)
    return torch.mean(torch.square(v_psi - d_psi))


# --------------------------------------------------------------------------- #
# text generation (the PaliGemma path)
# --------------------------------------------------------------------------- #


def lm_logits(params: dict, hidden: Tensor) -> Tensor:
    """The tied lm head: hidden [B, Q, Dv] @ embed_tokens^T -> fp32 logits
    [B, Q, V]. The table's transpose is a view: on the card the bf16 product
    reads it in place (``matmul_f32``), with no copy of the table."""
    return matmul_f32(hidden, params["embed_tokens"].t())


def _text_mask(cols: Tensor, kv_len, b: int, lq: int) -> Tensor:
    """[B, 1, Lq, T] additive fp32 mask, broadcast (no copy): 0 on the
    columns below ``kv_len`` (an int or a 0-d device tensor), MASK_NEG on
    the rest of the static cache."""
    return torch.where(cols < kv_len, 0.0, MASK_NEG).to(torch.float32).expand(b, 1, lq, -1)


def text_prefill(
    params: dict, cfg: PiZeroConfig, input_ids: Tensor, pixel_values: Tensor, cache
) -> Tensor:
    """The prompt [B, S] (image tokens, BOS, text) through the vlm trunk,
    bidirectional over the prompt, its K/V written into ``cache``
    ([L, B, T_max, Hkv, Dh] each) at [0, S). Returns the hidden states
    [B, S, Dv]."""
    embeds = embed_image_text(params, cfg, input_ids, pixel_values)
    b, s, _ = embeds.shape
    cols = torch.arange(cache[0].shape[2], device=embeds.device)
    positions = torch.arange(1, s + 1, dtype=torch.int32, device=embeds.device).expand(b, s)
    hidden, _ = joint_lib.joint_text_forward(
        params["joint"], cfg.joint, embeds, positions, _text_mask(cols, s, b, s), cache, 0
    )
    return hidden


def text_decode_step(params: dict, cfg: PiZeroConfig, cache, tok: Tensor, offset) -> Tensor:
    """One decode step: the tokens ``tok`` [B, 1] at cache slot ``offset`` (a
    Python int, or a 0-d int64 device tensor, which a CUDA graph can hold),
    attending to the slots up to and including it. Returns the next
    position's logits [B, 1, V]."""
    b = tok.shape[0]
    positions = torch.zeros((b, 1), dtype=torch.int32, device=tok.device) + offset + 1
    cols = torch.arange(cache[0].shape[2], device=tok.device)
    hidden, _ = joint_lib.joint_text_forward(
        params["joint"], cfg.joint, params["embed_tokens"][tok], positions,
        _text_mask(cols, offset + 1, b, 1), cache, offset,
    )
    return lm_logits(params, hidden)


@torch.no_grad()
def infer_text_logits(
    params: dict, cfg: PiZeroConfig, input_ids: Tensor, pixel_values: Tensor
) -> Tensor:
    """One bidirectional prefill over the prompt: fp32 logits [B, S, V] at
    every position."""
    b, s = input_ids.shape
    dtype = params["embed_tokens"].dtype
    cache = joint_lib.init_text_cache(cfg.joint, b, s, dtype, input_ids.device)
    return lm_logits(params, text_prefill(params, cfg, input_ids, pixel_values, cache))


def top_p_filter(logits: Tensor, temperature: float = 1.0, top_p: float = 1.0) -> Tensor:
    """[B, V] logits -> fp32 logits / temperature with MASK_NEG outside the
    nucleus, JAX's formulation: sorted descending, a token is kept while the
    probability mass before it (the exclusive cumulative sum) is at most
    ``top_p``, so the top token always is; the kept set is every logit at or
    above the last kept one's (a per-row threshold, no scatter back through
    the sort)."""
    logits = logits.to(torch.float32) / temperature
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    keep = (torch.cumsum(sorted_probs, dim=-1) - sorted_probs) <= top_p
    n_keep = keep.sum(dim=-1, keepdim=True)
    thresh = torch.gather(sorted_logits, -1, n_keep - 1)
    return torch.where(logits >= thresh, logits, MASK_NEG)


def sample_top_p(
    generator: torch.Generator, logits: Tensor, temperature: float = 1.0, top_p: float = 1.0
) -> Tensor:
    """[B, V] logits -> [B] ids drawn from the renormalized nucleus
    (``top_p_filter``) with ``generator``."""
    probs = torch.softmax(top_p_filter(logits, temperature, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def greedy_pick(logits: Tensor) -> Tensor:
    """[B, 1, V] logits -> [B, 1] ids: the first maximal index."""
    return logits.argmax(dim=-1)


class TextDecode:
    """The text decode of ``batch`` rows against a static cache of
    ``max_len`` slots. Its state lives in device buffers that keep their
    addresses, so that a CUDA graph can hold ``step``
    (``models/compiled.CompiledDecode``): the two caches, the token picked
    last [B, 1], the write offset and the step index (0-d int64), the done
    flags [B] and the emitted tokens [B, max_len] (step i writes column i).
    ``pick`` maps [B, 1, V] logits to [B, 1] ids."""

    def __init__(self, params: dict, cfg: PiZeroConfig, batch: int, max_len: int, eos_token_id: int = 1):
        device = params["embed_tokens"].device
        self.params, self.cfg, self.eos_token_id = params, cfg, eos_token_id
        self.cache = joint_lib.init_text_cache(cfg.joint, batch, max_len, params["embed_tokens"].dtype, device)
        index = lambda shape: torch.zeros(shape, dtype=torch.int64, device=device)  # noqa: E731
        self.tok, self.offset, self.step_index = index((batch, 1)), index(()), index(())
        self.done = torch.zeros((batch,), dtype=torch.bool, device=device)
        self.tokens = index((batch, max_len))

    @torch.no_grad()
    def prefill(self, input_ids: Tensor, pixel_values: Tensor, pick=greedy_pick) -> None:
        """The prompt [B, S] into the zeroed caches, and the state set for
        the first step: its token picked from the last position's logits,
        offset S, no row done."""
        b, s = input_ids.shape
        if b != self.tok.shape[0] or s >= self.tokens.shape[1]:
            raise ValueError(f"prompt {(b, s)}; this decode takes {self.tok.shape[0]} rows "
                             f"and fewer than {self.tokens.shape[1]} tokens")
        for c in self.cache:
            c.zero_()
        hidden = text_prefill(self.params, self.cfg, input_ids, pixel_values, self.cache)
        self.tok.copy_(pick(lm_logits(self.params, hidden[:, -1:])))
        self.offset.fill_(s)
        self.step_index.zero_()
        self.done.zero_()

    @torch.no_grad()
    def step(self, pick=greedy_pick) -> None:
        """Emits the token picked before this step (``pad_token_id`` once
        the row has emitted EOS), runs it through the trunk at the offset
        and picks the next."""
        logits = text_decode_step(self.params, self.cfg, self.cache, self.tok, self.offset)
        emitted = torch.where(self.done, self.cfg.pad_token_id, self.tok[:, 0])
        self.tokens.index_copy_(1, self.step_index.view(1), emitted[:, None])
        self.done |= self.tok[:, 0] == self.eos_token_id
        self.tok.copy_(pick(logits))
        self.offset += 1
        self.step_index += 1


@torch.no_grad()
def generate_text(
    params: dict,
    cfg: PiZeroConfig,
    input_ids: Tensor,  # [B, S] unpadded prompt (image tokens + BOS + text)
    pixel_values: Tensor,
    max_new_tokens: Optional[int] = None,
    eos_token_id: int = 1,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_p: float = 1.0,
) -> Tensor:
    """Text decoding against a static cache of S + max_new slots, eagerly
    (``TextDecode``): greedy (the first maximal index) unless a
    ``generator`` is given, then top-p sampling from it at ``temperature``
    (a generator seeded alike reproduces the sequence). Returns [B,
    max_new] ids in JAX's order: position i emits the token picked before
    step i; after EOS (which is emitted) a row emits ``pad_token_id``."""
    max_new = max_new_tokens or cfg.max_decode_tokens
    b, s = input_ids.shape
    if generator is None:
        pick = greedy_pick
    else:
        def pick(logits):
            return sample_top_p(generator, logits[:, -1], temperature, top_p)[:, None]
    state = TextDecode(params, cfg, b, s + max_new, eos_token_id)
    state.prefill(input_ids, pixel_values, pick)
    for _ in range(max_new):
        state.step(pick)
    return state.tokens[:, :max_new]
