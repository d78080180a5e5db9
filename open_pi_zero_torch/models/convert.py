"""Checkpoint converters (counterpart of the JAX package's
``models/convert.py``): HF PaliGemma safetensors and reference VLA ``.pt``
checkpoints -> the port's param tree.

Key maps follow the reference loaders:
  - paligemma safetensors: embed_tokens / vision_tower /
    multi_modal_projector / language_model.model -> vlm
  - VLA .pt: strip torch.compile's ``_orig_mod.`` prefix; EMA checkpoints
    wrap the model as ``module.`` + ``n_averaged``

Layout conversions (torch -> here), the JAX package's:
  - nn.Linear weight [out, in]      -> kernel [in, out]       (transpose)
  - Conv2d patch embed [D, C, P, P] -> kernel [P*P*C, D]      (permute to
    the (ph, pw, c) flat order of ``models/siglip.patchify``)
  - per-layer modules               -> stacked [L, ...] tensors
  - proprio mixture                 -> dropped (tied to action)

The result is the tree ``params_from_jax`` gives for the JAX converter's
output: contiguous CPU tensors, float32 for float32 or bfloat16 inputs
(the JAX converter widens bfloat16 to float32 first); ``to_dtype`` casts
it. A source leaf is a torch tensor or anything numpy reads.
``load_safetensors_dir`` reads the safetensors format itself: the card's
machine has no ``safetensors`` package.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict

import numpy as np
import torch

from open_pi_zero_torch.config import PiZeroConfig

# the safetensors dtype names and their torch dtypes
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """One safetensors file: an 8-byte little-endian header length, a JSON
    header {name: {dtype, shape, data_offsets: [begin, end]}} (plus an
    optional ``__metadata__``), then the raw little-endian bytes, offsets
    counted from the end of the header. Each tensor is read on its own, so
    a file is never held whole in memory."""
    size = os.path.getsize(path)
    out = {}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        if size < 8 or 8 + n > size:
            raise ValueError(f"{path}: header length {n} exceeds the file")
        header = json.loads(f.read(n))
        data_size = size - 8 - n
        for name, meta in header.items():
            if name == "__metadata__":
                continue
            dtype = _SAFETENSORS_DTYPES.get(meta["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name} has dtype {meta['dtype']}, which the reader does not take")
            begin, end = meta["data_offsets"]
            shape = tuple(meta["shape"])
            count = int(np.prod(shape)) if shape else 1
            itemsize = torch.empty((), dtype=dtype).element_size()
            if not 0 <= begin <= end <= data_size or end - begin != count * itemsize:
                raise ValueError(f"{path}: {name}'s data_offsets {begin, end} do not hold {shape} {meta['dtype']}")
            f.seek(8 + n + begin)
            buf = bytearray(f.read(end - begin))  # a writable buffer the tensor owns
            t = torch.frombuffer(buf, dtype=dtype) if count else torch.empty(0, dtype=dtype)
            out[name] = t.reshape(shape)
    return out


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Read every *.safetensors file under `path` into CPU tensors."""
    tensors: Dict[str, torch.Tensor] = {}
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".safetensors"):
            tensors.update(read_safetensors(os.path.join(path, fname)))
    if not tensors:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    return tensors


def _np(x) -> torch.Tensor:
    """A source leaf as a CPU tensor, bfloat16 widened to float32."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return t.float() if t.dtype == torch.bfloat16 else t
    return torch.from_numpy(np.array(x, copy=True))


def _t(x) -> torch.Tensor:
    return _np(x).T.contiguous()


def _stack(tensors: dict, fmt: str, L: int, transpose: bool = True) -> torch.Tensor:
    mats = [_np(tensors[fmt.format(i)]) for i in range(L)]
    if transpose:
        mats = [m.T for m in mats]
    return torch.stack(mats)


# --------------------------------------------------------------------------- #
# SigLIP + projector + vlm mixture from HF PaliGemma keys
# --------------------------------------------------------------------------- #


def convert_siglip(tensors: dict, cfg: PiZeroConfig, prefix: str = "vision_tower.vision_model.") -> dict:
    L = cfg.siglip.num_hidden_layers
    p = prefix
    conv_w = _np(tensors[p + "embeddings.patch_embedding.weight"])  # [D, C, P, P]
    patch_kernel = conv_w.permute(2, 3, 1, 0).reshape(-1, conv_w.shape[0])

    def lin(name):
        return {
            "kernel": _stack(tensors, p + "encoder.layers.{}." + name + ".weight", L),
            "bias": _stack(tensors, p + "encoder.layers.{}." + name + ".bias", L, transpose=False),
        }

    def ln(name):
        return {
            "scale": _stack(tensors, p + "encoder.layers.{}." + name + ".weight", L, transpose=False),
            "bias": _stack(tensors, p + "encoder.layers.{}." + name + ".bias", L, transpose=False),
        }

    def group(named: dict) -> dict:
        """{short: hf_name} -> group dict incl. `<short>_lora` adapters when
        the checkpoint carries them (unmerged lora_A [r, in] / lora_B
        [out, r] beside each frozen .weight)."""
        out = {}
        for short, name in named.items():
            out[short] = lin(name)
            if p + "encoder.layers.0." + name + ".lora_A" in tensors:
                out[f"{short}_lora"] = {
                    "a": _stack(tensors, p + "encoder.layers.{}." + name + ".lora_A", L),
                    "b": _stack(tensors, p + "encoder.layers.{}." + name + ".lora_B", L),
                }
        return out

    return {
        "embeddings": {
            "patch": {
                "kernel": patch_kernel,
                "bias": _np(tensors[p + "embeddings.patch_embedding.bias"]),
            },
            "position": _np(tensors[p + "embeddings.position_embedding.weight"]),
        },
        "layers": {
            "ln1": ln("layer_norm1"),
            "ln2": ln("layer_norm2"),
            "attn": group({
                "q": "self_attn.q_proj",
                "k": "self_attn.k_proj",
                "v": "self_attn.v_proj",
                "o": "self_attn.out_proj",
            }),
            "mlp": group({"fc1": "mlp.fc1", "fc2": "mlp.fc2"}),
        },
        "post_layernorm": {
            "scale": _np(tensors[p + "post_layernorm.weight"]),
            "bias": _np(tensors[p + "post_layernorm.bias"]),
        },
    }


def convert_gemma_mixture(
    tensors: dict,
    cfg: PiZeroConfig,
    prefix: str,
    use_final_norm: bool,
) -> dict:
    """One mixture in PaliGemma layout (vlm from `language_model.model.`,
    or action/proprio from `joint_model.mixtures.<name>.`)."""
    L = cfg.joint.num_hidden_layers

    def lin(name):
        return _stack(tensors, prefix + "layers.{}." + name + ".weight", L)

    def norm_w(name):
        return _stack(tensors, prefix + "layers.{}." + name + ".weight", L, transpose=False)

    def has(key):
        return (prefix + "layers.0." + key) in tensors

    def adaptive_norm(name):
        """AdaptiveRMSNorm: to_gamma = Sequential(Linear, Sigmoid), to_beta =
        Linear(bias=False)."""
        return {
            "gamma_kernel": _stack(tensors, prefix + "layers.{}." + name + ".to_gamma.0.weight", L),
            "gamma_bias": _stack(tensors, prefix + "layers.{}." + name + ".to_gamma.0.bias", L, transpose=False),
            "beta_kernel": _stack(tensors, prefix + "layers.{}." + name + ".to_beta.weight", L),
        }

    adaptive = has("input_layernorm.to_gamma.0.weight")

    def norm_params(name):
        return adaptive_norm(name) if adaptive else {"weight": norm_w(name)}

    out = {
        "layers": {
            "input_norm": norm_params("input_layernorm"),
            "attn": {
                "q": lin("self_attn.q_proj"),
                "k": lin("self_attn.k_proj"),
                "v": lin("self_attn.v_proj"),
                "o": lin("self_attn.o_proj"),
            },
            "post_norm": norm_params("post_attention_layernorm"),
            "mlp": {
                "gate": lin("mlp.gate_proj"),
                "up": lin("mlp.up_proj"),
                "down": lin("mlp.down_proj"),
            },
        }
    }

    # adaLN-Zero residual gates
    for ours, theirs in (
        ("post_scale", "post_adaptive_scale"),
        ("final_scale", "final_adaptive_scale"),
    ):
        if has(theirs + ".to_adaln_zero_gamma.weight"):
            out["layers"][ours] = {
                "kernel": _stack(tensors, prefix + "layers.{}." + theirs + ".to_adaln_zero_gamma.weight", L),
                "bias": _stack(tensors, prefix + "layers.{}." + theirs + ".to_adaln_zero_gamma.bias", L, transpose=False),
            }

    # LoRA adapters: unmerged lora_A [r, in] / lora_B [out, r] next to each
    # frozen .weight; dropping them would discard the whole fine-tune
    for group, names in (
        ("attn", {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
                  "v": "self_attn.v_proj", "o": "self_attn.o_proj"}),
        ("mlp", {"gate": "mlp.gate_proj", "up": "mlp.up_proj",
                 "down": "mlp.down_proj"}),
    ):
        for short, name in names.items():
            if has(name + ".lora_A"):
                out["layers"][group][f"{short}_lora"] = {
                    "a": _stack(tensors, prefix + "layers.{}." + name + ".lora_A", L),
                    "b": _stack(tensors, prefix + "layers.{}." + name + ".lora_B", L),
                }

    if use_final_norm:
        if (prefix + "norm.to_gamma.0.weight") in tensors:
            out["final_norm"] = {
                "gamma_kernel": _t(tensors[prefix + "norm.to_gamma.0.weight"]),
                "gamma_bias": _np(tensors[prefix + "norm.to_gamma.0.bias"]),
                "beta_kernel": _t(tensors[prefix + "norm.to_beta.weight"]),
            }
        else:
            out["final_norm"] = {"weight": _np(tensors[prefix + "norm.weight"])}
    return out


def convert_paligemma(tensors: dict, cfg: PiZeroConfig) -> dict:
    """HF PaliGemma checkpoint -> partial params: {embed_tokens, siglip,
    projector, joint.mixtures.vlm}. The action expert is not in the
    paligemma checkpoint (it trains from scratch)."""
    vlm_final_norm = cfg.mixture("vlm").use_final_norm
    return {
        "embed_tokens": _np(tensors["language_model.model.embed_tokens.weight"]),
        "siglip": convert_siglip(tensors, cfg),
        "projector": {
            "kernel": _t(tensors["multi_modal_projector.linear.weight"]),
            "bias": _np(tensors["multi_modal_projector.linear.bias"]),
        },
        "joint": {
            "mixtures": {
                "vlm": convert_gemma_mixture(
                    tensors, cfg, "language_model.model.", vlm_final_norm
                )
            }
        },
    }


# --------------------------------------------------------------------------- #
# full VLA checkpoint (.pt from the reference trainer)
# --------------------------------------------------------------------------- #


def normalize_vla_state_dict(state: dict) -> dict:
    """Strip torch.compile's `_orig_mod.` and EMA/SWA AveragedModel's
    `module.` prefixes and drop bookkeeping keys."""
    out = {}
    for k, v in state.items():
        if k == "n_averaged":
            continue
        k = re.sub(r"^(module\.)?(_orig_mod\.)?", "", k)
        out[k] = v
    return out


def convert_vla_state_dict(state: dict, cfg: PiZeroConfig) -> dict:
    """Reference PiZero state dict -> the full param tree. The proprio
    mixture's tensors are ignored (identical to action via weight tying)."""
    state = normalize_vla_state_dict(state)

    def lin2(prefix):
        p = {"kernel": _t(state[prefix + ".weight"])}
        if prefix + ".bias" in state:
            p["bias"] = _np(state[prefix + ".bias"])
        return p

    params = {
        "embed_tokens": _np(state["embed_tokens.weight"]),
        "siglip": convert_siglip(state, cfg, prefix="vision_tower.vision_model."),
        "projector": lin2("multi_modal_projector.linear"),
        "joint": {
            "mixtures": {
                "vlm": convert_gemma_mixture(
                    state, cfg, "joint_model.mixtures.vlm.",
                    cfg.mixture("vlm").use_final_norm,
                ),
                "action": convert_gemma_mixture(
                    state, cfg, "joint_model.mixtures.action.",
                    cfg.mixture("action").use_final_norm,
                ),
            }
        },
        "action_encoder": {
            "linear_1": lin2("action_encoder.linear_1"),
            "linear_2": lin2("action_encoder.linear_2"),
            "linear_3": lin2("action_encoder.linear_3"),
        },
        "proprio_encoder": lin2("proprio_encoder"),
        "action_decoder": lin2("action_decoder"),
    }
    if not cfg.joint.tie_proprio:
        params["joint"]["mixtures"]["proprio"] = convert_gemma_mixture(
            state, cfg, "joint_model.mixtures.proprio.",
            cfg.mixture("proprio").use_final_norm,
        )
    return params


def load_vla_checkpoint(path: str, cfg: PiZeroConfig, dtype=torch.float32) -> dict:
    """Load a reference trainer checkpoint ({"model": state_dict, ...}) or a
    bare state dict from a torch .pt file (tensors only: ``weights_only``)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state = payload.get("model", payload) if isinstance(payload, dict) else payload
    params = convert_vla_state_dict(state, cfg)
    return to_dtype(params, dtype)


def to_dtype(params: dict, dtype, device=None) -> dict:
    """Cast every leaf to ``dtype`` (and move it to ``device``, if given).
    Quantized base dicts (QLoRA checkpoints: NF4 / int8 payloads with their
    fp32 scales) keep their dtypes, which are part of the format."""

    def walk(t):
        if isinstance(t, dict):
            if {"q4", "qa"} & set(t) or (
                "scale" in t and "q" in t and not isinstance(t["q"], dict)
            ):
                return t if device is None else {k: v.to(device) for k, v in t.items()}
            return {k: walk(v) for k, v in t.items()}
        return t.to(device=device, dtype=dtype)

    return walk(params)


def merge_pretrained(init_params: dict, pretrained: dict, dtype=None) -> dict:
    """Overlay converted pretrained subtrees onto freshly-initialized params
    (the action expert keeps its random init, like the reference's
    strict=False joint load)."""

    def overlay(base, new):
        if isinstance(new, dict):
            out = dict(base)
            for k, v in new.items():
                out[k] = overlay(base[k], v)
            return out
        arr = _np(new).to(device=base.device, dtype=dtype or base.dtype)
        if arr.shape != base.shape:
            raise ValueError(f"shape mismatch {tuple(arr.shape)} vs {tuple(base.shape)}")
        return arr

    return overlay(init_params, pretrained)
