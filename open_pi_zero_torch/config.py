"""Configs: the dataclasses that describe the π0 geometry and its
training, and the YAML config loader.

A copy of the JAX package's ``config.py``. Field names, defaults and the
``tiny_pizero_config`` / ``bridge_width_dryrun_config`` constructors are
the same, so a config built on one side describes the same model and the
same training on the other. The loader (``ConfigDict``, ``load_config``
with ``_base_`` inheritance, ``key=value`` overrides and the ``${a.b}``,
``${env:VAR,default}`` and arithmetic-only ``${eval:'...'}``
interpolations) is the JAX package's too, but it reads YAML through
``yaml_subset`` instead of PyYAML: the port imports no ``yaml``. A config
outside that subset raises with its file and line, and so does an
override value outside it (JAX takes a value that PyYAML cannot parse as
a string).
"""

from __future__ import annotations

import ast
import dataclasses
import math
import os
import re
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

from open_pi_zero_torch import yaml_subset

# --------------------------------------------------------------------------- #
# ConfigDict + YAML loading with interpolation
# --------------------------------------------------------------------------- #


class ConfigDict(dict):
    """dict with attribute access; nested dicts are wrapped lazily."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return ConfigDict(v) if isinstance(v, dict) and not isinstance(v, ConfigDict) else v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get(self, key: str, default: Any = None) -> Any:
        v = super().get(key, default)
        return ConfigDict(v) if isinstance(v, dict) and not isinstance(v, ConfigDict) else v


_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def _lookup(root: dict, dotted: str) -> Any:
    cur: Any = root
    for part in dotted.split("."):
        cur = cur[part]
    return cur


_SAFE_EVAL_NAMES = {"min": min, "max": max, "round": round, "abs": abs, "int": int,
                    "float": float, "len": len, "math": math}


def _safe_eval(expr: str) -> Any:
    """Arithmetic-only eval for ${eval:...}."""
    node = ast.parse(expr, mode="eval")
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Attribute, ast.Subscript, ast.Lambda)):
            raise ValueError(f"disallowed expression in eval resolver: {expr}")
        if isinstance(sub, ast.Call):
            if not isinstance(sub.func, ast.Name) or sub.func.id not in _SAFE_EVAL_NAMES:
                raise ValueError(f"disallowed call in eval resolver: {expr}")
    return eval(compile(node, "<cfg-eval>", "eval"), {"__builtins__": {}}, _SAFE_EVAL_NAMES)


def _resolve_value(val: Any, root: dict, depth: int = 0) -> Any:
    if depth > 32:
        raise ValueError("config interpolation too deep (cycle?)")
    if isinstance(val, str):
        # Iterate to a fixed point: the regex matches innermost ${...}
        # tokens only, so nested forms like ${eval:'x // ${bsz}'} need the
        # inner substitution first, then the (now flat) outer resolved.
        cur: Any = val
        for _ in range(32):
            if not isinstance(cur, str) or "${" not in cur:
                return cur
            m = _INTERP_RE.fullmatch(cur.strip())
            if m:  # whole-string interpolation: preserve type
                cur = _resolve_token(m.group(1), root, depth + 1)
                continue
            # partial interpolation: stringify the resolved pieces
            cur = _INTERP_RE.sub(
                lambda mm: str(_resolve_token(mm.group(1), root, depth + 1)), cur
            )
        raise ValueError(f"config interpolation did not converge: {val!r}")
    if isinstance(val, dict):
        return {k: _resolve_value(v, root, depth) for k, v in val.items()}
    if isinstance(val, list):
        return [_resolve_value(v, root, depth) for v in val]
    return val


def _resolve_token(token: str, root: dict, depth: int) -> Any:
    token = token.strip()
    if token.startswith("eval:"):
        expr = token[len("eval:"):].strip()
        if (expr.startswith("'") and expr.endswith("'")) or (
            expr.startswith('"') and expr.endswith('"')
        ):
            expr = expr[1:-1]
        # interpolations inside the expression were already substituted by
        # the caller when they appear as ${...}; resolve any that remain
        expr = _INTERP_RE.sub(lambda m: str(_resolve_token(m.group(1), root, depth + 1)), expr)
        return _safe_eval(expr)
    if token.startswith("env:") or token.startswith("oc.env:"):
        body = token.split(":", 1)[1]
        parts = [p.strip() for p in body.split(",", 1)]
        var = parts[0]
        if var in os.environ:
            return os.environ[var]
        if len(parts) == 2:
            return parts[1]
        raise KeyError(f"environment variable {var} not set and no default given")
    if token.startswith("round_up:") or token.startswith("round_down:"):
        kind, body = token.split(":", 1)
        v = float(_resolve_token(body, root, depth + 1)) if "${" in body else float(
            _INTERP_RE.sub(lambda m: str(_resolve_token(m.group(1), root, depth + 1)), body))
        return math.ceil(v) if kind == "round_up" else math.floor(v)
    val = _lookup(root, token)
    return _resolve_value(val, root, depth + 1)


def _apply_override(cfg: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    cur = cfg
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


def parse_override_value(s: str) -> Any:
    """The value of a ``key=value`` override, as YAML reads it; a value
    outside ``yaml_subset`` raises (``yaml_subset.YamlError``)."""
    return yaml_subset.parse_scalar_document(s, source=f"override value {s!r}")


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _load_raw(path: str, _seen: Optional[frozenset] = None) -> dict:
    """YAML file -> dict, honoring an optional `_base_: <relative path>` key
    (the base is loaded first, recursively, and the file deep-merged over
    it)."""
    path = os.path.abspath(path)
    seen = _seen or frozenset()
    if path in seen:
        raise ValueError(f"config _base_ cycle at {path}")
    raw = yaml_subset.load_file(path) or {}
    base_rel = raw.pop("_base_", None)
    if base_rel:
        base = _load_raw(
            os.path.join(os.path.dirname(path), str(base_rel)), seen | {path}
        )
        raw = _deep_merge(base, raw)
    return raw


def load_config(path: str, overrides: Optional[list] = None) -> ConfigDict:
    """Load a YAML config (with `_base_` inheritance), apply key=value
    overrides, resolve interpolations."""
    raw = _load_raw(path)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        k, v = ov.split("=", 1)
        _apply_override(raw, k.strip(), parse_override_value(v))
    resolved = _resolve_value(raw, raw)
    return ConfigDict(resolved)


# --------------------------------------------------------------------------- #
# Typed, hashable model configs
# --------------------------------------------------------------------------- #


@dataclass(frozen=True)
class LoraConfig:
    r: int = 32
    alpha: Optional[int] = None  # defaults to r (reference src/model/lora.py)
    dropout: float = 0.0


@dataclass(frozen=True)
class SiglipConfig:
    """SigLIP ViT tower (reference: src/model/paligemma/config.py:SiglipVisionConfig)."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_channels: int = 3
    image_size: int = 224
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    num_image_tokens: int = 256
    projection_dim: int = 2048  # multimodal projector output
    # the reference's vision tower is LoRA/quantize-configurable like the
    # trunk mixtures (config/train/bridge.yaml `vision.use_lora: ${lora}`,
    # `vision.use_quantize: ${quantize}`, siglip.py:98-106 get_layer)
    use_lora: bool = False
    use_quantize: bool = False
    lora: LoraConfig = field(default_factory=LoraConfig)

    @property
    def lora_scaling(self) -> float:
        return (self.lora.alpha / self.lora.r) if self.lora.alpha else 1.0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class MixtureConfig:
    """One expert of the mixture-of-transformers trunk
    (reference: config/train/bridge.yaml `mixture:` block)."""

    hidden_size: int
    intermediate_size: int
    use_final_norm: bool
    cache: bool
    rope_theta: float
    adaptive_mode: Optional[str] = None  # None | "adaLN" | "adaLN-Zero"
    use_lora: bool = False
    use_quantize: bool = False
    lora: LoraConfig = field(default_factory=LoraConfig)

    @property
    def lora_scaling(self) -> float:
        return (self.lora.alpha / self.lora.r) if self.lora.alpha else 1.0


@dataclass(frozen=True)
class JointConfig:
    """Mixture-agnostic trunk geometry (reference: config/train/bridge.yaml `joint:`)."""

    num_hidden_layers: int = 18
    num_attention_heads: int = 8
    num_key_value_heads: int = 1
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    attention_bias: bool = False
    attention_dropout: float = 0.0
    attn_softclamp: float = 50.0  # gemma default (reference joint_model.py:139)
    time_hidden_size: int = 256
    mixture_names: Tuple[str, ...] = ("vlm", "proprio", "action")
    mixtures: Tuple[MixtureConfig, ...] = ()
    # proprio expert shares the action expert's weights (reference
    # pizero.py:262-264 tie_action_proprio_weights; structural here)
    tie_proprio: bool = True
    # rematerialize each trunk layer in the backward pass (training-memory
    # vs FLOPs trade); read by joint_forward
    remat: bool = False

    def mixture(self, name: str) -> MixtureConfig:
        return self.mixtures[self.mixture_names.index(name)]


@dataclass(frozen=True)
class PiZeroConfig:
    """Full pi0 VLA model (reference: src/model/vla/pizero.py + bridge.yaml)."""

    vocab_size: int = 257216
    pad_token_id: int = 0
    image_token_index: int = 257152
    max_image_text_tokens: int = 276  # 256 image + <=20 text
    cond_steps: int = 1  # proprio tokens
    horizon_steps: int = 4  # action tokens
    action_dim: int = 7
    proprio_dim: int = 7
    num_inference_steps: int = 10
    final_action_clip_value: Optional[float] = 1.0
    flow_sig_min: float = 0.001
    flow_sampling: str = "beta"  # "beta" | "uniform"
    # ODE integrator for infer_action's flow (reference is Euler-only,
    # pizero.py:416-490). "midpoint" is the 2nd-order tier: 2 expert
    # evals/step, so midpoint-K costs like euler-2K but integrates the flow
    # with O(h^2) error. Parity default stays "euler" @ 10 steps.
    flow_integrator: str = "euler"  # "euler" | "midpoint"
    flow_alpha: float = 1.5
    flow_beta: float = 1.0
    time_hidden_size: int = 256
    time_max_period: float = 100.0
    action_expert_adaptive_mode: Optional[str] = None
    use_lm_head: bool = False
    max_decode_tokens: int = 64  # static text-generation KV budget
    # Euler-loop unroll factor of the JAX package's compiled loop; kept so
    # the two configs have the same fields. The port's loop is a Python
    # loop and does not read it.
    euler_unroll: Optional[int] = None
    siglip: SiglipConfig = field(default_factory=SiglipConfig)
    joint: JointConfig = field(default_factory=lambda: _default_joint())

    def __post_init__(self):
        if self.flow_integrator not in ("euler", "midpoint"):
            raise ValueError(
                f"flow_integrator must be 'euler' or 'midpoint', "
                f"got {self.flow_integrator!r}"
            )

    @property
    def num_proprio_tokens(self) -> int:
        return self.cond_steps

    @property
    def num_action_tokens(self) -> int:
        return self.horizon_steps

    @property
    def total_tokens(self) -> int:
        return self.max_image_text_tokens + self.cond_steps + self.horizon_steps

    @property
    def prefix_tokens(self) -> int:
        """image+text+proprio tokens cached during action inference."""
        return self.max_image_text_tokens + self.cond_steps

    def mixture(self, name: str) -> MixtureConfig:
        return self.joint.mixture(name)


def _default_joint(
    action_expert_rope_theta: float = 100.0,
    adaptive_mode: Optional[str] = None,
    vlm_use_final_norm: bool = False,
) -> JointConfig:
    return JointConfig(
        mixtures=(
            MixtureConfig(
                hidden_size=2048,
                intermediate_size=16384,
                use_final_norm=vlm_use_final_norm,
                cache=True,
                rope_theta=10000.0,
            ),
            MixtureConfig(
                hidden_size=1024,
                intermediate_size=4096,
                use_final_norm=True,
                cache=True,
                rope_theta=action_expert_rope_theta,
                adaptive_mode=adaptive_mode,
            ),
            MixtureConfig(
                hidden_size=1024,
                intermediate_size=4096,
                use_final_norm=True,
                cache=False,
                rope_theta=action_expert_rope_theta,
                adaptive_mode=adaptive_mode,
            ),
        )
    )


def pizero_config_from_dict(cfg: ConfigDict) -> PiZeroConfig:
    """Build a typed PiZeroConfig from a loaded YAML ConfigDict
    (schema mirrors reference config/train/bridge.yaml)."""
    vis = cfg.vision.config if "vision" in cfg else ConfigDict()
    proj = cfg.get("vision_projector", ConfigDict()).get("config", ConfigDict())
    proj_dim = (
        proj.get("vision_config", ConfigDict()).get("projection_dim", 2048)
        if proj
        else 2048
    )
    siglip = SiglipConfig(
        hidden_size=vis.get("hidden_size", 1152),
        intermediate_size=vis.get("intermediate_size", 4304),
        num_hidden_layers=vis.get("num_hidden_layers", 27),
        num_attention_heads=vis.get("num_attention_heads", 16),
        num_channels=vis.get("num_channels", 3),
        image_size=vis.get("image_size", 224),
        patch_size=vis.get("patch_size", 14),
        layer_norm_eps=float(vis.get("layer_norm_eps", 1e-6)),
        num_image_tokens=vis.get("num_image_tokens", 256),
        projection_dim=proj_dim,
        use_lora=bool(cfg.get("vision", ConfigDict()).get("use_lora", False)),
        use_quantize=bool(cfg.get("vision", ConfigDict()).get("use_quantize", False)),
        lora=LoraConfig(
            r=int(vis.get("lora", ConfigDict()).get("r", cfg.get("lora_r", 32))),
            alpha=cfg.get("lora_alpha"),
            dropout=float(
                vis.get("lora", ConfigDict()).get(
                    "dropout", cfg.get("lora_dropout", 0.0)
                )
            ),
        ),
    )
    joint_cfg = cfg.joint.config if "joint" in cfg else ConfigDict()
    mix = cfg.get("mixture", ConfigDict())
    names = tuple(mix.keys()) if mix else ("vlm", "proprio", "action")
    mixtures = []
    for name in names:
        m = mix.get(name, ConfigDict())
        mixtures.append(
            MixtureConfig(
                hidden_size=m.get("hidden_size", 1024),
                intermediate_size=m.get("intermediate_size", 4096),
                use_final_norm=bool(m.get("use_final_norm", False)),
                cache=bool(m.get("cache", False)),
                rope_theta=float(m.get("rope_theta", 10000.0)),
                adaptive_mode=m.get("adaptive_mode", None) or None,
                use_lora=bool(m.get("use_lora", False)),
                use_quantize=bool(m.get("use_quantize", False)),
                lora=LoraConfig(
                    r=int(cfg.get("lora_r", 32)),
                    alpha=cfg.get("lora_alpha"),
                    dropout=float(cfg.get("lora_dropout", 0.0)),
                ),
            )
        )
    joint = JointConfig(
        num_hidden_layers=joint_cfg.get("num_hidden_layers", 18),
        num_attention_heads=joint_cfg.get("num_attention_heads", 8),
        num_key_value_heads=joint_cfg.get("num_key_value_heads", 1),
        head_dim=joint_cfg.get("head_dim", 256),
        rms_norm_eps=float(joint_cfg.get("rms_norm_eps", 1e-6)),
        attention_bias=bool(joint_cfg.get("attention_bias", False)),
        attention_dropout=float(joint_cfg.get("attention_dropout", 0.0)),
        time_hidden_size=cfg.get("time_hidden_size", 256),
        mixture_names=names,
        mixtures=tuple(mixtures),
        remat=bool(cfg.get("remat", False)),
    )
    return PiZeroConfig(
        vocab_size=cfg.get("vocab_size", 257216),
        pad_token_id=cfg.get("pad_token_id", 0),
        image_token_index=cfg.get("image_token_index", 257152),
        max_image_text_tokens=cfg.get("max_image_text_tokens", cfg.get("max_seq_len", 276)),
        cond_steps=cfg.get("cond_steps", 1),
        horizon_steps=cfg.get("horizon_steps", 4),
        action_dim=cfg.get("action_dim", 7),
        proprio_dim=cfg.get("proprio_dim", 7),
        num_inference_steps=cfg.get("num_inference_steps", 10),
        final_action_clip_value=cfg.get("final_action_clip_value", 1.0),
        flow_sig_min=float(cfg.get("flow_sig_min", 0.001)),
        flow_sampling=cfg.get("flow_sampling", "beta"),
        flow_integrator=cfg.get("flow_integrator", "euler"),
        flow_alpha=float(cfg.get("flow_alpha", 1.5)),
        flow_beta=float(cfg.get("flow_beta", 1.0)),
        time_hidden_size=cfg.get("time_hidden_size", 256),
        time_max_period=float(cfg.get("time_max_period", 100.0)),
        action_expert_adaptive_mode=cfg.get("action_expert_adaptive_mode", None) or None,
        use_lm_head=bool(cfg.get("use_lm_head", False)),
        siglip=siglip,
        joint=joint,
    )


def training_config_from_dict(cfg: ConfigDict) -> TrainingConfig:
    """A typed TrainingConfig from a loaded config (the JAX package's
    mapping: ``quantize`` turns on the 8-bit optimizer states as well as
    the mixtures' and SigLIP's NF4 bases)."""

    def sched(d):
        d = d or ConfigDict()
        return LRSchedulerConfig(
            first_cycle_steps=int(d.get("first_cycle_steps", 10_000_000)),
            min_lr=float(d.get("min_lr", 1e-8)),
            warmup_steps=int(d.get("warmup_steps", 200)),
            cycle_mult=float(d.get("cycle_mult", 1.0)),
            gamma=float(d.get("gamma", 1.0)),
        )

    return TrainingConfig(
        global_batch_size=int(cfg.get("global_batch_size", 1024)),
        per_device_batch_size=int(cfg.get("per_device_batch_size", 16)),
        action_lr=float(cfg.get("action_lr", 5e-5)),
        vlm_lr=float(cfg.get("vlm_lr", 5e-5)),
        action_weight_decay=float(cfg.get("action_weight_decay", 0.0)),
        vlm_weight_decay=float(cfg.get("vlm_weight_decay", 0.0)),
        max_grad_norm=float(cfg.get("max_grad_norm", 1.0)),
        train_vlm=bool(cfg.get("train_vlm", True)),
        action_lr_scheduler=sched(cfg.get("action_lr_scheduler")),
        vlm_lr_scheduler=sched(cfg.get("vlm_lr_scheduler")),
        use_ema=bool(cfg.get("use_ema", False)),
        ema_decay=float(cfg.get("ema_decay", 0.99)),
        ema_start=int(cfg.get("ema_start", 0) or 0),
        ema_freq=int(cfg.get("ema_freq", 1)),
        use_swa=bool(cfg.get("use_swa", False)),
        swa_start=int(cfg.get("swa_start", 0) or 0),
        swa_freq=int(cfg.get("swa_freq", 1) or 1),
        quantize_optimizer_states=bool(cfg.get("quantize", False)),
        lora=bool(cfg.get("lora", False)),
    )


def tiny_pizero_config(**kw) -> PiZeroConfig:
    """A scaled-down config for fast tests (same topology, tiny dims)."""
    joint = JointConfig(
        num_hidden_layers=kw.pop("num_hidden_layers", 2),
        num_attention_heads=kw.pop("num_attention_heads", 4),
        num_key_value_heads=kw.pop("num_key_value_heads", 1),
        head_dim=kw.pop("head_dim", 16),
        time_hidden_size=32,
        mixtures=(
            MixtureConfig(64, 128, use_final_norm=False, cache=True, rope_theta=10000.0),
            MixtureConfig(
                32, 64, use_final_norm=True, cache=True, rope_theta=100.0,
                adaptive_mode=kw.get("action_expert_adaptive_mode"),
            ),
            MixtureConfig(
                32, 64, use_final_norm=True, cache=False, rope_theta=100.0,
                adaptive_mode=kw.get("action_expert_adaptive_mode"),
            ),
        ),
    )
    siglip = SiglipConfig(
        hidden_size=32,
        intermediate_size=64,
        num_hidden_layers=2,
        num_attention_heads=4,
        image_size=28,
        patch_size=14,
        num_image_tokens=4,
        projection_dim=64,
    )
    defaults = dict(
        vocab_size=512,
        image_token_index=500,
        max_image_text_tokens=12,
        time_hidden_size=32,
        max_decode_tokens=16,
        siglip=siglip,
        joint=joint,
    )
    defaults.update(kw)
    return PiZeroConfig(**defaults)


def bridge_width_dryrun_config() -> PiZeroConfig:
    """Full bridge WIDTHS at depth L=2: trunk 2048/16384 hidden with 8Q/1KV
    heads of dim 256, action expert 1024/4096, SigLIP 1152/4304 — every
    width at production size — while a 56px image (16 image tokens) and a
    4096 vocab keep a run cheap enough for the CPU. chip_smoke.py runs it
    on the card and on the CPU and holds the two against each other."""
    joint = dataclasses.replace(_default_joint(), num_hidden_layers=2)
    siglip = SiglipConfig(
        num_hidden_layers=2,
        image_size=56,
        num_image_tokens=16,
    )
    return PiZeroConfig(
        vocab_size=4096,
        image_token_index=4000,
        max_image_text_tokens=16 + 8,
        siglip=siglip,
        joint=joint,
    )


@dataclass(frozen=True)
class LRSchedulerConfig:
    """Cosine-annealing-with-warmup-restarts knobs (reference
    src/utils/optim.py:31; config/train/bridge.yaml `*_lr_scheduler`)."""

    first_cycle_steps: int = 10_000_000
    min_lr: float = 1e-8
    warmup_steps: int = 200
    cycle_mult: float = 1.0
    gamma: float = 1.0


@dataclass(frozen=True)
class TrainingConfig:
    """Optimization hyperparameters (reference config/train/bridge.yaml:68-86
    and src/agent/train.py:169-210). The defaults are the bridge config's."""

    global_batch_size: int = 1024
    per_device_batch_size: int = 16
    action_lr: float = 5e-5
    vlm_lr: float = 5e-5
    action_weight_decay: float = 0.0
    vlm_weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    train_vlm: bool = True
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    action_lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)
    vlm_lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)
    # model averaging (reference src/agent/model_averaging.py)
    use_ema: bool = False
    ema_decay: float = 0.99
    ema_start: int = 0
    ema_freq: int = 1
    use_swa: bool = False
    swa_start: int = 0
    swa_freq: int = 1
    # 8-bit optimizer states (reference bnb AdamW8bit; training/quantized_adam.py)
    quantize_optimizer_states: bool = False
    # LoRA fine-tune of the VLM side (reference freeze_non_lora_weights_in_vlm)
    lora: bool = False
