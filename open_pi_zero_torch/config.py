"""Typed configs: the dataclasses that describe the π0 geometry and its
training.

A copy of the typed part of the JAX package's ``config.py`` (the YAML
loader stays there: the port imports no ``yaml`` and nothing of the JAX
package). Field names, defaults and the ``tiny_pizero_config`` /
``bridge_width_dryrun_config`` constructors are the same, so a config
built on one side describes the same model and the same training on the
other.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


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
    # 8-bit optimizer states (reference bnb AdamW8bit); not ported yet
    quantize_optimizer_states: bool = False
    # LoRA fine-tune of the VLM side (reference freeze_non_lora_weights_in_vlm);
    # not ported yet
    lora: bool = False
