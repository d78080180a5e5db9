"""Standalone PaliGemma (vision-language, no action expert): the facade of
the JAX package's ``models/paligemma.py``, with the reference's
``PaliGemmaForConditionalGeneration`` surface (greedy ``generate``,
``logits``).

The text path and the VLA path share one trunk (``models/joint.py``); this
module configures it as plain PaliGemma: the vlm mixture only, its final
norm on, the tied lm head. On the card ``generate`` runs the compiled
decode (``models/compiled.CompiledDecode``, one CUDA graph per batch size
and cache length, all in one pool), as the JAX facade jits
``generate_text``; on the CPU it decodes eagerly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from open_pi_zero_torch import resolve_device
from open_pi_zero_torch.config import PiZeroConfig
from open_pi_zero_torch.models import compiled, convert, pizero


def paligemma_config(base: Optional[PiZeroConfig] = None) -> PiZeroConfig:
    """``base`` (``PiZeroConfig()`` by default) specialized for text
    generation: ``use_lm_head`` and the vlm mixture's final norm."""
    cfg = base or PiZeroConfig()
    mixtures = tuple(
        dataclasses.replace(m, use_final_norm=True) if i == 0 else m
        for i, m in enumerate(cfg.joint.mixtures)
    )
    return dataclasses.replace(
        cfg, use_lm_head=True, joint=dataclasses.replace(cfg.joint, mixtures=mixtures)
    )


class PaliGemmaForConditionalGeneration:
    """Holds (cfg, params) and exposes greedy ``generate`` and ``logits`` on
    the params' device."""

    def __init__(self, cfg: PiZeroConfig, params: dict):
        self.cfg, self.params = cfg, params
        self.device = params["embed_tokens"].device
        self.dtype = params["embed_tokens"].dtype
        self._decoders = {}  # (B, T_max) -> CompiledDecode, on the card
        self._pool = None

    @classmethod
    def from_pretrained(
        cls, path: str, dtype=torch.float32, base: Optional[PiZeroConfig] = None, device="cuda"
    ) -> "PaliGemmaForConditionalGeneration":
        """A local HF PaliGemma checkout (``*.safetensors``) through the
        port's reader and ``convert_paligemma``."""
        cfg = paligemma_config(base)
        tensors = convert.load_safetensors_dir(os.path.expanduser(path))
        params = convert.convert_paligemma(tensors, cfg)
        return cls(cfg, convert.to_dtype(params, dtype, resolve_device(device)))

    @classmethod
    def init(
        cls, cfg: Optional[PiZeroConfig] = None, *, seed: int = 0, dtype=torch.float32, device="cuda"
    ) -> "PaliGemmaForConditionalGeneration":
        """Random params from ``seed`` (``pizero.init_params``)."""
        cfg = paligemma_config(cfg)
        return cls(cfg, pizero.init_params(cfg, seed=seed, device=device, dtype=dtype))

    def _inputs(self, input_ids, pixel_values):
        ids = torch.as_tensor(input_ids, device=self.device)
        return ids, torch.as_tensor(pixel_values, device=self.device).to(self.dtype)

    def generate(self, input_ids, pixel_values, max_new_tokens: int = 20) -> torch.Tensor:
        """Greedy decode of [B, S] prompts; returns [B, max_new_tokens] ids
        (pad after EOS)."""
        ids, pix = self._inputs(input_ids, pixel_values)
        if self.device.type != "cuda":
            return pizero.generate_text(self.params, self.cfg, ids, pix, max_new_tokens)
        key = (ids.shape[0], ids.shape[1] + max_new_tokens)
        if key not in self._decoders:
            decoder = compiled.CompiledDecode(
                self.params, self.cfg, *key, device=self.device, pool=self._pool
            )
            self._decoders[key], self._pool = decoder, decoder.pool
        return self._decoders[key](ids, pix, max_new_tokens)

    def logits(self, input_ids, pixel_values) -> torch.Tensor:
        """Full-sequence fp32 logits [B, S, V] (one bidirectional prefill)."""
        return pizero.infer_text_logits(self.params, self.cfg, *self._inputs(input_ids, pixel_values))
