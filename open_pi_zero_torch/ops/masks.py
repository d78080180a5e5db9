"""Block-wise causal masks and per-mixture position ids (counterpart of the
JAX package's ``ops/masks.py``; same semantics, same layout).

Layout of the joint sequence:

    [ 0 .. I-1 ]               image+text (I = max_image_text_tokens),
                                of which only the first `cnt` are valid
    [ I ]                       proprio (cond_steps tokens)
    [ I+P .. I+P+A-1 ]          action (horizon_steps tokens)

Mask rules (additive; 0 = attend, MASK_NEG = blocked):
  - img/text rows < cnt attend to img/text cols < cnt
  - padding rows attend to nothing (all MASK_NEG; the fp32 softmax of a
    uniform row is finite, and the outputs are discarded)
  - proprio+action rows attend to img/text cols < cnt
  - proprio rows attend to proprio cols
  - action rows attend to proprio and action cols

Position ids are static (identical across the batch):
  vlm 1..I, proprio 1..P, action P+1..P+A.
"""

from __future__ import annotations

from typing import Tuple

import torch

# finite fill value: keeps the fp32 softmax NaN-free on fully masked rows
MASK_NEG = float(torch.finfo(torch.float32).min)


def build_block_causal_mask(
    image_text_cnt: torch.Tensor,  # [B] int: valid image+text tokens per sample
    max_image_text_tokens: int,
    num_proprio_tokens: int,
    num_action_tokens: int,
    dtype=torch.float32,
) -> torch.Tensor:
    """Return additive mask [B, 1, T, T], T = I + P + A."""
    total = max_image_text_tokens + num_proprio_tokens + num_action_tokens
    proprio_start = max_image_text_tokens
    action_start = max_image_text_tokens + num_proprio_tokens
    device = image_text_cnt.device

    rows = torch.arange(total, device=device)[:, None]
    cols = torch.arange(total, device=device)[None, :]
    cnt = image_text_cnt.to(torch.int64)[:, None, None]  # [B,1,1]

    row_is_valid_it = rows < cnt
    row_is_suffix = rows >= proprio_start
    row_is_action = rows >= action_start
    col_is_valid_it = cols < cnt
    col_is_proprio = (cols >= proprio_start) & (cols < action_start)
    col_is_action = cols >= action_start

    attend = (
        ((row_is_valid_it | row_is_suffix) & col_is_valid_it)
        | (row_is_suffix & col_is_proprio)
        | (row_is_action & col_is_action)
    )  # [B, T, T]
    # clamp the fill to the target dtype's own min: float32 min overflows
    # to -inf in bf16, which would NaN fully-masked rows
    neg = float(torch.finfo(dtype).min)
    zero = torch.zeros((), dtype=dtype, device=device)
    mask = torch.where(attend, zero, torch.full((), neg, dtype=dtype, device=device))
    return mask[:, None, :, :]


def split_prefix_and_action_masks(
    mask: torch.Tensor,  # [B, 1, T, T]
    max_image_text_tokens: int,
    num_proprio_tokens: int,
    num_action_tokens: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prefix_mask [B,1,I+P,I+P], action_mask [B,1,A,T]), as views."""
    prefix = max_image_text_tokens + num_proprio_tokens
    return mask[..., :prefix, :prefix], mask[..., -num_action_tokens:, :]


def vlm_position_ids(max_image_text_tokens: int, device=None) -> torch.Tensor:
    """1..I — constant regardless of padding."""
    return torch.arange(1, max_image_text_tokens + 1, dtype=torch.int32, device=device)


def proprio_position_ids(num_proprio_tokens: int, device=None) -> torch.Tensor:
    return torch.arange(1, num_proprio_tokens + 1, dtype=torch.int32, device=device)


def action_position_ids(
    num_proprio_tokens: int, num_action_tokens: int, device=None
) -> torch.Tensor:
    return torch.arange(
        num_proprio_tokens + 1,
        num_proprio_tokens + num_action_tokens + 1,
        dtype=torch.int32,
        device=device,
    )
