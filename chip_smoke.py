#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (open_pi_zero_torch) on one NVIDIA card.

    python3 chip_smoke.py [--dp-layers N]

Phases, each of which raises on failure:
  1. build   — nvcc builds csrc/mot_attention.cu (K1) and
               csrc/mot_attention_bwd.cu (K1-vjp's backward kernels), and
               the host C++ compiler csrc/jpeg_codec.cc (the data
               pipeline's JPEG codec), into build/torch_kernels/, one
               compiler per source, all at once; prints each kernel
               instance's registers and spills and the card's name and
               power limit as nvidia-smi reports them
  2. kernels — the launch floor: an empty kernel's device time per
               launch and the interval between back-to-back launches. Then
               the MoT-attention kernel against its plain version on the
               card, at the main path's shapes (prefill, Euler, decode,
               the text path's generate prefill 260 x 280 and decode step
               1 x 280 with their broadcast masks, K1-shard's Euler step,
               the training shape) and edge cases (a
               fully masked row, a cluster block whose whole Lkv slice is
               masked), in bf16 (2e-2) and fp32 (1e-4), two calls bitwise
               equal; kernel, plain and library times per launch in the
               dtype of the path that runs the shape (fp32 for K1-shard's
               Euler step and training), each on one input called back to
               back, beside the bound and the launch geometry. Then the two
               backward kernels (row side, key side) against their
               arithmetic in plain PyTorch (mot_attention_bwd_ref) at the
               fp32 training shape and K1-shard's (Hq = 4), 1e-4: each
               kernel's device time per launch beside its bound, the
               reference's time and the launch geometry
  3. parity  — bridge widths at depth 2 (bridge_width_dryrun_config), fp32:
               the whole action inference on the card (kernel) against the
               CPU (plain version), max|diff| <= 1e-3
  3b. golden — the original PyTorch reference's recorded chunk
               (tests/fixtures/pizero_infer_action.npz): its state dict
               through the port's convert_vla_state_dict, fp32 on the card
               with the fixture's noise, K1 at head dim 8 (zero-padded to
               16), within the CPU replay's rtol 2e-4 / atol 2e-5
  4. main    — the main path: full-width PiZeroConfig() in bf16 with random
               weights from a seed, infer_action at B=1 twice; exactly
               L + L * steps kernel launches per chunk, bitwise-equal
               chunks; warm chunk time and peak memory; then one chunk
               under torch.profiler, with the counts set to 0 again: the
               kernel's device time summed over its launches there is the
               `ms` of the kernels line. The kernel's inputs of one more
               chunk are kept and replayed, in the main path's order,
               through the kernel (held against the plain version), the
               plain version and one library attention call, in the
               replay worker, a process of its own started before the
               build that profiles only the replays of phases 4, 8 and 11
               (the profiler loses device events in a process that has
               profiled much before): their summed
               device times are `plain_ms` and `library_ms`, the
               kernel's counted by its symbol with every launch traced,
               and the inputs' sizes give `bound_ms`
               The float chunk's kernels and copies launched, counted
               under the profiler
  4b. serving layout — from the phase-4 params, the fused bf16 tree
               (fuse_for_serving) and the production tree
               (prepare_for_serving with serving_layout_kwargs({})): fused
               qkv/gate-up, a weight-only int8 action expert, a W8A8 VLM
               trunk, bf16 SigLIP. Each driven as phase 4 drives the float
               tree (exactly L + L * steps K1 launches per chunk, two chunks
               bitwise equal, finite within the clip, warm chunk time, peak
               memory with the tree alone), then one chunk under the
               profiler: device-busy ms, kernels and copies launched, K1's
               device ms by symbol (the three eager chunks are timed in
               turns in phase 4c). The production chunk's mean L1 drift
               from the fused chunk over 3 input and noise seeds (<= 5e-3);
               the device time of the int8 -> bf16 weight copies of one
               chunk; the NF4 expert tier once (launches, time, drift); the
               production layout at bridge widths, depth 2, fp32, card vs
               CPU (<= 1e-3), with the W8A8 activations that the two sides
               rounded to different int8 values, and without W8A8
  4c. compiled — the float, fused and production chunks at B = 1 and the
               production tree's refined chunk from t = 0.5, each captured
               as one CUDA graph (models/compiled.py) in one shared pool:
               three replays bitwise equal to three eager chunks from a
               generator seeded alike; one replay under the profiler with
               every K1 launch traced by symbol (198, or 108 refined) and
               none counted by the wrapper; kernels and copies per replay
               beside the eager chunk's, device-busy ms, K1 ms, host ms per
               replay, the pool's bytes; the warm chunk of each graph and of
               its eager chunk in turns (median of TURNS, 3); then the bf16 trees
               are freed. Then a capture under the cyclic GC: a dropped
               reference cycle holding a CompiledChunk, gc.set_threshold(1,
               1, 1), another capture (tiny config): it succeeds, the cycle
               is collected, the replay is bitwise the eager chunk
  4d. adaln  — full-width PiZeroConfig() with adaLN-Zero action and
               proprio experts, bf16, B = 1: the float and production trees
               as phase 4 drives the float tree (198 K1 launches per chunk,
               bitwise chunks, warm chunk, a profiled chunk), then as CUDA
               graphs with phase 4c's checks (108 K1 refined); card vs CPU
               at bridge widths in fp32 (<= 1e-3, the gate kernels drawn
               off zero) and one fp32 training update there (phase 7's
               checks)
  4e. text   — paligemma_config(PiZeroConfig()), bf16, B = 1, on
               scripts/bench_textgen.py's prompt (S = 260, 20 new tokens, no
               EOS): the bf16 tree, the weight-only int8 VLM and the
               production tree (W8A8 VLM trunk, rows padded to 17 at
               decode). Each: the prompt's logits; an eager generate with
               L + 20 L = 378 K1 launches, its first token the logits'
               argmax; the compiled decode (models/compiled.CompiledDecode:
               one CUDA graph per decode step) bitwise the eager tokens and
               its K/V caches bitwise the eager decode's; the tied head
               allocating its output only (no copy of the 1.05 GB table);
               K1 and device-busy ms per token (a profiled compiled generate
               less its prefill), host ms per replay; then logits, prefill,
               eager and compiled generate of the three trees in turns
               (median of TURNS, 3): ms per decode token beside the byte bound
               (the trunk's and the table's bytes at 3.35 TB/s). Card vs
               CPU at bridge widths in fp32 (logits <= 1e-3, greedy tokens
               equal, eager and graph); the reference's golden text logits
               (tests/fixtures/pizero_text_logits.npz) through
               convert_paligemma and the facade on the card (rtol/atol
               2e-3, the first token the fixture's argmax)
  5. serve   — the port's serve CLI (python -m
               open_pi_zero_torch.scripts.serve) in a subprocess on a free
               port: configs/eval/bridge.yaml, --random-init, buckets 1,2,
               the production layout and refine_from_prev=0.5, its chunks
               compiled; 4 robots (a fresh request, then two that carry
               their last chunk) and one request per codec; every reply
               finite, in the clip, [4, 7]; the refined ones counted by the
               CLI, which stops cleanly on SIGINT
  6. train-kernel — the kernel's autograd Function (K1-vjp: K1 forward,
               the two backward kernels) against plain autograd through the
               plain version, at the training shape (B=16, Lq=Lkv=281, the
               training mask) and with a fully masked row: the output and
               dq, dk, dv of a random cotangent, fp32 (1e-4) and bf16
               (2e-2); two backward launches per VJP; two VJPs bitwise equal.
               The same at head dims between the kernels' sizes, which K1
               and its backward zero-pad: (B, Lq, Lkv, Hq, Hkv, D) = (2, 7,
               9, 4, 1, 8), (1, 4, 25, 4, 1, 24), and phase 8e's reach
               update (32, 29, 29, 4, 1, 24) and eval chunk (1, 4, 29, 4,
               1, 24); and at the scale-up recipe's update (32, 29, 29, 8,
               1, 32) and eval chunk (1, 4, 29, 8, 1, 32), unpadded
  7. train-parity — bridge widths at depth 2, fp32, remat on, B=2,
               grad_accum=2, injected flow times and noise, Adam eps 1e-3:
               one update on the card (kernel) against the same update on
               the CPU (plain version): loss and grad norm (relative 1e-3)
               and the updated params (max|diff| <= 1e-6). One TrainAgent
               update at configs/eval/simpler_lite.yaml's geometry (head dim
               24, zero-padded to 32), fp32, card vs CPU: loss and grad norm
               (1e-3), the params (1e-6). Then the update in the QLoRA
               recipe (NF4 vlm and SigLIP bases, LoRA adapters with B drawn
               off zero, int8 Adam moments): loss and grad norm (1e-3), the
               adapters and the action expert (1e-6), the moments' payloads
               at most one code apart but
               where a grad is rounding noise on both sides and its sign
               differs (codes -1 and +1; both counts printed), their scales
               (1e-3 relative), the NF4 bases bitwise unchanged
  8. train-main — the training path: full-width PiZeroConfig() in fp32,
               remat on, the bridge TrainingConfig, B=16 per microbatch,
               grad_accum=2, 3 updates on synthetic batches from a seed;
               exactly 3 * 2 * 2L K1 launches and 3 * 2 * L VJPs of two
               backward launches each; finite losses; every trained leaf
               changed, the frozen ones bitwise unchanged; update time and
               peak memory. The kernel's
               inputs of one update are kept and replayed as the training
               path runs them (two forwards, the second with its VJP)
               through the Function, through K1 with a backward that
               recomputes in PyTorch, through the plain version and through one
               library attention call, timed as in phase 4: `ms`,
               `backward_ms` (the backward kernels' device time by symbol),
               `recompute_ms`, `plain_ms`, `library_ms` and `bound_ms` of
               the mot_attention_vjp entry
  8a. codec  — the JPEG codec built in phase 1, on the card's host:
               bitwise the committed fixture of TensorFlow's encodes and
               decodes (tests/fixtures/jpeg_codec.npz: 224² and 256² 4:2:0
               at quality 95, 4:4:4 at 75, gray, a 37x53 noise frame), the
               decodes at both IDCTs (IFAST, the default, and ISLOW,
               dct_method INTEGER_ACCURATE, which the offline resize runs);
               the host ms per decode (each IDCT) and per encode of a 224²
               and a 256² frame (median of 50) and the 224² decodes'
               frames/s on one thread per core
  8b. train-agent — the real data workflow: a bridge-shaped RLDS dataset
               written by the port's writer as raw frames (8 episodes of
               34-42 steps, 256² JPEG image_0 of a smooth moving scene, the
               size of raw OXE bridge frames; 7-dim state and action, an
               instruction, is_first; 2 shards), resized to 224² JPEG by
               the port's scripts/modify_rlds_dataset (its seconds and
               frames/s), then the launcher
               (scripts/run.main --mode train) on configs/train/bridge.yaml
               in its QLoRA recipe (quantize, lora, remat; B=16 x 2, 3
               updates, validation at 3, a save at the end) with
               data.train.data_path there: the TrainAgent builds its
               datasets from cfg.data (the TF-free pipeline, augmentation
               on). Cut from the recipe: the dataset's size; the shuffle
               buffer 200000 -> 1000 frames; the frame-transform threads
               100 -> 2, the trajectory threads 10 -> 1 (DATA_OVERRIDES).
               Exactly 3 * 2 * 2L K1 and 3 * 2 * 2L backward launches in the
               updates, one chunk's in the validation; finite losses;
               every trained leaf changed, the NF4 bases and embed_tokens
               bitwise unchanged; the validation's l1 and accuracies; update
               time and each update's wait for its batch, peak memory, the
               tree's, optimizer state's and checkpoint's bytes, save and
               restore times; the pipeline alone (a fresh iterator's first
               batch, then frames/s through JPEG decode, resize, augment and
               batching), and the same on a PNG copy of the dataset's
               pixels. A second agent with resume_checkpoint_path=auto
               (its datasets from cfg.data too) takes ckpt_3 over a partial
               ckpt_99, restores step 3 and cnt_batch, and its update 4
               equals the first agent's on the same batch, the first of a
               fresh iterator (bitwise, or within 1e-6, said which); its
               save of ckpt_4 is skipped (the first agent's save is timed).
               scripts/serve.load_params serves ckpt_3 (merge, NF4 decode,
               production layout): one bf16 chunk, finite, in the clip,
               within the drift limit (mean L1 5e-3) of the merged float
               params' bf16 chunk
  8d. eval   — run right after 8b, in its temporary log_dir: the
               launcher (open_pi_zero_torch.scripts.run's main) evaluates
               8b's ckpt_3 with configs/eval/bridge.yaml, env.task=
               simpler_lite_reach, bf16, 3 episodes, and the keys of the
               model 8b trained (its serving layout: the production tree):
               the EvalAgent's closed loop on the port's ReachEnv, each 112²
               frame resized to 224² by the Lanczos-4 resize, FakeTokenizer.
               Every act one replay of the captured chunk (the wrapper counts
               K1 only at the capture), the first 3 in-loop chunks bitwise
               the eager chunk on their batch and noise, every chunk finite
               and in the clip; one profiled act traces 198 K1; the in-loop
               chunk latency and the host ms per chunk (resize, processor,
               postprocess, the 4 env steps). One more episode with
               refine_from_prev=0.5 on the same params: the full graph
               replays first, then the refined graph (a profiled act: 108
               K1). Card vs CPU at bridge widths, depth 2, fp32: one reach
               episode, the CPU's chunk on each card replay's noise, actions
               <= 1e-3, the same success
  8g. verify — run after 8d, in 8b's log_dir: the readiness harness
               open_pi_zero_torch/scripts/verify_checkpoint.py through its
               main on 8b's ckpt_3 at full width, fp32 (its default), with
               configs/eval/bridge.yaml and the keys of the model 8b
               trained: load (the checkpoint directory, adapters merged,
               NF4 bases decoded), oracle (the cached chunk against the
               no-cache forward), drift (the production layout against the
               fused one) PASS within the script's default bands (mean L1
               2.5e-3); refine reports its value; textgen and episodes skip
               (no lm head, no simpler_env). Each stage's seconds and
               values; K1's launches over the stages, exactly those their
               chunks take (each at the main path's shapes but the no-cache
               forward's)
  8c. train-8bit — phase 8's full fine-tune with int8 Adam moments
               (configs/train/bridge_v5e.yaml's recipe on one card), 2
               updates: finite losses, the launches, update time, peak memory
               and the optimizer state's bytes beside phase 8's
  8e. learn  — the closed-loop learning chain of
               open_pi_zero_torch/scripts/demo_closed_loop.py at its reach
               recipe's geometry (hidden 96, 3 layers, 4 Q / 1 KV heads of
               24, 56² frames, B = 32, lr 1e-3, EMA from half-way) with a
               cut run length: 24 expert demos through the port's RLDS
               writer (expert rate 1.0), 100 updates from cfg.data (every
               loss finite, the mean loss of updates 51-100 below half
               that of updates 1-50, K1 and its backward launched exactly
               L and 2 L times per update), the final checkpoint with its
               params/ export, 4 trained and 4 random-init episodes (rates
               printed, not asserted: 100 updates is before the loss
               breaks), then e2e_tier_sweep on the checkpoint with the
               fp32_fused and w8a8_default tiers, 2 episodes each; the
               update time and batch wait printed; one more update of the
               run's agent profiled (K1's and the backward kernels' device
               ms per reach-recipe update). Then its tri_lever leg: the
               three-family recipe (reach and pick_place in the bridge
               family, the drawer in the fractal one with its half-size
               coverage set, one policy with its proprio padded to 8) cut
               to 4 demos per bridge dataset, 6 drawer demos and 3
               coverage demos, 50 updates and 1 episode per scored task:
               finite losses, K1 and its backward launched exactly L and
               2 L times per update, drawer_cov trained on and not scored,
               the drawer's episode on the card through the EDR adapter
               and the bridge legs' with their proprio padded to 8, one
               rate per scored task (printed, not asserted). Phase 6
               holds K1-vjp against plain autograd at this phase's update
               and eval chunk geometries
  8f. qlora  — open_pi_zero_torch/scripts/demo_qlora_finetune.py on 8e's
               checkpoint as the base, cut short: 24 pick_place demos and
               the reach replay set at weight 0.5, 100 updates of B = 32
               with the VLM trunk and SigLIP as NF4 bases with LoRA r 16:
               the 26 NF4 payload leaves bitwise unchanged, the loss per 50
               updates falling, K1 and its backward launched exactly L and
               2 L times per update; 4 episodes per eval (new task, old
               task, the base on both; rates printed, not asserted); the
               update time printed and one more update profiled
  9. shard-kernel — K1-shard (the kernel on one rank's shard under a
               mesh) in 2 spawned ranks, mesh (data=1, model=2), the world
               that then runs phase 11 and tp-train (phase 10 runs after
               them): each rank's
               shard against the plain version on the whole inputs sliced
               to it, at the main path's prefill and Euler shapes at B=1
               and B=2, a fully masked row, bf16 (2e-2) and fp32 (1e-4);
               and the training shape in fp32 with the VJP through the
               backward kernels, two launches in each rank (dq per shard,
               dk and dv after the all-reduce over the model ranks)
 10. shard-parity — bridge widths at depth 2, fp32, B=4, injected noise,
               mesh (data=2, model=2), 4 ranks: the TP x DP chunk gathered
               to rank 0 against the CPU's single-process chunk (plain
               version), max|diff| <= 1e-3; then in the same world one
               DP x TP update (remat, EMA, B = 2, injected t and x0)
               gathered to rank 0 against the CPU's single-process update
               of the same params: loss and grad norm 1e-3 relative, params
               1e-6, K1-shard's launches one card's, the replicated leaves
               bitwise equal over each model group
 11. shard-main — the fp32 2-card TP recipe: full-width PiZeroConfig() in
               fp32, mesh (data=1, model=2), B=1. Every rank builds the
               params from seed 0 on its card; rank 0 first runs one
               unsharded chunk; then each rank keeps its shard. Exactly
               L + L * steps K1 launches per rank per chunk, all through
               K1-shard; the TP chunk against the unsharded one (<= 1e-3);
               two TP chunks bitwise equal; the backend, the ranks' cards,
               the warm chunk time (median of 5) and each rank's peak
               memory. Rank 0's K1-shard inputs of one chunk are replayed
               here, with no rank left on the card, through K1 (the
               forward K1-shard launches), the plain version and one
               library call, timed as in phase 4: `ms`, `plain_ms`,
               `library_ms` and `bound_ms` of the mot_attention_shard entry
 11b. tp-train — tensor-parallel training in the same world of 2 ranks:
               full-width PiZeroConfig() in fp32, both towers cut to 4
               layers (TP_LAYERS), remat, EMA, Adam eps 1e-3 and the full lr
               as phase 7, B = 4 x 2 injected, 3 updates. Rank 0 first takes
               them unsharded (one card's path), then both ranks take them
               on their TP shards: every rank's K1 and backward launches
               per update one card's (2 x 2 L each), every attention call
               through K1-shard; the ranks' losses and norms alike, within
               1e-3 relative of the unsharded ones, the gathered params
               within 1e-6, the replicated leaves bitwise equal. Update ms
               per rank, the model group's all-reduce ms, peak memory per
               rank; the kernels line's tp_launches_per_update. Then the
               same for configs/train/bridge.yaml's QLoRA recipe (NF4 trunk
               and SigLIP bases, LoRA r 32, int8 Adam moments) at its
               widths, depth TP_LAYERS, the same B, updates, eps and lr,
               with its own checks: the gathered adapters within 1e-6 of
               the unsharded ones, every rank's NF4 payloads bitwise as
               drawn and alike over the ranks, the int8 moments of the
               split leaves gathered whole the blockwise quantization of
               their values (every code and scale, the scales alike on
               both ranks); tp_qlora_launches_per_update
 12. dp-main — data-parallel training and ZeRO-1: configs/train/
               bridge.yaml's QLoRA recipe at full width, both towers cut to
               4 layers (DP_LAYERS; --dp-layers 0 keeps the recipe's 18 and
               27), on 2 ranks, B = 16 per rank x accumulation 2 (a global
               batch of 64), phase 8b's dataset written again, at 224².
               First one process alone takes the update of one injected
               global batch (B = 32 x 2, the recipe's first update at the
               full lr, Adam eps 1e-3 as phase 7); then each rank takes the
               same update on its rows with replicated moments and, from
               the same params, with ZeRO-1: the two bitwise equal on every
               rank (trained leaves, int8 moments and scales gathered),
               ZeRO-1's moment bytes per rank beside the replicated ones,
               rank 0's against the one process (loss and grad norm 1e-3
               relative, params 1e-6), every rank's K1 and backward launches per
               update those of one card's update (2 x 2 L each: 16 at
               depth 4). Then the TrainAgent on the 2 ranks (zero1, data
               from cfg.data, each rank its shard): 2 updates and a
               collective save of ckpt_2, a third update on a fresh
               iterator's first batch; a fresh agent resumes from ckpt_2
               (world_size 2 in its meta.json) and takes the same update:
               bitwise on every rank. Update ms per rank, the gradient
               all-reduce's ms, peak memory per rank, the save's seconds
The ranks share the one card over gloo (CUDA tensors staged through host
memory: NCCL refuses two ranks on one card); with a card per rank they
take NCCL. The run prints which.
Then one line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
Without a card, or outside a checkout, it exits non-zero before any result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from open_pi_zero_torch import config as cfg_lib
from open_pi_zero_torch import serving
from open_pi_zero_torch.agents import env_adapter
from open_pi_zero_torch.agents.eval import EvalAgent
from open_pi_zero_torch.agents.dataset import RLDSInterleavedDataset
from open_pi_zero_torch.agents.train import TrainAgent
from open_pi_zero_torch.data import images, jpeg
from open_pi_zero_torch.data import rlds as data_rlds
from open_pi_zero_torch.envs import make_env
from open_pi_zero_torch.envs.reach_env import ReachEnv
from open_pi_zero_torch.models import compiled, convert, fuse, pizero
from open_pi_zero_torch.models.paligemma import PaliGemmaForConditionalGeneration, paligemma_config
from open_pi_zero_torch.models.tree import tree_leaves, tree_map
from open_pi_zero_torch.ops import _build
from open_pi_zero_torch.ops import fused_attention as fa
from open_pi_zero_torch.ops import linear as linear_ops
from open_pi_zero_torch.ops import lora as lora_lib
from open_pi_zero_torch.ops.attention import mot_attention_ref
from open_pi_zero_torch.ops.masks import MASK_NEG
from open_pi_zero_torch.parallel import make_mesh, ranks, run_ranks, set_mesh
from open_pi_zero_torch.processing import VLAProcessor
from open_pi_zero_torch.scripts import (demo_closed_loop, demo_qlora_finetune, e2e_tier_sweep, modify_rlds_dataset,
                                        run, serve, verify_checkpoint)
from open_pi_zero_torch.training import checkpoint as ckpt_lib
from open_pi_zero_torch.training import optimizer as opt_lib
from open_pi_zero_torch.training import seeds
from open_pi_zero_torch.training import train_step
from open_pi_zero_torch.training.quantized_adam import AdamW8bit

# H100 SXM published peaks at the full 700 W limit: HBM bytes/s and dense
# bf16 tensor-core FLOP/s. fp32-accurate products run on the tensor cores
# as three TF32 products each (3xTF32, K1's route), so fp32 work is bound
# at a third of the dense TF32 peak (495 TFLOP/s), not at the 67 TFLOP/s
# of fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 495e12 / 3
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
REPLACES = "open_pi_zero_tpu/ops/pallas_attention.py:123"
REPLACES_VJP = "open_pi_zero_tpu/ops/pallas_attention.py:165"
REPLACES_SHARD = "open_pi_zero_tpu/ops/pallas_attention.py:221"
RANK_TIMEOUT_S = 600  # every collective of a spawned world
TEXT_PROMPT = 260  # scripts/bench_textgen.py's prompt: 256 image tokens, BOS, 3 text tokens
TEXT_MAX_NEW = 20  # its new tokens
KERNEL_SYMBOL = "mot_attention_fwd_kernel"  # the kernel's name in a profile
ROWS_SYMBOL = "mot_attention_bwd_rows_kernel"  # K1-vjp's backward kernels
KEYS_SYMBOL = "mot_attention_bwd_keys_kernel"
MARKERS = 128  # empty kernels before the work of a profiled window
WINDOW_TRIES = 6  # windows that profiled_window takes at most
# rounds of the phases that time chunks and generates in turns (4c, 4d, 4e)
TURNS = 3


START = time.time()


def log(msg: str) -> None:
    """One line of the run's log, after the seconds since the script's start."""
    print(f"[{time.time() - START:7.1f} s] {msg}", flush=True)


def log_build_instances(build_log: str) -> None:
    """One line per kernel instance from ptxas -v: its kernel, dtype and
    template sizes (K1: head dim and rows per block; the row side: head
    dim; the key side: D tile), registers and spills (shared memory is
    dynamic: ``fused_attention.smem_bytes``, ``bwd_smem_bytes``)."""
    name = None
    for line in build_log.splitlines():
        found = re.search(r"(mot_attention_(?:fwd|bwd_rows|bwd_keys)_kernel)I(13__nv_bfloat16|f)Li(\d+)E(?:Li(\d+)E)?",
                          line)
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            if found:
                sizes = " ".join(f"{k}={v}" for k, v in zip(("D", "rows"), found.group(3, 4)) if v)
                if found.group(1) == KEYS_SYMBOL:
                    sizes = f"d_tile={found.group(3)}"
                dtype = "bf16" if found.group(2) != "f" else "fp32"
                name = f"{found.group(1).replace('mot_attention_', '').replace('_kernel', '')} {dtype} {sizes}"
        elif name and ("spill" in line or "registers" in line):
            log(f"build: {name}: {line.replace('ptxas info    :', '').strip()}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, samples: int = 21, calls: int = 10) -> float:
    """Median over `samples` of the mean device time of `calls` back-to-back
    calls, between CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def profiled_window(fn, expected: dict, counted=None) -> tuple:
    """(got, its device events, wall ms) of one run of ``fn`` under torch.profiler:
    ``got[match]`` is (device ms, events) of the device events whose name
    contains ``match`` (all of them for None), the marker kernels left
    out. The profiler loses device events in some windows on an H100:
    mostly the first ones, more late in a process, once about half of a
    replayed training update. So ``fn`` runs after MARKERS empty kernels,
    which take the loss of a window's first events, and a window counts
    only if
    - a marker was traced (a lost prefix ended before ``fn``);
    - ``expected[match]`` events of each ``match`` were traced, where that
      is not None;
    - with ``counted``, the wrappers' (K1, backward) launch counts, set to
      0 just before ``fn``, equal it;
    - each ``match`` expected None has as many events as in an earlier
      window that passed the other checks: a window that lost events falls
      short of the other.
    One that does not count is taken again, WINDOW_TRIES times at most;
    then it raises. Host ops are not traced: turning every host op of a
    full-width update into an event took some 40 s of the host per window,
    the device events about a tenth."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", torch.cuda.current_device())
    totals = [m for m, n in expected.items() if n is None]
    passed = []  # the totals of the windows that passed the other checks
    activities = [ProfilerActivity.CUDA]
    for _ in range(WINDOW_TRIES):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(MARKERS):
                fa.empty_launch(dev)
            torch.cuda.synchronize()
            if counted is not None:
                fa.launches = fa.bwd_launches = 0
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        averages = prof.key_averages()
        events = device_events(averages)
        marker_ms, markers = device_ms(events, "opz_empty_kernel")
        got = {}
        for match in expected:
            ms, count = device_ms(events, match)
            got[match] = (ms - marker_ms, count - markers) if match is None else (ms, count)
        launched = (fa.launches, fa.bwd_launches)
        complete = (markers > 0 and all(n in (None, got[m][1]) for m, n in expected.items())
                    and counted in (None, launched))
        if complete and (not totals or [got[m][1] for m in totals] in passed):
            return got, events, wall
        if complete:
            passed.append([got[m][1] for m in totals])
        if not complete or len(passed) > 1:
            log(f"profiler: window taken again: {markers} of {MARKERS} markers traced, events "
                f"{ {m: c for m, (_, c) in got.items()} }, {expected} expected, launches counted "
                f"{launched}, {counted} expected; totals of the windows that passed {passed}")
    raise AssertionError(f"the profiler lost events in {WINDOW_TRIES} windows running")


def profiled_ms(fn, match=None, expected=None, counted=None) -> tuple:
    """(device ms, events) of ``profiled_window`` for one ``match``."""
    return profiled_window(fn, {match: expected}, counted)[0][match]


def bwd_kernel_ms(fn, calls: int) -> dict:
    """{symbol: device ms} of the two backward kernels over one run of
    ``fn``, which runs ``calls`` backwards; raises unless the wrapper
    counted and the profiler traced every launch of both."""
    got, _, _ = profiled_window(fn, {ROWS_SYMBOL: calls, KEYS_SYMBOL: calls}, counted=(0, 2 * calls))
    return {symbol: ms for symbol, (ms, _) in got.items()}


def kernel_ms(fn, calls: int) -> float:
    """K1's device time over one run of ``fn``, which launches it
    ``calls`` times, summed by the kernel's symbol; raises unless the
    wrapper counted and the profiler traced every launch."""
    return profiled_ms(fn, KERNEL_SYMBOL, expected=calls, counted=(calls, 0))[0]


def device_time_ms(fn, match=None, calls: int = 20) -> float:
    """Mean device time per call of ``fn`` under torch.profiler over
    ``calls`` calls, after a warm-up: for the kernel's symbol, K1's
    launches (every one traced), else every device event. Host time
    between launches is left out, so a kernel faster than its launch is
    timed, not the host."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(calls):
            fn()

    return (kernel_ms(run, calls) if match == KERNEL_SYMBOL else profiled_ms(run, match)[0]) / calls


def example_batch(cfg, b: int, rng) -> dict:
    """One observation per row: all image tokens, <bos> and 7 text tokens,
    the rest padding; random pixels and proprio."""
    n_img = cfg.siglip.num_image_tokens
    ids = np.zeros((b, cfg.max_image_text_tokens), np.int32)
    ids[:, :n_img] = cfg.image_token_index
    ids[:, n_img] = 2
    ids[:, n_img + 1 : n_img + 8] = 100
    size = cfg.siglip.image_size
    return {
        "input_ids": ids,
        "pixel_values": rng.uniform(-1, 1, size=(b, size, size, 3)).astype(np.float32),
        "attention_mask": (ids != cfg.pad_token_id).astype(np.int32),
        "proprios": rng.normal(size=(b, cfg.cond_steps, cfg.proprio_dim)).astype(np.float32),
    }


def run_infer(params, cfg, batch: dict, action0: np.ndarray, device, dtype):
    t = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    return pizero.infer_action(
        params, cfg, None, t["input_ids"], t["pixel_values"].to(dtype),
        t["attention_mask"], t["proprios"].to(dtype),
        action0=torch.as_tensor(action0, device=device),
    )


# --------------------------------------------------------------------------- #
# phase 2: the kernel against its plain version
# --------------------------------------------------------------------------- #


def attention_cases(dev):
    """(name, q/k/v shapes, fp32 mask, softcap): the main path's shapes with
    the main path's masks (strided views of the block-causal mask), and
    edge cases with random masks."""
    cfg = cfg_lib.PiZeroConfig()
    am = torch.zeros(2, cfg.max_image_text_tokens, dtype=torch.int32, device=dev)
    am[0, :264] = 1
    am[1, :200] = 1
    _, prefix, action, _ = pizero.prepare_action_inputs(cfg, am)
    rng = np.random.default_rng(0)

    def rand_mask(b, lq, lkv):
        m = np.where(rng.random((b, 1, lq, lkv)) > 0.3, 0.0, MASK_NEG).astype(np.float32)
        m[..., 0] = 0.0
        return torch.from_numpy(m).to(dev)

    euler = (1, 4, 281, 8, 1, 256)
    _, split = fa.launch_geometry(*euler, 2, fa.card_limits(dev))
    size = -(-281 // split)
    slice_masked = action[:1].clone()
    slice_masked[..., size : 2 * size] = MASK_NEG  # the cluster's second block sees no key
    train_am = torch.zeros(TRAIN_B, cfg.max_image_text_tokens, dtype=torch.int32, device=dev)
    for i in range(TRAIN_B):
        train_am[i, : 257 + i] = 1
    train_mask = pizero.prepare_action_inputs(cfg, train_am)[0]
    # the text path's masks are broadcast views (batch and row strides 0)
    # over the static cache: the generate prefill (S = 260 of 280 slots) and
    # a decode step that sees 270 of them
    cols = torch.arange(TEXT_PROMPT + TEXT_MAX_NEW, device=dev)
    bf16, fp32 = torch.bfloat16, torch.float32
    return [
        ("prefill", (1, 277, 277, 8, 1, 256), prefix[:1], 50.0, bf16),
        ("euler", euler, action[:1], 50.0, bf16),
        ("decode", (1, 1, 277, 8, 1, 256), rand_mask(1, 1, 277), 50.0, bf16),
        ("text_prefill", (1, TEXT_PROMPT, 280, 8, 1, 256), pizero._text_mask(cols, TEXT_PROMPT, 1, TEXT_PROMPT), 50.0,
         bf16),
        ("text_decode", (1, 1, 280, 8, 1, 256), pizero._text_mask(cols, 270, 1, 1), 50.0, bf16),
        ("shard_euler", (1, 4, 281, 4, 1, 256), action[:1], 50.0, fp32),
        ("train", (TRAIN_B, 281, 281, 8, 1, 256), train_mask, 50.0, fp32),
        ("prefill_b2", (2, 277, 277, 8, 1, 256), prefix, 50.0, bf16),
        ("multi_kv", (1, 1, 300, 8, 2, 32), rand_mask(1, 1, 300), 50.0, bf16),
        ("fully_masked", euler, torch.full((1, 1, 4, 281), MASK_NEG, device=dev), 50.0, bf16),
        ("slice_masked", euler, slice_masked, 50.0, bf16),
        ("no_softcap", euler, action[:1], None, bf16),
    ]


def bound_ms(shape, mask, dtype=torch.bfloat16) -> tuple:
    """Least time for the function in ``dtype`` on an H100: q, k, v and the
    fp32 mask read once and the output written once, over HBM;
    4*B*Hq*Lq*Lkv*D FLOP over the peak of ``dtype``. Returns (ms, "bytes" |
    "operations")."""
    t_bytes, t_ops = bound_parts(shape, mask, dtype)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mask_bytes(mask: torch.Tensor) -> int:
    """The bytes of ``mask``'s distinct elements: a broadcast view (stride 0
    along a dimension, as the text path's masks are) is read once, not once
    per batch or row."""
    return mask.element_size() * math.prod(n for n, s in zip(mask.shape, mask.stride()) if s != 0)


def bound_parts(shape, mask, dtype=torch.bfloat16) -> tuple:
    """(ms to move the bytes, ms to do the operations) of one call: q, k,
    v in ``dtype`` and the fp32 mask's distinct elements read once, the
    output written once; 4*B*Hq*Lq*Lkv*D FLOP at the peak rate of
    ``dtype``."""
    b, lq, lkv, hq, hkv, d = shape
    size = torch.finfo(dtype).bits // 8
    moved = size * (2 * b * lq * hq * d + 2 * b * lkv * hkv * d) + mask_bytes(mask)
    peak = FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    return moved / HBM_BYTES_PER_S * 1e3, 4 * b * hq * lq * lkv * d / peak * 1e3


def launch_floor(dev) -> dict:
    """The empty kernel's device time per launch (profiled over 200
    launches) and the interval between back-to-back launches (events): the
    floor under each of K1's launches."""
    from torch.profiler import ProfilerActivity, profile

    interval = time_ms(lambda: fa.empty_launch(dev), calls=100)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            fa.empty_launch(dev)
        torch.cuda.synchronize()
    ms, count = device_ms(device_events(prof.key_averages()), "opz_empty_kernel")
    return {"device_ms_per_launch": ms / count, "interval_ms": interval}


def check_kernel(dev) -> dict:
    """Each case against the plain version in fp32 and bf16, then the
    kernel's, the plain version's and the library call's time per launch in
    the case's dtype, beside the bound, the launch geometry and the
    determinism of two calls."""
    results = {}
    for name, shape, mask, softcap, time_dtype in attention_cases(dev):
        b, lq, lkv, hq, hkv, d = shape
        rng = np.random.default_rng(len(results))
        base = [
            torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
            for s in ((b, lq, hq, d), (b, lkv, hkv, d), (b, lkv, hkv, d))
        ]
        row = {"shape": shape, "softcap": softcap}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dtype) for x in base)
            got = fa.mot_attention_fused(q, k, v, mask, softcap)
            want = mot_attention_ref(q, k, v, mask, softcap)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} {dtype}: non-finite kernel output")
            err = float((got.float() - want.float()).abs().max())
            torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype],
                                       msg=lambda m: f"{name} {dtype}: {m}")
            row[f"max_abs_err_{str(dtype)[6:]}"] = err
            if not torch.equal(got, fa.mot_attention_fused(q, k, v, mask, softcap)):
                raise AssertionError(f"{name} {dtype}: two calls differ")
        # times in the dtype of the path that runs the shape
        q, k, v = (x.to(time_dtype) for x in base)
        row["time_dtype"] = str(time_dtype)[6:]
        row["rows_per_block"], row["split"] = fa.launch_geometry(*shape, q.element_size(), fa.card_limits(dev))
        row["ms"] = device_time_ms(lambda: fa.mot_attention_fused(q, k, v, mask, softcap), KERNEL_SYMBOL)
        row["plain_ms"] = device_time_ms(lambda: mot_attention_ref(q, k, v, mask, softcap))
        # yardstick: one library call of (unsoftcapped) masked attention on
        # the same inputs, heads first, K/V expanded to the query heads
        qh = q.transpose(1, 2)
        kh = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
        vh = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
        mh = mask.clamp(min=float(torch.finfo(time_dtype).min)).to(time_dtype)
        row["library_ms"] = device_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mh)
        )
        row["bound_ms"], row["bound_by"] = bound_ms(shape, mask, time_dtype)
        results[name] = row
    return results


def bwd_bound_parts(shape) -> dict:
    """(ms to move the bytes, ms to do the operations) of each backward
    kernel's work at ``shape`` in fp32, and of the whole VJP: the row side
    reads q, k, v, the mask and the cotangent and writes dq, p~ and dS
    ([B, Hkv, G Lq, Lkv] each), 6N FLOP (q k^T, g v^T, dS k); the key side
    reads p~, dS, q and the cotangent and writes dk, dv, 4N FLOP; the VJP
    reads q, k, v, the mask and the cotangent and writes dq, dk, dv, 8N
    FLOP (its scores must be recomputed or stored: q k^T is left out).
    N = B Hq Lq Lkv D, at a third of the TF32 peak (3xTF32)."""
    b, lq, lkv, hq, hkv, d = shape
    q_bytes, kv_bytes, scores = 4 * b * lq * hq * d, 4 * b * lkv * hkv * d, 4 * b * hq * lq * lkv
    n = b * hq * lq * lkv * d
    moved = {
        "rows": 3 * q_bytes + 2 * kv_bytes + scores // hq + 2 * scores,
        "keys": 2 * scores + 2 * q_bytes + 2 * kv_bytes,
        "vjp": 3 * q_bytes + 4 * kv_bytes + scores // hq,
    }
    ops = {"rows": 6 * n, "keys": 4 * n, "vjp": 8 * n}
    return {k: (moved[k] / HBM_BYTES_PER_S * 1e3, ops[k] / FP32_FLOPS * 1e3) for k in moved}


def check_bwd_kernels(dev) -> dict:
    """The backward kernels at the fp32 training shape and K1-shard's
    (Hq = 4) against their arithmetic in plain PyTorch (1e-4), then each
    kernel's device time per launch (20 back-to-back backwards, both
    kernels traced by symbol), beside its bound, the reference's time per
    backward and the launch geometry."""
    results = {}
    q8, k, v, mask, g8 = training_attention_inputs(dev, torch.float32)
    for name, hq in (("train", 8), ("shard_train", 4)):
        q, g = q8[:, :, :hq].contiguous(), g8[:, :, :hq].contiguous()
        shape = (TRAIN_B, q.shape[1], k.shape[1], hq, 1, q.shape[3])
        got = fa._launch_bwd(q, k, v, mask, 50.0, g)
        want = fa.mot_attention_bwd_ref(q, k, v, mask, 50.0, g)
        torch.cuda.synchronize()
        row = {"shape": shape}
        for part, a, b in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=lambda m, n=f"{name} {part}": f"{n}: {m}")
            row[f"max_abs_err_{part}"] = float((a - b).abs().max())
        row["row_blocks"], row["d_tile"], row["key_blocks"] = fa.bwd_launch_geometry(*shape)

        def backwards(calls=20):
            for _ in range(calls):
                fa._launch_bwd(q, k, v, mask, 50.0, g)

        backwards(3)
        per_symbol = bwd_kernel_ms(backwards, 20)
        row["rows_ms"], row["keys_ms"] = per_symbol[ROWS_SYMBOL] / 20, per_symbol[KEYS_SYMBOL] / 20
        row["plain_ms"] = device_time_ms(lambda: fa.mot_attention_bwd_ref(q, k, v, mask, 50.0, g), calls=5)
        for part, (t_bytes, t_ops) in bwd_bound_parts(shape).items():
            row[f"{part}_bound_ms"], row[f"{part}_bound_by"] = (
                (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))
        results[name] = row
    return results


# --------------------------------------------------------------------------- #
# phases 3-5
# --------------------------------------------------------------------------- #


def with_adaln(cfg):
    """``cfg`` with adaLN-Zero action and proprio experts (the vlm keeps its
    Gemma norms)."""
    mixtures = tuple(dataclasses.replace(m, adaptive_mode="adaLN-Zero") if i else m
                     for i, m in enumerate(cfg.joint.mixtures))
    return dataclasses.replace(cfg, joint=dataclasses.replace(cfg.joint, mixtures=mixtures),
                               action_expert_adaptive_mode="adaLN-Zero")


def cpu_params(cfg, seed: int = 1) -> dict:
    """fp32 params on the CPU from ``seed``; adaLN-Zero's gate kernels and
    the LoRA adapters' B, zero at init, drawn off zero so that the time
    conditioning reaches the gates and every adapter has a grad."""
    params = pizero.init_params(cfg, seed=seed, device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed)
    for mixture in params["joint"]["mixtures"].values():
        for stage in ("post_scale", "final_scale"):
            if stage in mixture["layers"]:
                mixture["layers"][stage]["kernel"].normal_(0.0, 0.05, generator=gen)
    for path, b in leaves_with_paths(params):
        if path.endswith("_lora/b"):
            b.normal_(0.0, 0.01, generator=gen)
    return params


def check_parity_with_cpu(dev, cfg=None) -> float:
    """Bridge widths, depth 2, fp32: card (kernel) vs CPU (plain version)."""
    cfg = cfg or cfg_lib.bridge_width_dryrun_config()
    params_cpu = cpu_params(cfg)
    params_dev = tree_map(lambda x: x.to(dev), params_cpu)
    rng = np.random.default_rng(1)
    batch = example_batch(cfg, 2, rng)
    batch["attention_mask"][1, 20:] = 0  # the second row is shorter
    batch["input_ids"][1, 20:] = 0
    a0 = rng.normal(size=(2, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
    before = fa.launches
    on_card = run_infer(params_dev, cfg, batch, a0, dev, torch.float32).cpu()
    if fa.launches == before:
        raise AssertionError("the card run did not launch the kernel")
    on_cpu = run_infer(params_cpu, cfg, batch, a0, "cpu", torch.float32)
    # fp32 on both sides (TF32 off): the two differ only in summation order,
    # ~1e-6 relative per op, grown through 2 layers x 10 flow steps; 1e-3
    # leaves room for that and catches any wrong mask, cast or layout
    err = float((on_card - on_cpu).abs().max())
    if not err <= 1e-3:
        raise AssertionError(f"card vs CPU max|diff| {err} > 1e-3")
    return err


def check_main_path(dev, cfg, params, samples: int = 11) -> dict:
    """Two chunks of ``params`` at B = 1 (L + L * steps K1 launches each,
    bitwise equal, finite, inside the clip), then ``samples`` warm chunks
    timed (none: ``chunk_ms`` None), the peak memory."""
    rng = np.random.default_rng(2)
    batch = example_batch(cfg, 1, rng)
    a0 = rng.normal(size=(1, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
    L = cfg.joint.num_hidden_layers
    evals = 2 if cfg.flow_integrator == "midpoint" else 1
    expected = L + L * cfg.num_inference_steps * evals

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    fa.launches = 0
    first = run_infer(params, cfg, batch, a0, dev, torch.bfloat16)
    torch.cuda.synchronize()
    launches = fa.launches
    second = run_infer(params, cfg, batch, a0, dev, torch.bfloat16)
    torch.cuda.synchronize()
    if launches != expected or fa.launches != 2 * expected:
        raise AssertionError(f"kernel launches {launches}, {fa.launches - launches}; want {expected} each")
    if tuple(first.shape) != (1, cfg.horizon_steps, cfg.action_dim):
        raise AssertionError(f"chunk shape {tuple(first.shape)}")
    clip = cfg.final_action_clip_value
    if not (torch.isfinite(first).all() and first.abs().max() <= clip):
        raise AssertionError("chunk not finite or outside the clip")
    if not torch.equal(first, second):
        raise AssertionError("two runs with the same noise differ")
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        run_infer(params, cfg, batch, a0, dev, torch.bfloat16)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    return {
        "launches": launches,
        "chunk_ms": statistics.median(times) if times else None,
        "peak_mem_gb": peak / 1e9,
        # the params' own bytes plus the chunk's peak above what was resident:
        # the peak with this tree alone on the card
        "alone_peak_mem_gb": (tree_bytes(params) + peak - resident) / 1e9,
        "chunk": first.float().cpu().numpy().round(4).tolist(),
    }


def tree_bytes(tree) -> int:
    """Bytes of a param tree's tensors, each storage counted once."""
    storages = {x.untyped_storage().data_ptr(): x.untyped_storage().nbytes() for x in tree_leaves(tree)}
    return sum(storages.values())


# --------------------------------------------------------------------------- #
# phase 4b: the serving layout
# --------------------------------------------------------------------------- #

DRIFT_SEEDS = 3
DRIFT_LIMIT = 5e-3  # mean L1 of the production chunk against the fused bf16 chunk


def drift_chunks(dev, cfg, params, seeds) -> np.ndarray:
    """The chunks of ``params`` for input and noise seeds ``seeds``."""
    out = []
    for seed in seeds:
        rng = np.random.default_rng(100 + seed)
        batch = example_batch(cfg, 1, rng)
        a0 = rng.normal(size=(1, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
        out.append(run_infer(params, cfg, batch, a0, dev, torch.bfloat16).float().cpu().numpy())
    return np.stack(out)


def int8_copy_ms(cfg, params) -> float:
    """Device ms of the bf16 copies that the weight-only int8 tier makes in
    one chunk: each int8 payload of the action expert (which the proprio
    token shares at prefill) cast to bf16 once per pass, 1 + steps passes.
    The copies alone under the profiler (``profiled_window``, every copy
    traced): launched one by one they keep the host busier than the card,
    so CUDA events would time the host."""
    layers = params["joint"]["mixtures"]["action"]["layers"]
    payloads = [d["q"] for group in ("attn", "mlp") for d in layers[group].values() if "q" in d]
    views = [x for q in payloads for x in q.unbind(0)]  # one per layer, as the path takes them
    passes = 1 + cfg.num_inference_steps

    def copies():
        for _ in range(passes):
            for x in views:
                x.to(torch.bfloat16)

    copies()
    got, _, _ = profiled_window(copies, {None: passes * len(views)}, counted=(0, 0))
    return got[None][0]


def check_parity_with_cpu_serving(dev) -> dict:
    """Bridge widths, depth 2, fp32, the production layout: card (kernel,
    cuBLAS's int8 and fp32 products) vs CPU (plain version), and the
    activations that the two sides' per-token quantization rounded to
    different int8 values; the same layout without W8A8 vs the CPU, for
    the gap that W8A8 does not explain."""
    cfg = cfg_lib.bridge_width_dryrun_config()
    float_cpu = pizero.init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    layouts = {"production": fuse.serving_layout_kwargs({}), "without_w8a8": fuse.serving_layout_kwargs({"w8a8": False})}
    rng = np.random.default_rng(12)
    batch = example_batch(cfg, 2, rng)
    batch["attention_mask"][1, 20:] = 0  # the second row is shorter
    batch["input_ids"][1, 20:] = 0
    a0 = rng.normal(size=(2, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
    quantize = linear_ops.quantize_act_per_token
    recorded = {"card": [], "cpu": []}  # per call: (x / scale, the int8 values), production only

    def recording(side):
        def run(x):
            q, scale = quantize(x)
            recorded[side].append(((x.float() / scale).cpu(), q.cpu()))
            return q, scale
        return run

    out = {}
    for name, knobs in layouts.items():
        params_cpu = fuse.prepare_for_serving(float_cpu, **knobs)
        params_dev = tree_map(lambda x: x.to(dev), params_cpu)
        before = fa.launches
        try:
            if name == "production":
                linear_ops.quantize_act_per_token = recording("card")
            on_card = run_infer(params_dev, cfg, batch, a0, dev, torch.float32).cpu()
            if fa.launches == before:
                raise AssertionError("the card run did not launch the kernel")
            if name == "production":
                linear_ops.quantize_act_per_token = recording("cpu")
            on_cpu = run_infer(params_cpu, cfg, batch, a0, "cpu", torch.float32)
        finally:
            linear_ops.quantize_act_per_token = quantize
        out[f"{name}_max_abs_diff"] = float((on_card - on_cpu).abs().max())
        del params_cpu, params_dev
    # as phase 3: fp32 on both sides; the int8 products are exact, the
    # per-token quantization is the same IEEE arithmetic, and an activation
    # that the sums' order moves across an int8 rounding boundary moves its
    # output by one step of its scale, far below 1e-3
    err = out["production_max_abs_diff"]
    if not err <= 1e-3:
        raise AssertionError(f"serving layout: card vs CPU max|diff| {err} > 1e-3")
    if len(recorded["card"]) != len(recorded["cpu"]) or not recorded["card"]:
        raise AssertionError(f"W8A8 activations quantized {len(recorded['card'])} times on the card, "
                             f"{len(recorded['cpu'])} on the CPU")
    flipped, first = [], None  # per call; a flip moves the inputs of the calls after it
    for call, ((u_card, q_card), (u_cpu, q_cpu)) in enumerate(zip(recorded["card"], recorded["cpu"])):
        differ = q_card != q_cpu
        flipped.append(int(differ.sum()))
        if first is None and differ.any():
            at = tuple(int(i) for i in differ.nonzero()[0])
            first = {"call": call, "index": at, "card": [float(u_card[at]), int(q_card[at])],
                     "cpu": [float(u_cpu[at]), int(q_cpu[at])]}
    out["w8a8_activations"] = {
        "calls": len(recorded["card"]), "elements": sum(q.numel() for _, q in recorded["card"]),
        "flipped_per_call": flipped, "first_flip": first,  # x / scale and its int8 value on each side
    }
    return out


def check_serving_layout(dev, cfg, params, info: str) -> tuple:
    """Phase 4b: the fused bf16 tree and the production tree (int8 action
    expert, W8A8 VLM trunk, bf16 SigLIP) from the phase-4 params, each
    driven as phase 4 drives the float tree; the production chunk's drift
    from the fused one; the NF4 expert tier once; the production layout
    card vs CPU at bridge widths. Returns (results, the fused and production
    trees)."""
    t0 = time.time()
    knobs = fuse.serving_layout_kwargs({})  # the production defaults
    trees = {"fused": fuse.fuse_for_serving(params), "production": fuse.prepare_for_serving(params, **knobs)}
    torch.cuda.synchronize()
    log(f"serving-layout: fused and production trees built in {time.time() - t0:.1f} s; "
        f"{ {k: round(tree_bytes(v) / 1e9, 3) for k, v in trees.items()} } GB")
    L = cfg.joint.num_hidden_layers
    expected = L + L * cfg.num_inference_steps
    results = {}
    for name, tree in trees.items():
        row = check_main_path(dev, cfg, tree)  # 198 launches, bitwise chunks, clip, latency, memory
        row.update(profile_chunk(dev, cfg, tree, expected, label=f"profile {name}"))
        row["tree_gb"] = tree_bytes(tree) / 1e9
        results[name] = row
        log(f"serving-layout {name}: warm chunk {row['chunk_ms']:.3f} ms (median of 11), {row['launches']} K1 "
            f"launches, {row['kernels_per_chunk']} kernels and {row['copies_per_chunk']} copies per chunk, device "
            f"busy {row['busy_ms']:.3f} ms of a profiled {row['wall_ms']:.3f} ms, K1 {row['ms']:.3f} ms; tree {row['tree_gb']:.3f} GB, peak with "
            f"the tree alone {row['alone_peak_mem_gb']:.3f} GB, on {info}")
    fused_chunks = drift_chunks(dev, cfg, trees["fused"], range(DRIFT_SEEDS))
    prod_chunks = drift_chunks(dev, cfg, trees["production"], range(DRIFT_SEEDS))
    drift = float(np.abs(prod_chunks - fused_chunks).mean())
    results["production"]["drift_per_seed"] = np.abs(prod_chunks - fused_chunks).mean(axis=(1, 2, 3)).tolist()
    results["production"]["drift"] = drift
    if not drift <= DRIFT_LIMIT:
        raise AssertionError(f"production chunk drift {drift} from the fused bf16 chunk > {DRIFT_LIMIT}")
    results["production"]["int8_copy_ms"] = int8_copy_ms(cfg, trees["production"])

    nf4 = fuse.prepare_for_serving(params, **{**knobs, "bits": 4})
    fa.launches = 0
    nf4_chunk = drift_chunks(dev, cfg, nf4, range(1))  # the first call
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    drift_chunks(dev, cfg, nf4, range(1))
    torch.cuda.synchronize()
    results["nf4_expert"] = {
        "launches_per_chunk": fa.launches // 2, "chunk_ms": (time.perf_counter() - t1) * 1e3,
        "tree_gb": tree_bytes(nf4) / 1e9, "drift": float(np.abs(nf4_chunk - fused_chunks[:1]).mean()),
    }
    if results["nf4_expert"]["launches_per_chunk"] != expected or not np.isfinite(nf4_chunk).all():
        raise AssertionError(f"NF4 tier: {results['nf4_expert']}")
    del nf4
    results["parity"] = check_parity_with_cpu_serving(dev)
    return results, trees


# --------------------------------------------------------------------------- #
# phase 3b: the reference's golden chunk, through the port's converter
# --------------------------------------------------------------------------- #

GOLDEN_FIXTURE = "tests/fixtures/pizero_infer_action.npz"
GOLDEN_RTOL, GOLDEN_ATOL = 2e-4, 2e-5  # the CPU replay's (tests/test_torch_golden.py)


def golden_config() -> cfg_lib.PiZeroConfig:
    """The geometry the fixture was recorded at (the parity suite's,
    tests/test_reference_parity_pizero.py): head dim 8, which K1's wrapper
    zero-pads to 16, and a proprio expert of its own."""
    mix = cfg_lib.MixtureConfig  # hidden, intermediate, final norm, cache, rope theta
    joint = cfg_lib.JointConfig(
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1, head_dim=8, time_hidden_size=16,
        mixtures=(mix(32, 64, False, True, 10000.0), mix(16, 32, True, True, 100.0), mix(16, 32, True, False, 100.0)),
        tie_proprio=False,
    )
    siglip = cfg_lib.SiglipConfig(hidden_size=24, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
                                  image_size=28, patch_size=14, num_image_tokens=4, projection_dim=32)
    return cfg_lib.PiZeroConfig(
        vocab_size=64, pad_token_id=0, image_token_index=50, max_image_text_tokens=7, cond_steps=1,
        horizon_steps=4, action_dim=3, proprio_dim=5, num_inference_steps=2, final_action_clip_value=1.0,
        flow_sig_min=0.001, time_hidden_size=16, time_max_period=100.0, siglip=siglip, joint=joint,
    )


def check_golden(dev) -> dict:
    """The original PyTorch reference's recorded chunk: its state dict
    through the port's convert_vla_state_dict, fp32 on the card with the
    fixture's noise; K1 (head dim 8, zero-padded) in every layer."""
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), GOLDEN_FIXTURE)) as z:
        payload = {k: z[k] for k in z.files}
    state = {k[len("state/"):]: v for k, v in payload.items() if k.startswith("state/")}
    cfg = golden_config()
    params = convert.to_dtype(convert.convert_vla_state_dict(state, cfg), torch.float32, dev)
    fa.launches = 0
    got = pizero.infer_action(
        params, cfg, None,
        torch.as_tensor(payload["ids"].astype(np.int32), device=dev),
        torch.as_tensor(np.ascontiguousarray(payload["pix"].transpose(0, 2, 3, 1)), device=dev),  # NHWC
        torch.as_tensor(payload["am"].astype(np.int32), device=dev),
        torch.as_tensor(payload["prop"], device=dev),
        action0=torch.as_tensor(payload["a0"], device=dev),
    ).cpu().numpy()
    L = cfg.joint.num_hidden_layers
    if fa.launches != L + L * cfg.num_inference_steps:
        raise AssertionError(f"golden: {fa.launches} K1 launches")
    want = payload["want"]
    err = float(np.abs(got - want).max())
    excess = float((np.abs(got - want) - (GOLDEN_ATOL + GOLDEN_RTOL * np.abs(want))).max())
    if not excess <= 0:
        raise AssertionError(f"golden chunk on the card: max|diff| {err}, outside rtol {GOLDEN_RTOL} / atol "
                             f"{GOLDEN_ATOL} by {excess}")
    return {"max_abs_diff": err, "launches": fa.launches, "shape": list(got.shape)}


# --------------------------------------------------------------------------- #
# phase 4c: the compiled chunk, one CUDA graph per bucket
# --------------------------------------------------------------------------- #

GRAPH_SEED = 7  # the noise generator of the graphs and of the eager chunks they are held against


def reserved_bytes(dev) -> int:
    """Device memory the caching allocator holds once its unused cached
    blocks are released: a graph's private pool stays in it."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(dev)


def check_compiled_chunk(dev, cfg, tree, t_start: float, pool, label: str) -> tuple:
    """One tree's B = 1 chunk (from ``t_start``) captured as a graph in
    ``pool``: three consecutive replays bitwise equal to three eager chunks
    from a generator seeded alike; one replay under the profiler (every
    K1 launch traced by symbol, none counted by the wrapper: a replay makes
    no Python launch); host ms per replay with the inputs on the card; the
    pool's growth. Returns (row, the graph, the eager chunk it is held
    against, the batch it was profiled on)."""
    L = cfg.joint.num_hidden_layers
    expected = L + L * round(cfg.num_inference_steps * (1 - t_start))
    rng = np.random.default_rng(20)
    batches = [example_batch(cfg, 1, rng) for _ in range(3)]
    for batch in batches:
        if t_start > 0:
            batch["prev_chunk"] = rng.uniform(-1, 1, size=(1, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
    before = reserved_bytes(dev)
    t0 = time.perf_counter()
    graph = compiled.compile_chunk(tree, cfg, 1, generator=torch.Generator(dev).manual_seed(GRAPH_SEED),
                                   t_start=t_start, device=dev, pool=pool)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    pool_bytes = reserved_bytes(dev) - before
    eager = serving.make_infer_fn(tree, cfg, device=dev, seed=GRAPH_SEED, t_start=t_start)
    for i, batch in enumerate(batches):
        got, want = graph(batch), eager(batch)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: replay {i} differs from the eager chunk by "
                                 f"{float((got.float() - want.float()).abs().max())}")
        if not (torch.isfinite(got).all() and got.abs().max() <= cfg.final_action_clip_value):
            raise AssertionError(f"{label}: replay {i} not finite or outside the clip")
    got, traced, wall = profiled_window(
        lambda: graph(batches[0]),
        {None: None, "Memcpy": None, "Memset": None, KERNEL_SYMBOL: expected, ROWS_SYMBOL: 0, KEYS_SYMBOL: 0},
        counted=(0, 0),
    )
    busy, events = got[None]
    log_profile(label, traced, wall, busy)
    copies = got["Memcpy"][1] + got["Memset"][1]
    on_card = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()}
    host = []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph(on_card)
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    row = {
        "t_start": t_start, "k1_launches_per_replay": got[KERNEL_SYMBOL][1], "k1_ms": got[KERNEL_SYMBOL][0],
        "busy_ms": busy, "profiled_wall_ms": wall, "kernels_per_replay": events - copies,
        "copies_per_replay": copies, "host_ms_per_replay": statistics.median(host),
        "pool_bytes": pool_bytes, "capture_s": capture_s,
    }
    return row, graph, eager, batches[0]


def check_compiled(dev, cfg, trees: dict, eager_rows: dict, info: str, label: str = "compiled") -> dict:
    """Phase 4c: the float, fused and production trees' B = 1 chunks and the
    production tree's refined chunk from t = 0.5 as CUDA graphs in one
    pool (as one server holds them), each held bitwise against the eager
    chunk; then the warm chunk of each graph and of each eager chunk, all
    eight in turns within each round (median of TURNS, host clock around the
    call and a synchronize, inputs from the host as a server gets them):
    the host's pace drifts within a run, so chunks timed one after another
    in blocks are not comparable."""
    runs = [(name, tree, 0.0) for name, tree in trees.items()] + [("production_refined", trees["production"], 0.5)]
    results, timed, pool = {}, {}, None
    for name, tree, t_start in runs:
        row, graph, eager, batch = check_compiled_chunk(dev, cfg, tree, t_start, pool, f"{label} {name}")
        pool = graph.pool
        results[name], timed[name] = row, (graph, eager, batch)
        eager_row = eager_rows.get(name, {})
        log(f"{label} {name}: {row['k1_launches_per_replay']} K1 launches traced per replay, "
            f"{row['kernels_per_replay']} kernels and {row['copies_per_replay']} copies per replay (eager chunk: "
            f"{eager_row.get('kernels_per_chunk', 'not profiled')} and {eager_row.get('copies_per_chunk', '-')}), "
            f"device busy {row['busy_ms']:.3f} ms of a profiled {row['profiled_wall_ms']:.3f} ms, K1 "
            f"{row['k1_ms']:.3f} ms, host {row['host_ms_per_replay']:.4f} ms per replay, pool +{row['pool_bytes']} "
            f"bytes, captured in {row['capture_s']:.2f} s; three replays bitwise equal to three eager chunks")
    times = {name: {"graph": [], "eager": []} for name in timed}
    for _ in range(TURNS):
        for name, (graph, eager, batch) in timed.items():
            for kind, fn in (("graph", graph), ("eager", eager)):
                t0 = time.perf_counter()
                fn(batch)
                torch.cuda.synchronize()
                times[name][kind].append((time.perf_counter() - t0) * 1e3)
    for name, t in times.items():
        results[name]["graph_chunk_ms"] = statistics.median(t["graph"])
        results[name]["eager_chunk_ms"] = statistics.median(t["eager"])
        log(f"{label} {name}: warm chunk in turns (median of {TURNS}) graph {results[name]['graph_chunk_ms']:.3f} ms, "
            f"eager {results[name]['eager_chunk_ms']:.3f} ms, on {info}")
    results["pool_bytes"] = sum(r["pool_bytes"] for r in results.values() if isinstance(r, dict))
    return results



def check_capture_under_gc(dev) -> dict:
    """Phase 4c, the capture under the cyclic GC: a reference cycle that
    holds a CompiledChunk is dropped, the GC set to collect at nearly every
    allocation, and another chunk captured (tiny config, fp32, B = 1). The
    capture succeeds, the dead cycle is gone, and a replay is bitwise the
    eager chunk."""
    cfg = cfg_lib.tiny_pizero_config()
    params = pizero.init_params(cfg, seed=0, device=dev)

    class Holder:
        pass

    dead = Holder()
    dead.graph = compiled.compile_chunk(params, cfg, 1, generator=torch.Generator(dev).manual_seed(GRAPH_SEED),
                                        device=dev)
    dead.me = dead  # a cycle: only the GC frees it, and its graph's memory with it
    ref = weakref.ref(dead)
    del dead
    thresholds, collections = gc.get_threshold(), sum(g["collections"] for g in gc.get_stats())
    gc.set_threshold(1, 1, 1)
    try:
        t0 = time.perf_counter()
        graph = compiled.compile_chunk(params, cfg, 1, generator=torch.Generator(dev).manual_seed(GRAPH_SEED),
                                       device=dev)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
    finally:
        gc.set_threshold(*thresholds)
    collections = sum(g["collections"] for g in gc.get_stats()) - collections
    eager = serving.make_infer_fn(params, cfg, device=dev, seed=GRAPH_SEED)
    batch = example_batch(cfg, 1, np.random.default_rng(21))
    if ref() is not None or not torch.equal(graph(batch), eager(batch)):
        raise AssertionError(f"dead cycle collected: {ref() is None}; the replay differs from the eager chunk")
    return {"capture_s": capture_s, "gc_collections": collections, "threshold": [1, 1, 1]}


# --------------------------------------------------------------------------- #
# phase 4d: the adaLN-Zero action expert
# --------------------------------------------------------------------------- #


def check_adaln(dev, info: str) -> dict:
    """Phase 4d: the full-width model with adaLN-Zero action and proprio
    experts in bf16, B = 1: the float and production trees driven eagerly
    (launches, bitwise chunks, clip, memory), then as CUDA graphs with
    phase 4c's checks (the refined chunk included; the replays' profiles
    give the device-busy and K1 ms, the in-turn timing the warm graph and
    eager chunks); card vs CPU at bridge widths in fp32; one fp32 training
    update at bridge widths, card vs CPU."""
    t0 = time.time()
    cfg = with_adaln(cfg_lib.PiZeroConfig())
    params = pizero.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    trees = {"float": params, "production": fuse.prepare_for_serving(params, **fuse.serving_layout_kwargs({}))}
    torch.cuda.synchronize()
    log(f"adaln: full-width adaLN-Zero float and production trees built in {time.time() - t0:.1f} s")
    results = {}
    for name, tree in trees.items():
        row = check_main_path(dev, cfg, tree, samples=0)  # 198 launches, bitwise chunks, clip, memory
        row["tree_gb"] = tree_bytes(tree) / 1e9
        results[name] = row
        log(f"adaln {name}: {row['launches']} K1 launches per chunk, two chunks bitwise equal; tree "
            f"{row['tree_gb']:.3f} GB, peak with the tree alone {row['alone_peak_mem_gb']:.3f} GB, on {info}")
    results["compiled"] = check_compiled(dev, cfg, trees, results, info, label="adaln compiled")
    del params, trees
    torch.cuda.empty_cache()
    bridge = with_adaln(cfg_lib.bridge_width_dryrun_config())
    results["parity_max_abs_diff"] = check_parity_with_cpu(dev, bridge)
    results["train_parity"] = check_train_parity(dev, bridge)
    return results


# --------------------------------------------------------------------------- #
# phase 4e: the PaliGemma text path
# --------------------------------------------------------------------------- #


def text_prompt(cfg, b: int, rng, text_len: int = 3):
    """scripts/bench_textgen.py's prompt: every image token, BOS, then
    ``text_len`` text tokens; random pixels in the params' dtype."""
    n_img = cfg.siglip.num_image_tokens
    ids = np.full((b, n_img + 1 + text_len), 100, np.int64)
    ids[:, :n_img] = cfg.image_token_index
    ids[:, n_img] = 2
    ids[:, n_img + 1 :] += np.arange(b)[:, None]  # rows differ
    size = cfg.siglip.image_size
    pix = rng.uniform(-1, 1, size=(b, size, size, 3)).astype(np.float32)
    return ids, pix


def text_bytes_per_token(tree) -> int:
    """Bytes a decode step must read at least: the vlm trunk's weights and
    the tied table (the lm head reads all of it)."""
    return tree_bytes(tree["joint"]["mixtures"]["vlm"]) + tree_bytes({"t": tree["embed_tokens"]})


def check_tied_head_reads_in_place(dev, tree, hidden) -> int:
    """The bytes allocated above what was resident during one tied-head
    call on one row: its [1, 1, V] output, not a copy of the table's
    transpose (1.05 GB at full width)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    pizero.lm_logits(tree, hidden)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - resident
    if extra > tree_bytes({"t": tree["embed_tokens"]}) // 10:
        raise AssertionError(f"the tied head allocated {extra} bytes: a copy of the table")
    return extra


def check_text_tree(dev, cfg, tree, ids, pix, pool) -> tuple:
    """One tree at B = 1: the prompt's logits; an eager generate of
    TEXT_MAX_NEW tokens (L + TEXT_MAX_NEW * L K1 launches, its first token
    the logits' last argmax, two calls bitwise equal); the compiled decode,
    bitwise the eager tokens, and its K/V caches bitwise those of the eager
    decode (at init the tied head copies the prompt's last token back, so
    the caches are the stronger check); the tied head reads the table in
    place; one replayed decode step under the profiler (K1's and the
    device's busy ms per token, the kernels per step); host ms per replay.
    Returns (row, the decoder)."""
    L = cfg.joint.num_hidden_layers
    expected = L + TEXT_MAX_NEW * L
    logits = pizero.infer_text_logits(tree, cfg, ids, pix)
    if tuple(logits.shape) != (1, ids.shape[1], cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"text logits {tuple(logits.shape)} or not finite")
    fa.launches = 0
    eager = pizero.generate_text(tree, cfg, ids, pix, TEXT_MAX_NEW, eos_token_id=-1)
    torch.cuda.synchronize()
    launches = fa.launches
    again = pizero.generate_text(tree, cfg, ids, pix, TEXT_MAX_NEW, eos_token_id=-1)
    if launches != expected or not torch.equal(eager, again):
        raise AssertionError(f"eager generate: {launches} K1 launches (want {expected}), two calls equal "
                             f"{torch.equal(eager, again)}")
    if int(eager[0, 0]) != int(logits[0, -1].argmax()):
        raise AssertionError(f"first token {int(eager[0, 0])}, the logits' argmax {int(logits[0, -1].argmax())}")
    t0 = time.perf_counter()
    decoder = compiled.CompiledDecode(tree, cfg, 1, ids.shape[1] + TEXT_MAX_NEW, eos_token_id=-1, device=dev,
                                      pool=pool)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    for call in range(2):
        got = decoder(ids, pix, TEXT_MAX_NEW)
        if not torch.equal(got, eager):
            raise AssertionError(f"compiled decode call {call}: {got.tolist()} vs eager {eager.tolist()}")
    state = pizero.TextDecode(tree, cfg, 1, ids.shape[1] + TEXT_MAX_NEW, eos_token_id=-1)
    state.prefill(ids, pix)
    for _ in range(TEXT_MAX_NEW):
        state.step()
    if not (torch.equal(state.tokens[:, :TEXT_MAX_NEW], eager)
            and all(torch.equal(a, b) for a, b in zip(state.cache, decoder.state.cache))):
        raise AssertionError("the compiled decode's K/V caches differ from the eager decode's")
    del state
    hidden = pizero.text_prefill(tree, cfg, ids, pix, decoder.state.cache)[:, -1:]
    head_bytes = check_tied_head_reads_in_place(dev, tree, hidden)
    del hidden
    decoder.prefill(ids, pix)
    # one decode step per window (each window a replay; at most WINDOW_TRIES
    # of the TEXT_MAX_NEW slots after the prompt are used)
    got, traced, wall = profiled_window(
        decoder.step, {None: None, KERNEL_SYMBOL: L, ROWS_SYMBOL: 0, KEYS_SYMBOL: 0}, counted=(0, 0)
    )
    log_profile("text decode step", traced, wall, got[None][0])
    decoder.prefill(ids, pix)
    torch.cuda.synchronize()
    host = []
    for _ in range(TEXT_MAX_NEW):
        t1 = time.perf_counter()
        decoder.step()
        host.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    row = {
        "tokens": eager[0].tolist(), "k1_launches_per_generate": launches,
        "k1_ms_per_token": got[KERNEL_SYMBOL][0], "busy_ms_per_token": got[None][0],
        "kernels_per_token": got[None][1], "profiled_step_wall_ms": wall,
        "host_ms_per_replay": statistics.median(host), "capture_s": capture_s, "tied_head_extra_bytes": head_bytes,
        "tree_gb": tree_bytes(tree) / 1e9, "bytes_per_token_gb": text_bytes_per_token(tree) / 1e9,
        "bound_ms_per_token": text_bytes_per_token(tree) / HBM_BYTES_PER_S * 1e3,
    }
    return row, decoder


def check_text_parity_with_cpu(dev) -> dict:
    """Bridge widths, depth 2, fp32, B = 2: the prompt's logits card vs CPU
    (<= 1e-3) on the params at init, and the greedy tokens (eager on both
    sides, and the card's compiled decode) with the vlm trunk's kernels
    times 8 and the token table times 0.05, so that the decode leaves the
    init's fixed point (the tied head copying the last prompt token back)."""
    cfg = paligemma_config(cfg_lib.bridge_width_dryrun_config())
    params_cpu = cpu_params(cfg)
    ids, pix = text_prompt(cfg, 2, np.random.default_rng(13))
    ids, pix = torch.from_numpy(ids), torch.from_numpy(pix)
    on_card = pizero.infer_text_logits(tree_map(lambda x: x.to(dev), params_cpu), cfg, ids.to(dev), pix.to(dev))
    err = float((on_card.cpu() - pizero.infer_text_logits(params_cpu, cfg, ids, pix)).abs().max())
    if not err <= 1e-3:
        raise AssertionError(f"text logits card vs CPU max|diff| {err} > 1e-3")
    vlm = params_cpu["joint"]["mixtures"]["vlm"]["layers"]
    for group in ("attn", "mlp"):
        vlm[group] = tree_map(lambda x: x * 8, vlm[group])
    params_cpu["embed_tokens"] = params_cpu["embed_tokens"] * 0.05
    params_dev = tree_map(lambda x: x.to(dev), params_cpu)
    want = pizero.generate_text(params_cpu, cfg, ids, pix, 8)
    eager = pizero.generate_text(params_dev, cfg, ids.to(dev), pix.to(dev), 8).cpu()
    graph = compiled.CompiledDecode(params_dev, cfg, 2, ids.shape[1] + 8, device=dev)(ids, pix, 8).cpu()
    if len(set(want.flatten().tolist())) <= 2 or not (torch.equal(eager, want) and torch.equal(graph, want)):
        raise AssertionError(f"greedy tokens: CPU {want.tolist()}, card {eager.tolist()}, graph {graph.tolist()}")
    return {"logits_max_abs_diff": err, "tokens": want.tolist()}


TEXT_GOLDEN_FIXTURE = "tests/fixtures/pizero_text_logits.npz"


def check_text_golden(dev) -> dict:
    """The reference's recorded text logits: its state under the HF
    PaliGemma names through the port's ``convert_paligemma``, fp32 on the
    card through the facade (its ``generate`` is the compiled decode), K1
    at head dim 8: rtol 2e-3 / atol 2e-3 (the CPU replay's), the first
    token the fixture's argmax."""
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), TEXT_GOLDEN_FIXTURE)) as z:
        payload = {k: z[k] for k in z.files}
    hf = {}
    for key, value in payload.items():
        name = key[len("state/"):]
        if name.startswith("joint_model.mixtures.vlm."):
            hf["language_model.model." + name[len("joint_model.mixtures.vlm."):]] = value
        elif name == "embed_tokens.weight":
            hf["language_model.model.embed_tokens.weight"] = value
        elif name.startswith(("vision_tower.", "multi_modal_projector.")):
            hf[name] = value
    cfg = paligemma_config(golden_config())
    model = PaliGemmaForConditionalGeneration(
        cfg, convert.to_dtype(convert.convert_paligemma(hf, cfg), torch.float32, dev)
    )
    ids, pix = payload["ids"].astype(np.int64), np.ascontiguousarray(payload["pix"].transpose(0, 2, 3, 1))
    fa.launches = 0
    got = model.logits(ids, pix).cpu().numpy()
    toks = model.generate(ids, pix, max_new_tokens=3).cpu()
    want = payload["want"]
    excess = float((np.abs(got - want) - (2e-3 + 2e-3 * np.abs(want))).max())
    if not excess <= 0 or int(toks[0, 0]) != int(want[0, -1].argmax()):
        raise AssertionError(f"golden text logits: outside rtol/atol 2e-3 by {excess}, first token "
                             f"{int(toks[0, 0])} vs {int(want[0, -1].argmax())}")
    return {"max_abs_diff": float(np.abs(got - want).max()), "launches": fa.launches, "tokens": toks.tolist()}


def check_text(dev, info: str) -> dict:
    """Phase 4e: ``paligemma_config(PiZeroConfig())`` in bf16 at B = 1 on
    scripts/bench_textgen.py's prompt (S = 260, 20 new tokens, no EOS): the
    bf16 tree, the weight-only int8 VLM (bench_textgen's ``int8``) and the
    production tree (W8A8 VLM trunk), each through ``check_text_tree``; then
    the logits, the prefill, the eager greedy, the eager top-p (0.9, a
    seeded generator) and the compiled generate of the three in turns
    (median of TURNS); card vs CPU at bridge widths; the golden text logits."""
    t0 = time.time()
    cfg = paligemma_config(cfg_lib.PiZeroConfig())
    params = pizero.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    trees = {
        "bf16": params,
        "int8_vlm": fuse.prepare_for_serving(params, quantize_mixtures=("vlm",)),
        "production": fuse.prepare_for_serving(params, **fuse.serving_layout_kwargs({})),
    }
    ids, pix = text_prompt(cfg, 1, np.random.default_rng(14))
    ids, pix = torch.from_numpy(ids).to(dev), torch.from_numpy(pix).to(dev, torch.bfloat16)
    torch.cuda.synchronize()
    log(f"text: full-width bf16 PaliGemma trees built in {time.time() - t0:.1f} s")
    results, decoders, pool = {}, {}, None
    for name, tree in trees.items():
        row, decoders[name] = check_text_tree(dev, cfg, tree, ids, pix, pool)
        pool = decoders[name].pool
        results[name] = row
        log(f"text {name}: {row['k1_launches_per_generate']} K1 launches per generate, K1 "
            f"{row['k1_ms_per_token']:.4f} ms and device busy {row['busy_ms_per_token']:.3f} ms per token "
            f"({row['kernels_per_token']} kernels), host {row['host_ms_per_replay']:.4f} ms per replay, tree "
            f"{row['tree_gb']:.3f} GB, tied head +{row['tied_head_extra_bytes']} bytes; graph tokens bitwise eager, "
            f"on {info}")
    timed = {name: {"logits": [], "prefill": [], "eager": [], "sampled": [], "graph": []} for name in trees}
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(TURNS):
        for name, tree in trees.items():
            runs = {
                "logits": lambda: pizero.infer_text_logits(tree, cfg, ids, pix),
                "prefill": lambda: decoders[name].prefill(ids, pix),
                "eager": lambda: pizero.generate_text(tree, cfg, ids, pix, TEXT_MAX_NEW, eos_token_id=-1),
                "sampled": lambda: pizero.generate_text(tree, cfg, ids, pix, TEXT_MAX_NEW, eos_token_id=-1,
                                                        generator=gen, top_p=0.9),
                "graph": lambda: decoders[name](ids, pix, TEXT_MAX_NEW),
            }
            for kind, fn in runs.items():
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                timed[name][kind].append((time.perf_counter() - t1) * 1e3)
    for name, t in timed.items():
        row = results[name]
        med = {kind: statistics.median(v) for kind, v in t.items()}
        row.update({f"{kind}_ms": v for kind, v in med.items()})
        for kind in ("eager", "sampled", "graph"):
            row[f"{kind}_ms_per_token"] = (med[kind] - med["prefill"]) / TEXT_MAX_NEW
        log(f"text {name}: in turns (median of {TURNS}) logits {med['logits']:.3f} ms, prefill {med['prefill']:.3f} ms, "
            f"generate eager {med['eager']:.3f} / top-p 0.9 eager {med['sampled']:.3f} / graph {med['graph']:.3f} "
            f"ms: per decode token eager {row['eager_ms_per_token']:.3f}, top-p eager "
            f"{row['sampled_ms_per_token']:.3f}, graph {row['graph_ms_per_token']:.3f} ms (byte bound "
            f"{row['bound_ms_per_token']:.3f} ms: {row['bytes_per_token_gb']:.3f} GB at the data sheet's 3.35 TB/s), "
            f"on {info}")
    del params, trees, decoders
    torch.cuda.empty_cache()
    results["parity"] = check_text_parity_with_cpu(dev)
    results["golden"] = check_text_golden(dev)
    return results


# --------------------------------------------------------------------------- #
# phase 5: the serve CLI in a process of its own
# --------------------------------------------------------------------------- #

SERVE_CONFIG = "configs/eval/bridge.yaml"
SERVE_OVERRIDES = ["use_bf16=true", "quantize=true", "refine_from_prev=0.5"]  # the production layout
SERVE_FLAGS = ["--random-init", "--batch-sizes", "1,2", "--port", "0"]
SERVE_TIMEOUT_S = 600


def check_serving_cli(info: str) -> dict:
    """Phase 5: ``python -m open_pi_zero_torch.scripts.serve`` with the
    production layout and the refined tier, started as a subprocess on a
    port of the OS's choosing; 4 robots over persistent binary connections,
    each one fresh request then two that carry its last chunk, and one
    fresh request and one refined request through ``request_action`` (JSON
    and binary codecs). Every reply finite, inside the clip, [4, 7]; the
    refined ones counted by the CLI at its stop (SIGINT), which must exit
    cleanly."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    args = ["--config", SERVE_CONFIG, *SERVE_FLAGS, *SERVE_OVERRIDES]
    proc = subprocess.Popen([sys.executable, "-m", "open_pi_zero_torch.scripts.serve", *args], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, ready = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            if "serving on" in line:
                ready.set()
        ready.set()  # the process ended

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        if not ready.wait(SERVE_TIMEOUT_S) or proc.poll() is not None:
            raise AssertionError("serve CLI did not come up: " + "\n".join(lines[-40:]))
        up_s = time.time() - t0
        port = int(re.search(r"serving on [\d.]+:(\d+)", next(x for x in lines if "serving on" in x)).group(1))
        cfg = cfg_lib.pizero_config_from_dict(cfg_lib.load_config(os.path.join(root, SERVE_CONFIG), SERVE_OVERRIDES))
        rng = np.random.default_rng(3)
        obs = [{k: v[0] for k, v in example_batch(cfg, 1, rng).items()} for _ in range(5)]
        replies, errors = [], []

        def robot(i):
            try:
                send, close = serving.open_action_connection("127.0.0.1", port, timeout=120)
                try:
                    chunk = send(obs[i])
                    replies.append(chunk)
                    for _ in range(2):
                        chunk = send({**obs[i], "prev_chunk": chunk})
                        replies.append(chunk)
                finally:
                    close()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"robot {i}: {type(e).__name__}: {e}")

        robots = [threading.Thread(target=robot, args=(i,)) for i in range(4)]
        for t in robots:
            t.start()
        for t in robots:
            t.join(timeout=300)
        fresh = serving.request_action("127.0.0.1", port, obs[4], timeout=120, binary=False)
        replies += [fresh, serving.request_action("127.0.0.1", port, {**obs[4], "prev_chunk": fresh}, timeout=120)]
        if errors or any(t.is_alive() for t in robots):
            raise AssertionError(f"serve CLI: {errors or 'a robot hung'}")
        for r in replies:
            if r.shape != (cfg.horizon_steps, cfg.action_dim) or not np.isfinite(r).all() \
                    or np.abs(r).max() > cfg.final_action_clip_value:
                raise AssertionError(f"serve CLI: bad reply {r.shape}")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
        reader.join(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for line in lines:
        log(f"serve CLI | {line}")
    stopped = [re.search(r"stopped: (\d+) requests answered, (\d+) of them by refine_fn", x) for x in lines]
    stopped = [m for m in stopped if m]
    want = {"answered": len(replies), "refined": 9}  # 4 robots x 2 + 1
    if rc != 0 or not stopped or (int(stopped[-1].group(1)), int(stopped[-1].group(2))) != tuple(want.values()):
        raise AssertionError(f"serve CLI: exit code {rc}, its count {stopped and stopped[-1].group(0)}, want {want}")
    return {"requests": len(replies), "refined": want["refined"], "up_s": up_s, "exit_code": rc}


def device_events(averages) -> list:
    """The CUDA events of a profile's ``key_averages()`` (read once per
    profile: each call walks every event of the window). User annotations
    (such as the optimizer's step) span kernels counted on their own and
    are left out."""
    return [e for e in averages if e.device_type.name == "CUDA" and not e.is_user_annotation]


def device_ms(events: list, match=None) -> tuple:
    """(summed self device time in ms, number of calls) of the
    ``device_events`` whose name contains `match` (all of them when None)."""
    events = [e for e in events if match is None or match in e.key]
    return sum(e.self_device_time_total for e in events) / 1e3, sum(e.count for e in events)


def profile_chunk(dev, cfg, params, expected: int, label: str = "profile") -> dict:
    """One warm chunk of the main path under torch.profiler
    (``profiled_window``: every K1 launch traced, the totals confirmed by
    a second window): the kernel's device time summed over its launches,
    the device time by kernel, the kernels and copies launched."""
    rng = np.random.default_rng(4)
    batch = example_batch(cfg, 1, rng)
    a0 = rng.normal(size=(1, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
    run_infer(params, cfg, batch, a0, dev, torch.bfloat16)
    got, traced, wall = profiled_window(
        lambda: run_infer(params, cfg, batch, a0, dev, torch.bfloat16),
        {None: None, "Memcpy": None, "Memset": None, KERNEL_SYMBOL: expected, ROWS_SYMBOL: 0, KEYS_SYMBOL: 0},
        counted=(expected, 0),
    )
    busy, events = got[None]
    log_profile(label, traced, wall, busy)
    copies = got["Memcpy"][1] + got["Memset"][1]
    return {"launches": expected, "ms": got[KERNEL_SYMBOL][0], "wall_ms": wall, "busy_ms": busy,
            "kernels_per_chunk": events - copies, "copies_per_chunk": copies}


def log_profile(label: str, events: list, wall: float, busy: float) -> None:
    """Log the device-busy share of a profiled window and its top kernels
    by device time (of its ``device_events``), the marker kernels left out."""
    log(f"{label}: wall {wall:.3f} ms, device busy {busy:.3f} ms ({100 * busy / wall:.1f}%)")
    events = [e for e in events if "opz_empty_kernel" not in e.key]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in events[:15]:
        log(f"{label}:   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")


def record_main_path_calls(dev, cfg, params) -> list:
    """The kernel's inputs, in order, over one chunk of the main path."""
    calls = []
    launch = fa.mot_attention_fused

    def recording(q, k, v, mask, softcap=50.0):
        calls.append((q.clone(), k.clone(), v.clone(), mask.clone(), softcap))
        return launch(q, k, v, mask, softcap)

    rng = np.random.default_rng(5)
    batch = example_batch(cfg, 1, rng)
    a0 = rng.normal(size=(1, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
    fa.mot_attention_fused = recording  # ops.attention looks it up at each call
    try:
        run_infer(params, cfg, batch, a0, dev, torch.bfloat16)
    finally:
        fa.mot_attention_fused = launch
    torch.cuda.synchronize()
    return calls


def replay(calls, attention=fa.mot_attention_fused) -> dict:
    """The main path's kernel calls replayed in order: ``attention`` (the
    kernel's wrapper) held against the plain version on each, then the
    device time of the wrapper, of the plain version and of one library
    attention call (without the softcap) summed over all of them (the
    kernel's by its symbol, every launch traced), and the bound of their
    sizes. Run it in the replay worker (``replay_in_worker``)."""
    err = 0.0
    for q, k, v, mask, softcap in calls:
        got, want = attention(q, k, v, mask, softcap), mot_attention_ref(q, k, v, mask, softcap)
        torch.testing.assert_close(got, want, rtol=TOL[q.dtype], atol=TOL[q.dtype])
        err = max(err, float((got.float() - want.float()).abs().max()))
    # library inputs: heads first, K/V expanded to the query heads, the mask
    # in the inputs' dtype; made before the timed calls
    lib_inputs = []
    for q, k, v, mask, _ in calls:
        g = q.shape[2] // k.shape[2]
        lib_inputs.append((
            q.transpose(1, 2), k.repeat_interleave(g, dim=2).transpose(1, 2),
            v.repeat_interleave(g, dim=2).transpose(1, 2),
            mask.clamp(min=float(torch.finfo(q.dtype).min)).to(q.dtype),
        ))
    timed = {
        "kernel": lambda: [attention(*c) for c in calls],
        "plain": lambda: [mot_attention_ref(*c) for c in calls],
        "library": lambda: [torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=m)
                            for q, k, v, m in lib_inputs],
    }
    out = {"max_abs_err": err}
    for name, fn in timed.items():
        fn()  # warm
        # the kernel counted by its symbol, as the main path's profile
        # counts it: one traced launch per call
        out[f"{name}_ms"] = kernel_ms(fn, len(calls)) if name == "kernel" else profiled_ms(fn)[0]
    t_bytes = t_ops = 0.0
    for q, k, v, mask, _ in calls:
        (b, lq, hq, d), (_, lkv, hkv, _) = q.shape, k.shape
        tb, to = bound_parts((b, lq, lkv, hq, hkv, d), mask, q.dtype)
        t_bytes, t_ops = t_bytes + tb, t_ops + to
    out["bound_ms"], out["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


_REPLAYER = []  # the replay worker (one ProcessPoolExecutor), started by start_replayer


def _replayer_init() -> None:
    """The replay worker's start: its CUDA context and the profiler's
    one-time set-up (some 15 s of its first window on an H100 host),
    taken while the main process builds the kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.set_device(0)
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def start_replayer() -> None:
    """Start the replay worker, a spawned process that profiles nothing but
    the replays: late in a process that has profiled much, the profiler
    lost the first events of every window (15 of 128 openers in each of
    K1-shard's), so that taking a window again did not help."""
    if not _REPLAYER:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        _REPLAYER.append(ProcessPoolExecutor(1, multiprocessing.get_context("spawn"), _replayer_init))
        _REPLAYER[0].submit(int)  # the worker starts now, not at the first replay


def stop_replayer() -> None:
    while _REPLAYER:
        _REPLAYER.pop().shutdown()


def replay_job(kind: str, path: str) -> dict:
    """``replay`` (kind "forward") or ``replay_vjp`` (kind "vjp") of the
    calls saved at ``path``, in the replay worker; its cached blocks are
    freed after."""
    dev = torch.device("cuda", 0)
    calls = [tuple(x.to(dev) if torch.is_tensor(x) else x for x in c) for c in torch.load(path)]
    try:
        return replay(calls) if kind == "forward" else replay_vjp(calls)
    finally:
        del calls
        torch.cuda.empty_cache()


def replay_in_worker(calls, kind: str) -> dict:
    """The replay of ``calls`` in the replay worker (``start_replayer``)."""
    start_replayer()
    with tempfile.TemporaryDirectory(prefix="opz_replay_") as tmp:
        path = os.path.join(tmp, "calls.pt")
        torch.save([tuple(x.cpu() if torch.is_tensor(x) else x for x in c) for c in calls], path)
        return _REPLAYER[0].submit(replay_job, kind, path).result()


# --------------------------------------------------------------------------- #
# phases 6-8: training
# --------------------------------------------------------------------------- #

TRAIN_B = 16  # per microbatch: the bridge config's per-device batch
GRAD_ACCUM = 2


def training_attention_inputs(dev, dtype, fully_masked_row: bool = False):
    """The training path's attention at full width: q [16, 281, 8, 256],
    k/v [16, 281, 1, 256], the block-causal mask of rows with 257..272
    valid image+text tokens, and a random cotangent."""
    cfg = cfg_lib.PiZeroConfig()
    am = torch.zeros(TRAIN_B, cfg.max_image_text_tokens, dtype=torch.int32, device=dev)
    for i in range(TRAIN_B):
        am[i, : 257 + i] = 1
    mask, _, _, _ = pizero.prepare_action_inputs(cfg, am)
    if fully_masked_row:
        mask = mask.clone()
        mask[0, 0, 3] = MASK_NEG
    rng = np.random.default_rng(6)
    q_shape, kv_shape = (TRAIN_B, cfg.total_tokens, 8, 256), (TRAIN_B, cfg.total_tokens, 1, 256)
    q, k, v, g = (
        torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev, dtype)
        for s in (q_shape, kv_shape, kv_shape, q_shape)
    )
    return q, k, v, mask, g


def out_and_grads(attention, q, k, v, mask, g, softcap=50.0) -> tuple:
    """(out, dq, dk, dv) of ``attention`` for the cotangent ``g``."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = attention(q, k, v, mask, softcap)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), g))


# (B, Lq, Lkv, Hq, Hkv, D) at head dims between the kernels' sizes: the
# reference fixtures' 8 and SimplerLite's 24, zero-padded to 16 and 32; the
# last two are phase 8e's: the reach recipe's update (B = 32, the 29-token
# sequence) and its eval chunk (4 action tokens over the 29)
PADDED_GEOMETRIES = ((2, 7, 9, 4, 1, 8), (1, 4, 25, 4, 1, 24), (32, 29, 29, 4, 1, 24), (1, 4, 29, 4, 1, 24))
# the scale-up recipe's update and eval chunk (demo_closed_loop --hidden 256
# --layers 6 --heads 8 --kv-heads 1 --head-dim 32): 8 query rows per KV head
# at a head dim the kernels take unpadded
SCALE_UP_GEOMETRIES = ((32, 29, 29, 8, 1, 32), (1, 4, 29, 8, 1, 32))


def check_vjp_padded(dev) -> dict:
    """Phase 6 at PADDED_GEOMETRIES: K1-vjp (K1, then the two backward
    kernels, each at the padded head dim, scaled by the true one) against
    plain autograd; max|diff| of the output and of each grad. The same at
    SCALE_UP_GEOMETRIES, which no padding touches."""
    errs = {}
    for b, lq, lkv, hq, hkv, d in PADDED_GEOMETRIES + SCALE_UP_GEOMETRIES:
        rng = np.random.default_rng(d)
        geometry = f"B={b} Lq={lq} Lkv={lkv} Hq={hq} D={d}"
        shapes = ((b, lq, hq, d), (b, lkv, hkv, d), (b, lkv, hkv, d), (b, lq, hq, d))
        arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
        mask = np.where(rng.random((b, 1, lq, lkv)) > 0.3, 0.0, MASK_NEG).astype(np.float32)
        mask[..., 0] = 0.0
        mask = torch.from_numpy(mask).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (torch.from_numpy(x).to(dev, dtype) for x in arrays)
            before = (fa.launches, fa.bwd_launches)
            got = out_and_grads(fa.mot_attention_fused, q, k, v, mask, g)
            torch.cuda.synchronize()
            if (fa.launches - before[0], fa.bwd_launches - before[1]) != (1, 2):
                raise AssertionError(f"{geometry}: {fa.launches - before[0]} K1 and {fa.bwd_launches - before[1]} "
                                     "backward launches for one VJP, want 1 and 2")
            want = out_and_grads(mot_attention_ref, q, k, v, mask, g)
            for name, x, y in zip(("out", "dq", "dk", "dv"), got, want):
                label = f"{geometry} {str(dtype)[6:]} {name}"
                if x.shape != y.shape or not torch.isfinite(x).all():
                    raise AssertionError(f"{label}: shape {tuple(x.shape)}, want {tuple(y.shape)}, or not finite")
                torch.testing.assert_close(x, y, rtol=TOL[dtype], atol=TOL[dtype], msg=lambda m, n=label: f"{n}: {m}")
                errs[label] = float((x.float() - y.float()).abs().max())
    return errs


def check_vjp(dev) -> dict:
    """Phase 6: the kernel's autograd Function (K1, then the two backward
    kernels) against plain autograd through the plain version; max|diff|
    of the output and of each grad. Each VJP launches both backward
    kernels once, and two VJPs agree bitwise. Then the head dims that the
    kernels zero-pad (``check_vjp_padded``)."""
    errs = {}
    for case in ("train", "fully_masked"):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, g = training_attention_inputs(dev, dtype, case == "fully_masked")
            before = fa.bwd_launches
            got = out_and_grads(fa.mot_attention_fused, q, k, v, mask, g)
            again = out_and_grads(fa.mot_attention_fused, q, k, v, mask, g)
            want = out_and_grads(mot_attention_ref, q, k, v, mask, g)
            torch.cuda.synchronize()
            if fa.bwd_launches != before + 4:
                raise AssertionError(f"{case} {dtype}: {fa.bwd_launches - before} backward launches for 2 VJPs")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{case} {dtype}: two VJPs differ")
            for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
                label = f"{case} {str(dtype)[6:]} {name}"
                if not torch.isfinite(a).all():
                    raise AssertionError(f"{label}: not finite")
                torch.testing.assert_close(a, b, rtol=TOL[dtype], atol=TOL[dtype], msg=lambda m, n=label: f"{n}: {m}")
                errs[label] = float((a.float() - b.float()).abs().max())
    errs.update(check_vjp_padded(dev))
    return errs


def train_batch(cfg, b: int, rng, inject: bool = False) -> dict:
    """GRAD_ACCUM microbatches of the example_batch pattern with random
    actions, stacked on a leading axis; with ``inject``, fixed flow times
    and noise as well."""
    micro = [example_batch(cfg, b, rng) for _ in range(GRAD_ACCUM)]
    batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    shape = (GRAD_ACCUM, b, cfg.horizon_steps, cfg.action_dim)
    batch["actions"] = rng.normal(size=shape).astype(np.float32)
    if inject:
        batch["t"] = rng.uniform(0.05, 0.95, size=(GRAD_ACCUM, b)).astype(np.float32)
        batch["x0"] = rng.normal(size=shape).astype(np.float32)
    return batch


def on(device, batch: dict) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def with_remat(cfg):
    return dataclasses.replace(cfg, joint=dataclasses.replace(cfg.joint, remat=True))


def new_trainer(cfg, train_cfg, params, device):
    """(state, step) over ``params``, with the train stream's generator of
    seed 0 on ``device`` (``training/seeds.py``: not the init's numbers)."""
    optimizer = opt_lib.build_optimizer(train_cfg, params)
    generator = seeds.stream_generator(0, seeds.TRAIN, device=device)
    state = train_step.init_train_state(params, optimizer, generator, train_cfg)
    return state, train_step.make_train_step(cfg, train_cfg, optimizer, GRAD_ACCUM)


def check_train_parity(dev, cfg=None) -> dict:
    """Phase 7: one update at bridge widths, depth 2, fp32, on the card
    (kernel) and on the CPU (plain version) from the same params, batch,
    flow times and noise."""
    cfg = with_remat(cfg or cfg_lib.bridge_width_dryrun_config())
    # warmup 0: the first update takes the full lr, so that it shows. Adam
    # eps 1e-3: at the config's 1e-8, a grad that is rounding noise on both
    # sides (SigLIP's key bias, zero in exact arithmetic) steps by about
    # +-lr whatever its size, so the two sides' params could differ by 2 lr
    # with nothing wrong; at 1e-3 the update is linear in such grads
    sched = cfg_lib.LRSchedulerConfig(warmup_steps=0)
    train_cfg = cfg_lib.TrainingConfig(action_lr_scheduler=sched, vlm_lr_scheduler=sched, adam_eps=1e-3)
    batch = train_batch(cfg, 2, np.random.default_rng(7), inject=True)
    params_cpu = cpu_params(cfg)
    params_dev = tree_map(lambda x: x.to(dev, copy=True), params_cpu)
    metrics = {}
    for name, params, device in (("card", params_dev, dev), ("cpu", params_cpu, "cpu")):
        state, step = new_trainer(cfg, train_cfg, params, device)
        before = fa.launches
        metrics[name] = {k: float(v) for k, v in step(state, on(device, batch)).items()}
        if name == "card":
            launches = fa.launches - before
    expected = GRAD_ACCUM * 2 * cfg.joint.num_hidden_layers
    if launches != expected:
        raise AssertionError(f"card update launched the kernel {launches} times, want {expected}")
    rel = {k: abs(metrics["card"][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k]) for k in ("loss", "grad_norm")}
    param_err = max(
        float((a.detach().cpu() - b.detach()).abs().max())
        for a, b in zip(tree_leaves(params_dev), tree_leaves(params_cpu))
    )
    # fp32 on both sides (TF32 off): the two differ in summation order. The
    # loss and the grad norm agreed to 1.0e-7 and 3.3e-5 relative on an
    # H100; 1e-3 catches a wrong mask, cast or layout, as in phase 3. The
    # first Adam update lr * g / (|g| + eps) moves by at most
    # lr * |dg| / (4 eps) when g moves by dg, which is below 1e-9 here, so
    # the params differ by their own rounding (an ulp of 1.0 is 1.2e-7);
    # 1e-6 = lr / 50 catches a wrong group, lr, clip or surgery, each of
    # which moves a param by a good part of lr = 5e-5
    if not (max(rel.values()) <= 1e-3 and param_err <= 1e-6):
        raise AssertionError(f"card vs CPU: relative {rel}, params max|diff| {param_err}")
    return {"launches": launches, "metrics": metrics, "rel_diff": rel, "param_max_abs_diff": param_err}


def leaves_with_paths(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves_with_paths(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def fingerprint(x: torch.Tensor) -> int:
    """The int64 sum of an fp32 tensor's bit patterns: it differs once the
    tensor changed, unless the changes cancel exactly."""
    return int(x.detach().view(torch.int32).sum(dtype=torch.int64))


def frozen_parts(params: dict) -> dict:
    """Copies of what an update must leave bitwise unchanged: embed_tokens
    and the unused last-layer slices of the vlm layers."""
    vlm = params["joint"]["mixtures"]["vlm"]["layers"]
    parts = {"embed_tokens": params["embed_tokens"]}
    for path in opt_lib.UNUSED_LAST_LAYER_PATHS:
        leaf = vlm
        for key in path:
            leaf = leaf[key]
        parts["vlm/" + "/".join(path) + "[-1]"] = leaf[-1]
    return {k: v.detach().clone() for k, v in parts.items()}


def check_train_main(dev) -> tuple:
    """Phase 8: 3 full-width fp32 updates on the card. Returns (result,
    cfg, params, state, step, a batch)."""
    cfg = with_remat(cfg_lib.PiZeroConfig())
    train_cfg = cfg_lib.TrainingConfig()  # the bridge config's values
    t0 = time.time()
    params = pizero.init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    state, step = new_trainer(cfg, train_cfg, params, dev)
    rng = np.random.default_rng(8)
    batches = [on(dev, train_batch(cfg, TRAIN_B, rng)) for _ in range(3)]
    trained = [(p, x) for p, x in leaves_with_paths(params) if x.requires_grad]
    prints = {p: fingerprint(x) for p, x in trained}
    frozen = frozen_parts(params)
    torch.cuda.synchronize()
    log(f"train-main: full-width fp32 params, {len(trained)} trained leaves, "
        f"{opt_lib.trainable_param_count(params)} (1e9), built in {time.time() - t0:.1f} s")

    L = cfg.joint.num_hidden_layers
    expected = 3 * GRAD_ACCUM * 2 * L
    torch.cuda.reset_peak_memory_stats(dev)
    fa.launches = fa.bwd_launches = 0
    losses, norms, times = [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches, bwd_launches = fa.launches, fa.bwd_launches
    if launches != expected:
        raise AssertionError(f"{launches} kernel launches over 3 updates, want {expected}")
    if bwd_launches != expected:  # 3 * GRAD_ACCUM * L VJPs, two backward kernels each
        raise AssertionError(f"{bwd_launches} backward launches over 3 updates, want {expected}")
    if state.step != 3 or not all(np.isfinite(losses + norms)):
        raise AssertionError(f"step {state.step}, losses {losses}, grad norms {norms}")
    # SigLIP's key bias adds the same q.b to every score of a query row,
    # which the softmax cancels: its gradient is zero in exact arithmetic,
    # rounding noise here, and Adam's steps on that noise are below its ulp
    unchanged = [p for p, x in trained if fingerprint(x) == prints[p] and p != "/siglip/layers/attn/k/bias"]
    if unchanged:
        raise AssertionError(f"trained leaves unchanged after 3 updates: {unchanged}")
    moved = [k for k, v in frozen_parts(params).items() if not torch.equal(v, frozen[k])]
    if moved:
        raise AssertionError(f"frozen parts changed: {moved}")
    result = {
        "launches": launches,
        "bwd_launches": bwd_launches,
        "losses": losses,
        "grad_norms": norms,
        "update_ms": times,
        "update_ms_median_after_first": statistics.median(times[1:]),
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }
    return result, cfg, params, state, step, batches[0]


def record_training_calls(dev, cfg, params, batch) -> list:
    """The kernel's inputs, in order, over the forwards of one update's
    GRAD_ACCUM microbatches (a rematerialized layer runs its forward again
    on the same inputs in the backward pass)."""
    calls = []
    launch = fa.mot_attention_fused

    def recording(q, k, v, mask, softcap=50.0):
        calls.append((*(x.detach().clone() for x in (q, k, v, mask)), softcap))
        return launch(q, k, v, mask, softcap)

    fa.mot_attention_fused = recording  # ops.attention looks it up at each call
    try:
        with torch.no_grad():
            for i in range(GRAD_ACCUM):
                train_step.batch_loss(params, cfg, torch.Generator(dev).manual_seed(1), {k: v[i] for k, v in batch.items()})
    finally:
        fa.mot_attention_fused = launch
    torch.cuda.synchronize()
    return calls


def vjp_bound_parts(q, k, mask) -> tuple:
    """(ms to move the bytes, ms to do the operations) of the training
    path's attention for one (layer, microbatch): two forwards (the second
    a remat recompute) and one VJP. Bytes: each forward reads q, k, v and
    the fp32 mask's distinct elements and writes the output; the VJP reads
    q, k, v, the mask and the cotangent and writes dq, dk, dv. Operations:
    4N per forward (q k^T and p v) and 8N for the VJP (dv, dp, dq, dk), N =
    B Hq Lq Lkv D, at the peak rate of the inputs' type."""
    (b, lq, hq, d), (_, lkv, hkv, _) = q.shape, k.shape
    size = q.element_size()
    q_bytes, kv_bytes, m_bytes = b * lq * hq * d * size, 2 * b * lkv * hkv * d * size, mask_bytes(mask)
    forward = 2 * q_bytes + kv_bytes + m_bytes
    vjp = 3 * q_bytes + 2 * kv_bytes + m_bytes
    peak = FP32_FLOPS if q.dtype == torch.float32 else BF16_FLOPS
    ops = 16 * b * hq * lq * lkv * d
    return (2 * forward + vjp) / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3


class RecomputeVjp(torch.autograd.Function):
    """K1-vjp before its backward kernels, timed beside them: K1's forward,
    and a backward that recomputes through the plain version
    (``fused_attention._recompute_grads``, the port's CPU backward). Never
    called by the port on a card."""

    @staticmethod
    def forward(ctx, q, k, v, mask, softcap):
        ctx.save_for_backward(q, k, v, mask)
        ctx.softcap = softcap
        return fa._launch(q, k, v, mask, softcap)

    @staticmethod
    def backward(ctx, grad):
        return (*fa._recompute_grads(*ctx.saved_tensors, ctx.softcap, grad), None, None)


def replay_vjp(calls) -> dict:
    """One update's kernel calls replayed as the training path runs them:
    for each, a forward, then a forward and its VJP for a random cotangent.
    The Function is held against plain autograd on each; then the device
    time of that work through the Function (K1 and the backward kernels,
    whose own time is counted by symbol in the same window), through K1
    with the recompute backward (``RecomputeVjp``), through the plain
    version and through one library attention call (without the softcap,
    K/V expanded to the query heads outside the timed calls), and the
    bound of the calls' sizes. Run it in the replay worker
    (``replay_in_worker``)."""
    gen = torch.Generator(calls[0][0].device).manual_seed(9)
    cots = [torch.randn(c[0].shape, generator=gen, device=c[0].device, dtype=c[0].dtype) for c in calls]
    err = 0.0
    for (q, k, v, mask, softcap), g in zip(calls, cots):
        got = out_and_grads(fa.mot_attention_fused, q, k, v, mask, g, softcap)
        want = out_and_grads(mot_attention_ref, q, k, v, mask, g, softcap)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=TOL[q.dtype], atol=TOL[q.dtype])
            err = max(err, float((a.float() - b.float()).abs().max()))

    def route(attention, inputs):
        def run():
            for (q, k, v, mask, softcap), g in inputs:
                attention(q, k, v, mask, softcap)  # the forward whose activations remat drops
                out_and_grads(attention, q, k, v, mask, g, softcap)
        return run

    def sdpa(q, k, v, mask, _softcap):
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    lib_inputs = []
    for (q, k, v, mask, softcap), g in zip(calls, cots):
        group = q.shape[2] // k.shape[2]
        lib_inputs.append((
            (q.transpose(1, 2), k.repeat_interleave(group, dim=2).transpose(1, 2),
             v.repeat_interleave(group, dim=2).transpose(1, 2), mask, softcap),
            g.transpose(1, 2),
        ))
    timed = {
        "kernel": route(fa.mot_attention_fused, list(zip(calls, cots))),
        "recompute": route(RecomputeVjp.apply, list(zip(calls, cots))),
        "plain": route(mot_attention_ref, list(zip(calls, cots))),
        "library": route(sdpa, lib_inputs),
    }
    out = {"max_abs_err": err, "calls": len(calls)}
    n = len(calls)
    for name, fn in timed.items():
        fn()  # warm
        if name == "kernel":  # every K1 and backward launch traced, in one window
            got, _, _ = profiled_window(fn, {None: None, KERNEL_SYMBOL: 2 * n, ROWS_SYMBOL: n, KEYS_SYMBOL: n},
                                        counted=(2 * n, 2 * n))
            out["kernel_ms"] = got[None][0]
            out["forward_ms"] = got[KERNEL_SYMBOL][0]
            out["backward_ms"] = got[ROWS_SYMBOL][0] + got[KEYS_SYMBOL][0]
        else:
            out[f"{name}_ms"] = profiled_ms(fn)[0]
    t_bytes = t_ops = 0.0
    for q, k, _, mask, *_ in calls:
        tb, to = vjp_bound_parts(q, k, mask)
        t_bytes, t_ops = t_bytes + tb, t_ops + to
    out["bound_ms"], out["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


# --------------------------------------------------------------------------- #
# phases 7 (QLoRA), 8b, 8c: fine-tuning
# --------------------------------------------------------------------------- #

AGENT_CONFIG = "configs/train/bridge.yaml"
# its QLoRA recipe at B = 16 x 2 for 3 updates, validating and saving once
# at the end; pretrained_model_path points at no file, so that the agent
# takes FakeTokenizer whatever the machine's caches hold
AGENT_OVERRIDES = [
    "quantize=true", "lora=true", "remat=true", "load_pretrained_weights=false",
    "per_device_batch_size=16", "global_batch_size=32",
    "n_updates=3", "log_freq=1", "eval_freq=3", "eval_size=2", "save_model_freq=0",
]
INSTRUCTIONS = (b"put the spoon in the pot", b"open the drawer", b"move the carrot to the left of the plate")
# phase 8b's cuts of the config's data block (PERF.md section 4): the
# dataset written here (DEMO_EPISODES episodes of DEMO_STEPS steps); a
# shuffle buffer of 1000 frames, not 200000 (some 700 passes over ~300
# frames to fill); 2 frame-transform threads, not 100 (the transforms hold
# the GIL between numpy calls, so threads do not scale), and 1 trajectory
# read and transform thread, not 10
DATA_OVERRIDES = [
    "data.train.shuffle_buffer_size=1000", "data.train.num_parallel_calls=2",
    "data.train.traj_transform_threads=1", "data.train.traj_read_threads=1",
]
DEMO_EPISODES = 8
DEMO_STEPS = (34, 43)  # steps per episode, drawn in [34, 43): bridge's typical 38
RAW_SIZE = 256  # phase 8b's raw frames: the size of raw OXE bridge frames
PREPROCESS_WORKERS = 8  # modify_rlds_dataset's threads in phase 8b
PIPELINE_BATCHES = 8  # batches of 16 timed through the pipeline alone, after the first
CODEC_FIXTURE = "tests/fixtures/jpeg_codec.npz"  # TensorFlow's encodes and decodes (tests/make_jpeg_fixture.py)
CODEC_TIMED = 50  # calls timed per frame and direction in phase 8a


def qlora_config(cfg):
    """``cfg`` with LoRA adapters on the vlm mixture and SigLIP and their
    bases in NF4: configs/train/bridge.yaml's ``quantize: true, lora: true``."""
    mixtures = tuple(dataclasses.replace(m, use_lora=True, use_quantize=True) if n == "vlm" else m
                     for n, m in zip(cfg.joint.mixture_names, cfg.joint.mixtures))
    return dataclasses.replace(cfg, joint=dataclasses.replace(cfg.joint, mixtures=mixtures),
                               siglip=dataclasses.replace(cfg.siglip, use_lora=True, use_quantize=True))


class SyntheticFrames:
    """Seeded frame batches in the RLDS layout that the TrainAgent takes:
    uint8 images of ``size``², bridge's 7-dim proprio and action, 4-step
    chunks, one of three instructions; ``iterator(batch_size)`` starts
    again from the seed at each call. Phase 7's SimplerLite update takes
    them; phase 8b's agent reads the pipeline."""

    def __init__(self, seed: int, size: int = 224, horizon: int = 4, dim: int = 7):
        self.seed, self.size, self.horizon, self.dim = seed, size, horizon, dim

    def iterator(self, batch_size: int):
        rng = np.random.default_rng(self.seed)
        while True:
            yield {
                "observation": {
                    "image_primary": rng.integers(0, 256, (batch_size, 1, self.size, self.size, 3), dtype=np.uint8),
                    "proprio": rng.normal(size=(batch_size, 1, self.dim)).astype(np.float32),
                },
                "task": {"language_instruction": np.array(
                    [INSTRUCTIONS[i] for i in rng.integers(0, len(INSTRUCTIONS), batch_size)], dtype=object)},
                "action": rng.uniform(-1, 1, size=(batch_size, 1, self.horizon, self.dim)).astype(np.float32),
            }


def demo_frames(rng, steps: int, size: int = 224) -> list:
    """One episode's camera frames: a fixed scene of slow colour gradients
    and a blob (the arm's stand-in) moving across it, with a little sensor
    noise: smooth, so that JPEG and PNG compress them as they do camera
    frames."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    phase = rng.uniform(0, 6, 3)
    scene = np.stack([110 + 60 * np.sin(x / (35 + 10 * c) + phase[c]) * np.cos(y / (45 + 5 * c) - phase[c])
                      for c in range(3)], -1)
    colour = rng.uniform(-90, 90, 3).astype(np.float32)
    start, end = rng.uniform(30, size - 30, 2), rng.uniform(30, size - 30, 2)
    frames = []
    for t in range(steps):
        cx, cy = start + (end - start) * t / (steps - 1)
        blob = np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / 600.0)[..., None]
        noisy = scene + blob * colour + rng.normal(0, 1.5, scene.shape).astype(np.float32)
        frames.append(np.clip(noisy, 0, 255).astype(np.uint8))
    return frames


def write_demo_dataset(root: str, size: int = 224) -> dict:
    """A bridge-shaped RLDS dataset written by the port's writer under
    ``root/bridge_dataset``: DEMO_EPISODES episodes, ``size``² JPEG
    ``image_0`` (quality 95, 4:2:0, as OXE stores frames), 7-dim ``state``
    (a smooth path) and ``action`` (its deltas, then a gripper of 0, 1 or
    in between), an instruction, ``is_first``; two shards. Returns its
    sizes and the seconds it took."""
    t0 = time.time()
    rng = np.random.default_rng(11)
    L = data_rlds.LeafSpec
    leaves = [L("steps/observation/image_0", "uint8", (size, size, 3), "image", True, "jpeg"),
              L("steps/observation/state", "float32", (7,), "tensor", True),
              L("steps/action", "float32", (7,), "tensor", True),
              L("steps/language_instruction", "string", (), "text", True),
              L("steps/is_first", "bool", (), "tensor", True)]
    episodes, frames = [], 0
    with ThreadPoolExecutor(8) as pool:  # the codec encodes outside the GIL
        for i in range(DEMO_EPISODES):
            steps = int(rng.integers(*DEMO_STEPS))
            state = np.cumsum(rng.normal(0, 0.02, size=(steps, 7)), axis=0).astype(np.float32)
            gripper = rng.choice([0.0, 1.0, 0.5], size=(steps, 1), p=[0.45, 0.45, 0.1])
            action = np.concatenate([np.diff(state[:, :6], axis=0, append=state[-1:, :6]), gripper], 1)
            episodes.append({"steps": {
                "observation": {"image_0": list(pool.map(jpeg.encode_jpeg, demo_frames(rng, steps, size))),
                                "state": state},
                "action": action.astype(np.float32),
                "language_instruction": [INSTRUCTIONS[i % len(INSTRUCTIONS)]] * steps,
                "is_first": np.asarray([1] + [0] * (steps - 1), bool),
            }})
            frames += steps
    data_rlds.write_rlds_dataset(os.path.join(root, "bridge_dataset"), "bridge_dataset", episodes, leaves, shards=2)
    encoded = [len(b) for ep in episodes for b in ep["steps"]["observation"]["image_0"]]
    return {"episodes": DEMO_EPISODES, "frames": frames, "size": size,
            "jpeg_kb_mean": sum(encoded) / len(encoded) / 1e3,
            "bytes": dir_bytes(os.path.join(root, "bridge_dataset")), "write_s": time.time() - t0}


def preprocess_demo_dataset(src_root: str, dst_root: str) -> dict:
    """The real data workflow's offline step: the port's
    ``scripts/modify_rlds_dataset`` resizes ``src_root``'s raw
    ``RAW_SIZE``² JPEG frames to 224² JPEG under ``dst_root`` (decode,
    Lanczos3, quality-95 encode, PREPROCESS_WORKERS threads). Checks the
    output's spec and counts; returns its sizes and seconds."""
    t0 = time.time()
    src, dst = os.path.join(src_root, "bridge_dataset"), os.path.join(dst_root, "bridge_dataset")
    modify_rlds_dataset.main(["--src", src, "--dst", dst, "--size", "224", "224",
                              "--workers", str(PREPROCESS_WORKERS)])
    seconds = time.time() - t0
    spec = data_rlds.load_spec(dst)
    image = [l for l in spec.leaves if l.kind == "image"]
    episodes = list(data_rlds.episode_dataset(dst))
    frames = [b for ep in episodes for b in ep["steps"]["observation"]["image_0"]]
    if [(l.shape, l.encoding_format) for l in image] != [((224, 224, 3), "jpeg")] or len(episodes) != DEMO_EPISODES:
        raise AssertionError(f"preprocessed dataset: image leaves {image}, {len(episodes)} episodes")
    first = jpeg.decode_jpeg(frames[0])
    if first.shape != (224, 224, 3):
        raise AssertionError(f"a preprocessed frame decodes to {first.shape}")
    return {"episodes": len(episodes), "frames": len(frames), "size": 224, "seconds": seconds,
            "frames_per_s": len(frames) / seconds, "jpeg_kb_mean": sum(map(len, frames)) / len(frames) / 1e3,
            "bytes": dir_bytes(dst)}


def png_copy(src_root: str, dst_root: str) -> None:
    """``src_root``'s dataset with every frame decoded and written again as
    PNG: the same pixels, so that the pipeline's time on the two differs by
    the decoder alone."""
    src, dst = os.path.join(src_root, "bridge_dataset"), os.path.join(dst_root, "bridge_dataset")
    spec = data_rlds.load_spec(src)
    leaves = [dataclasses.replace(l, encoding_format="png") if l.kind == "image" else l for l in spec.leaves]
    episodes = list(data_rlds.episode_dataset(src))
    with ThreadPoolExecutor(8) as pool:
        for ep in episodes:
            obs = ep["steps"]["observation"]
            obs["image_0"] = list(pool.map(lambda b: images.encode_png(jpeg.decode_jpeg(b)), obs["image_0"]))
    data_rlds.write_rlds_dataset(dst, spec.name, episodes, leaves, shards=2)


def median_call_ms(fn, calls: int = CODEC_TIMED) -> float:
    """The median host ms of ``calls`` calls of ``fn``, after one more."""
    fn()
    times = []
    for _ in range(calls):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def jpeg_fixture_cases() -> list:
    """[(name, frame, jpeg bytes, TensorFlow's decode, quality,
    chroma_downsampling, TensorFlow's INTEGER_ACCURATE decode)] of
    CODEC_FIXTURE, in the layout that tests/make_jpeg_fixture.py writes."""
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), CODEC_FIXTURE)) as z:
        cases = []
        for name in [k[len("jpeg_"):] for k in z.files if k.startswith("jpeg_")]:
            source = str(z[f"frame_of_{name}"]) if f"frame_of_{name}" in z.files else name
            quality, chroma = (int(v) for v in z[f"settings_{name}"])
            cases.append((name, z[f"frame_{source}"], z[f"jpeg_{name}"].tobytes(), z[f"decoded_{name}"], quality,
                          bool(chroma), z[f"decoded_accurate_{name}"]))
    return cases


def check_codec(info: str) -> dict:
    """Phase 8a: the port's JPEG codec, built on this host by its C++
    compiler (phase 1), against the committed fixture of TensorFlow's
    encodes and decodes, bitwise, the decodes at both IDCTs (IFAST, the
    default; ISLOW, INTEGER_ACCURATE); then the host ms per decode (each
    IDCT) and per encode of a 224² and a 256² frame at the pipeline's
    settings (quality 95, 4:2:0), one call at a time, and the frames/s of
    IFAST decodes of the 224² frame on one thread per core (the codec runs
    outside the GIL)."""
    cases = jpeg_fixture_cases()
    for name, frame, data, decoded, quality, chroma, accurate in cases:
        encoded = jpeg.encode_jpeg(frame, quality=quality, chroma_downsampling=chroma)
        got = jpeg.decode_jpeg(data)
        islow = jpeg.decode_jpeg(data, dct_method="INTEGER_ACCURATE")
        if (encoded != data or got.shape != decoded.shape or not np.array_equal(got, decoded)
                or islow.shape != accurate.shape or not np.array_equal(islow, accurate)):
            raise AssertionError(f"codec vs the fixture's {name}: encode {'equal' if encoded == data else 'differs'}, "
                                 f"decode {got.shape} vs {decoded.shape}, ISLOW decode {islow.shape} vs "
                                 f"{accurate.shape}, equal {np.array_equal(islow, accurate)}")
    by_name = {c[0]: c for c in cases}
    timed = {}
    for name in ("rgb224", "rgb256"):
        _, frame, data = by_name[name][:3]
        timed[name] = {"decode_ms": median_call_ms(lambda: jpeg.decode_jpeg(data)),
                       "decode_islow_ms": median_call_ms(lambda: jpeg.decode_jpeg(data, dct_method="INTEGER_ACCURATE")),
                       "encode_ms": median_call_ms(lambda: jpeg.encode_jpeg(frame)), "jpeg_bytes": len(data)}
    threads = os.cpu_count() or 1
    data = by_name["rgb224"][2]
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(jpeg.decode_jpeg, [data] * threads))
        t = time.perf_counter()
        list(pool.map(jpeg.decode_jpeg, [data] * (threads * CODEC_TIMED)))
        threaded = threads * CODEC_TIMED / (time.perf_counter() - t)
    result = {"fixture_cases": [c[0] for c in cases], "bitwise": True, "timed": timed,
              "threads": threads, "decode_frames_per_s_threads": threaded}
    log(f"codec: csrc/jpeg_codec.cc built by {os.path.basename(_build.host_compiler())}, bitwise the fixture's "
        f"TensorFlow encodes and decodes, IFAST and ISLOW ({', '.join(result['fixture_cases'])}); per 224² frame "
        f"decode {timed['rgb224']['decode_ms']:.3f} ms (ISLOW {timed['rgb224']['decode_islow_ms']:.3f}), encode "
        f"{timed['rgb224']['encode_ms']:.3f} ms; per 256² frame decode {timed['rgb256']['decode_ms']:.3f} ms (ISLOW "
        f"{timed['rgb256']['decode_islow_ms']:.3f}), encode {timed['rgb256']['encode_ms']:.3f} ms (median of "
        f"{CODEC_TIMED}); 224² decodes on {threads} threads {threaded:.1f} frames/s, on {info}")
    return result


class TimedIterator:
    """An iterator that sums the ms its ``next`` calls take."""

    def __init__(self, it):
        self.it, self.ms = it, 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t = time.perf_counter()
        try:
            return next(self.it)
        finally:
            self.ms += (time.perf_counter() - t) * 1e3


def pipeline_alone(dataset, batch_size: int) -> dict:
    """The pipeline with no card in the loop: seconds to a fresh iterator's
    first batch (its shuffle buffer filled), then frames per second over
    PIPELINE_BATCHES more batches (decode, resize, augment, batching)."""
    t0 = time.perf_counter()
    it = dataset.iterator(batch_size)
    try:
        next(it)
        t1 = time.perf_counter()
        for _ in range(PIPELINE_BATCHES):
            next(it)
        t2 = time.perf_counter()
    finally:
        it.close()
    return {"first_batch_s": t1 - t0, "frames_per_s": PIPELINE_BATCHES * batch_size / (t2 - t1)}


def opt_tensors(state) -> list:
    """The optimizer state's tensors, in its params' order."""
    return [t for group in state.opt_state.param_groups for p in group["params"]
            for t in state.opt_state.state[p].values() if torch.is_tensor(t)]


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def nf4_leaves(params: dict) -> list:
    """(path, tensor) of every NF4 payload and absmax."""
    return [(p, x) for p, x in leaves_with_paths(params) if p.endswith("/q4") or p.endswith("/absmax")]


def check_qlora_parity(dev) -> dict:
    """Phase 7, QLoRA: one update at bridge widths, depth 2, fp32, remat,
    B = 2, grad_accum 2, NF4 bases, LoRA adapters (B drawn off zero) and
    int8 Adam moments, on the card (kernel) and on the CPU (plain version)
    from the same params, batch, flow times and noise."""
    cfg = with_remat(qlora_config(cfg_lib.bridge_width_dryrun_config()))
    sched = cfg_lib.LRSchedulerConfig(warmup_steps=0)
    # eps 1e-3 as in the float check above
    train_cfg = cfg_lib.TrainingConfig(action_lr_scheduler=sched, vlm_lr_scheduler=sched, adam_eps=1e-3,
                                       quantize_optimizer_states=True, lora=True)
    batch = train_batch(cfg, 2, np.random.default_rng(7), inject=True)
    params_cpu = lora_lib.quantize_per_model_config(cpu_params(cfg), cfg)
    params_dev = tree_map(lambda x: x.to(dev, copy=True), params_cpu)
    nf4_before = {p: x.clone() for p, x in nf4_leaves(params_cpu)}
    metrics, states = {}, {}
    for name, params, device in (("card", params_dev, dev), ("cpu", params_cpu, "cpu")):
        state, step = new_trainer(cfg, train_cfg, params, device)
        if not isinstance(state.opt_state, AdamW8bit):
            raise AssertionError(f"{type(state.opt_state).__name__}, want AdamW8bit")
        before = fa.launches
        metrics[name] = {k: float(v) for k, v in step(state, on(device, batch)).items()}
        if name == "card":
            launches = fa.launches - before
        states[name] = state
    expected = GRAD_ACCUM * 2 * cfg.joint.num_hidden_layers
    if launches != expected:
        raise AssertionError(f"card QLoRA update launched the kernel {launches} times, want {expected}")
    rel = {k: abs(metrics["card"][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k]) for k in ("loss", "grad_norm")}
    trained = [(p, a, b) for (p, a), b in zip(leaves_with_paths(params_dev), tree_leaves(params_cpu)) if b.requires_grad]
    param_err = max(float((a.detach().cpu() - b.detach()).abs().max()) for _, a, b in trained)
    if not any("_lora" in p for p, _, _ in trained) or not any(p.startswith("/joint/mixtures/action") for p, _, _ in trained):
        raise AssertionError("the trained leaves miss the adapters or the action expert")
    moved = [p for p, x in nf4_leaves(params_dev) if not torch.equal(x.cpu(), nf4_before[p])]
    moved += [p for p, x in nf4_leaves(params_cpu) if not torch.equal(x, nf4_before[p])]
    if moved:
        raise AssertionError(f"NF4 bases changed: {moved[:5]}")
    # the moments: payloads equal but where a value sits on a rounding tie
    # and the card's sums round it to the neighbouring code, or where a
    # grad is rounding noise on both sides and its sign differs: codes -1
    # and +1, values below 1.6e-6 of their block's absmax; scales to the
    # grads' own relative difference
    codes, scale_rel, bad = {"off_by_one": 0, "sign_of_noise": 0}, 0.0, []
    path_of = {id(x): p for p, x in leaves_with_paths(params_cpu)}
    opt = states["cpu"].opt_state
    names = [f"{path_of[id(p)]}:{k}" for group in opt.param_groups for p in group["params"]
             for k, t in opt.state[p].items() if torch.is_tensor(t)]
    for name, a, b in zip(names, opt_tensors(states["card"]), opt_tensors(states["cpu"])):
        a = a.cpu()
        if a.dtype == torch.int8:
            a, b = a.to(torch.int32), b.to(torch.int32)
            d = (a - b).abs()
            noise = (d > 1) & (a.abs() <= 1) & (b.abs() <= 1)
            codes["off_by_one"] += int((d == 1).sum())
            codes["sign_of_noise"] += int(noise.sum())
            if bool(((d > 1) & ~noise).any()):
                bad.append((name, int(d.max())))
        else:
            scale_rel = max(scale_rel, float(((a - b).abs() / b.abs()).max()))
    # fp32 on both sides: as in the float check; the adapters and the action
    # expert move by lr = 5e-5 per update, so 1e-6 catches a wrong group,
    # lr, code or bias correction
    if not (max(rel.values()) <= 1e-3 and param_err <= 1e-6 and not bad and scale_rel <= 1e-3):
        raise AssertionError(f"QLoRA card vs CPU: relative {rel}, params max|diff| {param_err}, moment codes "
                             f"{codes}, further apart in {bad[:5]}, scales relative {scale_rel}")
    return {"launches": launches, "metrics": metrics, "rel_diff": rel, "param_max_abs_diff": param_err,
            "trained_leaves": len(trained), "moment_codes": codes,
            "moment_codes_total": sum(t.numel() for t in opt_tensors(states["cpu"]) if t.dtype == torch.int8),
            "moment_scale_max_rel_diff": scale_rel, "nf4_leaves_unchanged": len(nf4_before)}


SIMPLER_LITE_CONFIG = "configs/eval/simpler_lite.yaml"
# the geometry's training keys: B = 2 x 2, remat, the full lr at the first update
SIMPLER_LITE_TRAIN = ["per_device_batch_size=2", "global_batch_size=4", "remat=true", "n_updates=1",
                      "action_lr_scheduler={warmup_steps: 0}", "vlm_lr_scheduler={warmup_steps: 0}"]


def check_simpler_lite_update(dev) -> dict:
    """Phase 7 at configs/eval/simpler_lite.yaml's geometry (3 layers, 4 Q
    heads and 1 KV head of 24, which K1 and its backward zero-pad to 32):
    one TrainAgent update in fp32 on the card (the kernels) and on the CPU
    (the plain version) from the CPU agent's params, on one batch of
    SyntheticFrames with injected flow times and noise, Adam eps 1e-3 as
    in the checks above: loss and grad norm within 1e-3 relative, the
    params within 1e-6."""
    tmp = tempfile.mkdtemp(prefix="opz_simpler_lite_")
    try:
        cfg = cfg_lib.load_config(SIMPLER_LITE_CONFIG, SIMPLER_LITE_TRAIN + [f"log_dir={tmp}"])
        frames = SyntheticFrames(0, size=int(cfg.vision.config.image_size))
        agents = {"card": TrainAgent(cfg, dataset=frames, device=dev), "cpu": TrainAgent(cfg, dataset=frames, device="cpu")}
        mcfg = agents["card"].model_cfg
        if mcfg.joint.head_dim != 24 or agents["card"].grad_accum != GRAD_ACCUM:
            raise AssertionError(f"head dim {mcfg.joint.head_dim}, grad_accum {agents['card'].grad_accum}")
        with torch.no_grad():
            for a, b in zip(tree_leaves(agents["card"].state.params), tree_leaves(agents["cpu"].state.params)):
                a.copy_(b)
        rng = np.random.default_rng(12)
        batch = agents["cpu"].next_update_batch(frames.iterator(agents["cpu"].step_batch_size))
        shape = tuple(batch["actions"].shape)
        batch["t"] = torch.from_numpy(rng.uniform(0.05, 0.95, size=shape[:2]).astype(np.float32))
        batch["x0"] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        metrics = {}
        for name, agent in agents.items():
            for group in agent.state.opt_state.param_groups:
                group["eps"] = 1e-3
            before = (fa.launches, fa.bwd_launches)
            metrics[name] = {k: float(v) for k, v in agent.train_step(agent.state, on(agent.device, batch)).items()}
            if name == "card":
                launches = (fa.launches - before[0], fa.bwd_launches - before[1])
        per_update = GRAD_ACCUM * 2 * mcfg.joint.num_hidden_layers
        if launches != (per_update, per_update):
            raise AssertionError(f"card update: {launches} K1 and backward launches, want {per_update} each")
        rel = {k: abs(metrics["card"][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k]) for k in ("loss", "grad_norm")}
        param_err = max(float((a.detach().cpu() - b.detach()).abs().max()) for a, b in
                        zip(tree_leaves(agents["card"].state.params), tree_leaves(agents["cpu"].state.params)))
        if not (max(rel.values()) <= 1e-3 and param_err <= 1e-6):
            raise AssertionError(f"SimplerLite update card vs CPU: relative {rel}, params max|diff| {param_err}")
        return {"head_dim": mcfg.joint.head_dim, "launches": launches[0], "bwd_launches": launches[1],
                "metrics": metrics, "rel_diff": rel, "param_max_abs_diff": param_err}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def compare_states(a, b) -> tuple:
    """(bitwise, max|diff|) over two TrainStates' params, optimizer tensors
    and generator states. A dtype that differs raises: torch.equal promotes
    its operands, so an fp32 copy of an int8 moment would pass as equal."""
    pairs = list(zip(tree_leaves(a.params), tree_leaves(b.params))) + list(zip(opt_tensors(a), opt_tensors(b)))
    dtypes = [(i, x.dtype, y.dtype) for i, (x, y) in enumerate(pairs) if x.dtype != y.dtype]
    if dtypes or len(opt_tensors(a)) != len(opt_tensors(b)):
        raise AssertionError(f"the states' tensors differ in dtype or number: {dtypes[:5]}")
    equal = all(torch.equal(x, y) for x, y in pairs) and torch.equal(a.generator.get_state(), b.generator.get_state())
    diff = max(float((x.detach().float() - y.detach().float()).abs().max()) for x, y in pairs)
    return equal and a.step == b.step, diff


def check_train_agent(dev, info: str) -> tuple:
    """Phase 8b: the QLoRA recipe through the TrainAgent at full width
    (``check_agent_run``), then phase 8d on its checkpoint (``check_eval``),
    in a temporary log_dir removed afterwards, which also holds the
    dataset and the statistics cache. Returns both results."""
    tmp = tempfile.mkdtemp(prefix="opz_train_agent_")
    cache = os.environ.get("XDG_CACHE_HOME")
    os.environ["XDG_CACHE_HOME"] = os.path.join(tmp, "cache")  # the pipeline's statistics cache
    try:
        t0 = time.time()
        agent = check_agent_run(dev, info, tmp)
        log("train-agent: " + json.dumps(agent))
        log(f"phase train-agent ok in {time.time() - t0:.1f} s")
        gc.collect()  # the agent and its wrapped methods form a cycle
        torch.cuda.empty_cache()
        t0 = time.time()
        evaluated = check_eval(dev, info, tmp)
        log("eval: " + json.dumps(evaluated))
        log(f"phase eval ok in {time.time() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.time()
        verified = check_verify(dev, info, tmp)
        log("verify: " + json.dumps(verified))
        log(f"phase verify ok in {time.time() - t0:.1f} s")
        return agent, evaluated
    finally:
        if cache is None:
            os.environ.pop("XDG_CACHE_HOME", None)
        else:
            os.environ["XDG_CACHE_HOME"] = cache
        shutil.rmtree(tmp, ignore_errors=True)


def check_agent_run(dev, info: str, tmp: str) -> dict:
    """The raw dataset written (``write_demo_dataset``, RAW_SIZE² JPEG) and
    resized to 224² JPEG by ``scripts/modify_rlds_dataset``
    (``preprocess_demo_dataset``); the launcher (``scripts/run.main --mode
    train``) builds the TrainAgent, whose datasets come from cfg.data, and
    runs its 3 updates, the validation and the save, each update's batch
    wait timed beside it; the pipeline alone, on the JPEG dataset and on a
    PNG copy of its pixels; a second agent resuming from ``auto``; serving
    from the checkpoint; one profiled update."""
    raw = write_demo_dataset(os.path.join(tmp, "raw"), size=RAW_SIZE)
    log(f"train-agent: wrote {raw['episodes']} bridge-shaped episodes, {raw['frames']} frames of {RAW_SIZE}² JPEG "
        f"({raw['jpeg_kb_mean']:.1f} kB each, {raw['bytes'] / 1e6:.1f} MB in 2 shards) in {raw['write_s']:.1f} s")
    data = preprocess_demo_dataset(os.path.join(tmp, "raw"), os.path.join(tmp, "data"))
    data["raw"] = raw
    log(f"train-agent: scripts/modify_rlds_dataset resized them to 224² JPEG ({data['jpeg_kb_mean']:.1f} kB each, "
        f"{data['bytes'] / 1e6:.1f} MB) in {data['seconds']:.2f} s, {data['frames_per_s']:.1f} frames/s on "
        f"{PREPROCESS_WORKERS} threads")
    overrides = AGENT_OVERRIDES + DATA_OVERRIDES + [
        f"log_dir={tmp}", f"pretrained_model_path={tmp}/no_tokenizer", f"data.train.data_path={os.path.join(tmp, 'data')}",
    ]
    cfg = cfg_lib.load_config(AGENT_CONFIG, overrides=overrides)
    timed = {"update_ms": [], "wait_ms": [], "fetch_ms": [], "losses": [], "grad_norms": [], "validate_launches": None,
             "eval": None}
    seen = {}
    original_run = TrainAgent.run

    def instrumented_run(agent):
        """The launcher's agent: keep it, time its steps, batch waits,
        validation and save, and note its leaves, then run."""
        seen["agent"], seen["build_s"] = agent, time.time() - t0
        seen["methods"] = methods = (agent.train_step, agent.validate, agent.save, agent.next_update_batch)
        train_step_fn, validate_fn, save_fn, next_batch_fn = methods

        def timed_step(st, batch):
            t = time.perf_counter()
            metrics = train_step_fn(st, batch)
            torch.cuda.synchronize()
            timed["update_ms"].append((time.perf_counter() - t) * 1e3)
            timed["losses"].append(float(metrics["loss"]))
            timed["grad_norms"].append(float(metrics["grad_norm"]))
            return metrics

        def timed_batch(it):
            fetch = TimedIterator(it)
            t = time.perf_counter()
            batch = next_batch_fn(fetch)
            torch.cuda.synchronize()
            timed["wait_ms"].append((time.perf_counter() - t) * 1e3)
            timed["fetch_ms"].append(fetch.ms)
            return batch

        def counted_validate(update):
            before = fa.launches
            timed["eval"] = validate_fn(update)
            timed["validate_launches"] = fa.launches - before
            return timed["eval"]

        def timed_save(update):
            t = time.perf_counter()
            path = save_fn(update)
            timed["save_s"] = time.perf_counter() - t
            return path

        agent.train_step, agent.validate, agent.save, agent.next_update_batch = (
            timed_step, counted_validate, timed_save, timed_batch)
        params = agent.state.params
        seen["trained"] = [(p, x) for p, x in leaves_with_paths(params) if x.requires_grad]
        seen["prints"] = {p: fingerprint(x) for p, x in seen["trained"]}
        seen["frozen"] = {p: x.detach().clone()
                          for p, x in nf4_leaves(params) + [("/embed_tokens", params["embed_tokens"])]}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fa.launches = fa.bwd_launches = 0
        return original_run(agent)

    TrainAgent.run = instrumented_run
    try:
        t0 = time.time()
        state = run.main(["--config", AGENT_CONFIG, "--mode", "train", "--device", str(dev), *overrides])
    finally:
        TrainAgent.run = original_run
    agent, build_s = seen["agent"], seen["build_s"]
    agent.train_step, agent.validate, agent.save, agent.next_update_batch = seen["methods"]
    trained, prints, frozen = seen["trained"], seen["prints"], seen["frozen"]
    mcfg = agent.model_cfg
    if state is not agent.state or agent.grad_accum != GRAD_ACCUM or not isinstance(state.opt_state, AdamW8bit):
        raise AssertionError(f"grad_accum {agent.grad_accum}, optimizer {type(state.opt_state).__name__}")
    L = mcfg.joint.num_hidden_layers
    per_update = GRAD_ACCUM * 2 * L
    launches, bwd_launches = fa.launches - (timed["validate_launches"] or 0), fa.bwd_launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    opt_gb = nbytes(opt_tensors(state)) / 1e9  # made at the first update
    tree_gb = nbytes(tree_leaves(state.params)) / 1e9
    log(f"train-agent: {AGENT_CONFIG} QLoRA at full width through scripts/run.py --mode train, the datasets from "
        f"cfg.data, built in {build_s:.1f} s: tree {tree_gb:.3f} GB, {len(trained)} trained leaves "
        f"({sum(x.numel() for _, x in trained) / 1e9:.4f} B params), {len(frozen) - 1} NF4 leaves")
    if launches != 3 * per_update or bwd_launches != 3 * per_update:
        raise AssertionError(f"{launches} K1 and {bwd_launches} backward launches over 3 updates, "
                             f"want {3 * per_update} and {3 * per_update}")
    want_val = mcfg.joint.num_hidden_layers * (1 + mcfg.num_inference_steps)  # one batch of 16, one chunk
    if timed["validate_launches"] != want_val or timed["eval"] is None:
        raise AssertionError(f"validate: {timed['validate_launches']} K1 launches (want {want_val}), {timed['eval']}")
    if state.step != 3 or not np.all(np.isfinite(timed["losses"] + timed["grad_norms"])):
        raise AssertionError(f"step {state.step}, losses {timed['losses']}, grad norms {timed['grad_norms']}")
    if len(timed["wait_ms"]) != 3:
        raise AssertionError(f"{len(timed['wait_ms'])} batch waits timed over 3 updates")
    unchanged = [p for p, x in trained if fingerprint(x) == prints[p]]
    now = dict(leaves_with_paths(state.params))
    moved = [p for p, x in frozen.items() if not torch.equal(x, now[p])]
    if unchanged or moved:
        raise AssertionError(f"trained leaves unchanged: {unchanged[:5]}; frozen leaves changed: {moved[:5]}")
    ckpt = os.path.join(agent.ckpt_dir, "ckpt_3")
    ckpt_gb = dir_bytes(ckpt) / 1e9
    t = time.perf_counter()
    ckpt_lib.restore_checkpoint(ckpt, state)  # the state it holds: a no-op but for the time
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    del frozen
    log(f"train-agent: 3 updates on pipeline frames, losses {timed['losses']}, grad norms {timed['grad_norms']}; "
        f"validate at 3: l1 {timed['eval']['l1']:.4f}, accuracy {timed['eval']['accuracy']} "
        f"({timed['validate_launches']} K1 launches); update {statistics.median(timed['update_ms'][1:]):.1f} ms "
        f"(median of updates 2-3), peak memory {peak_gb:.3f} GB, tree {tree_gb:.3f} GB, optimizer state "
        f"{opt_gb:.3f} GB, checkpoint {ckpt_gb:.3f} GB saved in {timed['save_s']:.2f} s, restored in "
        f"{restore_s:.2f} s, on {info}")
    log(f"train-agent: per update, the wait for its batch (B = {agent.step_batch_size} x {GRAD_ACCUM} frames "
        f"through the pipeline, preprocess, to the card) {[round(w, 3) for w in timed['wait_ms']]} ms, of it the "
        f"frames from the iterator {[round(f, 3) for f in timed['fetch_ms']]} ms, beside the update "
        f"{[round(u, 3) for u in timed['update_ms']]} ms (the first wait fills the shuffle buffer)")
    alone = pipeline_alone(agent.dataset, agent.step_batch_size)
    png_copy(os.path.join(tmp, "data"), os.path.join(tmp, "data_png"))
    png_cfg = cfg_lib.ConfigDict({**cfg.data.train, "data_path": os.path.join(tmp, "data_png")})
    alone["png"] = pipeline_alone(RLDSInterleavedDataset(png_cfg, train=True, seed=agent.seed), agent.step_batch_size)
    log(f"train-agent: the pipeline alone on this host: first batch of a fresh iterator in "
        f"{alone['first_batch_s']:.2f} s (1000 encoded frames read into the shuffle buffer), then "
        f"{alone['frames_per_s']:.1f} frames/s through JPEG decode, resize, augment and batching "
        f"({PIPELINE_BATCHES} batches of {agent.step_batch_size}); on a PNG copy of the same pixels "
        f"{alone['png']['first_batch_s']:.2f} s, then {alone['png']['frames_per_s']:.1f} frames/s; on {info}")

    # the resume: a partial ckpt_99 beside ckpt_3 (a save cut short: no
    # meta.json); the resumed agent's datasets come from cfg.data as well,
    # and its iterator starts again from the seed
    os.makedirs(os.path.join(agent.ckpt_dir, "ckpt_99", ckpt_lib.STATE_DIR))
    cfg2 = cfg_lib.load_config(AGENT_CONFIG, overrides=overrides + ["resume_checkpoint_path=auto", "n_updates=4"])
    resumed = TrainAgent(cfg2, device=dev)
    if resumed.state.step != 3 or resumed.cnt_batch != agent.cnt_batch:
        raise AssertionError(f"resumed at step {resumed.state.step}, cnt_batch {resumed.cnt_batch}; want 3, {agent.cnt_batch}")
    resumed_opt_gb = nbytes(opt_tensors(resumed.state)) / 1e9  # as restored, before its update
    # one update on the dataset's first batches; its save of ckpt_4 (a
    # second 10.7 GB write, timed by the first agent's) is skipped
    skipped_saves = []
    resumed.save = skipped_saves.append
    resumed.run()
    if skipped_saves != [4]:
        raise AssertionError(f"the resumed agent saved at {skipped_saves}, want [4]")
    it = agent.dataset.iterator(agent.step_batch_size)
    try:
        batch = agent.next_update_batch(it)
    finally:
        it.close()  # the pipeline's threads stop: this update runs alone on the host
    torch.cuda.synchronize()
    t = time.perf_counter()
    agent.train_step(state, batch)
    torch.cuda.synchronize()
    quiet_ms = (time.perf_counter() - t) * 1e3
    del batch
    bitwise, resume_diff = compare_states(resumed.state, state)
    if not (bitwise or resume_diff <= 1e-6):
        raise AssertionError(f"the resumed agent's update 4 differs from the first agent's: max|diff| {resume_diff}")
    if resumed_opt_gb != opt_gb:
        raise AssertionError(f"optimizer state {resumed_opt_gb:.3f} GB as restored, {opt_gb:.3f} GB as saved")
    log(f"train-agent: resumed from ckpt_3 (not the partial ckpt_99) at step 3, cnt_batch {resumed.cnt_batch}, "
        f"optimizer state {resumed_opt_gb:.3f} GB as restored ({opt_gb:.3f} GB saved); update 4 "
        f"{'bitwise' if bitwise else 'within 1e-6 of'} the first agent's (params, moments and their dtypes, "
        f"generator): max|diff| {resume_diff:.3e}; the first agent's update 4 with no pipeline thread running "
        f"{quiet_ms:.1f} ms (updates 2-3 beside the prefetch thread: {timed['update_ms'][1]:.1f}, "
        f"{timed['update_ms'][2]:.1f} ms)")
    del resumed
    torch.cuda.empty_cache()

    served = check_agent_serving(dev, cfg, mcfg, ckpt)
    return {
        "launches": launches, "bwd_launches": bwd_launches, "validate_launches": timed["validate_launches"],
        "losses": timed["losses"], "grad_norms": timed["grad_norms"], "eval": timed["eval"], "data": data,
        "wait_ms": timed["wait_ms"], "fetch_ms": timed["fetch_ms"], "pipeline_alone": alone,
        "update_ms_without_pipeline_thread": quiet_ms,
        "update_ms": timed["update_ms"], "update_ms_median_after_first": statistics.median(timed["update_ms"][1:]),
        "peak_mem_gb": peak_gb, "tree_gb": tree_gb, "opt_state_gb": opt_gb, "resumed_opt_state_gb": resumed_opt_gb,
        "checkpoint_gb": ckpt_gb,
        "save_s": timed["save_s"], "restore_s": restore_s, "build_s": build_s,
        "resume_bitwise": bitwise, "resume_max_abs_diff": resume_diff, "serving": served,
    }


def check_agent_serving(dev, cfg, mcfg, ckpt: str) -> dict:
    """``scripts/serve.load_params`` on the checkpoint (merge, NF4 decode,
    the production layout): one bf16 chunk, finite and in the clip, within
    the drift limit of the chunk of the merged float eval params in bf16,
    with the same noise."""
    rng = np.random.default_rng(9)
    batch = example_batch(mcfg, 1, rng)
    a0 = rng.normal(size=(1, mcfg.horizon_steps, mcfg.action_dim)).astype(np.float32)
    t0 = time.time()
    served = serve.load_params(cfg_lib.ConfigDict({**cfg, "checkpoint_path": ckpt}), mcfg, torch.bfloat16, dev, False)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    if lora_lib.has_lora(served) or "qa" not in served["joint"]["mixtures"]["vlm"]["layers"]["attn"]["qkv"]:
        raise AssertionError("the served tree is not the production layout of the merged params")
    chunk = run_infer(served, mcfg, batch, a0, dev, torch.bfloat16).float().cpu()
    tree_gb = nbytes(tree_leaves(served)) / 1e9
    del served
    merged = serve.merge_and_decode(ckpt_lib.restore_params(ckpt, serve.abstract_params(mcfg), dev), mcfg, torch.float32)
    merged = tree_map(lambda x: x.to(torch.bfloat16), merged)
    want = run_infer(merged, mcfg, batch, a0, dev, torch.bfloat16).float().cpu()
    del merged
    torch.cuda.empty_cache()
    drift = float((chunk - want).abs().mean())
    clip = mcfg.final_action_clip_value
    if not (torch.isfinite(chunk).all() and chunk.abs().max() <= clip and drift <= DRIFT_LIMIT):
        raise AssertionError(f"served chunk: finite {bool(torch.isfinite(chunk).all())}, max "
                             f"{float(chunk.abs().max())} (clip {clip}), drift {drift} (limit {DRIFT_LIMIT})")
    log(f"train-agent: served ckpt_3 through scripts/serve.load_params (loaded in {load_s:.1f} s, production tree "
        f"{tree_gb:.3f} GB): chunk finite, in the clip, drift from the merged float params' bf16 chunk {drift:.3e} "
        f"(<= {DRIFT_LIMIT})")
    return {"load_s": load_s, "tree_gb": tree_gb, "drift": drift}


# --------------------------------------------------------------------------- #
# phase 8d: closed-loop evaluation through the launcher
# --------------------------------------------------------------------------- #

EVAL_CONFIG = "configs/eval/bridge.yaml"
EVAL_EPISODES = 3
EVAL_CHECKED = 3  # in-loop chunks of the launcher's run held bitwise against the eager chunk
# the keys that make the eval config's model the one phase 8b trained: the
# train config's time embedding period and action-expert RoPE theta, and
# its QLoRA keys (AGENT_OVERRIDES; SigLIP's adapters and NF4 base too)
TRAINED_MODEL_OVERRIDES = [
    "time_max_period=100.0", "action_expert_rope_theta=100.0", "quantize=true", "lora=true",
    "vision.use_lora=true", "vision.use_quantize=true",
]
# bridge widths at depth 2 (config.bridge_width_dryrun_config) as eval
# config keys: a 56² image of 16 tokens, a 4096 vocabulary
BRIDGE_WIDTH_OVERRIDES = [
    "joint.config.num_hidden_layers=2", "vision.config.num_hidden_layers=2", "vision.config.image_size=56",
    "vision.config.num_image_tokens=16", "vocab_size=4096", "image_token_index=4000", "max_seq_len=24",
    "env.adapter.max_seq_len=24", "env.adapter.num_image_tokens=16", "env.adapter.image_size=[56, 56]",
    "env.adapter.image_token_index=4000",
]
HOST_PARTS = (  # (label, owner, method): the host work of a chunk, timed at the class
    ("preprocess", env_adapter.SimplerAdapter, "preprocess"),
    ("resize", env_adapter.SimplerAdapter, "resize_image"),
    ("processor", VLAProcessor, "__call__"),
    ("act", EvalAgent, "act"),
    ("postprocess", env_adapter.SimplerAdapter, "postprocess"),
    ("env_steps", ReachEnv, "step"),
)


class EvalProbe:
    """Instruments one eval run at the class level, and restores the
    classes on exit: the host ms of each part of a chunk (``HOST_PARTS``),
    each act's agent, inputs and chunk, and each graph replay's tier
    (t_start), noise and batch; ``check`` replays are held bitwise against
    the eager chunk afterwards."""

    def __init__(self):
        self.ms = {label: [] for label, _, _ in HOST_PARTS}
        self.acts, self.replays = [], []
        self._saved = []

    def __enter__(self):
        for label, owner, name in HOST_PARTS:
            self._wrap(owner, name, self._timed(label, getattr(owner, name)))
        self._wrap(EvalAgent, "act", self._recorded_act(EvalAgent.act))
        self._wrap(compiled.CompiledChunk, "__call__", self._recorded_replay(compiled.CompiledChunk.__call__))
        return self

    def __exit__(self, *exc):
        for owner, name, original in reversed(self._saved):
            setattr(owner, name, original)
        self._saved.clear()

    def _wrap(self, owner, name, fn):
        self._saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, fn)

    def _timed(self, label, fn):
        times = self.ms[label]

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            times.append((time.perf_counter() - t0) * 1e3)
            return out

        return timed

    def _recorded_act(self, act):
        def recorded(agent, inputs):
            out = act(agent, inputs)
            self.acts.append({"agent": agent, "inputs": inputs, "chunk": out})
            return out

        return recorded

    def _recorded_replay(self, call):
        def recorded(graph, batch):
            out = call(graph, batch)
            self.replays.append({"t_start": graph.t_start, "noise": graph.noise.clone(), "batch": batch})
            return out

        return recorded


def eager_chunk(agent, replay: dict) -> np.ndarray:
    """The eager chunk of one replay's batch and noise on the agent's
    params (its graph's ``_chunk``): ``infer_action`` or, from the
    batch's ``prev_chunk``, ``infer_action_refined``."""
    x = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, device=agent.device)
         for k, v in replay["batch"].items()}
    dtype = agent.dtype
    args = (agent.params, agent.model_cfg, None, x["input_ids"], x["pixel_values"].to(dtype), x["attention_mask"],
            x["proprios"].to(dtype))
    if replay["t_start"] > 0.0:
        out = pizero.infer_action_refined(*args, x["prev_chunk"].to(dtype), t_start=replay["t_start"], x0=replay["noise"])
    else:
        out = pizero.infer_action(*args, action0=replay["noise"])
    return out[0].float().cpu().numpy()


def check_in_loop_chunks(probe: EvalProbe, n: int, label: str) -> int:
    """The first ``n`` in-loop chunks bitwise equal to the eager chunk on
    the same batch and noise; every chunk finite and in the clip."""
    if len(probe.replays) != len(probe.acts):
        raise AssertionError(f"{label}: {len(probe.acts)} acts but {len(probe.replays)} graph replays")
    for i, (act, replay) in enumerate(zip(probe.acts, probe.replays)):
        chunk, clip = act["chunk"], act["agent"].model_cfg.final_action_clip_value
        if not (np.isfinite(chunk).all() and np.abs(chunk).max() <= clip):
            raise AssertionError(f"{label}: chunk {i} not finite or outside the clip {clip}")
        if i < n and not np.array_equal(chunk, eager_chunk(act["agent"], replay)):
            raise AssertionError(f"{label}: in-loop chunk {i} differs from the eager chunk on its batch and noise")
    return min(n, len(probe.acts))


def host_ms_per_chunk(probe: EvalProbe) -> dict:
    """Each host part's ms summed over the run, per chunk (the first chunk
    left out of the act's mean and median)."""
    n = len(probe.acts)
    out = {label: sum(ms) / n for label, ms in probe.ms.items() if label != "act"}
    out["preprocess_rest"] = out["preprocess"] - out["resize"] - out["processor"]
    acts = probe.ms["act"][1:]
    out["act_mean"], out["act_median"] = statistics.mean(acts), statistics.median(acts)
    return out


def eval_overrides(tmp: str, ckpt: str) -> list:
    """configs/eval/bridge.yaml on phase 8b's checkpoint: the SimplerLite
    reach task, bf16, the trained model's keys, a statistics file written
    from configs/statistics/bridge_statistics.json; no video (imageio is
    not on the card's machine) and pretrained_model_path at no file (so the
    adapter takes the warmed FakeTokenizer)."""
    stats = os.path.join(tmp, "eval_statistics.json")
    shutil.copyfile("configs/statistics/bridge_statistics.json", stats)
    return [
        "env.task=simpler_lite_reach", "use_bf16=true", f"n_eval_episode={EVAL_EPISODES}", f"checkpoint_path={ckpt}",
        f"env.adapter.dataset_statistics_path={stats}", *TRAINED_MODEL_OVERRIDES, "record_video=false",
        f"log_dir={tmp}/eval", f"env.adapter.pretrained_model_path={tmp}/no_tokenizer",
    ]


def check_eval(dev, info: str, tmp: str) -> dict:
    """Phase 8d: the launcher (``scripts/run.main``) evaluates phase 8b's
    ckpt_3 in closed loop on the SimplerLite reach task, at full width in
    bf16, in the serving layout of its config; a refined run of one
    episode on the same params; card vs CPU at bridge widths."""
    ckpt = os.path.join(tmp, "checkpoint", "ckpt_3")
    overrides = eval_overrides(tmp, ckpt)
    cfg = cfg_lib.load_config(EVAL_CONFIG, overrides)
    trained = cfg_lib.pizero_config_from_dict(cfg_lib.load_config(AGENT_CONFIG, AGENT_OVERRIDES))
    model = cfg_lib.pizero_config_from_dict(cfg)
    # remat is a training switch: the rest must be the trained model's
    if dataclasses.replace(model, joint=dataclasses.replace(model.joint, remat=trained.joint.remat)) != trained:
        raise AssertionError(f"the eval config's model {model} is not the one phase 8b trained: {trained}")
    L = trained.joint.num_hidden_layers
    per_chunk = L + L * trained.num_inference_steps
    per_refined = L + L * round(trained.num_inference_steps * 0.5)
    chunks_per_episode = math.ceil(make_env("simpler_lite_reach").max_steps / int(cfg.act_steps))

    # the launcher's run: K1 launches only at the capture (the warm-up and
    # the captured chunk); every act is one replay
    with EvalProbe() as probe:
        fa.launches = fa.bwd_launches = 0
        t0 = time.time()
        result = run.main(["--config", EVAL_CONFIG, "--device", str(dev), *overrides])
        run_s = time.time() - t0
        launches = fa.launches
    agent = probe.acts[0]["agent"]
    n = len(probe.acts)
    if result["n_episodes"] != EVAL_EPISODES or n != EVAL_EPISODES * chunks_per_episode:
        raise AssertionError(f"{result}, {n} chunks; want {EVAL_EPISODES} episodes of {chunks_per_episode}")
    if launches != 2 * per_chunk or {r["t_start"] for r in probe.replays} != {0.0}:
        raise AssertionError(f"{launches} K1 launches by the wrapper (want {2 * per_chunk}, the capture's), "
                             f"replays of tiers {sorted({r['t_start'] for r in probe.replays})}")
    checked = check_in_loop_chunks(probe, EVAL_CHECKED, "eval")
    host = host_ms_per_chunk(probe)
    layout = "production (int8 action expert, W8A8 VLM trunk)" if fuse.serving_layout_kwargs(cfg) else "fused bf16"
    inputs = probe.acts[-1]["inputs"]
    got, traced, wall = profiled_window(
        lambda: agent.act(inputs), {None: None, KERNEL_SYMBOL: per_chunk, ROWS_SYMBOL: 0, KEYS_SYMBOL: 0},
        counted=(0, 0))
    busy = got[None][0]
    log_profile("eval act", traced, wall, busy)
    log(f"eval: {EVAL_CONFIG} on ckpt_3 via scripts/run.main, {layout} layout, bf16: {result['n_episodes']} episodes, "
        f"success rate {result['success_rate']} (of a 3-update checkpoint: not a quality number), "
        f"{result['success_by_instruction']}; {n} chunks, {n} graph replays, {launches} K1 launches counted (the "
        f"capture); first {checked} in-loop chunks bitwise the eager chunk; all finite, in the clip")
    log(f"eval: in-loop chunk (act: inputs to the card, one replay, chunk to the host) mean {host['act_mean']:.3f} ms, "
        f"median {host['act_median']:.3f} ms (chunks 2-{n}); the loop's mean_inference_time_s "
        f"{1e3 * result['mean_inference_time_s']:.3f} ms (act + postprocess); host ms per chunk: resize "
        f"{host['resize']:.3f}, processor {host['processor']:.3f}, rest of preprocess {host['preprocess_rest']:.3f}, "
        f"postprocess {host['postprocess']:.3f}, {cfg.act_steps} env steps {host['env_steps']:.3f}; a profiled act "
        f"{wall:.3f} ms, device busy {busy:.3f} ms, K1 {got[KERNEL_SYMBOL][0]:.3f} ms over "
        f"{got[KERNEL_SYMBOL][1]} launches; run {run_s:.1f} s, on {info}")

    # the refined tier: one episode on the same served params; the first
    # chunk is the full graph's, every later one the refined graph's
    cfg2 = cfg_lib.load_config(EVAL_CONFIG, overrides + ["refine_from_prev=0.5", "n_eval_episode=1"])
    fa.launches = 0
    with EvalProbe() as probe2:
        refined_agent = EvalAgent(cfg2, params=agent.params, device=dev)
        if fa.launches != 2 * (per_chunk + per_refined):
            raise AssertionError(f"the two captures launched K1 {fa.launches} times, want {2 * (per_chunk + per_refined)}")
        refined_result = refined_agent.run()
    tiers = [r["t_start"] for r in probe2.replays]
    if refined_result["n_episodes"] != 1 or tiers != [0.0] + [0.5] * (chunks_per_episode - 1):
        raise AssertionError(f"refined run: {refined_result}, tiers {tiers}")
    checked_refined = check_in_loop_chunks(probe2, 4, "eval refined")
    refined_host = host_ms_per_chunk(probe2)
    k1 = {}
    for name, want in (("full", per_chunk), ("refined", per_refined)):
        def act():  # a retaken window acts again: the full act from an empty cache
            if name == "full":
                refined_agent.reset_policy_cache()
            return refined_agent.act(inputs)

        act()  # after it the cache holds a chunk: a refined act refines
        got2, _, _ = profiled_window(act, {KERNEL_SYMBOL: want, ROWS_SYMBOL: 0, KEYS_SYMBOL: 0}, counted=(0, 0))
        k1[name] = got2[KERNEL_SYMBOL]
    log(f"eval refined (refine_from_prev=0.5): 1 episode, success rate {refined_result['success_rate']}; "
        f"{len(tiers)} replays: the first of the full graph, {len(tiers) - 1} of the refined graph; first "
        f"{checked_refined} in-loop chunks bitwise the eager chunk; profiled act: full {k1['full'][1]} K1 launches "
        f"{k1['full'][0]:.3f} ms, refined {k1['refined'][1]} launches {k1['refined'][0]:.3f} ms; in-loop chunk "
        f"mean {refined_host['act_mean']:.3f} ms (chunks 2-{len(tiers)})")
    del refined_agent, agent, probe, probe2
    gc.collect()
    torch.cuda.empty_cache()

    parity = check_eval_parity(dev, tmp)
    return {
        "result": result, "chunks": n, "replays": n, "capture_launches": launches, "bitwise_checked": checked,
        "layout": layout, "host_ms_per_chunk": host, "profiled_act_ms": wall, "busy_ms": busy,
        "k1_launches_per_chunk": got[KERNEL_SYMBOL][1], "k1_ms": got[KERNEL_SYMBOL][0],
        "refined": {"result": refined_result, "tiers": tiers, "bitwise_checked": checked_refined,
                    "k1_launches": {k: v[1] for k, v in k1.items()}, "k1_ms": {k: v[0] for k, v in k1.items()},
                    "host_ms_per_chunk": refined_host},
        "parity": parity, "run_s": run_s,
    }


VERIFY_PASS = ("load", "oracle", "drift", "refine")  # the stages that must PASS at full width (refine: finite)


def check_verify(dev, info: str, tmp: str) -> dict:
    """Phase 8g: ``scripts/verify_checkpoint``'s main on phase 8b's ckpt_3
    at full width, fp32, with EVAL_CONFIG and the trained model's keys:
    load, oracle and drift PASS within its default bands, refine reports
    its value; K1 launched exactly as its stages' chunks take it: the
    oracle's cached chunk and its no-cache forward (L per velocity
    evaluation over the whole sequence), the drift's fused and production
    chunks, the refine's full chunk and its refined one."""
    ckpt = os.path.join(tmp, "checkpoint", "ckpt_3")
    mcfg = cfg_lib.pizero_config_from_dict(cfg_lib.load_config(EVAL_CONFIG, overrides=TRAINED_MODEL_OVERRIDES))
    L, steps = mcfg.joint.num_hidden_layers, mcfg.num_inference_steps
    chunk = L * (1 + steps)
    want = chunk + L * steps + 2 * chunk + chunk + L * (1 + round(steps * 0.5))
    fa.launches = 0
    result = verify_checkpoint.main([ckpt, "--config", EVAL_CONFIG, "--device", str(dev), *TRAINED_MODEL_OVERRIDES])
    launches = fa.launches
    status = dict(result["results"])
    if any(status.get(stage) != "PASS" for stage in VERIFY_PASS) or launches != want:
        raise AssertionError(f"verify_checkpoint on ckpt_3: {status}, values {result['values']}, {launches} K1 "
                             f"launches (want {want})")
    seconds = result["seconds"]
    log(f"verify: scripts/verify_checkpoint.py on ckpt_3 at full width, fp32: "
        + ", ".join(f"{stage} {status.get(stage, '-')} {seconds[stage]:.1f} s" for stage in seconds)
        + f"; oracle mean L1 {result['values']['oracle']:.3e}, drift {result['values']['drift']:.3e} (bands "
        f"{verify_checkpoint.DEFAULT_BAND}), refine {result['values']['refine']:.3e} (report-only); {launches} K1 "
        f"launches, on {info}")
    return {"results": result["results"], "values": result["values"], "seconds": seconds, "launches": launches}


def check_eval_parity(dev, tmp: str) -> dict:
    """One SimplerLite reach episode at bridge widths, depth 2, fp32, through
    an EvalAgent on the card (its graph) and one on the CPU (the eager
    chunk, K1's plain version) from the same params; the CPU chunk takes
    the noise each card replay drew. Actions within 1e-3, the same
    instructions, success and episode count."""
    stats = os.path.join(tmp, "eval_statistics.json")
    overrides = ["env.task=simpler_lite_reach", "use_bf16=false", "n_eval_episode=1", "record_video=false",
                 f"env.adapter.dataset_statistics_path={stats}", f"log_dir={tmp}/eval_parity",
                 f"env.adapter.pretrained_model_path={tmp}/no_tokenizer", *BRIDGE_WIDTH_OVERRIDES]
    cfg = cfg_lib.load_config(EVAL_CONFIG, overrides)
    mcfg = cfg_lib.pizero_config_from_dict(cfg)
    params_cpu = cpu_params(mcfg)
    params_dev = tree_map(lambda x: x.to(dev), params_cpu)
    with EvalProbe() as probe:
        card_result = EvalAgent(cfg, params=params_dev, device=dev).run()
    noises = [r["noise"].cpu() for r in probe.replays]
    cpu_agent = EvalAgent(cfg, params=params_cpu, device="cpu")

    def injected(inputs):
        x = {k: torch.as_tensor(inputs[k]) for k in ("input_ids", "pixel_values", "attention_mask", "proprios")}
        return pizero.infer_action(params_cpu, mcfg, None, x["input_ids"], x["pixel_values"], x["attention_mask"],
                                   x["proprios"], action0=noises.pop(0))

    cpu_agent._infer = injected
    with EvalProbe() as cpu_probe:
        cpu_result = cpu_agent.run()
    card_chunks = [a["chunk"] for a in probe.acts]
    cpu_chunks = [a["chunk"] for a in cpu_probe.acts]
    # fp32 on both sides (TF32 off): as phase 3, the card sums in other
    # orders, ~1e-6 relative per op; 1e-3 catches a wrong mask, cast or input
    err = max(float(np.abs(a - b).max()) for a, b in zip(card_chunks, cpu_chunks))
    same = {k: card_result[k] == cpu_result[k] for k in ("n_episodes", "success_rate", "success_by_instruction")}
    if len(card_chunks) != len(cpu_chunks) or err > 1e-3 or not all(same.values()) or noises:
        raise AssertionError(f"card vs CPU eval: {len(card_chunks)} / {len(cpu_chunks)} chunks, max|diff| {err}, "
                             f"results {card_result} / {cpu_result}")
    log(f"eval parity: bridge widths depth 2 fp32, one reach episode of {len(card_chunks)} chunks, card (graph) vs "
        f"CPU (eager, the card's noise): actions max|diff| {err:.3e} (<= 1e-3), success {card_result['success_rate']} "
        f"on both")
    return {"chunks": len(card_chunks), "max_abs_diff": err, "success_rate": card_result["success_rate"]}


def check_full_finetune_8bit(dev, info: str, updates: int = 2) -> dict:
    """Phase 8c: phase 8's full fine-tune (fp32, remat, B = 16 x 2) with
    int8 Adam moments (configs/train/bridge_v5e.yaml's recipe on one card)."""
    cfg = with_remat(cfg_lib.PiZeroConfig())
    train_cfg = cfg_lib.TrainingConfig(quantize_optimizer_states=True)
    params = pizero.init_params(cfg, seed=0, device=dev, dtype=torch.float32)
    state, step = new_trainer(cfg, train_cfg, params, dev)
    rng = np.random.default_rng(8)
    batches = [on(dev, train_batch(cfg, TRAIN_B, rng)) for _ in range(updates)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fa.launches = fa.bwd_launches = 0
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(float(step(state, batch)["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    expected = updates * GRAD_ACCUM * 2 * cfg.joint.num_hidden_layers
    if (fa.launches, fa.bwd_launches) != (expected, expected) or not np.all(np.isfinite(losses)):
        raise AssertionError(f"launches {(fa.launches, fa.bwd_launches)}, want {expected}; losses {losses}")
    result = {"losses": losses, "update_ms": times, "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
              "opt_state_gb": nbytes(opt_tensors(state)) / 1e9, "launches": fa.launches}
    log(f"train-8bit: full fine-tune, int8 Adam moments: losses {losses}, update {times[-1]:.1f} ms (update "
        f"{updates}), peak memory {result['peak_mem_gb']:.3f} GB, optimizer state {result['opt_state_gb']:.3f} GB, "
        f"on {info}")
    return result


# --------------------------------------------------------------------------- #
# phase 8e: the closed-loop learning chain, at a cut run length
# --------------------------------------------------------------------------- #


LEARN_DEMOS = 24
LEARN_UPDATES = 100
LEARN_EPISODES = 4  # trained and random-init episodes each
LEARN_WINDOW = 50  # updates per entry of demo_closed_loop's loss curve
LEARN_TIERS = "fp32_fused,w8a8_default"
LEARN_TIER_EPISODES = 2
LEVER_DEMOS = 4  # phase 8e's tri_lever leg: demos per bridge dataset
LEVER_DRAWER_DEMOS = 6  # its drawer set, two per target (the coverage set: half of it)
LEVER_UPDATES = 50
LEVER_EPISODES = 1  # trained and random-init episodes per scored task
LEVER_TASKS = ["reach", "pick_place", "drawer"]  # scored; drawer_cov is trained on only
QLORA_UPDATES = 100  # phase 8f, on 8e's checkpoint
QLORA_RETENTION = 0.5
QLORA_PAYLOADS = 26  # NF4 q4 / absmax leaves at the reach geometry (JAX: 26)


@contextlib.contextmanager
def learn_workdir():
    """A temporary workdir for phases 8e and 8f, with the pipeline's
    statistics cache inside it; removed on exit."""
    tmp = tempfile.mkdtemp(prefix="opz_learn_")
    cache = os.environ.get("XDG_CACHE_HOME")
    os.environ["XDG_CACHE_HOME"] = os.path.join(tmp, "cache")
    try:
        yield tmp
    finally:
        if cache is None:
            os.environ.pop("XDG_CACHE_HOME", None)
        else:
            os.environ["XDG_CACHE_HOME"] = cache
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def caught_agent():
    """{"agent", "batch"}: the TrainAgent that runs inside the block and
    its last update's batch, caught by wrapping the class's ``run`` and
    ``next_update_batch`` for the block."""
    caught, run_, next_ = {}, TrainAgent.run, TrainAgent.next_update_batch

    def run_kept(self):
        caught["agent"] = self
        return run_(self)

    def next_kept(self, it):
        caught["batch"] = next_(self, it)
        return caught["batch"]

    TrainAgent.run, TrainAgent.next_update_batch = run_kept, next_kept
    try:
        yield caught
    finally:
        TrainAgent.run, TrainAgent.next_update_batch = run_, next_


def profile_learn_update(caught: dict, layers: int, label: str) -> dict:
    """One more update of a caught agent on its last batch, profiled: K1's
    ``layers`` launches and the backward kernels' 2 ``layers`` (no remat, no
    accumulation), their device ms, the update's busy and wall ms."""
    agent = caught["agent"]
    got, traced, wall = profiled_window(
        lambda: agent.train_step(agent.state, caught["batch"]),
        {None: None, KERNEL_SYMBOL: layers, ROWS_SYMBOL: layers, KEYS_SYMBOL: layers},
        counted=(layers, 2 * layers),
    )
    busy = got[None][0]
    log_profile(label, traced, wall, busy)
    return {"kernel_ms": got[KERNEL_SYMBOL][0], "backward_ms": got[ROWS_SYMBOL][0] + got[KEYS_SYMBOL][0],
            "busy_ms": busy, "wall_ms": wall}


def check_learn(dev, info: str, tmp: str) -> dict:
    """Phase 8e: ``demo_closed_loop.main`` on the reach task at its recipe's
    geometry, cut to LEARN_DEMOS demos and LEARN_UPDATES updates, in ``tmp``
    (a ``learn_workdir``); then ``e2e_tier_sweep.main`` on its final
    checkpoint, and one more update of the run's agent profiled. The launch
    counts are set to 0 just before the run and read just after it."""
    with caught_agent() as caught:
        fa.launches = fa.bwd_launches = 0
        result = demo_closed_loop.main([
            "--task", "reach", "--workdir", tmp, "--n-demos", str(LEARN_DEMOS), "--n-updates", str(LEARN_UPDATES),
            "--n-eval-episodes", str(LEARN_EPISODES), "--device", str(dev),
        ])
        launches = (fa.launches, fa.bwd_launches)
    layers = result["model"]["layers"]
    curve = result["loss_per_50_updates"]
    if result["expert_success_rate"] != 1.0:
        raise AssertionError(f"expert success rate {result['expert_success_rate']}, want 1.0")
    if len(curve) != LEARN_UPDATES // LEARN_WINDOW or not np.all(np.isfinite(curve)):
        raise AssertionError(f"the loss per {LEARN_WINDOW} updates: {curve}")
    if not curve[-1] < curve[0] / 2:
        raise AssertionError(f"mean loss of the last {LEARN_WINDOW} updates {curve[-1]} is not below half of the "
                             f"first {LEARN_WINDOW}'s {curve[0]}")
    # no remat, no accumulation: one K1 per layer forward, its two
    # backward kernels per layer backward
    per_update = (result["k1_launches_per_update"], result["bwd_launches_per_update"])
    if per_update != (layers, 2 * layers) or launches[1] != 2 * layers * LEARN_UPDATES:
        raise AssertionError(f"launches per update {per_update}, want {(layers, 2 * layers)}; over the run "
                             f"{launches}")
    ckpt = os.path.join(tmp, "train", "checkpoint", f"ckpt_{LEARN_UPDATES}")
    if not (ckpt_lib.is_checkpoint(ckpt) and os.path.exists(os.path.join(ckpt, ckpt_lib.PARAMS_DIR,
                                                                               ckpt_lib.PARAMS_FILE))):
        raise AssertionError(f"no checkpoint with its params/ export at {ckpt}")
    log(f"learn: {LEARN_DEMOS} reach demos (expert rate {result['expert_success_rate']}), {LEARN_UPDATES} "
        f"updates of B = 32: update {result['update_ms']:.3f} ms (median, the first left out), batch wait "
        f"{result['batch_wait_ms']['median_after_first']:.3f} ms (median; mean "
        f"{result['batch_wait_ms']['mean_after_first']:.3f}, first {result['batch_wait_ms']['first']:.1f}), "
        f"timings {json.dumps(result['timings_s'])} s, on {info}")
    log(f"learn: loss per {LEARN_WINDOW} updates {[round(x, 4) for x in curve]}; K1 {per_update[0]:g} and backward "
        f"{per_update[1]:g} launches per update at head dim 24; the run's counts {launches}")
    log(f"learn: after {LEARN_UPDATES} updates, {LEARN_EPISODES} trained episodes "
        f"{result['trained_success_rate']}, random-init control {result['random_init_success_rate']} "
        "(printed, not asserted)")
    prof = profile_learn_update(caught, layers, "learn-profile")
    del caught
    log(f"learn: one more reach-recipe update profiled: K1 {prof['kernel_ms']:.5f} ms over {layers} launches, "
        f"backward kernels {prof['backward_ms']:.5f} ms over {2 * layers}, busy {prof['busy_ms']:.3f} ms of "
        f"{prof['wall_ms']:.3f} ms wall, on {info}")
    t0 = time.time()
    sweep = e2e_tier_sweep.main([
        "--checkpoint", ckpt, "--stats", os.path.join(tmp, "statistics.json"), "--tiers", LEARN_TIERS,
        "--n-episodes", str(LEARN_TIER_EPISODES), "--device", str(dev),
    ])
    rates = {name: tier["success_rate"] for name, tier in sweep["tiers"].items()}
    if list(rates) != LEARN_TIERS.split(",") or any(
            tier["n_episodes"] != LEARN_TIER_EPISODES for tier in sweep["tiers"].values()):
        raise AssertionError(f"tier sweep: {sweep['tiers']}")
    log(f"learn: e2e_tier_sweep on ckpt_{LEARN_UPDATES}, {LEARN_TIER_EPISODES} episodes per tier: {rates}, "
        f"{time.time() - t0:.1f} s")
    return {**result, "launches": launches, "tiers": rates, "profile": prof}


def check_learn_lever(dev, info: str, tmp: str) -> dict:
    """Phase 8e's second leg: ``demo_closed_loop.main`` on ``--task
    tri_lever`` (reach and pick_place in the bridge family, the drawer in
    the fractal one with its half-size coverage set, one policy with its
    proprio padded to 8), cut to LEVER_DEMOS demos per bridge dataset,
    LEVER_DRAWER_DEMOS drawer demos, LEVER_UPDATES updates and
    LEVER_EPISODES episodes per scored task, in its own directory of
    ``tmp``. The launch counts are set to 0 just before the run and read
    just after it."""
    work = os.path.join(tmp, "tri_lever")
    with EvalProbe() as probe:
        fa.launches = fa.bwd_launches = 0
        result = demo_closed_loop.main([
            "--task", "tri_lever", "--workdir", work, "--n-demos", str(LEVER_DEMOS), "--drawer-n-demos",
            str(LEVER_DRAWER_DEMOS), "--n-updates", str(LEVER_UPDATES), "--n-eval-episodes", str(LEVER_EPISODES),
            "--device", str(dev),
        ])
        launches = (fa.launches, fa.bwd_launches)
    layers = result["model"]["layers"]
    curve = result["loss_per_50_updates"]
    if len(curve) != LEVER_UPDATES // LEARN_WINDOW or not np.all(np.isfinite(curve)):
        raise AssertionError(f"tri_lever: the loss per {LEARN_WINDOW} updates: {curve}")
    per_update = (result["k1_launches_per_update"], result["bwd_launches_per_update"])
    if per_update != (layers, 2 * layers) or launches[1] != 2 * layers * LEVER_UPDATES:
        raise AssertionError(f"tri_lever: launches per update {per_update}, want {(layers, 2 * layers)}; over the "
                             f"run {launches}")
    # drawer_cov: demos written and trained on (its statistics come from
    # the pipeline), not scored
    trained, control = result["trained_success_rate"], result["random_init_success_rate"]
    if (set(result["expert_success_rate"]) != {*LEVER_TASKS, "drawer_cov"} or list(trained) != LEVER_TASKS
            or list(control) != LEVER_TASKS or not os.path.exists(os.path.join(work, "statistics_drawer_cov.json"))):
        raise AssertionError(f"tri_lever: experts {result['expert_success_rate']}, scored {trained}, control "
                             f"{control}; statistics {sorted(os.listdir(work))}")
    # each scored task's episodes on the card: the drawer's through the EDR
    # sticky-gripper adapter at its own 8 dims, the bridge legs' padded to 8
    acts = [(act["agent"], act["inputs"]["proprios"].shape[-1]) for act in probe.acts]
    del probe
    adapters = {(type(agent.adapter).__name__, agent.adapter.pad_proprio_to, width, agent.device.type)
                for agent, width in acts}
    want = {("EDRSimplerAdapter", None, 8, dev.type), ("BridgeSimplerAdapter", 8, 8, dev.type)}
    if adapters != want:
        raise AssertionError(f"tri_lever: the eval's acts went through {adapters}, want {want}")
    log(f"learn tri_lever: {LEVER_DEMOS} reach and pick_place demos, {LEVER_DRAWER_DEMOS} drawer demos and "
        f"{LEVER_DRAWER_DEMOS // 2} coverage demos (expert rates {result['expert_success_rate']}), {LEVER_UPDATES} "
        f"updates of B = 32: update {result['update_ms']:.3f} ms (median, the first left out), batch wait "
        f"{result['batch_wait_ms']['median_after_first']:.3f} ms (median; first "
        f"{result['batch_wait_ms']['first']:.1f}), timings {json.dumps(result['timings_s'])} s, on {info}")
    log(f"learn tri_lever: loss per {LEARN_WINDOW} updates {[round(x, 4) for x in curve]}; K1 {per_update[0]:g} and "
        f"backward {per_update[1]:g} launches per update; the run's counts {launches}; {len(acts)} eval chunks "
        f"through {sorted(adapters)}")
    log(f"learn tri_lever: after {LEVER_UPDATES} updates, {LEVER_EPISODES} episode per task: trained {trained}, "
        f"random-init control {control} (printed, not asserted)")
    return {**result, "launches": launches, "acts": len(acts)}


def check_qlora_demo(dev, info: str, tmp: str) -> dict:
    """Phase 8f: ``demo_qlora_finetune.main`` on phase 8e's checkpoint in
    ``tmp`` (the base), cut to LEARN_DEMOS pick_place demos and
    QLORA_UPDATES updates with the old task's replay at QLORA_RETENTION and
    LEARN_EPISODES episodes per eval; then one more update of its agent
    profiled. The launch counts are set to 0 just before the run and read
    just after it."""
    with caught_agent() as caught:
        fa.launches = fa.bwd_launches = 0
        result = demo_qlora_finetune.main([
            "--base-workdir", tmp, "--workdir", os.path.join(tmp, "qlora"), "--n-demos", str(LEARN_DEMOS),
            "--n-updates", str(QLORA_UPDATES), "--retention-weight", str(QLORA_RETENTION),
            "--n-eval-episodes", str(LEARN_EPISODES), "--device", str(dev),
        ])
        launches = (fa.launches, fa.bwd_launches)
    layers = demo_qlora_finetune.parse_args([]).layers
    curve = result["loss_per_50_updates"]
    if not (result["frozen_nf4_payloads_bitwise_unchanged"] and result["n_frozen_payload_leaves"] == QLORA_PAYLOADS):
        raise AssertionError(f"NF4 payloads: {result['n_frozen_payload_leaves']} leaves, unchanged "
                             f"{result['frozen_nf4_payloads_bitwise_unchanged']}; want {QLORA_PAYLOADS} unchanged")
    if result["expert_success_rate"] != 1.0:
        raise AssertionError(f"expert success rate {result['expert_success_rate']}, want 1.0")
    if len(curve) != QLORA_UPDATES // LEARN_WINDOW or not np.all(np.isfinite(curve)) or not curve[-1] < curve[0]:
        raise AssertionError(f"the loss per {LEARN_WINDOW} updates does not fall: {curve}")
    per_update = (result["k1_launches_per_update"], result["bwd_launches_per_update"])
    if per_update != (layers, 2 * layers) or launches[1] != 2 * layers * QLORA_UPDATES:
        raise AssertionError(f"launches per update {per_update}, want {(layers, 2 * layers)}; over the run "
                             f"{launches}")
    log(f"qlora: {LEARN_DEMOS} pick_place demos + the reach replay at weight {QLORA_RETENTION}, {QLORA_UPDATES} "
        f"updates of B = 32 on ckpt_{LEARN_UPDATES}: update {result['update_ms']:.3f} ms (median, the first left "
        f"out), batch wait {result['batch_wait_ms']['median_after_first']:.3f} ms (median; first "
        f"{result['batch_wait_ms']['first']:.1f}), timings {json.dumps(result['timings_s'])} s, on {info}")
    log(f"qlora: loss per {LEARN_WINDOW} updates {[round(x, 4) for x in curve]}; {result['n_frozen_payload_leaves']} "
        f"NF4 payload leaves bitwise unchanged; param groups {result['param_groups_B']} (1e9); K1 {per_update[0]:g} "
        f"and backward {per_update[1]:g} launches per update; the run's counts {launches}")
    log(f"qlora: {LEARN_EPISODES} episodes each (printed, not asserted): new task {result['new_task_success']}, "
        f"old task {result['old_task_success']['finetuned']} (base {result['old_task_success']['base_policy']})")
    prof = profile_learn_update(caught, layers, "qlora-profile")
    del caught
    log(f"qlora: one more QLoRA update profiled: K1 {prof['kernel_ms']:.5f} ms over {layers} launches, backward "
        f"kernels {prof['backward_ms']:.5f} ms over {2 * layers}, busy {prof['busy_ms']:.3f} ms of "
        f"{prof['wall_ms']:.3f} ms wall, on {info}")
    return {**result, "launches": launches, "profile": prof}


# --------------------------------------------------------------------------- #
# phases 9-11: inference under a mesh of processes
# --------------------------------------------------------------------------- #


def shard_cases() -> list:
    """Phase 9's inputs, whole (numpy), each sliced by the ranks: the main
    path's prefill and Euler shapes at B=1 and B=2 with their masks, a
    fully masked row, in bf16 and fp32; the training shape in fp32 with a
    cotangent."""
    cfg = cfg_lib.PiZeroConfig()
    am = torch.zeros(2, cfg.max_image_text_tokens, dtype=torch.int32)
    am[0, :264] = 1
    am[1, :200] = 1
    _, prefix, action, _ = pizero.prepare_action_inputs(cfg, am)
    masks = {
        "prefill": prefix[:1], "euler": action[:1], "prefill_b2": prefix, "euler_b2": action,
        "fully_masked": torch.full((1, 1, 4, 281), MASK_NEG),
    }
    cases = []
    for i, (name, mask) in enumerate(masks.items()):
        b, _, lq, lkv = mask.shape
        rng = np.random.default_rng(20 + i)
        q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((b, lq, 8, 256), (b, lkv, 1, 256), (b, lkv, 1, 256)))
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(dict(name=f"{name} {str(dtype)[6:]}", q=q, k=k, v=v, mask=mask.numpy().copy(),
                              softcap=50.0, dtype=str(dtype)[6:], tol=TOL[dtype]))
    q, k, v, mask, g = (x.numpy() for x in training_attention_inputs("cpu", torch.float32))
    cases.append(dict(name="train float32", q=q, k=k, v=v, mask=mask, g=g, softcap=50.0,
                      dtype="float32", tol=TOL[torch.float32]))
    return cases


def check_shard_kernel(rows: list) -> dict:
    """Phase 9: K1-shard in 2 ranks on the card against the plain version
    (``rows``: ``ranks.attention_rank`` on ``shard_cases()``); the
    training-shape VJP launches both backward kernels in each rank."""
    errs = {}
    for row in rows:
        if row["bwd_launches"] != (2 if row["name"] == "train float32" else 0):
            raise AssertionError(f"shard {row['name']}: a rank launched the backward kernels "
                                 f"{row['bwd_launches']} times")
        for key in [k for k in row if k.startswith("not_close_")]:
            part = key[len("not_close_"):]
            if row[key]:
                raise AssertionError(f"shard {row['name']} {part}: {row[key]} elements off, "
                                     f"max|diff| {row['max_abs_err_' + part]}")
            errs[f"{row['name']} {part}"] = row[f"max_abs_err_{part}"]
    return errs


def tp_training_config():
    """The TP updates' training config: phase 7's (the first update at the
    full lr, Adam's eps 1e-3) with the EMA from the first update, as the
    JAX package's TP step (``TrainingConfig(use_ema=True, ema_start=0)``)."""
    sched = cfg_lib.LRSchedulerConfig(warmup_steps=0)
    return cfg_lib.TrainingConfig(action_lr_scheduler=sched, vlm_lr_scheduler=sched, adam_eps=DP_ADAM_EPS,
                                  use_ema=True, ema_start=0)


def check_tp_update(name: str, cfg, got: dict, accum: int = GRAD_ACCUM) -> dict:
    """A ``ranks.train_rank`` result under a model axis against its reference (one process's
    updates): every rank's K1 and backward launches per update those of one
    card's update at ``accum`` microbatches (``dp_launches_per_update``),
    every attention call a K1-shard call; the ranks' losses and norms alike
    and within phase 7's limits of the reference (DP_TOL), the gathered
    params too; the replicated trained leaves bitwise equal over each model
    group."""
    per_update = dp_launches_per_update(cfg) // GRAD_ACCUM * accum
    for r in got["ranks"]:
        if not (set(r["launches"]) == set(r["bwd_launches"]) == set(r["shard_calls"]) == {per_update}):
            raise AssertionError(f"{name} rank {r['rank']}: K1 {r['launches']}, backward {r['bwd_launches']}, "
                                 f"K1-shard calls {r['shard_calls']} per update, want {per_update} each")
        if (r["losses"], r["grad_norms"]) != (got["ranks"][0]["losses"], got["ranks"][0]["grad_norms"]):
            raise AssertionError(f"{name}: the ranks' losses or grad norms differ: {got['ranks']}")
    ref, mine = got["reference"], got["ranks"][0]
    rel = {k: max(abs(a - b) / abs(b) for a, b in zip(mine[k], ref[k])) for k in ("losses", "grad_norms")}
    param_err = got["vs_reference"]["params"]["max_abs_diff"]
    if not (max(rel.values()) <= DP_TOL["relative"] and param_err <= DP_TOL["params"] and got["replicated_bitwise"]):
        raise AssertionError(f"{name}: vs one process relative {rel}, params max|diff| {param_err} (limits "
                             f"{DP_TOL}); replicated leaves bitwise equal: {got['replicated_bitwise']}")
    return {"launches_per_update": per_update, "relative": rel, "params_max_abs_diff": param_err,
            "replicated_bitwise": got["replicated_bitwise"]}


def check_shard_parity() -> dict:
    """Phase 10: bridge widths, depth 2, fp32, B=4 on a (2, 2) mesh of
    ranks on the card against the CPU's single-process chunk; then, in the
    same world, one DP x TP update (remat, EMA, B = 2, one row per data
    index, injected t and x0) against the single-process update of the
    same params (drawn on the card from seed 1) that rank 0 takes on the
    CPU first."""
    cfg = cfg_lib.bridge_width_dryrun_config()
    rng = np.random.default_rng(10)
    batch = example_batch(cfg, 4, rng)
    batch["attention_mask"][1, 20:] = 0  # a shorter row
    batch["input_ids"][1, 20:] = 0
    a0 = rng.normal(size=(4, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
    tcfg, train_cfg = with_remat(cfg), tp_training_config()
    train = [{k: v[0] for k, v in train_batch(tcfg, 2, rng, inject=True).items()}]  # one microbatch
    got, trained = run_ranks(
        ranks.sequence, 2, 2,
        [(ranks.infer_rank, (cfg, batch, a0, None, 1)),
         (ranks.train_rank, (tcfg, train_cfg, train, 1, False, None, 1, "cpu", False))],
        device="cuda", timeout_s=RANK_TIMEOUT_S)
    update = check_tp_update("shard-parity", tcfg, trained, accum=1)
    L = cfg.joint.num_hidden_layers
    expected = L + L * cfg.num_inference_steps
    if got["launches"] != expected:
        raise AssertionError(f"rank 0 launched K1 {got['launches']} times under the mesh, want {expected}")
    params_cpu = pizero.init_params(cfg, seed=1, device="cpu", dtype=torch.float32)
    on_cpu = run_infer(params_cpu, cfg, batch, a0, "cpu", torch.float32).numpy()
    # fp32 on both sides (TF32 off): TP reassociates the row-parallel sums and
    # the card sums in another order, ~1e-6 relative per op; as phase 3
    err = float(np.abs(got["chunk"] - on_cpu).max())
    if not (got["chunk"].shape == on_cpu.shape and err <= 1e-3):
        raise AssertionError(f"TP x DP chunk {got['chunk'].shape} vs CPU max|diff| {err} > 1e-3")
    return {"launches_per_rank": got["launches"], "max_abs_diff": err,
            "update": {**update, "cpu_update_s": trained["parts_s"]["reference"], "update_ms": [r["update_ms"] for r in trained["ranks"]],
                       "rank_program_s": trained["parts_s"]}}


def shard_main_args() -> tuple:
    """Phase 11's arguments of ``ranks.main_path_rank``: full width, fp32
    params from seed 0, B = 1, 5 timed chunks."""
    cfg = cfg_lib.PiZeroConfig()
    rng = np.random.default_rng(11)
    batch = example_batch(cfg, 1, rng)
    a0 = rng.normal(size=(1, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
    return cfg, 0, batch, a0, 5


def check_shard_main(cfg, got: dict) -> dict:
    """Phase 11: full-width fp32 TP=2 inference in 2 ranks (``got``:
    ``ranks.main_path_rank`` on ``shard_main_args()``)."""
    L = cfg.joint.num_hidden_layers
    expected = L + L * cfg.num_inference_steps
    for i, r in enumerate(got["ranks"]):
        if r["launches"] != expected:
            raise AssertionError(f"rank {i}: {r['launches']} K1 launches per chunk under the mesh, "
                                 f"want {expected}")
        if not r["bitwise_equal_chunks"]:
            raise AssertionError(f"rank {i}: two TP chunks with the same noise differ")
    chunk, ref = got["chunk"], got["unsharded"]
    clip = cfg.final_action_clip_value
    if chunk.shape != (1, cfg.horizon_steps, cfg.action_dim) or not (np.isfinite(chunk).all() and np.abs(chunk).max() <= clip):
        raise AssertionError(f"TP chunk {chunk.shape} not finite or outside the clip")
    # fp32 on both sides (TF32 off): TP only reassociates the sums of the
    # row-parallel projections
    err = float(np.abs(chunk - ref).max())
    if not err <= 1e-3:
        raise AssertionError(f"TP chunk vs unsharded chunk max|diff| {err} > 1e-3")
    calls = got.pop("calls")
    if len(calls) != expected:
        raise AssertionError(f"{len(calls)} K1-shard calls recorded, want {expected}")
    replayed = replay_in_worker(calls, "forward")  # K1-shard's forward is K1 on the shard
    return {
        "backend": got["backend"], "card": got["card"], "ranks": got["ranks"],
        "chunk_ms": got["chunk_ms"], "unsharded_chunk_ms": got["unsharded_ms"],
        "profile": got["profile"], "max_abs_diff_vs_unsharded": err,
        "chunk": chunk.round(4).tolist(), "replayed": replayed,
    }


# --------------------------------------------------------------------------- #
# tp-train: tensor-parallel training in the world of phases 9 and 11
# --------------------------------------------------------------------------- #

TP_LAYERS = 4  # both towers' depth: two ranks' fp32 states (Adam, EMA) and rank 0's unsharded one on one card
TP_B = 4  # rows per microbatch, all on the mesh's one data index
TP_UPDATES = 3


def tp_train_args() -> tuple:
    """tp-train's arguments of ``ranks.train_rank``: ``PiZeroConfig()``
    at full widths with both towers cut to TP_LAYERS, remat, fp32 params
    from seed 0 drawn on each rank's card; TP_UPDATES updates of TP_B x
    GRAD_ACCUM injected rows at ``tp_training_config``; rank 0 first takes
    them alone."""
    cfg = cfg_lib.PiZeroConfig()
    cfg = with_remat(dataclasses.replace(
        cfg, joint=dataclasses.replace(cfg.joint, num_hidden_layers=TP_LAYERS),
        siglip=dataclasses.replace(cfg.siglip, num_hidden_layers=TP_LAYERS)))
    rng = np.random.default_rng(13)
    batches = [train_batch(cfg, TP_B, rng, inject=True) for _ in range(TP_UPDATES)]
    return cfg, tp_training_config(), batches, GRAD_ACCUM, False, None, 0, "cuda", False


# the QLoRA recipe of configs/train/bridge.yaml (NF4 trunk and SigLIP bases,
# LoRA r 32, int8 Adam moments) at its widths, both towers cut to
# TP_LAYERS, the first update at the full lr
TP_QLORA_OVERRIDES = ["quantize=true", "lora=true", "remat=true", "action_lr_scheduler.warmup_steps=0",
                      "vlm_lr_scheduler.warmup_steps=0"]


def tp_qlora_args() -> tuple:
    """tp-train's second recipe, ``ranks.train_rank``'s arguments: the
    QLoRA recipe (TP_QLORA_OVERRIDES) at phase 7's Adam eps, params from
    seed 0 drawn and quantized on each rank's card; TP_UPDATES updates of
    TP_B x GRAD_ACCUM injected rows; rank 0 first takes them alone."""
    raw = cfg_lib.load_config(AGENT_CONFIG, overrides=TP_QLORA_OVERRIDES + dp_depth_overrides(TP_LAYERS))
    cfg = cfg_lib.pizero_config_from_dict(raw)
    train_cfg = dataclasses.replace(cfg_lib.training_config_from_dict(raw), adam_eps=DP_ADAM_EPS)
    rng = np.random.default_rng(14)
    batches = [train_batch(cfg, TP_B, rng, inject=True) for _ in range(TP_UPDATES)]
    return cfg, train_cfg, batches, GRAD_ACCUM, False, None, 0, "cuda", False


def check_tp_qlora(cfg, got: dict) -> dict:
    """tp-train's QLoRA recipe (``got``: ``ranks.train_rank`` on
    ``tp_qlora_args()``) beyond ``check_tp_update``: the gathered adapters
    within DP_TOL's params limit of the unsharded updates'; every rank's
    NF4 payloads bitwise as drawn and alike over the model group; the
    gathered int8 moments of the split leaves the whole-leaf blockwise
    quantization of their values (every code and scale), the scales alike
    on every rank."""
    checked = check_tp_update("tp-train QLoRA", cfg, got)
    adapters = got["vs_reference"]["adapters"]["max_abs_diff"]
    nf4, int8 = got["nf4"], got["int8_moments"]
    if not adapters <= DP_TOL["params"]:
        raise AssertionError(f"tp-train QLoRA: the gathered adapters vs unsharded max|diff| {adapters}")
    if not (nf4["leaves"] > 0 and nf4["unchanged"] and nf4["alike"]):
        raise AssertionError(f"tp-train QLoRA: the NF4 bases {nf4}")
    if not (int8["leaves"] > 0 and int8["scales_alike"] and int8["codes_differ"] == int8["scales_differ"] == 0):
        raise AssertionError(f"tp-train QLoRA: the int8 moments of the split leaves {int8}")
    return {**checked, "adapters_max_abs_diff": adapters, "nf4": nf4, "int8_moments": int8}


def tp_train_summary(name: str, cfg, got: dict, checked: dict, info: str) -> dict:
    """A tp-train recipe's numbers beside its checks (``checked``), logged;
    the unsharded updates' launches checked too."""
    ref = got["reference"]
    if set(ref["launches"]) != {checked["launches_per_update"]} or ref["bwd_launches"] != ref["launches"]:
        raise AssertionError(f"{name}: the unsharded updates launched K1 {ref['launches']} and the backward kernels "
                             f"{ref['bwd_launches']} times, want {checked['launches_per_update']} per update")
    rows = got["ranks"]
    result = {
        **checked, "backend": got["backend"], "card": got["card"], "seconds": got["seconds"], "parts_s": got["parts_s"],
        "depth": {"joint": cfg.joint.num_hidden_layers, "siglip": cfg.siglip.num_hidden_layers},
        "update_ms": [r["update_ms"] for r in rows],
        "update_ms_median": [statistics.median(r["update_ms"][1:]) for r in rows],
        "model_allreduce_ms": [r["model_allreduce_ms"] for r in rows],
        "model_allreduce_calls": [r["model_allreduce_calls"][0] for r in rows],
        "peak_gb": [r["peak_gb"] for r in rows],
        "moment_bytes": got["moment_bytes"],
        "reference": {k: ref[k] for k in ("losses", "grad_norms", "update_ms", "peak_gb")},
        "losses": rows[0]["losses"], "grad_norms": rows[0]["grad_norms"],
    }
    log(f"{name}: " + json.dumps(result))
    cards = "sharing one card" if got["backend"] == "gloo" else "a card each"
    log(f"{name}: depth {result['depth']['joint']} (SigLIP {result['depth']['siglip']}), TP = 2 on 2 ranks over "
        f"{got['backend']} ({cards}, {got['card']}), B = {TP_B} x {GRAD_ACCUM}: update ms per rank "
        f"{[round(m, 1) for m in result['update_ms_median']]} (median of updates 2-{TP_UPDATES}), of it the model "
        f"group's all-reduces {[[round(m, 1) for m in r['model_allreduce_ms']] for r in rows]} ms over "
        f"{result['model_allreduce_calls']} calls per update; peak memory per rank "
        f"{[round(g, 3) for g in result['peak_gb']]} GB; the unsharded update on one rank "
        f"{statistics.median(ref['update_ms'][1:]):.1f} ms, peak {ref['peak_gb']:.3f} GB; K1-shard "
        f"{checked['launches_per_update']} K1 and {checked['launches_per_update']} backward launches per rank per "
        f"update, one card's; vs unsharded relative {checked['relative']}, params max|diff| "
        f"{checked['params_max_abs_diff']:.3e}, replicated leaves bitwise equal over the ranks; on {info}")
    return result


def check_tp_train(cfg, got: dict, info: str) -> dict:
    """tp-train: full-width fp32 TP = 2 training in 2 ranks (``got``:
    ``ranks.train_rank`` on ``tp_train_args()``) against rank 0's
    unsharded updates (``check_tp_update``)."""
    checked = check_tp_update("tp-train", cfg, got)
    return tp_train_summary("tp-train fp32 (PiZeroConfig(), remat, EMA)", cfg, got, checked, info)


# --------------------------------------------------------------------------- #
# phase 12 (dp-main): data-parallel training and ZeRO-1 on a mesh of ranks
# --------------------------------------------------------------------------- #

DP_RANKS = 2  # sharing the one card over gloo
# phase 8b's QLoRA recipe on 2 ranks: B = 16 per rank x accumulation 2 (a
# global batch of 64), ZeRO-1, a save at update 2, no validation
DP_OVERRIDES = ["global_batch_size=64", "zero1=true", "n_updates=2", "save_model_freq=2", "eval_freq=0"]
# the raw update against one process: the first update at the full lr and
# Adam's eps 1e-3 (phase 7's reason: a grad that is rounding noise on both
# sides then moves its param by far less than lr)
DP_RAW_OVERRIDES = ["action_lr_scheduler.warmup_steps=0", "vlm_lr_scheduler.warmup_steps=0"]
DP_ADAM_EPS = 1e-3
DP_TOL = {"relative": 1e-3, "params": 1e-6}  # phase 7's limits: fp32 on both sides, sums in other orders
# the recipe's depth, cut for the run's time limit: DP_LAYERS of the trunk's
# 18 layers and of SigLIP's 27, every width the recipe's (--dp-layers 0
# keeps the recipe's depths)
DP_LAYERS = 4


def dp_depth_overrides(layers: int) -> list:
    """The config keys that cut both towers to ``layers`` (none for 0)."""
    if not layers:
        return []
    return [f"joint.config.num_hidden_layers={layers}", f"vision.config.num_hidden_layers={layers}"]


def dp_launches_per_update(mcfg) -> int:
    """K1's (and the backward kernels') launches in one update of the
    recipe on one card: two forwards (remat) and one VJP per layer and
    microbatch."""
    return GRAD_ACCUM * 2 * mcfg.joint.num_hidden_layers


def in_world_of_one(fn, *args, device):
    """``fn(mesh, *args)`` in this process, in a world of one rank (gloo),
    as ``run_ranks(fn, 1, 1, ...)`` runs it in a spawned one, without the
    spawned process's start-up (some 20 s on the card's host). The world
    is left on the way out."""
    with tempfile.TemporaryDirectory(prefix="opz_world_") as tmp:
        torch.distributed.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0)
        try:
            return fn(make_mesh(1, 1, device), *args)
        finally:
            set_mesh(None)
            torch.distributed.destroy_process_group()


def check_dp_main(dev, info: str, device_type: str = "cuda", layers: int = DP_LAYERS) -> dict:
    """Phase 12: configs/train/bridge.yaml's QLoRA recipe, cut to ``layers``
    (``dp_depth_overrides``), on DP_RANKS ranks sharing the card (``parallel/ranks.dp_main_rank``), after one process
    alone, this one, has taken the raw update on the whole global batch
    (``dp_reference_rank`` in a world of one), in a temporary directory that holds phase 8b's
    dataset, the checkpoints and the statistics cache."""
    tmp = tempfile.mkdtemp(prefix="opz_dp_main_")
    cache = os.environ.get("XDG_CACHE_HOME")
    os.environ["XDG_CACHE_HOME"] = os.path.join(tmp, "cache")
    try:
        data = write_demo_dataset(os.path.join(tmp, "data"))
        overrides = AGENT_OVERRIDES + DATA_OVERRIDES + DP_OVERRIDES + dp_depth_overrides(layers) + [
            f"log_dir={tmp}/train", f"pretrained_model_path={tmp}/no_tokenizer",
            f"data.train.data_path={os.path.join(tmp, 'data')}",
        ]
        agent_cfg = cfg_lib.load_config(AGENT_CONFIG, overrides=overrides)
        resume_cfg = cfg_lib.load_config(AGENT_CONFIG, overrides=overrides + ["resume_checkpoint_path=auto", "n_updates=3"])
        raw_cfg = cfg_lib.load_config(AGENT_CONFIG, overrides=overrides + DP_RAW_OVERRIDES)
        one_cfg = cfg_lib.load_config(  # one process: the global microbatch of 32 rows, accumulation 2 again
            AGENT_CONFIG, overrides=overrides + DP_RAW_OVERRIDES + [f"per_device_batch_size={TRAIN_B * DP_RANKS}"])
        mcfg = cfg_lib.pizero_config_from_dict(raw_cfg)
        batch = train_batch(mcfg, TRAIN_B * DP_RANKS, np.random.default_rng(12), inject=True)
        t0 = time.time()
        reference = in_world_of_one(ranks.dp_reference_rank, one_cfg, [batch], os.path.join(tmp, "reference.pt"),
                                    DP_ADAM_EPS, device=dev)
        reference_s = time.time() - t0
        t0 = time.time()
        got = run_ranks(ranks.dp_main_rank, DP_RANKS, 1, raw_cfg, [batch], DP_ADAM_EPS,
                        os.path.join(tmp, "reference.pt"), agent_cfg, resume_cfg, device=device_type,
                        timeout_s=RANK_TIMEOUT_S)
        ranks_s = time.time() - t0
        ckpt_gb = dir_bytes(os.path.join(tmp, "train", "checkpoint", "ckpt_2")) / 1e9
        with open(os.path.join(tmp, "train", "checkpoint", "ckpt_2", ckpt_lib.META_FILE)) as f:
            meta = json.load(f)
    finally:
        if cache is None:
            os.environ.pop("XDG_CACHE_HOME", None)
        else:
            os.environ["XDG_CACHE_HOME"] = cache
        shutil.rmtree(tmp, ignore_errors=True)

    per_update = dp_launches_per_update(mcfg)
    rows = got["ranks"]
    if reference["launches"] != [per_update] or reference["bwd_launches"] != [per_update]:
        raise AssertionError(f"one process: {reference['launches']} K1 and {reference['bwd_launches']} backward "
                             f"launches in its update, want {per_update}")
    for r, row in enumerate(rows):
        for name, run in (*row["raw"].items(), ("agent", row["agent"])):
            if set(run["launches"]) != {per_update} or set(run["bwd_launches"]) != {per_update}:
                raise AssertionError(f"rank {r} {name}: {run['launches']} K1 and {run['bwd_launches']} backward "
                                     f"launches per update, want {per_update} each, as one card's update")
        if not row["zero1_bitwise"]:
            raise AssertionError(f"rank {r}: the ZeRO-1 update differs from the replicated one")
        agent = row["agent"]
        if not (agent["zero1"] and agent["resumed_at"] == 2 and agent["resume_bitwise"]
                and agent["resumed_cnt_batch"] == agent["saved_cnt_batch"]):
            raise AssertionError(f"rank {r}: the resume from ckpt_2: {agent}")
        replicated, zero1 = row["raw"]["replicated"], row["raw"]["zero1"]
        if not zero1["moment_bytes"] < 0.6 * replicated["moment_bytes"]:
            raise AssertionError(f"rank {r}: ZeRO-1 holds {zero1['moment_bytes']} moment bytes of "
                                 f"{replicated['moment_bytes']}")
    losses = [row["raw"]["replicated"]["losses"][0] for row in rows]
    norms = [row["raw"]["replicated"]["grad_norms"][0] for row in rows]
    if len(set(losses)) != 1 or len(set(norms)) != 1:
        raise AssertionError(f"the ranks' all-reduced losses {losses} or grad norms {norms} differ")
    rel = {"loss": abs(losses[0] - reference["losses"][0]) / abs(reference["losses"][0]),
           "grad_norm": abs(norms[0] - reference["grad_norms"][0]) / abs(reference["grad_norms"][0])}
    param_err = rows[0]["vs_reference_max_abs_diff"]
    if not (max(rel.values()) <= DP_TOL["relative"] and param_err <= DP_TOL["params"]):
        raise AssertionError(f"the DP update vs one process's update of the global batch: relative {rel}, "
                             f"params max|diff| {param_err} (limits {DP_TOL})")
    if not all(np.isfinite(row["agent"]["losses"]).all() for row in rows):
        raise AssertionError(f"agent losses {[row['agent']['losses'] for row in rows]}")
    if meta.get("world_size") != DP_RANKS:
        raise AssertionError(f"ckpt_2's meta.json: {meta}")
    result = {
        "backend": got["backend"], "card": got["card"], "data": data, "reference": reference,
        "reference_s": reference_s, "ranks_s": ranks_s, "checkpoint_gb": ckpt_gb,
        "vs_one_process": {"relative": rel, "params_max_abs_diff": param_err, "trained_leaves": rows[0]["trained_leaves"]},
        "ranks": rows, "launches_per_update": per_update,
        "depth": {"joint": mcfg.joint.num_hidden_layers, "siglip": mcfg.siglip.num_hidden_layers},
    }
    log("dp-main: " + json.dumps(result))
    agent_rows = [row["agent"] for row in rows]
    cards = "sharing one card" if got["backend"] == "gloo" else "a card each"
    log(f"dp-main: {AGENT_CONFIG} QLoRA at full width, depth {result['depth']['joint']} (SigLIP "
        f"{result['depth']['siglip']}), ZeRO-1, on {DP_RANKS} ranks over {got['backend']} ({cards}, {got['card']}), "
        f"B = {TRAIN_B} x {GRAD_ACCUM} per rank (global {TRAIN_B * GRAD_ACCUM * DP_RANKS}): update ms per rank "
        f"{[[round(u, 1) for u in a['update_ms']] for a in agent_rows]} (the gradient all-reduce "
        f"{[[round(u, 1) for u in a['allreduce_ms']] for a in agent_rows]} ms of it), peak memory per rank "
        f"{[round(a['peak_gb'], 3) for a in agent_rows]} GB; K1 and backward launches per update per rank "
        f"{[a['launches'] for a in agent_rows]} / {[a['bwd_launches'] for a in agent_rows]} (one card's update: "
        f"{per_update}); save of ckpt_2 ({ckpt_gb:.3f} GB) {[a['save_s'] for a in agent_rows]} s; the resumed update 3 "
        f"bitwise the continued one on every rank, on {info}")
    log(f"dp-main: one DP update on injected t/x0 vs one process's update of the global batch (B = "
        f"{TRAIN_B * DP_RANKS} x {GRAD_ACCUM}, {reference['update_ms'][0]:.1f} ms, peak {reference['peak_gb']:.3f} GB): "
        f"loss and grad norm relative {rel}, params max|diff| {param_err:.3e} over {rows[0]['trained_leaves']} "
        f"trained leaves (limits {DP_TOL}); ZeRO-1 bitwise the replicated update on every rank, moment bytes per "
        f"rank {[r['raw']['zero1']['moment_bytes'] for r in rows]} vs replicated "
        f"{[r['raw']['replicated']['moment_bytes'] for r in rows]}; raw update ms per rank replicated "
        f"{[r['raw']['replicated']['update_ms'] for r in rows]} / ZeRO-1 {[r['raw']['zero1']['update_ms'] for r in rows]}, "
        f"on {info}")
    return result


def single_card_phases(dev, info: str) -> list:
    """Phases 2-8 (and 4b) on card 0; returns their entries of the kernels
    line."""
    t0 = time.time()
    floor = launch_floor(dev)
    log(f"launch floor: empty kernel {floor['device_ms_per_launch']:.5f} ms device time per launch, "
        f"{floor['interval_ms']:.5f} ms between back-to-back launches, on {info}")
    kernel = check_kernel(dev)
    log("kernel_vs_plain, per launch: " + json.dumps(kernel))
    for name in ("euler", "prefill", "decode", "text_prefill", "text_decode", "shard_euler", "train"):
        r = kernel[name]
        log(f"kernel per launch {name} {r['shape']} {r['time_dtype']}: {r['ms']:.5f} ms "
            f"(bound {r['bound_ms']:.5f} ms, {r['bound_by']}; plain {r['plain_ms']:.5f}, library "
            f"{r['library_ms']:.5f}; {r['rows_per_block']} rows per block, split {r['split']}), on {info}")
    bwd = check_bwd_kernels(dev)
    log("backward kernels vs reference, per launch: " + json.dumps(bwd))
    for name, r in bwd.items():
        log(f"backward per launch {name} {r['shape']} float32: rows {r['rows_ms']:.5f} ms (bound "
            f"{r['rows_bound_ms']:.5f} ms, {r['rows_bound_by']}; {r['row_blocks']} blocks of 32 rows), keys "
            f"{r['keys_ms']:.5f} ms (bound {r['keys_bound_ms']:.5f} ms, {r['keys_bound_by']}; {r['key_blocks']} "
            f"blocks, d_tile {r['d_tile']}); VJP bound {r['vjp_bound_ms']:.5f} ms ({r['vjp_bound_by']}); "
            f"reference {r['plain_ms']:.5f} ms, on {info}")
    log(f"phase kernels ok in {time.time() - t0:.1f} s")

    t0 = time.time()
    err = check_parity_with_cpu(dev)
    log(f"parity: bridge widths depth 2 fp32, card vs CPU max|diff| {err:.3e} (<= 1e-3), "
        f"{time.time() - t0:.1f} s")

    t0 = time.time()
    golden = check_golden(dev)
    log(f"golden: the reference's chunk (pizero_infer_action.npz) through the port's converter, fp32 on the card: "
        f"max|diff| {golden['max_abs_diff']:.3e} (rtol {GOLDEN_RTOL}, atol {GOLDEN_ATOL}), {golden['launches']} K1 "
        f"launches at head dim 8, {time.time() - t0:.1f} s")

    t0 = time.time()
    cfg = cfg_lib.PiZeroConfig()
    params = pizero.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"main: full-width bf16 params built in {time.time() - t0:.1f} s")
    main_path = check_main_path(dev, cfg, params)
    log("main: " + json.dumps(main_path))
    log(f"main: warm chunk {main_path['chunk_ms']:.3f} ms (median of 11), peak memory "
        f"{main_path['peak_mem_gb']:.3f} GB, on {info}")
    prof = profile_chunk(dev, cfg, params, main_path["launches"])
    calls = record_main_path_calls(dev, cfg, params)
    replayed = replay_in_worker(calls, "forward")
    log(f"main: kernel on the main path {prof['ms']:.3f} ms over {prof['launches']} launches; "
        "replayed calls: " + json.dumps(replayed))

    log(f"main: float chunk under the profiler: {prof['kernels_per_chunk']} kernels and "
        f"{prof['copies_per_chunk']} copies launched, device busy {prof['busy_ms']:.3f} ms")
    log(f"phase main ok in {time.time() - t0:.1f} s")

    t0 = time.time()
    layout, trees = check_serving_layout(dev, cfg, params, info)
    log("serving-layout: " + json.dumps(layout))
    log(f"serving-layout: production chunk drift from the fused bf16 chunk {layout['production']['drift']:.3e} "
        f"(mean L1 over {DRIFT_SEEDS} seeds, <= {DRIFT_LIMIT}); NF4 expert drift {layout['nf4_expert']['drift']:.3e}; "
        f"int8 -> bf16 weight copies {layout['production']['int8_copy_ms']:.3f} ms of device time per chunk; "
        f"bridge widths depth 2 fp32 card vs CPU max|diff| {layout['parity']['production_max_abs_diff']:.3e} "
        f"(<= 1e-3), without W8A8 {layout['parity']['without_w8a8_max_abs_diff']:.3e}; W8A8 activations "
        f"rounded to another int8 value on the card than on the CPU: {layout['parity']['w8a8_activations']}")
    log(f"phase serving-layout ok in {time.time() - t0:.1f} s")

    t0 = time.time()
    compiled_rows = check_compiled(dev, cfg, {"float": params, **trees}, {"float": prof, **layout}, info)
    log("compiled: " + json.dumps(compiled_rows))
    under_gc = check_capture_under_gc(dev)
    log(f"compiled: a capture after a dead cycle holding a graph was dropped, with gc.set_threshold(1, 1, 1): "
        f"captured in {under_gc['capture_s']:.2f} s over {under_gc['gc_collections']} collections, the cycle "
        f"collected, the replay bitwise the eager chunk")
    log(f"phase compiled ok in {time.time() - t0:.1f} s")
    del params, calls, trees
    torch.cuda.empty_cache()

    t0 = time.time()
    adaln = check_adaln(dev, info)
    log("adaln: " + json.dumps(adaln))
    log(f"adaln: bridge widths depth 2 fp32 card vs CPU max|diff| {adaln['parity_max_abs_diff']:.3e} (<= 1e-3); "
        f"one training update card vs CPU {json.dumps(adaln['train_parity'])}")
    log(f"phase adaln ok in {time.time() - t0:.1f} s")

    t0 = time.time()
    text = check_text(dev, info)
    log("text: " + json.dumps(text))
    log(f"text: bridge widths depth 2 fp32 card vs CPU logits max|diff| {text['parity']['logits_max_abs_diff']:.3e} "
        f"(<= 1e-3), greedy tokens equal (eager and graph); golden text logits (pizero_text_logits.npz) through "
        f"convert_paligemma on the card max|diff| {text['golden']['max_abs_diff']:.3e} (rtol/atol 2e-3)")
    log(f"phase text ok in {time.time() - t0:.1f} s")

    t0 = time.time()
    served = check_serving_cli(info)  # the JAX daemon's default layout, with the refined tier
    log(f"serve: the serve CLI answered {served['requests']} requests ({served['refined']} refined), up in "
        f"{served['up_s']:.1f} s; phase serve ok in {time.time() - t0:.1f} s")

    t0 = time.time()
    vjp_errs = check_vjp(dev)
    log("train-kernel, max|diff| vs plain autograd: " + json.dumps(vjp_errs))
    log(f"phase train-kernel ok in {time.time() - t0:.1f} s")

    t0 = time.time()
    parity = check_train_parity(dev)
    log(f"train-parity: bridge widths depth 2 fp32, one update card vs CPU: {json.dumps(parity)}, "
        f"{time.time() - t0:.1f} s")

    t0 = time.time()
    simpler_lite = check_simpler_lite_update(dev)
    log(f"train-parity: {SIMPLER_LITE_CONFIG}'s geometry (head dim {simpler_lite['head_dim']}, zero-padded to 32 "
        f"by K1 and its backward), one TrainAgent update card vs CPU: {json.dumps(simpler_lite)}, "
        f"{time.time() - t0:.1f} s")

    t0 = time.time()
    qlora_parity = check_qlora_parity(dev)
    log(f"train-parity: QLoRA (NF4 bases, LoRA adapters, int8 Adam moments), bridge widths depth 2 fp32, one "
        f"update card vs CPU: {json.dumps(qlora_parity)}, {time.time() - t0:.1f} s")

    t0 = time.time()
    trained, cfg, params, state, step, batch = check_train_main(dev)
    log("train-main: " + json.dumps(trained))
    log(f"train-main: update {trained['update_ms_median_after_first']:.1f} ms (median of updates 2-3), "
        f"peak memory {trained['peak_mem_gb']:.3f} GB, B={TRAIN_B} x {GRAD_ACCUM}, on {info}")
    train_calls = record_training_calls(dev, cfg, params, batch)
    del params, state, step, batch
    torch.cuda.empty_cache()
    replayed_vjp = replay_in_worker(train_calls, "vjp")
    log("train-main: replayed calls of one update: " + json.dumps(replayed_vjp))
    log(f"phase train-main ok in {time.time() - t0:.1f} s")
    del train_calls
    torch.cuda.empty_cache()

    t0 = time.time()
    check_codec(info)
    log(f"phase codec ok in {time.time() - t0:.1f} s")

    agent, evaluated = check_train_agent(dev, info)  # phases 8b and 8d
    torch.cuda.empty_cache()

    t0 = time.time()
    full8 = check_full_finetune_8bit(dev, info)
    log("train-8bit: " + json.dumps(full8))
    log(f"train-8bit: peak memory {full8['peak_mem_gb']:.3f} GB and update {full8['update_ms'][-1]:.1f} ms against "
        f"fp32 Adam's {trained['peak_mem_gb']:.3f} GB and {trained['update_ms_median_after_first']:.1f} ms (phase 8)")
    log(f"phase train-8bit ok in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()

    t0 = time.time()
    with learn_workdir() as tmp:
        check_learn(dev, info, tmp)
        check_learn_lever(dev, info, tmp)
        log(f"phase learn ok in {time.time() - t0:.1f} s")
        t0 = time.time()
        check_qlora_demo(dev, info, tmp)
        log(f"phase qlora ok in {time.time() - t0:.1f} s")
    torch.cuda.empty_cache()

    entry = {
        "name": "mot_attention_fwd",
        "route": "cuda",
        "source": "open_pi_zero_torch/csrc/mot_attention.cu",
        "replaces": REPLACES,
        "launches": prof["launches"],
        "max_abs_err": max(replayed["max_abs_err"], *(r["max_abs_err_bfloat16"] for r in kernel.values())),
        # one chunk: device time summed over its launches
        "ms": prof["ms"],
        "plain_ms": replayed["plain_ms"],
        "bound_ms": replayed["bound_ms"],
        "bound_by": replayed["bound_by"],
        "library_ms": replayed["library_ms"],
        # the same launches over one chunk of the production serving layout
        "production_launches": layout["production"]["launches"],
        "production_ms": layout["production"]["ms"],
        # the same launches traced by symbol in one replay of the production
        # chunk's CUDA graph (the wrapper's count moves only at the capture)
        "compiled_traced_launches": compiled_rows["production"]["k1_launches_per_replay"],
        "compiled_ms": compiled_rows["production"]["k1_ms"],
        # the adaLN-Zero float chunk, and the text path: launches per eager
        # 20-token generate and device ms per decode token in the compiled
        # decode of the bf16 tree
        "adaln_launches": adaln["float"]["launches"],
        "adaln_ms": adaln["compiled"]["float"]["k1_ms"],
        "text_launches_per_generate": text["bf16"]["k1_launches_per_generate"],
        "text_ms_per_token": text["bf16"]["k1_ms_per_token"],
        # one full-width QLoRA update of the TrainAgent (phase 8b)
        "qlora_update_launches": agent["launches"] // 3,
        # one in-loop act of the EvalAgent (phase 8d): a replay of the
        # production chunk's graph, profiled; and the refined graph's
        "eval_launches_per_chunk": evaluated["k1_launches_per_chunk"],
        "eval_ms": evaluated["k1_ms"],
        "eval_refined_launches_per_chunk": evaluated["refined"]["k1_launches"]["refined"],
        "eval_refined_ms": evaluated["refined"]["k1_ms"]["refined"],
    }
    vjp_entry = {
        "name": "mot_attention_vjp",
        "route": "cuda",
        # the backward kernels' source; the forward is K1's
        "source": "open_pi_zero_torch/csrc/mot_attention_bwd.cu",
        "sources": ["open_pi_zero_torch/csrc/mot_attention.cu", "open_pi_zero_torch/csrc/mot_attention_bwd.cu"],
        "replaces": REPLACES_VJP,
        # K1's forwards and both backward kernels' launches in one update of
        # phase 8's counted run
        "launches": (trained["launches"] + trained["bwd_launches"]) // 3,
        "max_abs_err": max(replayed_vjp["max_abs_err"], *vjp_errs.values(),
                           *(r[f"max_abs_err_{p}"] for r in bwd.values() for p in ("dq", "dk", "dv"))),
        # one update: the two forwards and the VJP of every (layer,
        # microbatch), device time summed over the replayed calls
        "ms": replayed_vjp["kernel_ms"],
        "backward_ms": replayed_vjp["backward_ms"],
        "recompute_ms": replayed_vjp["recompute_ms"],
        "plain_ms": replayed_vjp["plain_ms"],
        "bound_ms": replayed_vjp["bound_ms"],
        "bound_by": replayed_vjp["bound_by"],
        "library_ms": replayed_vjp["library_ms"],
        # one full-width QLoRA update of the TrainAgent (phase 8b): K1's
        # forwards and the backward kernels' launches
        "qlora_update_launches": (agent["launches"] + agent["bwd_launches"]) // 3,
    }
    return [entry, vjp_entry]


def mesh_phases(dev, info: str, dp_layers: int = DP_LAYERS) -> dict:
    """Phases 9-12 in spawned ranks; returns the K1-shard entry of the
    kernels line. Phases 9, 11 and tp-train share one world of 2 ranks
    (mesh (1, 2)), one rank program after the other, so that its
    processes start once."""
    t0 = time.time()
    main_args, tp_args, qlora_args = shard_main_args(), tp_train_args(), tp_qlora_args()
    attention_rows, main_path, tp_train, tp_qlora = run_ranks(
        ranks.sequence, 1, 2, [(ranks.attention_rank, (shard_cases(),)), (ranks.main_path_rank, main_args),
                               (ranks.train_rank, tp_args), (ranks.train_rank, qlora_args)],
        device="cuda", timeout_s=RANK_TIMEOUT_S)
    log(f"shard-kernel, shard-main and tp-train: their world of 2 ranks ran all three in {time.time() - t0:.1f} s "
        f"(tp-train's programs {tp_train['seconds']:.1f} s fp32, {tp_qlora['seconds']:.1f} s QLoRA, of it)")
    shard_errs = check_shard_kernel(attention_rows)
    log("shard-kernel, 2 ranks, mesh (1, 2), max|diff| vs the plain version: " + json.dumps(shard_errs))
    log(f"phase shard-kernel ok in {time.time() - t0:.1f} s")

    t0 = time.time()
    shard = check_shard_main(main_args[0], main_path)
    log("shard-main: " + json.dumps(shard))
    log(f"shard-main: full-width fp32 TP=2, backend {shard['backend']}, ranks on "
        f"{[r['device'] for r in shard['ranks']]} ({shard['card']}); warm TP chunk "
        f"{statistics.median(shard['chunk_ms']):.3f} ms (median of 5, rank 0; host-staged gloo "
        f"transport when the ranks share a card), unsharded fp32 chunk on one rank "
        f"{statistics.median(shard['unsharded_chunk_ms']):.3f} ms (median of 3); peak memory per rank "
        f"{[round(r['peak_mem_gb'], 3) for r in shard['ranks']]} GB, on {info}")
    log(f"phase shard-main ok in {time.time() - t0:.1f} s (its ranks' run counted in shard-kernel's)")

    t0 = time.time()
    tp = check_tp_train(tp_args[0], tp_train, info)
    qlora = tp_train_summary(f"tp-train QLoRA ({AGENT_CONFIG} quantize, lora)", qlora_args[0], tp_qlora,
                             check_tp_qlora(qlora_args[0], tp_qlora), info)
    log(f"tp-train QLoRA: the gathered adapters vs unsharded max|diff| {qlora['adapters_max_abs_diff']:.3e} "
        f"(limit {DP_TOL['params']}); NF4 bases {qlora['nf4']}; int8 moments of the split leaves "
        f"{qlora['int8_moments']}; moment bytes per rank {qlora['moment_bytes']}")
    log(f"phase tp-train ok in {time.time() - t0:.1f} s (its ranks' runs, {tp['seconds']:.1f} and "
        f"{qlora['seconds']:.1f} s, counted in shard-kernel's)")

    t0 = time.time()
    shard_parity = check_shard_parity()
    log(f"shard-parity: bridge widths depth 2 fp32 B=4, mesh (2, 2) on the card vs CPU: "
        f"{json.dumps(shard_parity)}, {time.time() - t0:.1f} s")
    log(f"shard-parity: one DP x TP update (B = 2) on the mesh vs the CPU's single-process update: "
        f"relative {shard_parity['update']['relative']}, params max|diff| "
        f"{shard_parity['update']['params_max_abs_diff']:.3e} (limits {DP_TOL}), K1-shard "
        f"{shard_parity['update']['launches_per_update']} K1 and backward launches per rank")

    t0 = time.time()
    dp = check_dp_main(dev, info, layers=dp_layers)
    log(f"phase dp-main ok in {time.time() - t0:.1f} s")
    dp_agent = dp["ranks"][0]["agent"]

    return {
        "name": "mot_attention_shard",
        "route": "cuda",
        "source": "open_pi_zero_torch/csrc/mot_attention.cu",
        "replaces": REPLACES_SHARD,
        "launches": shard["ranks"][0]["launches"],
        "max_abs_err": max(shard["replayed"]["max_abs_err"], *shard_errs.values()),
        # one TP chunk of rank 0, fp32: device time summed over the replayed calls
        "ms": shard["replayed"]["kernel_ms"],
        "plain_ms": shard["replayed"]["plain_ms"],
        "bound_ms": shard["replayed"]["bound_ms"],
        "bound_by": shard["replayed"]["bound_by"],
        "library_ms": shard["replayed"]["library_ms"],
        # phase 12: every attention call of a DP rank goes through K1-shard
        # (a model group of one); rank 0's launches per update of the
        # QLoRA recipe (K1's forwards, then the backward kernels'), one
        # card's count
        "dp_launches_per_update": dp_agent["launches"][0],
        "dp_bwd_launches_per_update": dp_agent["bwd_launches"][0],
        # tp-train: rank 0's launches per update of the TP = 2 training, its
        # forwards through K1-shard and its VJPs' backward kernels (one
        # card's count at the same depth and accumulation)
        "tp_launches_per_update": tp_train["ranks"][0]["launches"][0],
        "tp_bwd_launches_per_update": tp_train["ranks"][0]["bwd_launches"][0],
        # the same for tp-train's QLoRA recipe (NF4 bases, LoRA, int8 moments)
        "tp_qlora_launches_per_update": tp_qlora["ranks"][0]["launches"][0],
        "tp_qlora_bwd_launches_per_update": tp_qlora["ranks"][0]["bwd_launches"][0],
    }


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Smoke run of open_pi_zero_torch on one NVIDIA card.")
    parser.add_argument("--dp-layers", type=int, default=DP_LAYERS,
                        help="depth of both towers in phase 12 (dp-main); 0 runs the recipe's depths")
    return parser.parse_args(argv)


def main() -> None:
    args = parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card only")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    start_replayer()
    try:
        t0 = time.time()
        sources = (fa.SOURCE, fa.BWD_SOURCE, jpeg.SOURCE)
        with ThreadPoolExecutor(len(sources)) as pool:  # one compiler per source, all at once
            list(pool.map(_build.build, sources))
        info = card()
        log(f"build: {', '.join(sources)} in {time.time() - t0:.1f} s")
        for source in sources:
            log_build_instances(_build.build_log(source))
        print(f"card: {info}", flush=True)  # as nvidia-smi prints it

        kernels = single_card_phases(dev, info)
        kernels.append(mesh_phases(dev, info, args.dp_layers))
    finally:
        stop_replayer()
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
