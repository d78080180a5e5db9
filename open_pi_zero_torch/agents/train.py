"""TrainAgent: the training workspace (counterpart of the JAX package's
``agents/train.py``; reference src/agent/train.py), on one card or on a
data mesh of processes.

From a config (``config.load_config``) it builds the params (random from
the seed, optionally PaliGemma safetensors or a checkpoint's eval export as
the base, then the config's NF4 quantization of the frozen bases), the
optimizer (AdamW, or int8 moments with ``quantize``) and the train step
with gradient accumulation; resumes from a checkpoint (a path, or
``"auto"``: the newest complete ``ckpt_N``); then ``run`` takes
``n_updates`` updates on frame batches from ``dataset``, validating every
``eval_freq`` and saving every ``save_model_freq`` from
``save_model_start``, and once at the end (unless that update was just
saved).

On a data mesh (a world of n processes joined by
``parallel.init_distributed``, which ``scripts/run.py --distributed``
calls under torchrun, or ranks of ``parallel.run_ranks``; the model axis
is 1, as the JAX agent's) each rank reads its shard of the data, the
accumulation is ``global_batch_size // (per_device_batch_size * n)``, the
train step all-reduces the grads once per update, and ``zero1: true``
shards the moments and the EMA/SWA average over the ranks (a no-op on one
rank, as in JAX). Rank 0 picks the checkpoint to resume and broadcasts it;
validation gathers the ranks' predictions, so its metrics are those of the
global validation batch; every rank enters a save's collectives, rank 0
writes and logs (wandb too).

Where it differs from the JAX agent, by design:
  - the data: without ``dataset=``, the datasets come from ``cfg.data``
    as in JAX, through the port's TF-free pipeline
    (``agents/dataset.RLDSInterleavedDataset``), and are built before the
    params, so that a data fault stops the agent early; ``dataset=`` takes
    any object whose ``iterator(batch_size)`` yields frame batches in the
    RLDS layout of ``preprocess_batch``; with neither the agent raises;
  - the tokenizer: ``FakeTokenizer`` when ``pretrained_model_path`` does
    not exist, as in JAX; an existing path raises, since the PaliGemma
    tokenizer needs transformers (ROADMAP.md, "Not queued");
  - checkpoints are ``training/checkpoint.py``'s, not orbax directories:
    ``resume_checkpoint_path`` and ``base_params_checkpoint`` refuse the
    JAX package's with the command line of ``convert_jax_checkpoint.py``,
    whose params export ``base_params_checkpoint`` then reads.
"""

from __future__ import annotations

import logging
import os
import re
import tempfile
from collections import deque
from typing import Optional

import numpy as np
import torch

from open_pi_zero_torch import resolve_device
from open_pi_zero_torch.agents.dataset import RLDSInterleavedDataset
from open_pi_zero_torch.config import ConfigDict, pizero_config_from_dict, training_config_from_dict
from open_pi_zero_torch.models import convert, pizero
from open_pi_zero_torch.ops import lora as lora_lib
from open_pi_zero_torch.parallel import collectives
from open_pi_zero_torch.parallel.mesh import broadcast_int, get_mesh, process_index, world_size
from open_pi_zero_torch.processing import FakeTokenizer, VLAProcessor, load_paligemma_tokenizer
from open_pi_zero_torch.training import averaging as avg_lib
from open_pi_zero_torch.training import checkpoint as ckpt_lib
from open_pi_zero_torch.training import optimizer as opt_lib
from open_pi_zero_torch.training import schedules, seeds
from open_pi_zero_torch.training.train_step import init_train_state, make_train_step, shard_state_zero1
from open_pi_zero_torch.utils.metric import get_action_accuracy, l1_loss
from open_pi_zero_torch.utils.monitor import Timer, log_device_memory, log_execution_time, main_process_only

log = logging.getLogger(__name__)


def _strip_lora(tree):
    """Drop the ``<name>_lora`` adapter subtrees: the shape of a plain
    float checkpoint."""
    if isinstance(tree, dict):
        return {k: _strip_lora(v) for k, v in tree.items() if not k.endswith("_lora")}
    return tree


def _graft(dst, src):
    """Deep-merge ``src`` into ``dst`` where keys exist (adapters absent
    from ``src`` keep their fresh initialization)."""
    if isinstance(src, dict) and isinstance(dst, dict):
        return {**dst, **{k: _graft(dst[k], v) for k, v in src.items()}}
    return src


def _load_tokenizer(cfg: ConfigDict):
    path = cfg.get("pretrained_model_path")
    if path and os.path.exists(os.path.expanduser(str(path))):
        return load_paligemma_tokenizer(os.path.expanduser(str(path)))
    log.warning("pretrained_model_path missing; using FakeTokenizer (tests only)")
    return FakeTokenizer(image_token_id=int(cfg.get("image_token_index", 257152)))


class TrainAgent:
    def __init__(self, cfg: ConfigDict, dataset=None, val_dataset=None, device=None):
        self.cfg = cfg
        mesh = get_mesh()  # a mesh's ranks run on its device unless told otherwise
        self.device = resolve_device((mesh.device if mesh is not None else "cuda") if device is None else device)
        self.seed = int(cfg.get("seed", 42))
        self.debug = bool(cfg.get("debug", False))
        self.log_dir = os.path.expanduser(str(cfg.get("log_dir", os.path.join(tempfile.gettempdir(), "opz_train"))))
        self.ckpt_dir = os.path.join(self.log_dir, "checkpoint")
        os.makedirs(self.ckpt_dir, exist_ok=True)

        self.model_cfg = pizero_config_from_dict(cfg)
        self.train_cfg = training_config_from_dict(cfg)

        # ---- parallelism / batch math (reference train.py:134-139) ----
        n_devices = world_size()
        gbs, pbs = self.train_cfg.global_batch_size, self.train_cfg.per_device_batch_size
        if gbs % (pbs * n_devices):
            raise ValueError(f"global_batch_size {gbs} not divisible by per_device {pbs} x devices {n_devices}")
        self.grad_accum = max(1, gbs // (pbs * n_devices))
        self.step_batch_size = pbs  # per microbatch, this rank's
        self.mesh = mesh
        if n_devices > 1:
            if self.mesh is None or self.mesh.size != n_devices:
                raise RuntimeError(f"a world of {n_devices} processes without its mesh: call "
                                   "parallel.init_distributed() first (scripts/run.py --distributed)")
            if self.mesh.n_model != 1:
                raise NotImplementedError("tensor-parallel training: the JAX TrainAgent trains on a data mesh only")
            if device is not None and self.device.type != self.mesh.device.type:
                raise ValueError(f"device {self.device} on a mesh of {self.mesh.device.type} ranks")
            self.device = self.mesh.device
        else:
            self.mesh = None
        self.is_main = process_index() == 0
        log.info("devices=%d device=%s accum=%d per-device=%d global=%d", n_devices, self.device, self.grad_accum,
                 pbs, gbs)

        # ---- data: built before the params (reference train.py:143-155) ----
        if dataset is None:
            if cfg.get("data") is None:
                raise ValueError("no data: pass dataset= or give the config a data block")
            dataset = RLDSInterleavedDataset(cfg.data.train, train=True, seed=self.seed)
            if cfg.data.get("val") is not None and cfg.get("eval_freq"):
                val_cfg = ConfigDict({**cfg.data.train, **cfg.data.val})
                val_dataset = RLDSInterleavedDataset(val_cfg, train=False, seed=self.seed)

        # ---- params, optimizer, state ----
        params = self._build_params()
        self.optimizer = opt_lib.build_optimizer(self.train_cfg, params)
        # flow times and noise: a stream of its own, not the init's (seeds.py);
        # seeded alike on every rank, each keeping its rows of every draw
        generator = seeds.stream_generator(self.seed, seeds.TRAIN, device=self.device)
        self.state = init_train_state(params, self.optimizer, generator, self.train_cfg)
        self.zero1 = bool(cfg.get("zero1", False)) and self.mesh is not None
        if self.zero1:
            # ZeRO-1: the moments and the EMA/SWA average sharded over the data ranks
            self.state = shard_state_zero1(self.state, self.optimizer, self.mesh)
        if self.device.type == "cuda":
            log_device_memory(log, "building the train state", self.device)

        self.cnt_batch = 0
        self._wandb_id: Optional[str] = None
        resume = cfg.get("resume_checkpoint_path")
        if resume == "auto":
            # elastic restarts: the newest complete checkpoint, chosen on rank 0
            resume = self._latest_checkpoint()
        if resume:
            self.state, extra = ckpt_lib.restore_checkpoint(str(resume), self.state)
            self.cnt_batch = int(extra.get("cnt_batch", 0))
            self._wandb_id = extra.get("wandb_id")
            log.info("resumed from %s at update %d", resume, self.state.step)

        self.dataset, self.val_dataset = dataset, val_dataset

        self.processor = VLAProcessor(
            _load_tokenizer(cfg),
            num_image_tokens=self.model_cfg.siglip.num_image_tokens,
            max_seq_len=self.model_cfg.max_image_text_tokens,
            tokenizer_padding=str(cfg.get("tokenizer_padding", "max_length")),
        )
        self.train_step = make_train_step(self.model_cfg, self.train_cfg, self.optimizer, self.grad_accum)

        # ---- schedule ----
        self.n_updates = int(cfg.get("n_updates", 0))
        self.log_freq = int(cfg.get("log_freq", 16))
        self.save_model_freq = int(cfg.get("save_model_freq", 0) or 0)
        self.save_model_start = int(cfg.get("save_model_start", 0) or 0)
        self.eval_freq = int(cfg.get("eval_freq", 0) or 0)
        self.eval_size = int(cfg.get("eval_size", 0) or 0)
        self.eval_thresholds = list(cfg.get("eval_thresholds", [0.05, 0.1, 0.2, 0.3, 0.5]))

        self.wandb = None
        if cfg.get("wandb") and not self.debug:
            self._init_wandb()

    @main_process_only
    def _init_wandb(self) -> None:
        try:
            import wandb

            run = wandb.init(
                project=str(self.cfg.wandb.get("project", "open-pi-zero-tpu")),
                name=str(self.cfg.get("name", "run")),
                config=dict(self.cfg),
                id=self._wandb_id,  # resume the run across restarts
                resume="allow" if self._wandb_id else None,
            )
            self._wandb_id = run.id
            self.wandb = wandb  # only after a successful init
        except Exception as e:  # wandb missing or offline: train without it
            log.warning("wandb disabled: %s", e)

    def _latest_checkpoint(self) -> Optional[str]:
        """The newest COMPLETE checkpoint (``state/`` and ``meta.json``): a
        save cut short leaves a partial ``ckpt_N`` that must not be taken.
        In a world of processes rank 0 chooses and broadcasts its choice,
        so that every rank restores the same update."""
        best_step = -1
        if process_index() == 0 and os.path.isdir(self.ckpt_dir):
            for d in os.listdir(self.ckpt_dir):
                m = re.fullmatch(r"ckpt_(\d+)", d)
                path = os.path.join(self.ckpt_dir, d)
                complete = os.path.isdir(os.path.join(path, ckpt_lib.STATE_DIR)) and os.path.exists(
                    os.path.join(path, ckpt_lib.META_FILE)
                )
                if m and complete:
                    best_step = max(best_step, int(m.group(1)))
        best_step = broadcast_int(best_step)
        return os.path.join(self.ckpt_dir, f"ckpt_{best_step}") if best_step >= 0 else None

    # ------------------------------------------------------------------ #
    @log_execution_time(log)
    def _build_params(self) -> dict:
        params = pizero.init_params(self.model_cfg, seed=self.seed, device=self.device)
        path = self.cfg.get("pretrained_model_path")
        if bool(self.cfg.get("load_pretrained_weights", False)) and path:
            path = os.path.expanduser(str(path))
            pretrained = convert.convert_paligemma(convert.load_safetensors_dir(path), self.model_cfg)
            params = convert.merge_pretrained(params, pretrained)
            log.info("loaded pretrained PaliGemma weights from %s", path)
        base_ckpt = self.cfg.get("base_params_checkpoint")
        if base_ckpt:
            # warm-start the bases from a checkpoint's eval export (a tree
            # without adapters); the fresh adapters stay
            loaded = ckpt_lib.restore_params(os.path.expanduser(str(base_ckpt)), _strip_lora(params), self.device)
            params = _graft(params, loaded)
            log.info("warm-started base weights from %s", base_ckpt)
        qparams = lora_lib.quantize_per_model_config(params, self.model_cfg)
        if qparams is not params:
            log.info("quantized frozen base weights (NF4) per config")
        counts = opt_lib.trainable_param_count(qparams, self.train_cfg.train_vlm)
        log.info("params: %s", {k: f"{v:.3f}B" for k, v in counts.items()})
        return qparams

    # ------------------------------------------------------------------ #
    def preprocess_batch(self, batch: dict) -> dict:
        """Frame batch (numpy, RLDS layout) -> model inputs (reference
        train.py:271-314): ``observation.image_primary`` uint8 [B, 1, H, W,
        3], ``observation.proprio`` [B, 1, P], ``task.language_instruction``
        bytes [B], ``action`` [B, 1, H_a, A]. The window dim is squeezed;
        the text is tokenized and the images normalized on the host."""
        obs = batch["observation"]
        images = obs["image_primary"]
        if images.ndim == 5:  # [B, W, H, W, C] window
            images = images[:, -1]
        texts = [
            t.decode("utf-8") if isinstance(t, bytes) else str(t)
            for t in np.asarray(batch["task"]["language_instruction"]).reshape(-1)
        ]
        model_inputs = self.processor(texts, images.astype(np.uint8))
        proprios = np.asarray(obs["proprio"], np.float32)
        if proprios.ndim == 2:
            proprios = proprios[:, None]
        actions = np.asarray(batch["action"], np.float32)
        if actions.ndim == 4:  # [B, W, H, A]
            actions = actions[:, -1]
        return {
            "input_ids": model_inputs["input_ids"],
            "pixel_values": model_inputs["pixel_values"],
            "attention_mask": model_inputs["attention_mask"],
            "proprios": proprios,
            "actions": actions,
        }

    def _stack_accum(self, batches: list) -> dict:
        if self.grad_accum == 1:
            return batches[0]
        return {k: np.stack([b[k] for b in batches]) for k in batches[0]}

    def to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def next_update_batch(self, it) -> dict:
        """The next update's batch on the card: ``grad_accum`` frame
        batches from ``it``, preprocessed and stacked on a leading axis."""
        micro = []
        for _ in range(self.grad_accum):
            micro.append(self.preprocess_batch(next(it)))
            self.cnt_batch += 1
        return self.to_device(self._stack_accum(micro))

    # ------------------------------------------------------------------ #
    def run(self):
        """The training loop (reference train.py:249-495). Returns the state."""
        it = self.dataset.iterator(self.step_batch_size)
        timer = Timer()
        losses = deque(maxlen=self.log_freq)  # device scalars, read at log boundaries only
        update = self.state.step
        action_lr = schedules.from_config(self.train_cfg.action_lr, self.train_cfg.action_lr_scheduler)

        saved_at = None
        while update < self.n_updates:
            metrics = self.train_step(self.state, self.next_update_batch(it))
            update += 1
            losses.append(metrics["loss"])

            if update % self.log_freq == 0:
                avg_loss = float(torch.stack(list(losses)).mean())  # the global batch's: every rank's equal
                grad_norm = float(metrics["grad_norm"])
                if self.is_main:
                    log.info(
                        "update %d/%d | loss %.4f | grad_norm %.3f | %.2fs/%d updates",
                        update, self.n_updates, avg_loss, grad_norm, timer(), self.log_freq,
                    )
                if self.wandb:
                    self.wandb.log({"loss": avg_loss, "gradient norm": grad_norm, "lr": action_lr(update)}, step=update)

            if self.eval_freq and update % self.eval_freq == 0 and self.val_dataset:
                self.validate(update)

            if self.save_model_freq and update >= self.save_model_start and update % self.save_model_freq == 0:
                self.save(update)
                saved_at = update

        if saved_at != self.state.step:  # the last update is saved once
            self.save(self.state.step)
        return self.state

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def validate(self, update: int) -> Optional[dict]:
        """Held-out L1 and thresholded action accuracy through KV-cached
        ``infer_action`` on the eval params (reference train.py:413-459).
        Returns {"l1", "accuracy": {threshold: share}}. On a data mesh each
        rank infers its shard's batch (the noise rows of the global batch's
        draw) and the ranks' actions and predictions are gathered, so the
        metrics are one device's over the global batch (the ranks' batches
        in rank order); the ranks stop together when one runs out."""
        it = self.val_dataset.iterator(self.step_batch_size)
        n_batches = max(1, self.eval_size // max(1, self.step_batch_size))
        eval_params = avg_lib.eval_params(self.state.avg, self.state.params)
        generator = seeds.stream_generator(self.seed, seeds.VALIDATION, update, device=self.device)
        accs, l1s = [], []
        for _ in range(n_batches):
            try:
                batch = self.to_device(self.preprocess_batch(next(it)))
            except StopIteration:
                batch = None
            if self.mesh is not None:
                more = torch.tensor([float(batch is not None)], device=self.device)
                if not float(collectives.all_reduce(more, op=torch.distributed.ReduceOp.MIN)):
                    break
            elif batch is None:
                break
            gt = batch.pop("actions")
            pred = pizero.infer_action(
                eval_params, self.model_cfg, generator,
                batch["input_ids"], batch["pixel_values"], batch["attention_mask"], batch["proprios"],
            )
            if self.mesh is not None:
                gt, pred = (collectives.all_gather(x, self.mesh.data_group) for x in (gt, pred))
            accs.append(get_action_accuracy(gt, pred, self.eval_thresholds).cpu().numpy())
            l1s.append(float(l1_loss(gt, pred)))
        if not accs:
            return None
        acc = np.mean(accs, axis=0)
        l1 = float(np.mean(l1s))
        result = {"l1": l1, "accuracy": {t: float(a) for t, a in zip(self.eval_thresholds, acc)}}
        if self.is_main:
            log.info("eval @ %d | l1 %.4f | acc %s", update, l1, {t: f"{a:.3f}" for t, a in result["accuracy"].items()})
        if self.wandb:
            payload = {f"eval acc - thres {t}": a for t, a in result["accuracy"].items()}
            payload["eval l1"] = l1
            self.wandb.log(payload, step=update)
        return result

    # ------------------------------------------------------------------ #
    @log_execution_time(log)
    def save(self, update: int) -> str:
        """Save ``ckpt_<update>``: the state, the eval export, the metadata.
        On a data mesh every rank calls it (the gathers of ZeRO-1 and of
        the average are collectives); rank 0 writes."""
        path = os.path.join(self.ckpt_dir, f"ckpt_{update}")
        ckpt_lib.save_checkpoint(
            path, self.state,
            extra={"cnt_batch": self.cnt_batch, "wandb_id": self._wandb_id},
            eval_params=avg_lib.eval_params(self.state.avg, self.state.params),
        )
        if self.is_main:
            log.info("saved checkpoint %s", path)
        return path
