"""EvalAgent: closed-loop SimplerEnv evaluation (counterpart of the JAX
package's ``agents/eval.py``; reference src/agent/eval.py).

The policy step is one action chunk at B = 1. On a card it is one replay
of a CUDA graph (``models/compiled.compile_chunk``), the counterpart of
the JAX agent's ``jax.jit`` over ``pizero.infer_action``; with
``refine_from_prev`` > 0 a second graph runs the refined chunk from
``t_start``, and both draw their noise from one CUDA generator seeded
with the config's seed (the JAX agent's ``jax.random.key(seed)``). On the
CPU the chunk runs eagerly (``pizero.infer_action`` or
``infer_action_refined``) with a CPU generator seeded alike.

Everything env-facing is host numpy through the env adapters.
``simpler_env`` and ``imageio`` are imported only for real Simpler tasks
and for video; where they are missing that raises ImportError.

Parameters passed in are used as they are. Otherwise the checkpoint is
loaded as the serve CLI loads it (``scripts/serve.load_params``): a
reference ``.pt`` or a checkpoint directory of the port's trainer (or a
JAX package's checkpoint converted by ``convert_jax_checkpoint.py``; an
orbax directory raises with that command line), its LoRA adapters merged
per mixture and its NF4 bases decoded, then the serving layout of the
config's knobs (``fuse.serving_layout_kwargs``).
"""

from __future__ import annotations

import logging
import os
import random
import tempfile

import numpy as np
import torch

from open_pi_zero_torch import resolve_device
from open_pi_zero_torch.agents.env_adapter import make_adapter
from open_pi_zero_torch.config import ConfigDict, pizero_config_from_dict
from open_pi_zero_torch.models import compiled, pizero
from open_pi_zero_torch.scripts import serve
from open_pi_zero_torch.utils.monitor import Timer, log_execution_time

log = logging.getLogger(__name__)

Tensor = torch.Tensor


class EvalAgent:
    def __init__(self, cfg: ConfigDict, env=None, adapter=None, params=None, device="cuda"):
        """env/adapter/params injectable for tests; by default built from
        config (simpler_env.make, reference eval.py:56-58)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = int(cfg.get("seed", 42))
        random.seed(self.seed)
        np.random.seed(self.seed)

        self.model_cfg = pizero_config_from_dict(cfg)
        self.dtype = torch.bfloat16 if cfg.get("use_bf16") else torch.float32

        self.n_eval_episode = int(cfg.get("n_eval_episode", 240))
        self.n_video = int(cfg.get("n_video", 0))
        self.record_video = bool(cfg.get("record_video", False)) and self.n_video > 0
        self.act_steps = int(cfg.get("act_steps", cfg.get("horizon_steps", 4)))
        self.log_dir = os.path.expanduser(str(cfg.get("log_dir", os.path.join(tempfile.gettempdir(), "opz_eval"))))
        self.video_dir = os.path.join(self.log_dir, "video")
        os.makedirs(self.video_dir, exist_ok=True)

        # ---- model ----
        self.params = params if params is not None else self._load_params()
        # training-free action caching (refine_from_prev = t_start in (0, 1)):
        # steady-state chunks warm-start the flow from the re-noised previous
        # chunk and integrate only [t_start, 1]; the first chunk of an
        # episode runs the full flow. Off by default: on SimplerLite the JAX
        # package measured it harmless on reach but 10 points of success
        # lost on pick-and-place (E2E_TIER_SUCCESS.json)
        self.refine_t = float(cfg.get("refine_from_prev", 0.0))
        if not 0.0 <= self.refine_t < 1.0:
            raise ValueError(f"refine_from_prev must be in [0, 1), got {self.refine_t}")
        self.generator = torch.Generator(self.device).manual_seed(self.seed)
        self.graphs = {}  # t_start -> CompiledChunk, on a card
        if self.device.type == "cuda":
            self._compile_graphs()
        self._prev_chunk = None  # [1, A, act_dim] on the device, normalized

        # ---- env ----
        self.env = env
        if self.env is None:
            task = str(cfg.env.task)
            if task.startswith("simpler_lite"):
                # in-repo kinematic envs (envs/): closed-loop smoke and
                # learning runs without SimplerEnv installed
                from open_pi_zero_torch.envs import make_env

                self.env = make_env(task, seed=self.seed)
            else:
                import simpler_env

                self.env = simpler_env.make(task)
        self.adapter = adapter
        if self.adapter is None:
            acfg = dict(cfg.env.adapter)
            self.adapter = make_adapter(acfg.pop("name"), **acfg)

    @log_execution_time(log)
    def _load_params(self) -> dict:
        if not self.cfg.get("checkpoint_path"):
            raise ValueError("checkpoint_path required for eval")
        return serve.load_params(self.cfg, self.model_cfg, self.dtype, self.device, random_init=False)

    def _compile_graphs(self) -> None:
        """Capture the B = 1 chunk, and with refine_from_prev the refined
        chunk, as CUDA graphs in one pool, drawing from the agent's
        generator; the policy calls replay them. (No attribute of the agent
        refers back to it, so an agent that goes out of scope frees its
        graphs then, not at a garbage collection that may fall inside
        another capture.)"""
        pool = None
        for t in (0.0, self.refine_t) if self.refine_t > 0.0 else (0.0,):
            self.graphs[t] = compiled.compile_chunk(
                self.params, self.model_cfg, 1, generator=self.generator, t_start=t, device=self.device, pool=pool
            )
            pool = self.graphs[t].pool

    # ------------------------------------------------------------------ #
    def _infer(self, inputs: dict) -> Tensor:
        """The full chunk [1, A, act_dim]: a replay of its graph on a card,
        else the eager chunk."""
        if self.graphs:
            return self.graphs[0.0](inputs)
        return self._eager(inputs)

    def _infer_refined(self, inputs: dict, prev_chunk: Tensor) -> Tensor:
        """The refined chunk from ``prev_chunk``: a replay of its graph on a
        card, else the eager chunk."""
        if self.graphs:
            return self.graphs[self.refine_t]({**inputs, "prev_chunk": prev_chunk})
        return self._eager(inputs, prev_chunk)

    def _eager(self, inputs: dict, prev_chunk=None) -> Tensor:
        """The eager chunk: ``pizero.infer_action``, or from ``prev_chunk``
        the refined chunk, noise from the agent's generator."""
        x = {k: torch.as_tensor(np.asarray(inputs[k]), device=self.device)
             for k in ("input_ids", "pixel_values", "attention_mask", "proprios")}
        args = (
            self.params, self.model_cfg, self.generator, x["input_ids"], x["pixel_values"].to(self.dtype),
            x["attention_mask"], x["proprios"].to(self.dtype),
        )
        if prev_chunk is None:
            return pizero.infer_action(*args)
        return pizero.infer_action_refined(*args, prev_chunk.to(self.dtype), t_start=self.refine_t)

    def act(self, inputs: dict) -> np.ndarray:
        """model inputs -> normalized action chunk [A, act_dim]."""
        if self.refine_t > 0.0 and self._prev_chunk is not None:
            chunk = self._infer_refined(inputs, self._prev_chunk)
        else:
            chunk = self._infer(inputs)
        if self.refine_t > 0.0:
            self._prev_chunk = chunk
        return chunk[0].float().cpu().numpy()

    def reset_policy_cache(self) -> None:
        """Drop the cached chunk at episode boundaries — the first chunk of
        an episode always runs the full flow (no stale warm-start across
        resets)."""
        self._prev_chunk = None

    # ------------------------------------------------------------------ #
    def run(self) -> dict:
        """Episode loop (reference eval.py:60-179): reset with episode-keyed
        object placement, run chunks of `act_steps`, handle multi-subtask
        instruction switching, account success on truncation."""
        env, adapter = self.env, self.adapter
        cnt_episode = 0
        successes = []
        episode_instructions = []  # first instruction per episode
        per_step_times = []
        video_writer = None
        timer = Timer()

        env_reset_options = {}
        if hasattr(env, "reset") and self.cfg.get("env") is not None:
            env_reset_options = {"obj_init_options": {"episode_id": cnt_episode}}
        obs, reset_info = env.reset(seed=self.seed, options=env_reset_options)
        instruction = env.get_language_instruction()
        episode_instructions.append(instruction)
        adapter.reset()
        self.reset_policy_cache()
        log.info("instruction: %s", instruction)
        if self.record_video:
            video_writer = self._open_video(cnt_episode)

        while cnt_episode < self.n_eval_episode:
            inputs = adapter.preprocess(env, obs, instruction)
            timer()
            action_chunk = adapter.postprocess(self.act(inputs))
            per_step_times.append(timer())

            success, truncated = False, False
            for action in action_chunk[: self.act_steps]:
                obs, reward, success, truncated, info = env.step(action)
                if video_writer is not None:
                    video_writer.append_data(adapter.get_video_frame(env, obs))
                new_instruction = env.get_language_instruction()
                if new_instruction != instruction:
                    instruction = new_instruction  # multi-subtask envs
                    log.info("new instruction: %s", instruction)
                if truncated:
                    break

            if truncated:
                successes.append(bool(success))
                if video_writer is not None:
                    self._close_video(video_writer, cnt_episode, bool(success))
                    video_writer = None
                cnt_episode += 1
                if cnt_episode >= self.n_eval_episode:
                    break
                env_reset_options["obj_init_options"] = {"episode_id": cnt_episode}
                obs, reset_info = env.reset(options=env_reset_options)
                instruction = env.get_language_instruction()
                episode_instructions.append(instruction)
                adapter.reset()
                self.reset_policy_cache()
                if self.record_video and cnt_episode < self.n_video:
                    video_writer = self._open_video(cnt_episode)

        success_rate = float(np.mean(successes)) if successes else 0.0
        # per-instruction breakdown, episodes bucketed by their FIRST
        # instruction: on multi-subtask envs (simpler_lite_reach_multi) a
        # mid-episode switch stays attributed to the opening instruction,
        # so it reads as "episodes that STARTED with k"
        by_instr = {}
        for instr, s in zip(episode_instructions, successes):
            n_ok, n = by_instr.get(instr, (0, 0))
            by_instr[instr] = (n_ok + int(s), n + 1)
        result = {
            "n_episodes": cnt_episode,
            "success_rate": success_rate,
            "success_by_instruction": {
                k: f"{ok}/{n}" for k, (ok, n) in sorted(by_instr.items())
            },
            "mean_inference_time_s": (
                float(np.mean(per_step_times[1:])) if len(per_step_times) > 1 else None
            ),  # the first chunk left out (reference try_checkpoint:111-115)
        }
        log.info("eval done: %s", result)
        return result

    # ------------------------------------------------------------------ #
    def _open_video(self, episode_id: int):
        import imageio

        path = os.path.join(self.video_dir, f"episode_{episode_id}.mp4")
        return imageio.get_writer(path, fps=10)

    def _close_video(self, writer, episode_id: int, success: bool):
        writer.close()
        if success:  # success-suffix renaming (reference eval.py:144-151)
            src = os.path.join(self.video_dir, f"episode_{episode_id}.mp4")
            dst = os.path.join(self.video_dir, f"episode_{episode_id}_success.mp4")
            os.replace(src, dst)
