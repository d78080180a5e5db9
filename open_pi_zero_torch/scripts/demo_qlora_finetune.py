"""QLoRA fine-tuning demonstration on SimplerLite (counterpart of the JAX
package's ``scripts/demo_qlora_finetune.py``).

Shows that the QLoRA tier learns in its loop, not only that it steps:

  1. the base is a trained reach policy: the newest ``ckpt_N`` of a
     ``demo_closed_loop`` run (``--base-workdir``), its ``params/`` export;
  2. the VLM trunk and SigLIP are frozen as NF4 bases with fresh LoRA
     adapters (r = ``--lora-r``); the action and proprio experts stay float
     and trained, as in the reference's LoRA tier;
  3. the ``TrainAgent`` fine-tunes on a held-out task (``--task``, the
     pick_place demos written by ``envs.write_demo_dataset``); with
     ``--retention-weight`` > 0 the old task's demos (reach, the base's own
     demo seed) join as a second dataset of a weighted OXE mix;
  4. the frozen NF4 payloads (every ``q4`` and ``absmax`` leaf) are checked
     bitwise unchanged after training;
  5. the fine-tuned tree (NF4 bases and unmerged adapters, the training
     layout) is scored in the closed loop on the new task and on the old
     one, beside the base policy's success on both.

  python -m open_pi_zero_torch.scripts.demo_qlora_finetune \\
      --base-workdir build/opz_reach --workdir build/opz_qlora \\
      --n-updates 14000 --retention-weight 0.5 --out E2E_QLORA_TORCH.json

It runs on the card unless ``--device cpu``. One card takes the whole
batch. The JAX script's config turns on no 8-bit optimizer moments (it has
no ``quantize`` key) and neither does this one. ``--resume`` continues from
the newest complete checkpoint in ``--workdir`` (with ``--save-freq``), so
a long run can be split into several. Besides
the JAX script's JSON keys the result holds the card's name and power
limit (``device``), the median update time (first update left out), the
batch wait per update, the kernels' launches per update and the loss per
50 updates.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import re
import time

import numpy as np

RETENTION_MIX = "qlora_retention"
REPLAY_DATASET = "simpler_lite_replay"


def latest_ckpt(ckpt_dir: str) -> str:
    """The ``ckpt_N`` under ``ckpt_dir`` with the largest N."""
    best, step = None, -1
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"ckpt_(\d+)", d)
        if m and int(m.group(1)) > step:
            best, step = os.path.join(ckpt_dir, d), int(m.group(1))
    if best is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return best


def quantized_payloads(params: dict, path=()) -> dict:
    """{slash path: numpy array} of every NF4 payload leaf (q4 / absmax)."""
    out = {}
    if isinstance(params, dict):
        if "q4" in params and "absmax" in params:
            for k in ("q4", "absmax"):
                out["/".join(path + (k,))] = params[k].detach().cpu().numpy()
            return out
        for k, v in params.items():
            out.update(quantized_payloads(v, path + (k,)))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base-workdir", default="build/opz_reach",
                    help="demo_closed_loop workdir of the trained base policy (reach)")
    ap.add_argument("--workdir", default="build/opz_qlora")
    ap.add_argument("--out", default=None, help="artifact JSON path")
    ap.add_argument("--task", default="pick_place", choices=["pick_place", "reach"])
    ap.add_argument("--n-demos", type=int, default=600)
    ap.add_argument("--n-updates", type=int, default=18000)
    ap.add_argument("--n-eval-episodes", type=int, default=40)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=96)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--lora-r", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval-seed", type=int, default=1000)
    ap.add_argument("--retention-weight", type=float, default=0.0,
                    help="sampling weight of the old task's (reach) demos beside the new "
                         "task's 1.0, so the float action expert keeps seeing the old task "
                         "(0 = the new task only)")
    ap.add_argument("--save-freq", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest complete checkpoint in --workdir")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def write_demo_sets(args, data_dir: str, log):
    """The new task's demos (and with retention the old task's replay set)
    under ``data_dir``, each written unless it exists; returns the new
    task's expert success rate (None where the demos were reused)."""
    from open_pi_zero_torch.envs import write_demo_dataset

    sets = [(args.task, "bridge_dataset")]
    if args.retention_weight > 0:
        # the base run's demo generator and seed: the replay stream is the
        # base policy's own training distribution
        sets.append(("reach", REPLAY_DATASET))
    expert_rate = None
    for task, name in sets:
        ds_dir = os.path.join(data_dir, name)
        if os.path.exists(os.path.join(ds_dir, "features.json")):
            log.info("reusing demos at %s", ds_dir)
            continue
        rate = write_demo_dataset(ds_dir, args.n_demos, seed=0, task=task, dataset_name=name)
        if name == "bridge_dataset":
            expert_rate = rate
    return expert_rate


@contextlib.contextmanager
def retention_mix(weight: float):
    """The mix the fine-tune trains on: ``bridge`` alone, or with
    ``weight`` > 0 the new task's set at 1.0 and the replay set (a copy of
    ``bridge_dataset``'s registry entry and transform) at ``weight``,
    registered in the OXE tables for the block and taken out after it."""
    from open_pi_zero_torch.data import oxe

    if weight <= 0:
        yield "bridge"
        return
    tables = (oxe.REGISTRY, oxe.STANDARDIZE_FNS, oxe.MIXES)
    saved = [dict(t) for t in tables]
    oxe.REGISTRY[REPLAY_DATASET] = dict(oxe.REGISTRY["bridge_dataset"])
    oxe.STANDARDIZE_FNS[REPLAY_DATASET] = oxe.bridge_transform
    oxe.MIXES[RETENTION_MIX] = [("bridge_dataset", 1.0), (REPLAY_DATASET, weight)]
    try:
        yield RETENTION_MIX
    finally:
        for table, before in zip(tables, saved):
            table.clear()
            table.update(before)


def qlora_geometry(args) -> dict:
    """``model_geometry`` with the VLM trunk and SigLIP as NF4 bases with
    LoRA adapters of rank ``--lora-r``."""
    from open_pi_zero_torch.scripts.demo_closed_loop import model_geometry

    geometry = model_geometry(args.hidden, args.layers, proprio_dim=7)
    geometry["mixture"]["vlm"] = {**geometry["mixture"]["vlm"], "use_quantize": True, "use_lora": True}
    geometry["vision"] = {**geometry["vision"], "use_quantize": True, "use_lora": True}
    geometry["lora_r"] = args.lora_r
    return geometry


def train_config(args, base_ckpt: str, mix: str, data_dir: str):
    """The TrainAgent's config: the JAX script's, on one card."""
    from open_pi_zero_torch.config import ConfigDict

    warmup = min(100, args.n_updates // 5)
    return ConfigDict({
        "name": "qlora_finetune",
        "seed": 0,
        "log_dir": os.path.join(args.workdir, "train"),
        "load_pretrained_weights": False,
        "base_params_checkpoint": base_ckpt,
        "lora": True,  # the optimizer's vlm group: the adapters only
        "n_updates": args.n_updates,
        "log_freq": 50,
        "save_model_freq": args.save_freq,
        "eval_freq": 0,
        "global_batch_size": args.global_batch,
        "per_device_batch_size": args.global_batch,
        "action_lr": args.lr,
        "vlm_lr": args.lr,
        "action_lr_scheduler": {"warmup_steps": warmup, "first_cycle_steps": args.n_updates, "min_lr": 1e-5},
        "vlm_lr_scheduler": {"warmup_steps": warmup, "first_cycle_steps": args.n_updates, "min_lr": 1e-5},
        # no EMA: an average of NF4 payloads means nothing, and the check
        # wants the trained tree itself
        "use_ema": False,
        "resume_checkpoint_path": "auto" if args.resume else None,
        **qlora_geometry(args),
        "data": {"train": {
            "dataset_mix": mix,
            "data_path": data_dir,
            "split": "train",
            "window_size": 1,
            "action_horizon": 4,
            "skip_unlabeled": True,
            "load_proprio": True,
            "augment": False,
            "shuffle_buffer_size": 20_000,
            "num_parallel_calls": 4,
            "traj_transform_threads": 2,
            "traj_read_threads": 2,
            "resize_size": [56, 56],
        }},
    })


def write_statistics(path: str, stats: dict) -> str:
    with open(path, "w") as f:
        json.dump({"action": stats["action"], "proprio": stats["proprio"]}, f)
    return path


def main(argv=None) -> dict:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("qlora")

    from open_pi_zero_torch import resolve_device
    from open_pi_zero_torch.agents.train import TrainAgent
    from open_pi_zero_torch.config import ConfigDict, pizero_config_from_dict
    from open_pi_zero_torch.envs import warm_tokenizer
    from open_pi_zero_torch.models import pizero
    from open_pi_zero_torch.ops import fused_attention as fa
    from open_pi_zero_torch.ops import lora as lora_lib
    from open_pi_zero_torch.scripts.demo_closed_loop import (
        UpdateTimes, device_info, fresh_tokenizer, model_geometry, run_eval,
    )
    from open_pi_zero_torch.training import checkpoint as ckpt_lib
    from open_pi_zero_torch.training import optimizer as opt_lib

    device = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    t0 = time.time()
    base_ckpt = latest_ckpt(os.path.join(args.base_workdir, "train", "checkpoint"))
    log.info("base checkpoint: %s", base_ckpt)

    # ---- 1. the held-out task's demos (and the old task's replay set) ----
    data_dir = os.path.join(args.workdir, f"rlds_n{args.n_demos}")
    expert_rate = write_demo_sets(args, data_dir, log)

    # ---- 2. QLoRA: NF4-frozen trunk and SigLIP, fresh adapters, float experts ----
    with retention_mix(args.retention_weight) as mix:
        train_cfg = train_config(args, base_ckpt, mix, data_dir)
        agent = TrainAgent(train_cfg, device=device)
    warm_tokenizer(agent.processor.tokenizer)
    if not (lora_lib.has_quantized_bases(agent.state.params) and lora_lib.has_lora(agent.state.params)):
        raise RuntimeError("the QLoRA tree lacks its NF4 bases or its adapters")
    # the payloads the agent quantizes from the base: those of update 0,
    # also when the state was resumed from a later checkpoint
    frozen_before = quantized_payloads(agent._build_params())
    log.info("%d NF4 payload leaves snapshotted", len(frozen_before))
    t_setup = time.time()

    # ---- 3. fine-tune ----
    timed = UpdateTimes(agent)
    first_update = agent.state.step
    launches = (fa.launches, fa.bwd_launches)
    state = agent.run()
    updates = max(1, state.step - first_update)
    k1_per_update = (fa.launches - launches[0]) / updates
    bwd_per_update = (fa.bwd_launches - launches[1]) / updates
    t_train = time.time()

    # ---- 4. the frozen bases bitwise unchanged ----
    frozen_after = quantized_payloads(state.params)
    if frozen_before.keys() != frozen_after.keys():
        raise RuntimeError("the NF4 payload leaves differ in their paths after training")
    changed = [k for k in frozen_before if not np.array_equal(frozen_before[k], frozen_after[k])]
    if changed:
        raise RuntimeError(f"frozen NF4 payloads changed: {changed[:5]}")
    log.info("all %d NF4 payloads bitwise unchanged", len(frozen_after))

    # ---- 5. closed loop: the QLoRA tree as it trained (NF4 bases, adapters) ----
    all_stats = agent.dataset.dataset.dataset_statistics
    new_stats_path = write_statistics(os.path.join(args.workdir, "statistics.json"), all_stats[0])
    base_stats_path = os.path.join(args.base_workdir, "statistics.json")
    if args.retention_weight > 0:
        # the old task normalizes with the statistics its replay set trained
        # with (mix order: new, replay)
        base_stats_path = write_statistics(os.path.join(args.workdir, "statistics_reach.json"), all_stats[1])
    geometry, params = qlora_geometry(args), state.params
    counts = opt_lib.trainable_param_count(params, train_vlm=True)
    del agent, state
    eval_kw = dict(device=device, log_dir=os.path.join(args.workdir, "eval"))
    new_task = run_eval(geometry, params, new_stats_path, fresh_tokenizer(),
                        args.n_eval_episodes, args.eval_seed, task=args.task, **eval_kw)
    log.info("fine-tuned on the new task [%s]: %s", args.task, new_task)
    old_task = run_eval(geometry, params, base_stats_path, fresh_tokenizer(),
                        args.n_eval_episodes, args.eval_seed, task="reach", **eval_kw)
    log.info("fine-tuned on the old task [reach]: %s", old_task)

    # the base on the new task: the floor the adapters climbed from; its
    # float tree has no adapters, so it runs at the plain geometry
    base_geo = model_geometry(args.hidden, args.layers, proprio_dim=7)
    abstract = pizero.init_params(pizero_config_from_dict(ConfigDict(base_geo)), seed=0, device="cpu")
    base_params = ckpt_lib.restore_params(base_ckpt, abstract, device)
    base_on_new = run_eval(base_geo, base_params, new_stats_path, fresh_tokenizer(),
                           args.n_eval_episodes, args.eval_seed, task=args.task, **eval_kw)
    base_on_old = run_eval(base_geo, base_params, base_stats_path, fresh_tokenizer(),
                           args.n_eval_episodes, args.eval_seed, task="reach", **eval_kw)
    log.info("base policy on the new task: %s | on the old task: %s", base_on_new, base_on_old)

    result = {
        "proof": "QLoRA learns in the closed loop: NF4-frozen trunk and SigLIP + LoRA fine-tune "
                 "on a held-out task" + (f", old-task replay at weight {args.retention_weight}"
                                          if args.retention_weight > 0 else ""),
        "base_checkpoint": base_ckpt,
        "held_out_task": args.task,
        "n_demos": args.n_demos,
        "n_updates": args.n_updates,
        "n_eval_episodes": args.n_eval_episodes,
        "expert_success_rate": expert_rate,
        "lora_r": args.lora_r,
        "frozen_nf4_payloads_bitwise_unchanged": True,
        "n_frozen_payload_leaves": len(frozen_after),
        "new_task_success": {
            "finetuned": new_task["success_rate"],
            "base_policy_floor": base_on_new["success_rate"],
        },
        "old_task_success": {
            "finetuned": old_task["success_rate"],
            "base_policy": base_on_old["success_rate"],
            "note": (f"the replay mix keeps the old task in the fine-tune's stream at weight "
                     f"{args.retention_weight}" if args.retention_weight > 0 else
                     "reported, not asserted: the float action expert is retrained on the new "
                     "task only"),
        },
        "retention_weight": args.retention_weight,
        "param_groups_B": {k: round(v, 6) for k, v in counts.items()},
        "timings_s": {"setup": round(t_setup - t0, 1),
                      "train": round(t_train - t_setup, 1),
                      "eval": round(time.time() - t_train, 1)},
        "devices": 1,
        # the port's own fields: the card and what its updates cost
        "device": device_info(device),
        "updates_this_run": [first_update + 1, first_update + updates],
        **timed.summary(),
        "k1_launches_per_update": k1_per_update,
        "bwd_launches_per_update": bwd_per_update,
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
