"""End-to-end closed-loop learning demonstration on SimplerLite
(counterpart of the JAX package's ``scripts/demo_closed_loop.py``).

Shows that the whole stack learns, not just that each stage runs:
scripted expert -> RLDS demos written by the port's writer
(``envs.write_demo_dataset``, JPEG frames) -> the unmodified bridge
pipeline (``data/``, ``agents/dataset.py``: gripper binarize, action
relabel, bound normalization) -> ``TrainAgent`` (K1 forward, K1-vjp
backward, EMA) -> a ``training/checkpoint.py`` checkpoint with its
``params/`` eval export -> ``EvalAgent`` episode loop (one CUDA graph per
tier on a card) through the real BridgeSimplerAdapter -> closed-loop
success rate, the reference's acceptance metric (reference
README.md:90-114, src/agent/eval.py:60-179). A random-init control policy
is scored on the same episode seeds as the floor.

  python -m open_pi_zero_torch.scripts.demo_closed_loop --task reach \\
      --workdir build/opz_reach --save-freq 2000 --out E2E_CLOSED_LOOP_TORCH.json

It runs on the card unless ``--device cpu``. One card takes the whole
batch (``per_device_batch_size`` = ``global_batch_size``, no gradient
accumulation). ``--resume`` continues from the newest complete checkpoint
in ``--workdir``, so a run longer than one session of the card is split
into several calls. Besides the JAX script's JSON keys the result holds
the card's name and power limit (``device``), the ``seed``, the median
update time (first update left out), the batch wait per update, the
card's utilization while it trains (``nvidia-smi``'s samples, of every
process on the card), the kernels' launches per update and the loss per
50 updates. ``--seed`` and
``--init-params`` (the seeded init replaced by a params export, e.g. the
JAX package's init converted by ``tests/demo_reference_inputs.py``) serve
diagnostics of a run; the JAX script's recipe leaves both unset.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import statistics
import subprocess
import time

import torch

TASKS = ("reach", "pick_place", "multi", "drawer", "drawer_lever", "multi_family", "tri_family", "tri_lever")
LOSS_WINDOW = 50  # updates per entry of the result's loss curve


def model_geometry(hidden: int, layers: int, proprio_dim: int = 7,
                   heads: int = 4, kv_heads: int = 1,
                   head_dim: int = 0) -> dict:
    """Config-dict geometry block shared by train and eval (image 56x56,
    patch 14 -> 16 image tokens; text budget 8 -> seq 24). proprio_dim is
    7 for the bridge-family tasks (POS_EULER) and 8 for the fractal family
    (POS_QUAT, reference oxe/__init__.py:40-62). heads/kv_heads/head_dim
    expose the trunk GQA ratio for scale-up runs (the bridge recipe is
    8Q/1KV, reference config/train/bridge.yaml:174-177)."""
    h2 = hidden // 2
    return {
        "vocab_size": 10_000,
        "image_token_index": 500,
        "pad_token_id": 0,
        "max_image_text_tokens": 24,
        "max_seq_len": 24,
        "cond_steps": 1,
        "horizon_steps": 4,
        "action_dim": 7,
        "proprio_dim": proprio_dim,
        "num_inference_steps": 10,
        "time_hidden_size": 2 * h2,
        "mixture": {
            "vlm": {"hidden_size": hidden, "intermediate_size": 2 * hidden,
                    "cache": True, "rope_theta": 10000.0},
            "proprio": {"hidden_size": h2, "intermediate_size": 2 * h2,
                        "cache": True, "use_final_norm": True, "rope_theta": 100.0},
            "action": {"hidden_size": h2, "intermediate_size": 2 * h2,
                       "use_final_norm": True, "rope_theta": 100.0},
        },
        "vision": {"config": {
            "hidden_size": h2, "intermediate_size": 2 * h2,
            "num_hidden_layers": layers, "num_attention_heads": 4,
            "image_size": 56, "patch_size": 14, "num_image_tokens": 16,
        }},
        "vision_projector": {"config": {"vision_config": {"projection_dim": hidden}}},
        "joint": {"config": {
            "num_hidden_layers": layers, "num_attention_heads": heads,
            "num_key_value_heads": kv_heads,
            "head_dim": head_dim or max(16, hidden // 4),
        }},
    }


def fresh_tokenizer():
    """The eval side's FakeTokenizer, warmed in the fixed instruction order
    as the train side's is, so that both vocabularies agree."""
    from open_pi_zero_torch.envs import warm_tokenizer
    from open_pi_zero_torch.processing import FakeTokenizer

    tok = FakeTokenizer(image_token_id=500)
    warm_tokenizer(tok)
    return tok


def run_eval(cfg_geometry, params, stats_path, tokenizer, n_episodes, seed,
             act_steps=4, refine_from_prev=0.0, task="reach", adapter_name="bridge",
             pad_proprio_to=None, env_task=None, device="cuda", log_dir="build/opz_demo_eval"):
    """The closed-loop success of ``params`` on ``n_episodes`` SimplerLite
    episodes from ``seed``: the EvalAgent's result dict."""
    from open_pi_zero_torch.agents.env_adapter import make_adapter
    from open_pi_zero_torch.agents.eval import EvalAgent
    from open_pi_zero_torch.config import ConfigDict
    from open_pi_zero_torch.envs import make_env

    adapter = make_adapter(
        adapter_name,
        dataset_statistics_path=stats_path,
        num_image_tokens=16,
        image_size=(56, 56),
        max_seq_len=24,
        tokenizer=tokenizer,
        pad_proprio_to=pad_proprio_to,
    )
    cfg = ConfigDict({
        "seed": seed,
        "log_dir": log_dir,
        "n_eval_episode": n_episodes,
        "n_video": 0,
        "record_video": False,
        "act_steps": act_steps,
        "refine_from_prev": refine_from_prev,
        "env": {"task": f"simpler_lite_{env_task or task}"},  # first reset keys placement
        **cfg_geometry,
    })
    env = make_env(f"simpler_lite_{env_task or task}", seed=seed)
    agent = EvalAgent(cfg, env=env, adapter=adapter, params=params, device=device)
    return agent.run()


def device_info(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class UtilizationSampler:
    """The card's utilization as nvidia-smi samples it (the share of each
    sample period in which a kernel ran, every ``period_ms``) while the
    ``with`` block runs; every process on the card counts. ``summary()``
    is None off the card."""

    def __init__(self, device: torch.device, period_ms: int = 1000):
        self.device, self.period_ms, self.samples = device, period_ms, []

    def __enter__(self):
        self.proc = None
        if self.device.type == "cuda":
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
                 "-i", str(self.device.index or 0), "-lms", str(self.period_ms)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        if self.proc is not None:
            self.proc.terminate()
            out, _ = self.proc.communicate(timeout=60)
            self.samples = [float(x) for x in out.split() if x.replace(".", "", 1).isdigit()]

    def summary(self):
        if not self.samples:
            return None
        return {"mean_percent": statistics.fmean(self.samples), "median_percent": statistics.median(self.samples),
                "samples": len(self.samples), "period_ms": self.period_ms,
                "of": "the whole card: every process on it, not this run alone"}


class UpdateTimes:
    """The agent's updates and batch waits timed on the host clock, by
    wrapping the instance's ``train_step`` and ``next_update_batch``. Each
    update's loss is read as it ends, which waits for the card: an
    update's time is its launches and the card's work behind them."""

    def __init__(self, agent):
        self.update_ms, self.wait_ms, self.losses = [], [], []
        step, next_batch = agent.train_step, agent.next_update_batch

        def timed_step(state, batch):
            t = time.perf_counter()
            metrics = step(state, batch)
            self.losses.append(float(metrics["loss"]))
            self.update_ms.append((time.perf_counter() - t) * 1e3)
            return metrics

        def timed_batch(it):
            t = time.perf_counter()
            batch = next_batch(it)
            self.wait_ms.append((time.perf_counter() - t) * 1e3)
            return batch

        agent.train_step, agent.next_update_batch = timed_step, timed_batch

    def summary(self) -> dict:
        after_first = self.update_ms[1:] or self.update_ms
        waits = self.wait_ms[1:] or self.wait_ms
        return {
            "update_ms": statistics.median(after_first) if after_first else None,
            "batch_wait_ms": {
                "first": self.wait_ms[0] if self.wait_ms else None,
                "median_after_first": statistics.median(waits) if waits else None,
                "mean_after_first": statistics.fmean(waits) if waits else None,
            },
            "loss_per_50_updates": [
                statistics.fmean(self.losses[i: i + LOSS_WINDOW]) for i in range(0, len(self.losses), LOSS_WINDOW)
            ],
        }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default="build/opz_demo")
    ap.add_argument("--out", default=None, help="artifact JSON path")
    # defaults = the JAX package's measured recipe behind E2E_CLOSED_LOOP.json
    # (95% success on 40 unseen layouts at 8k updates; its loss breaks
    # ~0.13 -> 0.07 around update 5-6k)
    ap.add_argument("--task", default="reach", choices=TASKS)
    ap.add_argument("--n-demos", type=int, default=600)
    ap.add_argument("--drawer-n-demos", type=int, default=None,
                    help="demo count for the drawer dataset in mixed runs "
                         "(default: --n-demos); drawer needs more demos per "
                         "language target than the bridge tasks")
    ap.add_argument("--n-updates", type=int, default=8000)
    ap.add_argument("--n-eval-episodes", type=int, default=40)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=96)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=1)
    ap.add_argument("--head-dim", type=int, default=0,
                    help="0 = max(16, hidden//4)")
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--eval-seed", type=int, default=1000,
                    help="episode layouts disjoint from the demo seed 0")
    ap.add_argument("--drawer-target", default=None,
                    choices=["top", "middle", "bottom"],
                    help="restrict the drawer task to ONE language target "
                         "(demos AND eval)")
    ap.add_argument("--drawer-start-coverage", action="store_true",
                    help="collect drawer demos from full-workspace eef "
                         "starts (eval starts stay episode-keyed defaults)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in --workdir "
                         "(raise --n-updates past the finished run's count)")
    ap.add_argument("--save-freq", type=int, default=0,
                    help="also checkpoint every N updates (0 = final only); "
                         "intermediate checkpoints let the learning curve be "
                         "scored without retraining")
    ap.add_argument("--seed", type=int, default=0,
                    help="the TrainAgent's seed: its init and data order, and "
                         "(through training/seeds.py) its flow times and noise "
                         "(the JAX script's is 0)")
    ap.add_argument("--init-params", default=None,
                    help="start training from this checkpoint's params/ export "
                         "instead of the seeded init (base_params_checkpoint)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def demo_sets_of(task: str) -> tuple:
    """(mix name, [(demo task, dataset name)]) of a --task; registers the
    mix where it is not a stock one."""
    from open_pi_zero_torch import envs

    if task == "tri_lever":
        # tri-family WITH the drawer language-grounding lever: drawer
        # primary = no-coverage per-target-balanced, + coverage secondary
        return envs.register_simpler_lite_tri_lever_mix(), [
            ("reach", "bridge_dataset"), ("pick_place", "simpler_lite_pp"),
            ("drawer", "fractal20220817_data"), ("drawer_cov", "fractal_drawer_cov")]
    if task == "tri_family":
        # reach + pick_place (bridge) + drawer (fractal) in one policy
        return envs.register_simpler_lite_tri_mix(), [
            ("reach", "bridge_dataset"), ("pick_place", "simpler_lite_pp"), ("drawer", "fractal20220817_data")]
    if task == "multi_family":
        # bridge reach (7-dim POS_EULER proprio) + fractal drawer (8-dim
        # POS_QUAT) in ONE policy via the stock `oxe_simple` mix: cross-family
        # proprio zero-padding in a learned loop
        return "oxe_simple", [("reach", "bridge_dataset"), ("drawer", "fractal20220817_data")]
    if task == "multi":
        # one policy on BOTH bridge tasks through the interleaved
        # multi-dataset path (weighted sampling, transition-count
        # balancing, per-dataset statistics)
        return envs.register_simpler_lite_mix(), [("reach", "bridge_dataset"), ("pick_place", "simpler_lite_pp")]
    if task == "drawer_lever":
        # the language-grounding lever: PRIMARY no-coverage per-target-
        # balanced demos + SECONDARY coverage-start demos at half weight
        return envs.register_drawer_lever_mix(), [
            ("drawer", "fractal20220817_data"), ("drawer_cov", "fractal_drawer_cov")]
    if task == "drawer":
        # fractal/EDR family: raw RT-1 schema, rt1_transform, the EDR
        # sticky-gripper adapter at eval
        return "fractal", [("drawer", "fractal20220817_data")]
    return "bridge", [(task, "bridge_dataset")]


def demo_tag(args) -> str:
    """The demo-cache key: collection settings are encoded in the rlds dir
    name, so a rerun with different --n-demos / --drawer-target /
    --drawer-start-coverage never trains on stale demos (the per-dataset
    dir names inside must stay registry names)."""
    tag = f"_n{args.n_demos}"
    if args.task in ("drawer_lever", "tri_lever"):
        tag += "_lever"
    if args.drawer_n_demos:
        tag += f"_dn{args.drawer_n_demos}"
    if args.drawer_target:
        tag += f"_{args.drawer_target}"
    if args.drawer_start_coverage:
        tag += "_cov"
    return tag


def write_demos(args, demo_sets, data_dir: str, log) -> dict:
    """Each demo set's RLDS dir, written unless it exists; returns each
    task's expert success rate (None where the demos were reused)."""
    from open_pi_zero_torch import envs

    expert_rate = {}
    for task, name in demo_sets:
        ds_dir = os.path.join(data_dir, name)
        if os.path.exists(os.path.join(ds_dir, "features.json")):
            expert_rate[task] = None
            log.info("reusing demos at %s", ds_dir)
        elif task in ("drawer", "drawer_cov"):
            lever = args.task in ("drawer_lever", "tri_lever")
            n = args.drawer_n_demos or args.n_demos
            expert_rate[task] = envs.write_fractal_demo_dataset(
                ds_dir,
                # lever: the secondary coverage set is half the primary
                n // 2 if task == "drawer_cov" else n,
                # a distinct demo seed for the secondary set so its
                # layouts/episodes don't duplicate the primary's
                seed=1000 if task == "drawer_cov" else 0,
                dataset_name=name,
                target=args.drawer_target,
                start_coverage=args.drawer_start_coverage or task == "drawer_cov",
                balance_targets=lever,
            )
        else:
            expert_rate[task] = envs.write_demo_dataset(ds_dir, args.n_demos, seed=0, task=task, dataset_name=name)
    return expert_rate


def train_config(args, geometry: dict, mix: str, data_dir: str, n_datasets: int, cross_family: bool):
    """The TrainAgent's config: the JAX script's recipe on one card."""
    from open_pi_zero_torch.config import ConfigDict

    warmup = min(100, args.n_updates // 5)
    return ConfigDict({
        "name": "simpler_lite_demo",
        "seed": args.seed,
        "base_params_checkpoint": args.init_params,
        "log_dir": os.path.join(args.workdir, "train"),
        "load_pretrained_weights": False,
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
        "use_ema": True,
        "ema_start": max(0, args.n_updates // 2),
        "resume_checkpoint_path": "auto" if args.resume else None,
        **geometry,
        "data": {"train": {
            "dataset_mix": mix,
            "data_path": data_dir,
            "split": "train",
            "window_size": 1,
            "action_horizon": 4,
            "skip_unlabeled": True,
            "load_proprio": True,
            "augment": False,  # fixed camera: crops corrupt pixel<->world
            "shuffle_buffer_size": 20_000,
            "num_parallel_calls": 4,
            # allocate_threads needs >= 1 thread per dataset in the mix
            "traj_transform_threads": max(2, n_datasets),
            "traj_read_threads": max(2, n_datasets),
            "resize_size": [56, 56],
            # cross-family mix: pad bridge's 7-dim proprio to fractal's 8
            "max_proprio_dim": 8 if cross_family else None,
        }},
    })


def init_source(init_params) -> str | None:
    """What ``--init-params`` trained from: its export's ``meta.json``
    source; None for the seed's own init."""
    if not init_params:
        return None
    from open_pi_zero_torch.training import checkpoint as ckpt_lib

    return ckpt_lib._read_meta(init_params).get("source")


def main(argv=None) -> dict:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("demo")

    from open_pi_zero_torch import resolve_device
    from open_pi_zero_torch.agents.train import TrainAgent
    from open_pi_zero_torch.config import ConfigDict, pizero_config_from_dict
    from open_pi_zero_torch.envs import warm_tokenizer
    from open_pi_zero_torch.models import pizero
    from open_pi_zero_torch.models.tree import tree_leaves
    from open_pi_zero_torch.ops import fused_attention as fa
    from open_pi_zero_torch.training import averaging as avg_lib

    device = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    t0 = time.time()

    # ---- 1. expert demos -> RLDS (the port's writer) ----
    multi = args.task in ("multi", "multi_family", "tri_family", "tri_lever", "drawer_lever")
    drawer = args.task in ("drawer", "drawer_lever")
    multi_family = args.task == "multi_family"
    tri_family = args.task in ("tri_family", "tri_lever")
    mix, demo_sets = demo_sets_of(args.task)
    data_dir = os.path.join(args.workdir, "rlds" + demo_tag(args))
    expert_rate = write_demos(args, demo_sets, data_dir, log)
    expert_rate = expert_rate if multi else expert_rate[args.task]
    t_demos = time.time()

    # ---- 2. train through the pipeline ----
    fractal_proprio = drawer or multi_family or tri_family  # POS_QUAT width
    geometry = model_geometry(args.hidden, args.layers,
                              proprio_dim=8 if fractal_proprio else 7,
                              heads=args.heads, kv_heads=args.kv_heads,
                              head_dim=args.head_dim)
    train_cfg = train_config(args, geometry, mix, data_dir, len(demo_sets), multi_family or tri_family)
    agent = TrainAgent(train_cfg, device=device)
    warm_tokenizer(agent.processor.tokenizer)

    # ---- 3. per-dataset pipeline statistics for the eval adapter, written
    # BEFORE training starts, so that a run cut short can be evaluated from
    # its intermediate checkpoints (eval_scaleup_ckpt). dataset_statistics
    # order == mix order; per-task stats must match what training
    # normalizes that task's actions with.
    stats_paths = {}
    for (task, _), stats in zip(demo_sets, agent.dataset.dataset.dataset_statistics):
        suffix = "" if task == demo_sets[0][0] else f"_{task}"
        p = os.path.join(args.workdir, f"statistics{suffix}.json")
        with open(p, "w") as f:
            json.dump({"action": stats["action"], "proprio": stats["proprio"]}, f)
        stats_paths[task] = p

    timed = UpdateTimes(agent)
    first_update = agent.state.step
    launches = (fa.launches, fa.bwd_launches)
    with UtilizationSampler(device) as utilization:
        state = agent.run()
    updates = max(1, state.step - first_update)
    k1_per_update = (fa.launches - launches[0]) / updates
    bwd_per_update = (fa.bwd_launches - launches[1]) / updates
    t_train = time.time()

    params = avg_lib.eval_params(state.avg, state.params)
    del agent, state

    # ---- 4. closed-loop eval: trained vs random-init control ----
    rand_params = pizero.init_params(pizero_config_from_dict(ConfigDict(geometry)), seed=123, device=device)
    trained, control = {}, {}
    # drawer_cov is a TRAINING-mix-only dataset (coverage-start demos of
    # the same drawer env); closed-loop scoring happens once, on the
    # canonical episode-keyed drawer eval
    eval_sets = [(t, n) for t, n in demo_sets if t != "drawer_cov"]
    for task, _ in eval_sets:
        # adapter family follows the TASK (bridge adapter for reach/
        # pick_place, EDR sticky-gripper adapter for drawer); bridge tasks
        # under a cross-family policy pad their 7-dim proprio to 8
        kwargs = dict(
            task=task, adapter_name="edr" if task == "drawer" else "bridge",
            pad_proprio_to=8 if ((multi_family or tri_family) and task != "drawer") else None,
            env_task=f"drawer_{args.drawer_target}" if task == "drawer" and args.drawer_target else None,
            device=device, log_dir=os.path.join(args.workdir, "eval"),
        )
        trained[task] = run_eval(geometry, params, stats_paths[task], fresh_tokenizer(),
                                 args.n_eval_episodes, args.eval_seed, **kwargs)
        log.info("trained policy [%s]: %s", task, trained[task])
        control[task] = run_eval(geometry, rand_params, stats_paths[task], fresh_tokenizer(),
                                 args.n_eval_episodes, args.eval_seed, **kwargs)
        log.info("random-init control [%s]: %s", task, control[task])

    def rates(d):
        if args.task == "drawer_lever":
            return d["drawer"]["success_rate"]
        if multi:
            return {t: d[t]["success_rate"] for t, _ in eval_sets}
        return d[args.task]["success_rate"]

    result = {
        "task": f"simpler_lite_{args.task}" + (f"_{args.drawer_target}" if args.drawer_target else ""),
        "n_demos": args.n_demos,
        "n_updates": args.n_updates,
        "n_eval_episodes": args.n_eval_episodes,
        "expert_success_rate": expert_rate,
        "trained_success_rate": rates(trained),
        "random_init_success_rate": rates(control),
        "model": {"hidden": args.hidden, "layers": args.layers,
                  "params": sum(int(x.numel()) for x in tree_leaves(params))},
        "timings_s": {"demos": round(t_demos - t0, 1),
                      "train": round(t_train - t_demos, 1),
                      "eval": round(time.time() - t_train, 1)},
        "devices": 1,
        # the port's own fields: the card and what its updates cost
        "device": device_info(device),
        "seed": args.seed,
        "init": init_source(args.init_params),
        "updates_this_run": [first_update + 1, first_update + updates],  # a resumed run starts past 1
        **timed.summary(),
        "card_utilization": utilization.summary(),
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
