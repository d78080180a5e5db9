"""Two real ranks, one data mesh: the port's multi-process training check
(counterpart of the JAX package's ``scripts/dryrun_multiprocess.py``).

  python -m open_pi_zero_torch.scripts.dryrun_multiprocess [--device cuda|cpu] [--workdir DIR]

The parent starts one process alone and then two ranks, each with the
environment that torchrun gives a rank (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR=localhost``, a free ``MASTER_PORT``), which
join through ``parallel.init_distributed``. At the tiny config:

  raw-step   one DP update, each rank on its rows of a global batch; the
             loss must equal the lone process's update on the whole batch
             (the DDP all-reduce equivalence, reference train.py:121-126)
  agent      the TrainAgent with ZeRO-1 (moments and EMA sharded over the
             ranks) on per-rank data: 2 updates and a collective save, a
             fresh agent that resumes from the newest complete checkpoint
             (chosen on rank 0 and broadcast), 2 more updates, a final save

and prints one line, ``multiprocess dryrun: {json}``. The processes run on
the card unless ``--device cpu`` (two ranks on one card share it over
gloo). None imports JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile

N_PROC = 2
ROWS_PER_RANK = 2


def _global_step_batch(cfg, b: int) -> dict:
    """A batch whose rows differ, so that a wrong data split moves the loss."""
    import numpy as np

    rng = np.random.default_rng(42)
    ids = np.zeros((b, cfg.max_image_text_tokens), np.int32)
    ids[:, : cfg.siglip.num_image_tokens] = cfg.image_token_index
    ids[:, cfg.siglip.num_image_tokens] = 2
    for i in range(b):
        ids[i, cfg.siglip.num_image_tokens + 1] = 10 + i
    size = cfg.siglip.image_size
    return {
        "input_ids": ids,
        "pixel_values": rng.normal(size=(b, size, size, 3)).astype(np.float32),
        "attention_mask": (ids != cfg.pad_token_id).astype(np.int32),
        "proprios": rng.normal(size=(b, cfg.cond_steps, cfg.proprio_dim)).astype(np.float32),
        "actions": rng.uniform(-1, 1, size=(b, cfg.horizon_steps, cfg.action_dim)).astype(np.float32),
    }


def _raw_dp_step(device: str) -> float:
    """One update of the tiny config from seed 0 on this process's rows of
    the global batch (all of it without a mesh); returns the loss."""
    import torch

    from open_pi_zero_torch.config import TrainingConfig, tiny_pizero_config
    from open_pi_zero_torch.models import pizero
    from open_pi_zero_torch.parallel.mesh import get_mesh, shard_batch
    from open_pi_zero_torch.training import optimizer as opt_lib
    from open_pi_zero_torch.training import seeds
    from open_pi_zero_torch.training.train_step import init_train_state, make_train_step

    mesh = get_mesh()
    dev = torch.device(device) if mesh is None else mesh.device
    cfg = tiny_pizero_config()
    tcfg = TrainingConfig(use_ema=True, ema_start=0)
    params = pizero.init_params(cfg, seed=0, device=dev)
    optimizer = opt_lib.build_optimizer(tcfg, params)
    state = init_train_state(params, optimizer, seeds.stream_generator(0, seeds.TRAIN, device=dev), tcfg)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in _global_step_batch(cfg, N_PROC * ROWS_PER_RANK).items()}
    if mesh is not None:
        batch = shard_batch(mesh, batch)
    metrics = make_train_step(cfg, tcfg, optimizer)(state, batch)
    return float(metrics["loss"])


class FakeFrameDataset:
    """Seeded frame batches in the pipeline's layout, seeded per rank so
    that each rank feeds its own stream (the reference's per-rank
    DataLoader, train.py:142-146)."""

    def __init__(self, seed: int, image_size: int = 28, proprio_dim: int = 7, action_dim: int = 7, horizon: int = 4):
        self.seed, self.image_size, self.proprio_dim = seed, image_size, proprio_dim
        self.action_dim, self.horizon = action_dim, horizon

    def iterator(self, batch_size: int):
        import numpy as np

        rng = np.random.default_rng(self.seed)
        hw = self.image_size
        while True:
            yield {
                "observation": {
                    "image_primary": rng.integers(0, 255, (batch_size, hw, hw, 3), np.uint8),
                    "proprio": rng.normal(size=(batch_size, self.proprio_dim)).astype(np.float32),
                },
                "task": {"language_instruction": np.array([b"move the block"] * batch_size)},
                "action": rng.uniform(-1, 1, (batch_size, self.horizon, self.action_dim)).astype(np.float32),
            }


def agent_config(workdir: str, n_updates: int, resume: bool):
    """The tiny geometry (``config.tiny_pizero_config``) as a train config:
    2 ranks x 4 frames x accumulation 2, ZeRO-1, EMA, a save every 2."""
    from open_pi_zero_torch.config import ConfigDict

    return ConfigDict({
        "name": "multiproc", "seed": 0, "log_dir": os.path.join(workdir, "train"),
        "load_pretrained_weights": False, "n_updates": n_updates, "log_freq": 1,
        "save_model_freq": 2, "save_model_start": 0, "eval_freq": 0,
        "global_batch_size": 16, "per_device_batch_size": 4,
        "action_lr": 1e-4, "vlm_lr": 1e-4, "use_ema": True, "ema_start": 0,
        "zero1": True, "resume_checkpoint_path": "auto" if resume else None,
        "vocab_size": 10000, "image_token_index": 500, "pad_token_id": 0,
        "max_image_text_tokens": 12, "max_seq_len": 12, "cond_steps": 1, "horizon_steps": 4,
        "action_dim": 7, "proprio_dim": 7, "num_inference_steps": 2, "time_hidden_size": 32,
        "mixture": {
            "vlm": {"hidden_size": 64, "intermediate_size": 128, "cache": True, "rope_theta": 10000.0},
            "proprio": {"hidden_size": 32, "intermediate_size": 64, "cache": True, "use_final_norm": True,
                        "rope_theta": 100.0},
            "action": {"hidden_size": 32, "intermediate_size": 64, "use_final_norm": True, "rope_theta": 100.0},
        },
        "vision": {"config": {
            "hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
            "image_size": 28, "patch_size": 14, "num_image_tokens": 4,
        }},
        "vision_projector": {"config": {"vision_config": {"projection_dim": 64}}},
        "joint": {"config": {"num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 1,
                             "head_dim": 16}},
    })


def _agent_phase(workdir: str) -> dict:
    """2 updates and a collective save, then a fresh agent resumes from the
    newest complete checkpoint and takes 2 more."""
    from open_pi_zero_torch.agents.train import TrainAgent
    from open_pi_zero_torch.parallel.mesh import get_mesh
    from open_pi_zero_torch.training.optimizer import Zero1Optimizer

    mesh = get_mesh()
    ds = FakeFrameDataset(seed=100 + mesh.rank)
    agent = TrainAgent(agent_config(workdir, n_updates=2, resume=False), dataset=ds)
    state = agent.run()
    assert state.step == 2, state.step
    assert os.path.isdir(os.path.join(agent.ckpt_dir, "ckpt_2", "state")), "the collective save is missing"
    del agent, state

    agent = TrainAgent(agent_config(workdir, n_updates=4, resume=True), dataset=ds)
    resumed_at = agent.state.step
    assert resumed_at == 2, f"resumed at update {resumed_at}, want 2"
    state = agent.run()
    assert state.step == 4, f"final update {state.step}, want 4"
    # ZeRO-1: this rank holds a slice of the moments, not all of them
    opt = state.opt_state
    held = sum(t.numel() for st in getattr(opt, "inner", opt).state.values() for t in st.values() if t.dim())
    full = 2 * sum(p.numel() for p in getattr(opt, "leaves", []))
    sharded = isinstance(opt, Zero1Optimizer) and 0 < held < full
    assert sharded, "the moments are not sharded over the ranks"
    return {"resumed_at": resumed_at, "final_step": state.step, "zero1_sharded": sharded}


def run_single(workdir: str, device: str) -> None:
    loss = _raw_dp_step(device)
    with open(os.path.join(workdir, "single.json"), "w") as f:
        json.dump({"step_loss": loss}, f)
    print(f"[single] step loss {loss:.6f}")


def run_child(workdir: str, device: str) -> None:
    import torch

    from open_pi_zero_torch.parallel.mesh import init_distributed, shutdown_distributed

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // N_PROC))
    mesh = init_distributed(torch.device(device).type)
    try:
        assert mesh.size == N_PROC and mesh.n_model == 1, mesh.shape
        loss = _raw_dp_step(device)
        print(f"[rank {mesh.rank}] step loss {loss:.6f} ({mesh.backend} on {mesh.device})")
        result = _agent_phase(workdir)
        print(f"[rank {mesh.rank}] agent phase: {result}")
        with open(os.path.join(workdir, f"rank{mesh.rank}.json"), "w") as f:
            json.dump({"step_loss": loss, **result}, f)
    finally:
        shutdown_distributed()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(args: list, env: dict, logfile: str):
    out = open(logfile, "w")
    cmd = [sys.executable, "-m", "open_pi_zero_torch.scripts.dryrun_multiprocess", *args]
    return subprocess.Popen(cmd, env=env, stdout=out, stderr=subprocess.STDOUT), out


def _wait(procs: list, timeout: float) -> list:
    """Exit codes; a process past the deadline is killed (its code -9)."""
    codes = []
    for p, f in procs:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            codes.append(p.wait())
        finally:
            f.close()
    return codes


def run_parent(workdir: str, device: str, timeout: float = 900) -> dict:
    os.makedirs(workdir, exist_ok=True)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (here, os.environ.get("PYTHONPATH")) if p)}
    args = ["--workdir", workdir, "--device", device]
    logs = [os.path.join(workdir, name) for name in ("single.log", *(f"rank{r}.log" for r in range(N_PROC)))]

    def fail(what: str, codes: list, names: list):
        for name in names:
            with open(name) as f:
                sys.stdout.write(f"----- {os.path.basename(name)} tail -----\n{f.read()[-4000:]}\n")
        raise RuntimeError(f"{what} failed: exit codes {codes}")

    codes = _wait([_spawn(["--single", *args], env, logs[0])], timeout)
    if any(codes):
        fail("the lone process", codes, logs[:1])
    port = str(_free_port())
    procs = []
    for r in range(N_PROC):
        rank_env = {**env, "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(N_PROC),
                    "LOCAL_WORLD_SIZE": str(N_PROC), "MASTER_ADDR": "localhost", "MASTER_PORT": port}
        procs.append(_spawn(["--child", *args], rank_env, logs[1 + r]))
    codes = _wait(procs, timeout)
    if any(codes):
        fail("the ranks", codes, logs[1:])

    with open(os.path.join(workdir, "single.json")) as f:
        single = json.load(f)
    ranks = []
    for r in range(N_PROC):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    diff = abs(ranks[0]["step_loss"] - single["step_loss"])
    diff_ranks = max(abs(r["step_loss"] - ranks[0]["step_loss"]) for r in ranks)
    if not diff < 5e-5:
        raise AssertionError(f"{N_PROC}-rank DP loss {ranks[0]['step_loss']} vs one process "
                             f"{single['step_loss']}: diff {diff:.2e}")
    if diff_ranks != 0.0:
        raise AssertionError(f"the ranks' all-reduced losses differ by {diff_ranks}")
    for r in ranks:
        if not (r["resumed_at"] == 2 and r["final_step"] == 4 and r["zero1_sharded"]):
            raise AssertionError(f"agent phase: {r}")
    result = {
        "n_processes": N_PROC, "device": device,
        "single_loss": single["step_loss"], "multiproc_loss": ranks[0]["step_loss"], "loss_diff_vs_single": diff,
        "agent": {k: ranks[0][k] for k in ("resumed_at", "final_step", "zero1_sharded")},
        "ok": True,
    }
    print("multiprocess dryrun:", json.dumps(result), flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--workdir", default=None, help="logs, results and checkpoints (a temporary directory)")
    ap.add_argument("--single", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.single:
        run_single(args.workdir, args.device)
    elif args.child:
        run_child(args.workdir, args.device)
    else:
        import torch

        if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("dryrun_multiprocess: CUDA is not available; pass --device cpu to run on the CPU")
        run_parent(args.workdir or tempfile.mkdtemp(prefix="opz_multiproc_"), args.device)


if __name__ == "__main__":
    main()
