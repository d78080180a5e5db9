"""The port's ``TrainAgent.run`` held against the JAX package's, update by
update, at the closed-loop demonstration's recipe, on the CPU.

Each side takes its own script's config: the JAX package's
``scripts/demo_closed_loop.py`` (loaded by path) and the port's
``open_pi_zero_torch/scripts/demo_closed_loop.py`` run their ``main`` with
the same flags until they build their TrainAgent, where a stand-in takes the
config (``jax.device_count`` is 1: one card's batch). The recipe's loop is
whole: warmup into the cosine (``min(100, n // 5)`` = 6 updates), EMA from
``n // 2`` = update 15, the clip, the freeze surgery, AdamW's decay and
``eval_params``; ``tri_lever`` trains on its four datasets of two families
with ``max_proprio_dim`` 8, ``reach`` on one.

- The init: the JAX agent draws ``init_params(jax.random.key(0))`` itself;
  the port's trains from the same tree through ``--init-params``
  (``tests/demo_reference_inputs.jax_init_export``), asserted bitwise
  before the first update.
- The batches: the JAX agent's pipeline yields them (its
  ``dataset.iterator`` is wrapped to record what it hands the loop); the
  port's agent takes the same raw frame batches through ``dataset=``, so
  each side's processor and loop run on them and the data order is left
  out (the frames are held as a multiset in
  ``tests/test_torch_data_pipeline.py``).
- The params are compared after updates 1, 5, 10, ..., 30 (``SNAPSHOTS``).
- The draws: the flow times and the noise of each update come from JAX's
  key chain, recomputed here (``jax.random.key(seed)``, split per update,
  then into ``rng_t``/``rng_x0``; ``sample_flow_time`` and the normal draw
  of ``pizero.flow_matching_loss``), and reach the port's step through a
  stand-in for ``train_step._rank_rows``.

Per update: the loss (rtol 1e-5), the grad norm (rtol 1e-4) and the
learning rate of both groups (rtol 2e-6, atol 1e-6 of the group's peak lr:
JAX's schedule runs in float32, the port's in float64, and near the
cosine's end ``min_lr + (1 + cos)`` cancels, as
``tests/test_torch_training.py::test_schedule_matches_jax`` states). At the end: every params leaf,
every EMA leaf and ``eval_params`` within ``LEAF_ATOL`` (fp32 on both
sides, the port's run on one intra-op thread: ``one_torch_thread``; the
run's max|Δ| is printed by update).

Size: the demonstration's geometry, ``model_geometry(96, 3)`` (4 heads, 1
KV head of 24; proprio 8 for ``tri_lever``), uncut. The cuts, so that the
file runs in under a minute alone on one CPU worker (``--dist loadfile``):
global batch 4 (the recipe's 32); 30 updates (the recipe's 8,000-24,000;
40 took the file to 61-70 s, and its schedule's phases all fall inside
30); two demos per dataset (three for the drawer sets).
``tests/test_torch_demo_lockstep_scale_up.py`` runs ``check_lockstep`` at
the scale-up's geometry.
"""

import collections
import contextlib
import logging
import sys

import jax
import numpy as np
import pytest
import torch

import open_pi_zero_torch.agents.train as t_train
import open_pi_zero_tpu.agents.train as j_train
from open_pi_zero_torch import envs as t_envs
from open_pi_zero_torch.scripts import demo_closed_loop
from open_pi_zero_torch.training import train_step as t_step
from open_pi_zero_tpu import envs as j_envs
from open_pi_zero_tpu.ops import pallas_attention
from open_pi_zero_tpu.parallel import mesh as j_mesh
from open_pi_zero_tpu.training import schedules as j_schedules
from open_pi_zero_tpu.training.sampling import sample_flow_time
from tests import demo_reference_inputs
from tests.test_torch_demo_drawer import Captured, jax_script, restore_registries, stop  # noqa: F401
from tests.test_torch_demos import leaves_by_path

N_UPDATES = 30
RECIPE = ["--n-updates", str(N_UPDATES), "--global-batch", "4"]
# the demonstration's geometry, and the scale-up's (tests/test_torch_demo_lockstep_scale_up.py)
DEMO = dict(hidden=96, layers=3, heads=4, kv_heads=1, head_dim=0)
SCALE_UP = dict(hidden=256, layers=6, heads=8, kv_heads=1, head_dim=32)
TASKS = {
    "tri_lever": ["--task", "tri_lever", "--n-demos", "2", "--drawer-n-demos", "3"],
    "reach": ["--task", "reach", "--n-demos", "2"],
}
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4
LR_RTOL, LR_ATOL_OF_PEAK = 2e-6, 1e-6  # test_schedule_matches_jax's: float32 (JAX) against float64 (the port)
# every params, EMA and eval_params leaf at the end (measured, the port on one thread: 6.6e-6 reach, 9.78e-6
# tri_lever, 5.54e-6 the scale-up's reach; on eight threads up to 1.64e-5; flat once the lr decays)
LEAF_ATOL = 3e-5
FROZEN = "/embed_tokens"  # no grad on either side: compared at the end only
# updates whose params are compared on the way (memory: a copy of the tree each)
SNAPSHOTS = {1, *range(5, N_UPDATES + 1, 5)}

log = logging.getLogger(__name__)


@contextlib.contextmanager
def one_torch_thread():
    """The port's side on one intra-op thread, restored after: beside other
    busy processes (the other test workers) torch's thread pool stalls at
    each small op's barrier, and the scale-up case's port run took 211 s
    where it takes 7 s alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


class Replay:
    """The JAX agent's raw frame batches, in the order its loop took them."""

    def __init__(self, batches):
        self.batches = batches

    def iterator(self, batch_size):
        for batch in self.batches:
            assert len(batch["action"]) == batch_size
            yield batch


def jax_draws(seed: int, model_cfg, batch_size: int, action_shape) -> list:
    """JAX's flow times and noise of each update, from its train state's key
    chain (``agents/train.py``, ``training/train_step.py``)."""
    draws, rng = [], jax.random.key(seed)
    for _ in range(N_UPDATES):
        rng, sub = jax.random.split(rng)
        rng_t, rng_x0 = jax.random.split(sub)
        t = sample_flow_time(rng_t, batch_size, model_cfg)
        x0 = jax.random.normal(rng_x0, (batch_size, *action_shape), dtype=t.dtype)
        draws += [torch.from_numpy(np.array(t)), torch.from_numpy(np.array(x0))]
    return draws


def max_delta(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    return max(float(np.max(np.abs(got[k].astype(np.float64) - want[k]))) for k in want)


def numpy_leaves(tree) -> dict:
    """A JAX or torch params tree's leaves by path, copied to numpy."""
    return {k: np.array(v) for k, v in leaves_by_path(tree)}


def capture_configs(flags, tmp_path, monkeypatch):
    """Each script's train config; the JAX script writes its demos."""
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    monkeypatch.setattr(j_train, "TrainAgent", stop)
    monkeypatch.setattr(t_train, "TrainAgent", stop)
    # the port's demos are held bitwise JAX's elsewhere; its agent replays JAX's batches
    monkeypatch.setattr(demo_closed_loop, "write_demos", lambda args, sets, *a: {t: None for t, _ in sets})
    monkeypatch.setattr(sys, "argv", ["demo_closed_loop.py", *flags, "--workdir", str(tmp_path / "jax")])
    with pytest.raises(Captured) as got:
        jax_script().main()
    j_cfg = got.value.args[0]
    with pytest.raises(Captured) as got:
        demo_closed_loop.main([*flags, "--workdir", str(tmp_path / "port"), "--device", "cpu",
                               "--init-params", str(tmp_path / "init")])
    t_cfg = got.value.args[0]
    monkeypatch.undo()
    return j_cfg, t_cfg


def jax_agent(cfg, monkeypatch):
    """The JAX TrainAgent on a mesh of one CPU device (the port's one card)."""
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    monkeypatch.setattr(jax, "local_device_count", lambda: 1)
    monkeypatch.setattr(j_train, "make_mesh", lambda n_data=None: j_mesh.make_mesh(1, 1, jax.devices()[:1]))
    agent = j_train.TrainAgent(cfg)
    j_envs.warm_tokenizer(agent.processor.tokenizer)
    monkeypatch.setattr(agent, "save", lambda update: None)  # an orbax save: not compared
    return agent


@pytest.mark.parametrize("task", list(TASKS))
def test_port_train_agent_run_is_jax_s_update_by_update(task, tmp_path, monkeypatch, restore_registries):
    check_lockstep(task, DEMO, tmp_path, monkeypatch)


def check_lockstep(task, geometry, tmp_path, monkeypatch):
    """Both agents' runs of ``task`` at ``geometry`` (``model_geometry``'s
    keyword arguments), compared update by update and at the end."""
    flags = [f"--{k.replace('_', '-')}={v}" for k, v in geometry.items()]
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    j_cfg, t_cfg = capture_configs([*TASKS[task], *RECIPE, *flags], tmp_path, monkeypatch)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    proprio = int(j_cfg["proprio_dim"])
    assert proprio == int(t_cfg["proprio_dim"]) == (8 if task == "tri_lever" else 7)
    assert j_cfg["action_lr_scheduler"]["warmup_steps"] == N_UPDATES // 5 and j_cfg["ema_start"] == N_UPDATES // 2
    demo_reference_inputs.jax_init_export(str(tmp_path / "init"), seed=int(j_cfg["seed"]), proprio_dim=proprio,
                                          **geometry)

    # ---- JAX: its agent's run, each update's batch, metrics, lr and params recorded
    try:
        j_agent = jax_agent(j_cfg, monkeypatch)
        init = numpy_leaves(j_agent.state.params)
        batches, jax_steps = [], []
        raw_iterator, raw_step = j_agent.dataset.iterator, j_agent.train_step

        def recording_iterator(batch_size):
            for batch in raw_iterator(batch_size):
                batches.append(jax.tree.map(np.array, batch))
                yield batch

        peak = {g: float(getattr(j_agent.train_cfg, f"{g}_lr")) for g in ("action", "vlm")}

        def recording_step(state, batch):
            step = int(state.step)
            lrs = {g: float(j_schedules.from_config(peak[g], getattr(j_agent.train_cfg, f"{g}_lr_scheduler"))(step))
                   for g in peak}
            state, metrics = raw_step(state, batch)
            params = numpy_leaves(state.params) if step + 1 in SNAPSHOTS else None
            if params is not None:
                del params[FROZEN]
            jax_steps.append({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]), "lr": lrs,
                              "params": params})
            return state, metrics

        monkeypatch.setattr(j_agent.dataset, "iterator", recording_iterator)
        j_agent.train_step = recording_step
        j_state = j_agent.run()
        draws = collections.deque(jax_draws(int(j_cfg["seed"]), j_agent.model_cfg, 4, batches[0]["action"].shape[-2:]))
    finally:
        pallas_attention.set_attention_mesh(None)
    assert len(batches) == len(jax_steps) == N_UPDATES

    # ---- the port: its agent's run on JAX's batches and draws
    def injected(draw, rows):
        x = draws.popleft()
        assert x.shape[0] == rows
        return x

    monkeypatch.setattr(t_step, "_rank_rows", injected)
    t_agent = t_train.TrainAgent(t_cfg, dataset=Replay(batches), device="cpu")
    t_envs.warm_tokenizer(t_agent.processor.tokenizer)
    assert max_delta(numpy_leaves(t_agent.state.params), init) == 0.0
    raw_t_step, drift = t_agent.train_step, []

    def compared_step(state, batch):
        metrics = raw_t_step(state, batch)
        want = jax_steps[state.step - 1]
        lrs = {g["name"]: g["lr"] for g in state.opt_state.param_groups}
        if want["params"] is not None:
            got = numpy_leaves(state.params)
            del got[FROZEN]
            drift.append((state.step, max_delta(got, want["params"])))
        log.info("update %d: loss %.7g (JAX %.7g) grad_norm %.7g (JAX %.7g) lr %s (JAX %s)", state.step,
                 float(metrics["loss"]), want["loss"], float(metrics["grad_norm"]), want["grad_norm"], lrs, want["lr"])
        np.testing.assert_allclose(float(metrics["loss"]), want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(metrics["grad_norm"]), want["grad_norm"], rtol=NORM_RTOL)
        assert lrs.keys() == want["lr"].keys()
        for g in lrs:
            np.testing.assert_allclose(lrs[g], want["lr"][g], rtol=LR_RTOL, atol=LR_ATOL_OF_PEAK * peak[g])
        return metrics

    t_agent.train_step = compared_step
    with one_torch_thread():
        t_state = t_agent.run()
    assert t_state.step == int(j_state.step) == N_UPDATES and not draws
    assert [u for u, _ in drift] == sorted(SNAPSHOTS)
    print(f"{task}: params max|d| by update", " ".join(f"{u}: {d:.3g}" for u, d in drift))

    # ---- the end: params, EMA, eval_params
    from open_pi_zero_torch.training import averaging as t_avg
    from open_pi_zero_tpu.training import averaging as j_avg

    assert t_state.avg.n_averaged == int(j_state.avg.n_averaged) == N_UPDATES - N_UPDATES // 2 + 1
    ends = {
        "params": (t_state.params, j_state.params),
        "ema": (t_state.avg.avg_params, j_state.avg.avg_params),
        "eval_params": (t_avg.eval_params(t_state.avg, t_state.params), j_avg.eval_params(j_state.avg, j_state.params)),
    }
    for name, (got, want) in ends.items():
        d = max_delta(numpy_leaves(got), numpy_leaves(want))
        print(f"{task}: {name} max|d| {d:.3g}")
        assert d <= LEAF_ATOL, name
