"""The closed-loop learning chain of open_pi_zero_torch/scripts/
demo_closed_loop.py on the card: reach demos from the port's writer, the
bridge pipeline from cfg.data, and a 50-update TrainAgent run at the reach
recipe's geometry (hidden 96, 3 layers, 4 Q / 1 KV heads of 24, which K1
and its backward zero-pad to 32; B = 32, lr 1e-3, EMA from update 25),
with no warmup, so that the first update takes the full lr (the recipe's
warmup of n_updates // 5 would start it at min_lr 1e-5, a step too small
for the 1e-6 limit below to resolve), as chip_smoke.py's phase 7 does.

The run's first update is held against the same update on the CPU: both
agents start from the CPU agent's params and take one update on the same
batch with injected flow times and noise. Tolerances, as chip_smoke.py's
phase 7: the loss and the grad norm 1e-3 relative (the card sums in other
orders); Adam's eps is raised to 1e-3 on both sides for that update, so
that a grad that is rounding noise on both sides moves its param by far
less than the lr, and the updated params agree within 1e-6. Then the card
agent runs on to update 50 with the recipe's eps: every loss finite, K1
and its backward launched L and 2 L times per update, the checkpoint with
its ``params/`` eval export written.

Marked ``cuda``: the test asks the ``cuda`` fixture for the device and
skips when there is no card. The file imports no JAX, so it runs on the
card's machine: ``python -m pytest --noconftest tests/test_torch_demo_card.py -q``.
"""

import logging
import math
import os

import numpy as np
import pytest
import torch

from open_pi_zero_torch.agents.train import TrainAgent
from open_pi_zero_torch.models.tree import tree_leaves
from open_pi_zero_torch.ops import fused_attention as fa
from open_pi_zero_torch.scripts import demo_closed_loop as demo
from open_pi_zero_torch.training import checkpoint as ckpt_lib

pytestmark = pytest.mark.cuda

DEMOS = 8
UPDATES = 50


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_fifty_reach_updates_on_the_card_start_as_on_the_cpu(cuda, tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))  # the pipeline's statistics cache
    args = demo.parse_args(["--workdir", str(tmp_path), "--n-demos", str(DEMOS), "--n-updates", str(UPDATES)])
    mix, demo_sets = demo.demo_sets_of(args.task)
    data_dir = str(tmp_path / ("rlds" + demo.demo_tag(args)))
    assert demo.write_demos(args, demo_sets, data_dir, logging.getLogger("demo")) == {"reach": 1.0}
    cfg = demo.train_config(args, demo.model_geometry(args.hidden, args.layers), mix, data_dir, len(demo_sets), False)
    for scheduler in ("action_lr_scheduler", "vlm_lr_scheduler"):
        cfg[scheduler]["warmup_steps"] = 0
    agents = {"card": TrainAgent(cfg, device=cuda), "cpu": TrainAgent(cfg, device="cpu")}
    layers = agents["card"].model_cfg.joint.num_hidden_layers
    assert agents["card"].model_cfg.joint.head_dim == 24 and agents["card"].grad_accum == 1
    with torch.no_grad():
        for a, b in zip(tree_leaves(agents["card"].state.params), tree_leaves(agents["cpu"].state.params)):
            a.copy_(b)

    rng = np.random.default_rng(5)
    batch = agents["cpu"].next_update_batch(agents["cpu"].dataset.iterator(agents["cpu"].step_batch_size))
    shape = tuple(batch["actions"].shape)
    batch["t"] = torch.from_numpy(rng.uniform(0.05, 0.95, size=shape[:1]).astype(np.float32))
    batch["x0"] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    metrics = {}
    for name, agent in agents.items():
        groups = agent.state.opt_state.param_groups
        eps = [g["eps"] for g in groups]
        for g in groups:
            g["eps"] = 1e-3
        on_device = {k: v.to(agent.device) for k, v in batch.items()}
        metrics[name] = {k: float(v) for k, v in agent.train_step(agent.state, on_device).items()}
        assert [g["lr"] for g in groups] == [args.lr] * len(groups)
        for g, e in zip(groups, eps):
            g["eps"] = e
    for key in ("loss", "grad_norm"):
        assert abs(metrics["card"][key] - metrics["cpu"][key]) <= 1e-3 * abs(metrics["cpu"][key]), metrics
    err = max(float((a.detach().cpu() - b.detach()).abs().max()) for a, b in
              zip(tree_leaves(agents["card"].state.params), tree_leaves(agents["cpu"].state.params)))
    assert err <= 1e-6, err

    card = agents["card"]
    timed = demo.UpdateTimes(card)
    fa.launches = fa.bwd_launches = 0
    state = card.run()
    assert state.step == UPDATES and len(timed.losses) == UPDATES - 1
    assert all(math.isfinite(x) for x in timed.losses), timed.losses
    assert (fa.launches, fa.bwd_launches) == ((UPDATES - 1) * layers, (UPDATES - 1) * 2 * layers)
    ckpt = os.path.join(card.ckpt_dir, f"ckpt_{UPDATES}")
    assert os.path.exists(os.path.join(ckpt, ckpt_lib.PARAMS_DIR, ckpt_lib.PARAMS_FILE))
    assert os.path.exists(os.path.join(ckpt, ckpt_lib.META_FILE))
