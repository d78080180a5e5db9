"""The EvalAgent on the card: ``act`` is one replay of a CUDA graph, and
its chunk is bitwise the eager chunk on the same inputs and noise (the
graph's noise buffer after the call), for the full chunk and for the
refined chunk from the previous one; the first chunk of each episode is
the full one. At the geometry of configs/eval/simpler_lite.yaml, fp32,
random params: its head dim 24 runs through K1 zero-padded to 32, and the
card's chunk agrees with the CPU's (the plain version) within 1e-4 (fp32
on both sides, sums in other orders).

Marked ``cuda``: each test asks the ``cuda`` fixture for the device and
skips when there is no card. The file imports no JAX, so it runs on the
card's machine: ``python -m pytest --noconftest
tests/test_torch_eval_card.py -q``.
"""

import gc
import json
import os

import numpy as np
import pytest
import torch

from open_pi_zero_torch.agents import eval as t_eval
from open_pi_zero_torch.config import load_config, pizero_config_from_dict
from open_pi_zero_torch.models import compiled, pizero
from open_pi_zero_torch.models.tree import tree_map

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIMPLER_LITE = os.path.join(ROOT, "configs/eval/simpler_lite.yaml")
BRIDGE_STATS = os.path.join(ROOT, "configs/statistics/bridge_statistics.json")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _agent(tmp_path, device, *overrides):
    gc.collect()  # an earlier test's graphs go before this capture, not during it
    with open(BRIDGE_STATS) as f:
        (tmp_path / "stats.json").write_text(json.dumps(json.load(f)))
    cfg = load_config(SIMPLER_LITE, [f"log_dir={tmp_path}/eval", f"env.adapter.dataset_statistics_path={tmp_path}/stats.json",
                                     *overrides])
    params = pizero.init_params(pizero_config_from_dict(cfg), seed=2, device=device, dtype=torch.float32)
    return t_eval.EvalAgent(cfg, params=params, device=device)


def _eager(agent, inputs, noise, prev=None):
    x = {k: torch.as_tensor(inputs[k], device=agent.device) for k in ("input_ids", "pixel_values", "attention_mask", "proprios")}
    args = (agent.params, agent.model_cfg, None, x["input_ids"], x["pixel_values"], x["attention_mask"], x["proprios"])
    if prev is None:
        return pizero.infer_action(*args, action0=noise)
    return pizero.infer_action_refined(*args, prev, t_start=agent.refine_t, x0=noise)


def test_act_is_a_graph_replay_bitwise_the_eager_chunk(cuda, tmp_path, monkeypatch):
    agent = _agent(tmp_path, cuda, "refine_from_prev=0.5")
    assert set(agent.graphs) == {0.0, 0.5}
    replays, call = [], compiled.CompiledChunk.__call__
    monkeypatch.setattr(compiled.CompiledChunk, "__call__",
                        lambda self, batch: replays.append(self.t_start) or call(self, batch))
    env = agent.env
    obs, _ = env.reset(seed=agent.seed)
    agent.reset_policy_cache()
    prev = None
    for i in range(4):
        inputs = agent.adapter.preprocess(env, obs, env.get_language_instruction())
        got = agent.act(inputs)
        graph = agent.graphs[0.0 if i == 0 else 0.5]
        want = _eager(agent, inputs, graph.noise.clone(), prev)
        np.testing.assert_array_equal(got, want[0].cpu().numpy())
        prev = want
        for action in agent.adapter.postprocess(got):
            obs = env.step(action)[0]
    assert replays == [0.0, 0.5, 0.5, 0.5]
    agent.reset_policy_cache()
    agent.act(inputs)
    assert replays[-1] == 0.0


def test_card_episode_runs_and_draws_from_the_seeded_generator(cuda, tmp_path, monkeypatch):
    """One episode through run(); the graph's first draw is the first
    normal draw of a CUDA generator seeded with cfg.seed."""
    agent = _agent(tmp_path, cuda, "n_eval_episode=1")
    first, act = [], t_eval.EvalAgent.act
    monkeypatch.setattr(t_eval.EvalAgent, "act", lambda self, inputs: first.append(act(self, inputs)) or first[-1])
    result = agent.run()
    assert result["n_episodes"] == 1 and len(first) == 15
    gen = torch.Generator(cuda).manual_seed(agent.seed)
    noise = torch.zeros_like(agent.graphs[0.0].noise).normal_(generator=gen)
    obs, _ = agent.env.reset(seed=agent.seed, options={"obj_init_options": {"episode_id": 0}})
    agent.adapter.reset()
    inputs = agent.adapter.preprocess(agent.env, obs, agent.env.get_language_instruction())
    np.testing.assert_array_equal(first[0], _eager(agent, inputs, noise)[0].cpu().numpy())


def test_card_chunk_matches_the_cpu_chunk(cuda, tmp_path):
    agent = _agent(tmp_path, cuda)
    obs, _ = agent.env.reset(seed=agent.seed)
    inputs = agent.adapter.preprocess(agent.env, obs, agent.env.get_language_instruction())
    got = agent.act(inputs)
    x = {k: torch.as_tensor(inputs[k]) for k in ("input_ids", "pixel_values", "attention_mask", "proprios")}
    want = pizero.infer_action(tree_map(lambda t: t.cpu(), agent.params), agent.model_cfg, None, x["input_ids"],
                               x["pixel_values"], x["attention_mask"], x["proprios"],
                               action0=agent.graphs[0.0].noise.cpu())
    assert agent.model_cfg.joint.head_dim == 24
    err = float(np.abs(got - want[0].numpy()).max())
    assert err <= 1e-4, err
