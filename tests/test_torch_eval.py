"""The port's EvalAgent (``agents/eval.py``) against the JAX package's on
the CPU, in closed loop at the geometry of configs/eval/simpler_lite.yaml,
fp32, with the same params in both (``models/from_jax.params_from_jax``).

JAX and torch draw different noise, so each agent instance's policy call
is overridden here (``_infer``, ``_infer_refined``) so that both take the
same numpy noise per chunk; nothing in either package changes for that.
The per-chunk actions agree within 1e-5 (fp32 on both sides, the sums in
other orders: about 1e-7 per op at this size), and the loops see the same
instructions, success and episode count. A refined run (refine_from_prev
0.5) warm-starts every chunk but an episode's first on both sides.
Then the JAX package's own FakeEnv episode loop (tests/test_agents.py)
runs through both agents and returns the same dict.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pi_zero_torch.agents import env_adapter as t_ea
from open_pi_zero_torch.agents import eval as t_eval
from open_pi_zero_torch.config import ConfigDict as TConfigDict
from open_pi_zero_torch.config import load_config as t_load_config
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models.from_jax import params_from_jax
from open_pi_zero_torch.processing import FakeTokenizer as TFakeTokenizer
from open_pi_zero_tpu.agents import env_adapter as j_ea
from open_pi_zero_tpu.agents import eval as j_eval
from open_pi_zero_tpu.config import ConfigDict as JConfigDict
from open_pi_zero_tpu.config import load_config as j_load_config
from open_pi_zero_tpu.config import pizero_config_from_dict as j_model_config
from open_pi_zero_tpu.config import tiny_pizero_config as j_tiny_config
from open_pi_zero_tpu.models import pizero as j_pizero
from open_pi_zero_tpu.processing import FakeTokenizer as JFakeTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIMPLER_LITE = os.path.join(ROOT, "configs/eval/simpler_lite.yaml")
BRIDGE_STATS = os.path.join(ROOT, "configs/statistics/bridge_statistics.json")
TOL = 1e-5


def write_statistics(path) -> str:
    """A statistics file for the SimplerLite adapter: the bridge statistics
    with a narrower action range, so that a random policy's commands stay
    inside the workspace a few steps."""
    with open(BRIDGE_STATS) as f:
        stats = json.load(f)
    stats = stats.get("action") and stats or next(iter(stats.values()))
    stats["action"]["p01"][:2] = [-0.02, -0.02]
    stats["action"]["p99"][:2] = [0.02, 0.02]
    with open(path, "w") as f:
        json.dump(stats, f)
    return str(path)


def simpler_lite_overrides(tmp_path, *extra) -> list:
    return [f"log_dir={tmp_path}/eval", f"env.adapter.dataset_statistics_path={write_statistics(tmp_path / 'stats.json')}",
            f"checkpoint_path={tmp_path}/unused", *extra]


@pytest.fixture(scope="module")
def jax_params():
    cfg = j_model_config(j_load_config(SIMPLER_LITE))
    return jax.tree.map(np.asarray, j_pizero.init_params(jax.random.key(3), cfg))


@pytest.fixture(scope="module")
def jax_chunks():
    """Jitted JAX chunks on injected noise: the full flow from ``a0``, and
    the refined flow from the previous chunk re-noised with ``x0``
    (``pizero.infer_action_refined``'s arithmetic with its noise given)."""
    cfg = j_model_config(j_load_config(SIMPLER_LITE))
    full = jax.jit(lambda p, ids, pix, am, prop, a0: j_pizero.infer_action(
        p, cfg, jax.random.key(0), ids, pix, am, prop, action0=a0))

    def refined(p, ids, pix, am, prop, prev, x0, t_start):
        x_t = j_pizero.psi_t(cfg, x0, prev, jnp.full((prev.shape[0],), t_start, prev.dtype))
        return j_pizero.infer_action(p, cfg, jax.random.key(0), ids, pix, am, prop, action0=x_t, t_start=t_start)

    return full, jax.jit(refined, static_argnums=7)


def noise_stream(seed: int):
    rng = np.random.default_rng(seed)
    while True:
        yield rng.normal(size=(1, 4, 7)).astype(np.float32)


def inject_noise(t_agent, j_agent, j_chunks, seed: int) -> dict:
    """Override both agents' policy calls to take the same noise per chunk;
    record each side's chunks, which tier ran, and the instruction each
    chunk was computed for. Returns the records."""
    full, refined = j_chunks
    rec = {side: {"chunks": [], "tiers": [], "instructions": []} for side in ("torch", "jax")}
    t_noise, j_noise = noise_stream(seed), noise_stream(seed)
    cfg, t = t_agent.model_cfg, t_agent.refine_t

    def t_args(inputs):
        x = {k: torch.from_numpy(np.asarray(inputs[k])) for k in ("input_ids", "pixel_values", "attention_mask", "proprios")}
        return (t_agent.params, cfg, None, x["input_ids"], x["pixel_values"], x["attention_mask"], x["proprios"])

    def t_full(inputs):
        rec["torch"]["tiers"].append("full")
        return t_pizero.infer_action(*t_args(inputs), action0=torch.from_numpy(next(t_noise)))

    def t_refined(inputs, prev):
        rec["torch"]["tiers"].append("refined")
        return t_pizero.infer_action_refined(*t_args(inputs), prev, t_start=t, x0=torch.from_numpy(next(t_noise)))

    def j_full(params, rng, ids, pix, am, prop):
        rec["jax"]["tiers"].append("full")
        return full(params, ids, pix, am, prop, jnp.asarray(next(j_noise)))

    def j_refined(params, rng, ids, pix, am, prop, prev):
        rec["jax"]["tiers"].append("refined")
        return refined(params, ids, pix, am, prop, prev, jnp.asarray(next(j_noise)), t)

    t_agent._infer, t_agent._infer_refined = t_full, t_refined
    j_agent._infer, j_agent._infer_refined = j_full, j_refined
    for side, agent in (("torch", t_agent), ("jax", j_agent)):
        act, preprocess = agent.act, agent.adapter.preprocess

        def recorded_act(inputs, act=act, r=rec[side]):
            out = act(inputs)
            r["chunks"].append(out)
            return out

        def recorded_preprocess(env, obs, instruction, preprocess=preprocess, r=rec[side]):
            r["instructions"].append(instruction)
            return preprocess(env, obs, instruction)

        agent.act, agent.adapter.preprocess = recorded_act, recorded_preprocess
    return rec


def closed_loop_pair(tmp_path, jax_params, jax_chunks, *overrides, seed=0):
    overrides = simpler_lite_overrides(tmp_path, *overrides)
    j_agent = j_eval.EvalAgent(j_load_config(SIMPLER_LITE, overrides), params=jax_params)
    t_agent = t_eval.EvalAgent(t_load_config(SIMPLER_LITE, overrides),
                               params=params_from_jax(jax_params, device="cpu"), device="cpu")
    rec = inject_noise(t_agent, j_agent, jax_chunks, seed)
    results = {"torch": t_agent.run(), "jax": j_agent.run()}
    return results, rec


def assert_same_loop(results, rec):
    t, j = rec["torch"], rec["jax"]
    assert len(t["chunks"]) == len(j["chunks"]) > 0
    err = max(float(np.abs(a - b).max()) for a, b in zip(t["chunks"], j["chunks"]))
    assert err <= TOL, err
    assert all(a.dtype == np.float32 and a.shape == (4, 7) for a in t["chunks"])
    assert t["instructions"] == j["instructions"] and t["tiers"] == j["tiers"]
    for key in ("n_episodes", "success_rate", "success_by_instruction"):
        assert results["torch"][key] == results["jax"][key], key
    assert results["torch"]["mean_inference_time_s"] > 0
    return err


def test_reach_episode_matches_jax(tmp_path, jax_params, jax_chunks):
    results, rec = closed_loop_pair(tmp_path, jax_params, jax_chunks, "n_eval_episode=1")
    assert_same_loop(results, rec)
    assert results["torch"]["n_episodes"] == 1 and len(rec["torch"]["chunks"]) == 15  # 60 steps / 4
    assert set(rec["torch"]["tiers"]) == {"full"}


def test_multi_subtask_episode_matches_jax(tmp_path, jax_params, jax_chunks):
    """simpler_lite_reach_multi: 96 steps, the instruction switches once the
    first block is reached (a random policy may never reach it; the loop's
    instructions are compared either way)."""
    results, rec = closed_loop_pair(tmp_path, jax_params, jax_chunks, "n_eval_episode=1",
                                    "env.task=simpler_lite_reach_multi", seed=1)
    assert_same_loop(results, rec)
    assert len(rec["torch"]["chunks"]) == 24


def test_refined_tier_matches_jax_and_resets_per_episode(tmp_path, jax_params, jax_chunks):
    results, rec = closed_loop_pair(tmp_path, jax_params, jax_chunks, "n_eval_episode=2",
                                    "refine_from_prev=0.5", seed=2)
    assert_same_loop(results, rec)
    assert rec["torch"]["tiers"] == (["full"] + ["refined"] * 14) * 2


def test_refine_from_prev_out_of_range_raises(tmp_path, jax_params):
    cfg = t_load_config(SIMPLER_LITE, simpler_lite_overrides(tmp_path, "refine_from_prev=1.0"))
    with pytest.raises(ValueError, match="refine_from_prev"):
        t_eval.EvalAgent(cfg, params=params_from_jax(jax_params, device="cpu"), device="cpu")


def test_cpu_act_is_the_eager_chunk_from_the_seeded_generator(tmp_path, jax_params):
    """Without overrides, the CPU agent's act is pizero.infer_action with
    noise from a CPU generator seeded with cfg.seed, one draw per chunk
    (the refined chunk's draw is its re-noising)."""
    cfg = t_load_config(SIMPLER_LITE, simpler_lite_overrides(tmp_path, "refine_from_prev=0.5"))
    params = params_from_jax(jax_params, device="cpu")
    agent = t_eval.EvalAgent(cfg, params=params, device="cpu")
    obs, _ = agent.env.reset(seed=agent.seed)
    inputs = agent.adapter.preprocess(agent.env, obs, agent.env.get_language_instruction())
    first, second = agent.act(inputs), agent.act(inputs)
    gen = torch.Generator().manual_seed(int(cfg.seed))
    x = {k: torch.from_numpy(v) for k, v in inputs.items()}
    args = (params, agent.model_cfg, gen, x["input_ids"], x["pixel_values"], x["attention_mask"], x["proprios"])
    want1 = t_pizero.infer_action(*args)
    want2 = t_pizero.infer_action_refined(*args, want1, t_start=0.5)
    np.testing.assert_array_equal(first, want1[0].numpy())
    np.testing.assert_array_equal(second, want2[0].numpy())
    agent.reset_policy_cache()
    assert agent._prev_chunk is None


# --------------------------------------------------------------------------- #
# the JAX package's FakeEnv episode loop (tests/test_agents.py), through both
# --------------------------------------------------------------------------- #


class FakeEnv:
    """Minimal maniskill-like episode protocol: truncates every 6 steps,
    succeeds on even episodes."""

    def __init__(self):
        self.episode = -1
        self.t = 0

    def reset(self, seed=None, options=None):
        self.episode += 1
        self.t = 0
        return self._obs(), {}

    def _obs(self):
        return {"agent": {"eef_pos": np.array([0.1, 0.2, 0.3, 1, 0, 0, 0, 0.5])}}

    def step(self, action):
        assert action.shape == (7,)
        self.t += 1
        truncated = self.t >= 6
        success = truncated and (self.episode % 2 == 0)
        return self._obs(), 0.0, success, truncated, {}

    def get_language_instruction(self):
        return "put the spoon on the towel"


def _tiny_eval_cfg(tmp_path, config_dict, **extra):
    cfg = config_dict(
        {
            "seed": 0,
            "log_dir": str(tmp_path / "eval"),
            "n_eval_episode": 4,
            "n_video": 0,
            "record_video": False,
            "act_steps": 4,
            "horizon_steps": 4,
            "num_inference_steps": 2,
            "max_image_text_tokens": 12,
            "image_token_index": 500,
            "vocab_size": 10000,
            "time_hidden_size": 32,
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
        }
    )
    cfg.update(extra)
    return cfg


def _adapter(ea, fake_tokenizer):
    return ea.BridgeSimplerAdapter(dataset_statistics_path=BRIDGE_STATS, num_image_tokens=4, image_size=(28, 28),
                                   max_seq_len=12, tokenizer=fake_tokenizer(image_token_id=500))


def test_fake_env_loop_returns_the_jax_result(tmp_path, monkeypatch):
    img = np.zeros((64, 64, 3), np.uint8)
    monkeypatch.setattr(j_ea, "_get_simpler_image", lambda env, obs: img)
    monkeypatch.setattr(t_ea, "_get_simpler_image", lambda env, obs: img)
    model_cfg = j_tiny_config(vocab_size=10000, max_image_text_tokens=12, num_inference_steps=2)
    params = j_pizero.init_params(jax.random.key(0), model_cfg)
    j_agent = j_eval.EvalAgent(_tiny_eval_cfg(tmp_path, JConfigDict), env=FakeEnv(),
                               adapter=_adapter(j_ea, JFakeTokenizer), params=params)
    t_agent = t_eval.EvalAgent(_tiny_eval_cfg(tmp_path, TConfigDict), env=FakeEnv(),
                               adapter=_adapter(t_ea, TFakeTokenizer),
                               params=params_from_jax(jax.tree.map(np.asarray, params), device="cpu"), device="cpu")
    want, got = j_agent.run(), t_agent.run()
    assert got.keys() == want.keys()
    assert got["n_episodes"] == want["n_episodes"] == 4
    assert got["success_rate"] == want["success_rate"] == 0.5  # even episodes succeed
    assert got["success_by_instruction"] == want["success_by_instruction"] == {"put the spoon on the towel": "2/4"}
    assert got["mean_inference_time_s"] > 0 and want["mean_inference_time_s"] > 0
