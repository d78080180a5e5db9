"""The TrainAgent's QLoRA update on the card against the same update on
the CPU, at the tiny geometry in the layout of configs/train/bridge.yaml
(NF4 bases, LoRA adapters, int8 Adam moments, remat, grad_accum 2).

Marked ``cuda``: each test asks the ``cuda`` fixture for the device and
skips when there is no card. The file imports no JAX, so it runs on the
card's machine: ``python -m pytest --noconftest
tests/test_torch_train_agent_card.py -q``. It also holds the tiny config
and the synthetic frame dataset that tests/test_torch_train_agent.py
uses.

The two agents start from the CPU agent's params and take one update on
the same batch with injected flow times and noise. Tolerances, as
chip_smoke.py's phase 7: the loss and the grad norm 1e-3 relative (the
card sums in other orders); Adam's eps is raised to 1e-3 on both sides, so
that a grad that is rounding noise on both sides moves its param by far
less than lr (at 1e-8 it would step by about +-lr whatever its size), and
the updated params agree within 1e-6 = lr / 1000; the NF4 bases stay
bitwise unchanged.
"""

import numpy as np
import pytest
import torch

from open_pi_zero_torch.agents import train as t_agent
from open_pi_zero_torch.config import load_config
from open_pi_zero_torch.models.tree import tree_leaves

pytestmark = pytest.mark.cuda

TINY_YAML = """\
# the tiny geometry (config.tiny_pizero_config) in the layout of
# configs/train/bridge.yaml
seed: 0
log_dir: {log_dir}
pretrained_model_path: {log_dir}/no_such_weights
load_pretrained_weights: false
resume_checkpoint_path:
quantize: {quantize}
lora: {lora}
lora_r: 4
remat: true
global_batch_size: 4
per_device_batch_size: 2
action_lr_scheduler: {{warmup_steps: 0}}
vlm_lr_scheduler: {{warmup_steps: 0}}
n_updates: 2
log_freq: 1
eval_freq: 2
eval_size: 2
save_model_freq: 0
vocab_size: 512
pad_token_id: 0
image_token_index: 500
max_image_text_tokens: 12
cond_steps: 1
horizon_steps: 4
action_dim: 7
proprio_dim: 7
num_inference_steps: 2
time_hidden_size: 32
flow_sampling: beta
mixture:
  vlm: {{hidden_size: 64, intermediate_size: 128, use_final_norm: false, cache: true, rope_theta: 10000.0, use_lora: {lora}, use_quantize: {quantize}}}
  proprio: {{hidden_size: 32, intermediate_size: 64, use_final_norm: true, cache: true, rope_theta: 100.0}}
  action: {{hidden_size: 32, intermediate_size: 64, use_final_norm: true, cache: false, rope_theta: 100.0}}
vision:
  use_lora: {lora}
  use_quantize: {quantize}
  config: {{hidden_size: 32, intermediate_size: 64, num_hidden_layers: 2, num_attention_heads: 4, image_size: 28, patch_size: 14, num_image_tokens: 4}}
vision_projector:
  config: {{vision_config: {{projection_dim: 64}}}}
joint:
  config: {{num_hidden_layers: 2, num_attention_heads: 4, num_key_value_heads: 1, head_dim: 16}}
"""

INSTRUCTIONS = (b"pick up the spoon", b"put the carrot on the plate", b"open the drawer")


class Frames:
    """Seeded synthetic frame batches in the RLDS layout, forever:
    ``iterator(batch_size)`` starts again from the seed each call."""

    def __init__(self, seed: int, size: int = 28, horizon: int = 4, dim: int = 7):
        self.seed, self.size, self.horizon, self.dim = seed, size, horizon, dim

    def iterator(self, batch_size: int):
        rng = np.random.default_rng(self.seed)
        while True:
            yield {
                "observation": {
                    "image_primary": rng.integers(0, 256, size=(batch_size, 1, self.size, self.size, 3), dtype=np.uint8),
                    "proprio": rng.normal(size=(batch_size, 1, self.dim)).astype(np.float32),
                },
                "task": {"language_instruction": np.array(
                    [INSTRUCTIONS[i] for i in rng.integers(0, len(INSTRUCTIONS), size=batch_size)], dtype=object)},
                "action": rng.uniform(-1, 1, size=(batch_size, 1, self.horizon, self.dim)).astype(np.float32),
            }


def tiny_config(tmp_path, quantize=True, lora=True, overrides=()):
    path = tmp_path / f"train_q{int(quantize)}_l{int(lora)}.yaml"
    path.write_text(TINY_YAML.format(log_dir=tmp_path / "log", quantize=str(quantize).lower(), lora=str(lora).lower()))
    return load_config(str(path), overrides=list(overrides)), str(path)




@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def test_agent_qlora_update_on_the_card_matches_the_cpu(cuda, tmp_path):
    cfg, _ = tiny_config(tmp_path, overrides=["n_updates=1"])
    agents = {d: t_agent.TrainAgent(cfg, dataset=Frames(0), device=d) for d in ("cpu", cuda)}
    with torch.no_grad():
        for a, b in zip(tree_leaves(agents[cuda].state.params), tree_leaves(agents["cpu"].state.params)):
            a.copy_(b)
    rng = np.random.default_rng(0)
    it = Frames(0).iterator(2)
    batch = agents["cpu"].next_update_batch(it)
    shape = batch["actions"].shape
    batch["t"] = torch.from_numpy(rng.uniform(0.05, 0.95, size=shape[:2]).astype(np.float32))
    batch["x0"] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    before = {p: x.detach().clone() for p, x in _paths(agents["cpu"].state.params)}
    metrics = {}
    for device, agent in agents.items():
        for group in agent.state.opt_state.param_groups:
            group["eps"] = 1e-3
        on = {k: v.to(device) for k, v in batch.items()}
        metrics[str(device)] = {k: float(v) for k, v in agent.train_step(agent.state, on).items()}
    card, cpu = metrics[str(cuda)], metrics["cpu"]
    for k in ("loss", "grad_norm"):
        assert abs(card[k] - cpu[k]) <= 1e-3 * abs(cpu[k]), (k, card[k], cpu[k])
    moved = 0
    for (path, a), b in zip(_paths(agents[cuda].state.params), tree_leaves(agents["cpu"].state.params)):
        a = a.detach().cpu()
        if "q4" in path or "absmax" in path:
            assert torch.equal(a, before[path]) and torch.equal(b, before[path]), path
        else:
            assert float((a - b.detach()).abs().max()) <= 1e-6, path
            moved += not torch.equal(b, before[path])
    assert moved > 0
