"""The port against the original PyTorch reference, through the committed
golden fixtures (tests/fixtures/*.npz): the reference's state_dict goes
through the JAX package's converter into a JAX param tree, then through
``params_from_jax`` into the port, and the port's outputs must match the
reference's recorded outputs at the JAX replay's own tolerances
(tests/test_reference_parity_pizero.py, tests/test_reference_parity.py,
replayed by tests/test_golden_fixtures.py)."""

import jax
import numpy as np
import torch

from open_pi_zero_torch.models import joint as t_joint
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models import siglip as t_siglip
from open_pi_zero_torch.models.from_jax import params_from_jax
from open_pi_zero_torch.ops import masks as t_masks
from open_pi_zero_torch.ops.norms import rms_norm
from open_pi_zero_torch.ops.rope import apply_rope, rope_cos_sin
from open_pi_zero_tpu.models import convert
from tests import golden
from tests import test_reference_parity as joint_parity
from tests.test_reference_parity_pizero import build_our_cfg, convert_state
from tests.test_torch_models import torch_cfg


def test_golden_infer_action_replay():
    payload = golden.load_fixture_or_skip("pizero_infer_action")
    jcfg = build_our_cfg()
    params = params_from_jax(
        jax.tree.map(np.asarray, convert_state(payload["state"], jcfg)), device="cpu"
    )
    got = t_pizero.infer_action(
        params, torch_cfg(jcfg), None,
        torch.from_numpy(payload["ids"].astype(np.int32)),
        torch.from_numpy(np.ascontiguousarray(payload["pix"].transpose(0, 2, 3, 1))),  # NHWC
        torch.from_numpy(payload["am"].astype(np.int32)),
        torch.from_numpy(payload["prop"]),
        action0=torch.from_numpy(payload["a0"]),
    )
    np.testing.assert_allclose(got.numpy(), payload["want"], rtol=2e-4, atol=2e-5)


def test_golden_mask_and_positions_replay():
    payload = golden.load_fixture_or_skip("pizero_mask_positions")
    full, prefix, action, pos = t_pizero.prepare_action_inputs(
        torch_cfg(build_our_cfg()), torch.from_numpy(payload["am"].astype(np.int32))
    )
    np.testing.assert_array_equal(full.numpy() == 0.0, payload["want_full_open"])
    np.testing.assert_array_equal(prefix.numpy() == 0.0, payload["want_prefix_open"])
    np.testing.assert_array_equal(action.numpy() == 0.0, payload["want_action_open"])
    for name, key in (("vlm", "vp"), ("proprio", "pp"), ("action", "ap")):
        np.testing.assert_array_equal(pos[name].numpy(), payload[key][0])


def test_golden_gemma_modules_replay():
    """RMSNorm and RoPE against the reference's: rtol/atol 1e-6 for the
    norm, rtol 1e-5 / atol 1e-6 for RoPE, as the JAX replay."""
    payload = golden.load_fixture_or_skip("gemma_modules")
    got = rms_norm(torch.from_numpy(payload["x"]), torch.from_numpy(payload["w"]), 1e-6)
    np.testing.assert_allclose(got.numpy(), payload["want_norm"], rtol=1e-6, atol=1e-6)
    cos, sin = rope_cos_sin(torch.from_numpy(payload["positions"]), 8, 100.0)
    q = torch.from_numpy(np.ascontiguousarray(payload["q"].transpose(0, 2, 1, 3)))  # [B, L, H, D]
    np.testing.assert_allclose(
        apply_rope(q, cos, sin).numpy(), payload["want_rope"].transpose(0, 2, 1, 3), rtol=1e-5, atol=1e-6
    )


def test_golden_siglip_tower_replay():
    """SigLIP's tower against the reference's, fp32: rtol 2e-4, atol 2e-5,
    as the JAX replay."""
    payload = golden.load_fixture_or_skip("siglip_tower")
    scfg = joint_parity._siglip_config()

    class _C:
        siglip = scfg

    params = params_from_jax(jax.tree.map(np.asarray, convert.convert_siglip(payload["state"], _C)), device="cpu")
    pix = torch.from_numpy(np.ascontiguousarray(payload["pix"].transpose(0, 2, 3, 1)))  # NHWC
    got = t_siglip.forward(params, torch_cfg(scfg), pix)
    np.testing.assert_allclose(got.numpy(), payload["want"], rtol=2e-4, atol=2e-5)


def test_golden_joint_cached_action_step_replay():
    """The prefill of the vlm and proprio experts, then one cached step of
    the action expert, against the reference's: rtol 2e-4, atol 2e-5, as
    the JAX replay."""
    payload = golden.load_fixture_or_skip("joint_cached_action_step")
    jcfg = joint_parity._our_joint_config()
    cfg = torch_cfg(jcfg)
    params = params_from_jax(
        jax.tree.map(np.asarray, joint_parity._convert_ref_state(payload["state"], jcfg)), device="cpu"
    )
    lens = joint_parity.LENS
    full = t_masks.build_block_causal_mask(
        torch.from_numpy(payload["cnt"]), lens["vlm"], lens["proprio"], lens["action"]
    )
    prefix_mask, action_mask = t_masks.split_prefix_and_action_masks(
        full, lens["vlm"], lens["proprio"], lens["action"]
    )
    embeds = {n: torch.from_numpy(v) for n, v in payload["embeds"].items()}
    cache = t_joint.joint_prefill(
        params, cfg, {"vlm": embeds["vlm"], "proprio": embeds["proprio"]},
        {"vlm": t_masks.vlm_position_ids(lens["vlm"]),
         "proprio": t_masks.proprio_position_ids(lens["proprio"])},
        prefix_mask,
    )
    got = t_joint.joint_action_step(
        params, cfg, embeds["action"], cache,
        t_masks.action_position_ids(lens["proprio"], lens["action"]), action_mask,
    )
    np.testing.assert_allclose(got.numpy(), payload["want"], rtol=2e-4, atol=2e-5)
