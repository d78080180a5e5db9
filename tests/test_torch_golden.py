"""The port against the original PyTorch reference, through the committed
golden fixtures (tests/fixtures/*.npz): the reference's state_dict goes
through the JAX package's converter into a JAX param tree, then through
``params_from_jax`` into the port, and the port's outputs must match the
reference's recorded outputs at the JAX replay's own tolerances
(tests/test_reference_parity_pizero.py)."""

import jax
import numpy as np
import torch

from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models.from_jax import params_from_jax
from tests import golden
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
