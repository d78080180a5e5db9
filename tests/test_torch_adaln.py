"""adaLN and adaLN-Zero action experts in the port against the JAX package,
on the CPU: the two adaptive ops, the tiny model's chunks (cached, refined,
naive), the loss and its grads, the reference's golden adaLN-Zero forward,
the converter, the serving layout and TP = 2.

Params come from JAX's ``init_params`` (adaLN-Zero's gate kernels, zero at
init, are moved off zero so that the time conditioning reaches the gates);
inputs and noise are made with numpy from a seed.

Tolerances, with their reasons:
- fp32: 1e-4, as the other ``infer_action`` comparisons
  (tests/test_torch_models.py); the loss rtol 1e-5 and each grad leaf
  1e-4 of its own largest value, as tests/test_torch_training.py. The
  port's cached chunk against its naive chunk: rtol 1e-4 / atol 1e-5, JAX's
  oracle tolerance (tests/test_pizero.py).
- bf16 ops: the port's bf16 result no farther from JAX's fp32 result (on
  the same bf16 inputs, widened) than JAX's own compiled bf16 result is,
  plus one bf16 ulp of the largest output. XLA's excess precision drops
  some of the bf16 roundings that the ops spell out, so no op order of the
  port follows it exactly (tests/test_torch_bf16.py holds SigLIP so).
- The golden adaLN-Zero forward: rtol 2e-4 / atol 2e-5, the JAX replay's
  (tests/test_reference_parity.py).
- The converter and the serving layout: bitwise.
- TP = 2 against the port's single-process chunk: 1e-5 (fp32; TP only
  reassociates the row-parallel sums), as tests/test_torch_parallel.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pi_zero_torch import config as t_config
from open_pi_zero_torch.models import convert as t_convert
from open_pi_zero_torch.models import fuse as t_fuse
from open_pi_zero_torch.models import joint as t_joint
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models.tree import tree_map
from open_pi_zero_torch.ops import masks as t_masks
from open_pi_zero_torch.ops import norms as t_norms
from open_pi_zero_torch.parallel import ranks, run_ranks
from open_pi_zero_tpu.config import tiny_pizero_config
from open_pi_zero_tpu.models import fuse as j_fuse
from open_pi_zero_tpu.models import pizero as j_pizero
from open_pi_zero_tpu.ops import norms as j_norms
from tests import golden
from tests import test_reference_parity as joint_parity
from tests.test_torch_bf16 import bf16_ulp
from tests.test_torch_convert import assert_trees_bitwise as assert_converted_bitwise
from tests.test_torch_convert import jax_tree
from tests.test_torch_models import TOL, _flat, example_inputs, torch_cfg
from tests.test_torch_refined import as_jax, as_torch
from tests.test_torch_serving_layout import PRODUCTION, assert_trees_bitwise, jax_to_port
from tests.test_torch_training import _leaves_with_paths

MODES = ("adaLN", "adaLN-Zero")
NAIVE_TOL = dict(rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- #
# the two ops
# --------------------------------------------------------------------------- #


def _op_inputs(seed: int, b=2, s=5, dc=32, d=48):
    rng = np.random.default_rng(seed)
    f = lambda *shape, scale=1.0: (scale * rng.normal(size=shape)).astype(np.float32)  # noqa: E731
    return {
        "x": f(b, s, d, scale=3.0), "cond": f(b, dc), "gamma_kernel": f(dc, d, scale=0.2),
        "gamma_bias": f(d, scale=0.2), "beta_kernel": f(dc, d, scale=0.2), "kernel": f(dc, d, scale=0.3),
        "bias": f(d, scale=0.5) - 2.0,
    }


def _norm(ops, a):
    return ops.adaptive_rms_norm(a["x"], a["cond"], a["gamma_kernel"], a["gamma_bias"], a["beta_kernel"], 1e-6)


def _scale(ops, a):
    return ops.adaptive_layerscale(a["x"], a["cond"], a["kernel"], a["bias"])


OPS = {"adaptive_rms_norm": _norm, "adaptive_layerscale": _scale}


@pytest.mark.parametrize("cond_rank", [2, 3])
@pytest.mark.parametrize("op", sorted(OPS))
def test_adaptive_op_fp32_matches_jax(op, cond_rank):
    a = _op_inputs(0)
    if cond_rank == 3:  # a per-position cond [B, S, Dc]
        a["cond"] = np.repeat(a["cond"][:, None], a["x"].shape[1], axis=1) * np.linspace(0.5, 1.5, 5)[:, None]
        a["cond"] = a["cond"].astype(np.float32)
    want = OPS[op](j_norms, {k: jnp.asarray(v) for k, v in a.items()})
    got = OPS[op](t_norms, {k: torch.from_numpy(v) for k, v in a.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("op", sorted(OPS))
def test_adaptive_op_bf16_as_close_to_fp32_as_jax(op, seed):
    a = {k: v.astype(jnp.bfloat16) for k, v in ((k, jnp.asarray(v)) for k, v in _op_inputs(seed).items())}
    fn = jax.jit(lambda a: OPS[op](j_norms, a))
    jax_bf16 = np.asarray(fn(a), np.float32)
    jax_fp32 = np.asarray(fn({k: v.astype(jnp.float32) for k, v in a.items()}))
    port = OPS[op](t_norms, {k: torch.from_numpy(np.asarray(v, np.float32)).bfloat16() for k, v in a.items()})
    assert port.dtype == torch.bfloat16
    port_err = float(np.abs(port.float().numpy() - jax_fp32).max())
    jax_err = float(np.abs(jax_bf16 - jax_fp32).max())
    ulp = float(bf16_ulp(np.abs(jax_fp32).max()))
    assert port_err <= jax_err + ulp, f"port bf16 {port_err} vs JAX bf16 {jax_err} from fp32 (ulp {ulp})"


# --------------------------------------------------------------------------- #
# the tiny model
# --------------------------------------------------------------------------- #


def _ungate(tree):
    """adaLN-Zero's gate kernels off their zero init, so that the flow time
    reaches the gates; other leaves as they are."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path[-2:] in (("post_scale", "kernel"), ("final_scale", "kernel")):
            return node + np.float32(0.2) * np.sin(np.arange(node.size, dtype=np.float32)).reshape(node.shape)
        return node

    return walk(tree, ())


@pytest.fixture(scope="module", params=MODES)
def adaptive(request):
    """(JAX cfg, port cfg, JAX params, port params) of the tiny model with
    an adaptive action expert."""
    jcfg = tiny_pizero_config(action_expert_adaptive_mode=request.param)
    jparams = jax.tree.map(jnp.asarray, _ungate(jax.tree.map(np.asarray, j_pizero.init_params(jax.random.key(0), jcfg))))
    return jcfg, torch_cfg(jcfg), jparams, jax_to_port(jparams)


def test_init_params_tree_matches_jax(adaptive):
    jcfg, tcfg, jparams, _ = adaptive
    ours = t_pizero.init_params(tcfg, seed=0, device="cpu")
    assert _flat(ours) == _flat(jax.tree.map(np.asarray, jparams))
    action = ours["joint"]["mixtures"]["action"]
    assert set(action["layers"]["input_norm"]) == {"gamma_kernel", "gamma_bias", "beta_kernel"}
    assert set(action["final_norm"]) == {"gamma_kernel", "gamma_bias", "beta_kernel"}
    assert "weight" in ours["joint"]["mixtures"]["vlm"]["layers"]["input_norm"]
    zero = tcfg.action_expert_adaptive_mode == "adaLN-Zero"
    assert ("post_scale" in action["layers"]) == zero
    if zero:  # kernel 0, bias -2
        assert float(action["layers"]["final_scale"]["kernel"].abs().max()) == 0.0
        assert bool((action["layers"]["post_scale"]["bias"] == -2.0).all())
    w = tcfg.mixture("action").hidden_size
    assert tuple(ours["action_encoder"]["linear_2"]["kernel"].shape) == (w, w)  # no time concat


@pytest.mark.parametrize("seed", [0, 1])
def test_infer_action_matches_jax(adaptive, seed):
    jcfg, tcfg, jparams, tparams = adaptive
    ids, pix, am, prop, a0 = example_inputs(jcfg, seed=seed)
    want = j_pizero.infer_action(jparams, jcfg, jax.random.key(0), *as_jax((ids, pix, am, prop)), action0=jnp.asarray(a0))
    got = t_pizero.infer_action(tparams, tcfg, None, *as_torch((ids, pix, am, prop)), action0=torch.from_numpy(a0))
    print(f"{tcfg.action_expert_adaptive_mode} chunk seed {seed}: max|diff| {np.abs(got.numpy() - np.asarray(want)).max():.3e}")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_infer_action_refined_matches_jax(adaptive):
    jcfg, tcfg, jparams, tparams = adaptive
    ids, pix, am, prop, prev = example_inputs(jcfg, seed=1)
    key = jax.random.key(6)
    x0 = np.array(jax.random.normal(jax.random.split(key)[0], prev.shape, jnp.float32))  # JAX's draw
    want = j_pizero.infer_action_refined(jparams, jcfg, key, *as_jax((ids, pix, am, prop, prev)), t_start=0.5)
    got = t_pizero.infer_action_refined(
        tparams, tcfg, None, *as_torch((ids, pix, am, prop, prev)), t_start=0.5, x0=torch.from_numpy(x0)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_infer_action_naive_matches_jax_and_the_cached_chunk(adaptive):
    """The naive chunk recomputes the prefix at every step, conditioned at
    t = 0 as the cached prefix is: cached == naive."""
    jcfg, tcfg, jparams, tparams = adaptive
    ids, pix, am, prop, _ = example_inputs(jcfg, seed=2)
    key = jax.random.key(7)
    a0 = np.array(jax.random.normal(key, (2, jcfg.horizon_steps, jcfg.action_dim), jnp.float32))  # JAX's draw
    want = j_pizero.infer_action_naive(jparams, jcfg, key, *as_jax((ids, pix, am, prop)))
    inputs = as_torch((ids, pix, am, prop))
    naive = t_pizero.infer_action_naive(tparams, tcfg, None, *inputs, action0=torch.from_numpy(a0))
    cached = t_pizero.infer_action(tparams, tcfg, None, *inputs, action0=torch.from_numpy(a0))
    np.testing.assert_allclose(naive.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(cached.numpy(), naive.numpy(), **NAIVE_TOL)


def test_midpoint_cached_matches_naive(adaptive):
    _, tcfg, _, tparams = adaptive
    tcfg = dataclasses.replace(tcfg, flow_integrator="midpoint", num_inference_steps=4)
    ids, pix, am, prop, a0 = as_torch(example_inputs(tcfg, seed=3))
    cached = t_pizero.infer_action(tparams, tcfg, None, ids, pix, am, prop, action0=a0)
    naive = t_pizero.infer_action_naive(tparams, tcfg, None, ids, pix, am, prop, action0=a0)
    np.testing.assert_allclose(cached.numpy(), naive.numpy(), **NAIVE_TOL)


def _loss_batch(cfg, seed=5):
    ids, pix, am, prop, x0 = example_inputs(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    actions = rng.normal(size=x0.shape).astype(np.float32)
    t = rng.uniform(0.05, 0.95, size=(ids.shape[0],)).astype(np.float32)
    return (ids, pix, am, prop, actions, t), x0


def test_flow_matching_loss_and_every_grad_leaf_match_jax(adaptive):
    jcfg, tcfg, jparams, _ = adaptive
    inputs, x0 = _loss_batch(jcfg)
    want, jgrads = jax.value_and_grad(
        lambda p: j_pizero.flow_matching_loss(p, jcfg, jax.random.key(0), *as_jax(inputs), x0=jnp.asarray(x0))
    )(jparams)
    tparams = tree_map(lambda x: x.requires_grad_(), jax_to_port(jparams))
    got = t_pizero.flow_matching_loss(tparams, tcfg, None, *as_torch(inputs), x0=torch.from_numpy(x0))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    print(f"{tcfg.action_expert_adaptive_mode} loss {float(got.detach())!r} vs {float(want)!r}")
    jleaves = {p: np.asarray(v) for p, v in _leaves_with_paths(jgrads)}
    tleaves = _leaves_with_paths(tparams)
    assert [p for p, _ in tleaves] == list(jleaves)
    for path, leaf in tleaves:
        w = jleaves[path]
        scale = max(float(np.abs(w).max()), 1e-3)  # leaf-relative: grads span decades
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-4, atol=1e-4 * scale, err_msg=path)
    gates = [p for p, _ in tleaves if "scale/kernel" in p or "gamma_kernel" in p]
    assert gates and all(float(dict(tleaves)[p].grad.abs().max()) > 0 for p in gates)


@pytest.mark.parametrize("seed", range(2))
def test_bf16_infer_action_as_close_to_fp32_as_jax(adaptive, seed):
    """The whole chunk in bf16, held as the ops are: no farther from JAX's
    fp32 chunk on the same bf16 weights than JAX's bf16 chunk, plus one bf16
    ulp of the largest action value."""
    jcfg, tcfg, jparams, _ = adaptive
    jbf16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    ids, pix, am, prop, a0 = example_inputs(jcfg, seed=seed)
    pix, prop, a0 = (np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)) for x in (pix, prop, a0))

    def jax_chunk(params, dtype):
        return np.asarray(j_pizero.infer_action(
            params, jcfg, jax.random.key(0), jnp.asarray(ids), jnp.asarray(pix, dtype), jnp.asarray(am),
            jnp.asarray(prop, dtype), action0=jnp.asarray(a0, dtype),
        ), np.float32)

    jax_fp32 = jax_chunk(jax.tree.map(lambda a: a.astype(jnp.float32), jbf16), jnp.float32)
    jax_bf16 = jax_chunk(jbf16, jnp.bfloat16)
    port = t_pizero.infer_action(
        jax_to_port(jbf16), tcfg, None, torch.from_numpy(ids), torch.from_numpy(pix).bfloat16(),
        torch.from_numpy(am), torch.from_numpy(prop).bfloat16(), action0=torch.from_numpy(a0).bfloat16(),
    ).float().numpy()
    port_err, jax_err = float(np.abs(port - jax_fp32).max()), float(np.abs(jax_bf16 - jax_fp32).max())
    ulp = float(bf16_ulp(np.abs(jax_fp32).max()))
    print(f"{tcfg.action_expert_adaptive_mode} bf16 chunk seed {seed}: from JAX fp32, port {port_err:.4f}, "
          f"JAX bf16 {jax_err:.4f}, one ulp {ulp}")
    assert port_err <= jax_err + ulp, f"port bf16 {port_err} vs JAX bf16 {jax_err} from fp32 (ulp {ulp})"


# --------------------------------------------------------------------------- #
# the reference's golden adaLN-Zero forward and the converter
# --------------------------------------------------------------------------- #


def _golden_joint():
    """The fixture's payload, the JAX and port joint configs and the
    reference's state through the port's converter."""
    payload = golden.load_fixture_or_skip("adaln_zero_forward")
    jcfg = joint_parity._joint_config(joint_parity.GEOM, joint_parity.MIX, adaln=True)
    tcfg = torch_cfg(jcfg)

    class _T:
        joint = tcfg

    mixtures = {
        name: t_convert.convert_gemma_mixture(payload["state"], _T, f"mixtures.{name}.", tcfg.mixtures[i].use_final_norm)
        for i, name in enumerate(("vlm", "proprio", "action"))
    }
    return payload, jcfg, tcfg, {"mixtures": mixtures}


def test_convert_adaptive_mixtures_bitwise():
    payload, jcfg, _, params = _golden_joint()
    want = jax_tree(joint_parity._convert_ref_state(payload["state"], jcfg))
    assert_converted_bitwise(params, want)
    for name in ("proprio", "action"):
        layers = params["mixtures"][name]["layers"]
        assert set(layers["input_norm"]) == {"gamma_kernel", "gamma_bias", "beta_kernel"}
        assert set(layers["post_scale"]) == set(layers["final_scale"]) == {"kernel", "bias"}
        assert set(params["mixtures"][name]["final_norm"]) == {"gamma_kernel", "gamma_bias", "beta_kernel"}


def test_golden_adaln_zero_forward_replay():
    """The reference's adaLN-Zero JointModel forward (its gates moved off
    zero) through the port's converter and ``joint_forward`` with the time
    cond: rtol 2e-4, atol 2e-5, the JAX replay's."""
    payload, _, tcfg, params = _golden_joint()
    lens = joint_parity.LENS
    mask = t_masks.build_block_causal_mask(torch.from_numpy(payload["cnt"]), lens["vlm"], lens["proprio"], lens["action"])
    b = len(payload["cnt"])
    pos = {
        "vlm": t_masks.vlm_position_ids(lens["vlm"]).expand(b, -1),
        "proprio": t_masks.proprio_position_ids(lens["proprio"]).expand(b, -1),
        "action": t_masks.action_position_ids(lens["proprio"], lens["action"]).expand(b, -1),
    }
    params = t_convert.to_dtype(params, torch.float32)
    got = t_joint.joint_forward(
        params, tcfg, {n: torch.from_numpy(v) for n, v in payload["embeds"].items()}, pos, mask,
        time_cond=torch.from_numpy(payload["t_cond"]),
    )["action"]
    print(f"golden adaLN-Zero forward: max|diff| {np.abs(got.numpy() - payload['want']).max():.3e}")
    np.testing.assert_allclose(got.numpy(), payload["want"], rtol=2e-4, atol=2e-5)


# --------------------------------------------------------------------------- #
# the serving layout and TP
# --------------------------------------------------------------------------- #


def test_adaln_production_tree_matches_jax_and_serves(adaptive):
    """The production layout keeps the adaLN leaves float (JAX's
    QUANTIZE_KEYS do not name them): the tree bitwise JAX's, its chunk
    within 1e-4 of JAX's."""
    jcfg, tcfg, jparams, tparams = adaptive
    jtree, ttree = j_fuse.prepare_for_serving(jparams, **PRODUCTION), t_fuse.prepare_for_serving(tparams, **PRODUCTION)
    assert_trees_bitwise(ttree, jtree)
    layers = ttree["joint"]["mixtures"]["action"]["layers"]
    assert "q" in layers["mlp"]["gateup"] and torch.is_tensor(layers["input_norm"]["gamma_kernel"])
    ids, pix, am, prop, a0 = example_inputs(jcfg, seed=4)
    want = j_pizero.infer_action(jtree, jcfg, jax.random.key(0), *as_jax((ids, pix, am, prop)), action0=jnp.asarray(a0))
    got = t_pizero.infer_action(ttree, tcfg, None, *as_torch((ids, pix, am, prop)), action0=torch.from_numpy(a0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_adaln_streaming_build_bitwise_matches_two_step():
    cfg = t_config.tiny_pizero_config(action_expert_adaptive_mode="adaLN-Zero")
    want = t_fuse.prepare_for_serving(t_pizero.init_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16), **PRODUCTION)
    got = t_fuse.build_serving_params(cfg, seed=0, device="cpu", dtype=torch.bfloat16, **PRODUCTION)
    assert list(_leaves_with_paths(got)) and [p for p, _ in _leaves_with_paths(got)] == [p for p, _ in _leaves_with_paths(want)]
    for (path, a), (_, b) in zip(_leaves_with_paths(got), _leaves_with_paths(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_adaln_chunk_under_tp_2_matches_unsharded():
    """TP = 2 over gloo (two CPU ranks, mesh (1, 2)): the adaLN leaves stay
    whole on every rank (no TP rule names them, as in JAX)."""
    jcfg = tiny_pizero_config(action_expert_adaptive_mode="adaLN-Zero")
    jparams = _ungate(jax.tree.map(np.asarray, j_pizero.init_params(jax.random.key(0), jcfg)))
    tcfg = torch_cfg(jcfg)
    ids, pix, am, prop, a0 = example_inputs(jcfg, seed=6)
    batch = {"input_ids": ids, "pixel_values": pix, "attention_mask": am, "proprios": prop}
    (sharded,) = run_ranks(ranks.sequence, 1, 2, [(ranks.infer_rank, (tcfg, batch, a0, jparams))],
                           device="cpu", timeout_s=120)
    want = t_pizero.infer_action(jax_to_port(jparams), tcfg, None, *as_torch((ids, pix, am, prop)),
                                 action0=torch.from_numpy(a0))
    assert sharded["launches"] == 0  # the CPU ranks run the plain version
    np.testing.assert_allclose(sharded["chunk"], want.numpy(), rtol=1e-5, atol=1e-5)
