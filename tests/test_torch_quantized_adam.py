"""The port's blockwise int8 (``ops/quantization.py``: QTensor,
quantize_blockwise, dequantize_blockwise) and its 8-bit AdamW
(``training/quantized_adam.py``) against the JAX package on the CPU, on
the same numpy inputs.

Tolerances, each with its reason:
  - payloads and scales bitwise: the same fp32 arithmetic (the power-law
    root as XLA computes it), on inputs whose codes sit on no rounding
    tie;
  - dequantized values bitwise: the same products in the same order;
  - params after AdamW8bit updates 1e-6 absolute: both sides take the
    same fp32 steps, but the lr and the bias corrections are fp32 numbers
    that JAX computes from its own pow (an ulp apart at most), and
    lr = 1e-3 moves a param by about 1e-3 per step, so 1e-6 = lr / 1000
    catches a wrong moment, code or correction;
  - moment payloads after the updates at most one code apart (their count
    printed), where a value sits on a rounding tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open_pi_zero_torch.models.from_jax import params_from_jax
from open_pi_zero_torch.models.tree import tree_leaves
from open_pi_zero_torch.ops import quantization as t_quant
from open_pi_zero_torch.training import optimizer as t_opt
from open_pi_zero_torch.training import quantized_adam as t_qadam
from open_pi_zero_torch.training import schedules as t_sched
from open_pi_zero_tpu import config as j_config
from open_pi_zero_tpu.models import pizero as j_pizero
from open_pi_zero_tpu.ops import quantization as j_quant
from open_pi_zero_tpu.training import optimizer as j_opt
from open_pi_zero_tpu.training import quantized_adam as j_qadam
from open_pi_zero_tpu.training import schedules as j_sched
from tests.test_torch_models import torch_cfg

LR = 1e-3


def _moments_input(shape=(3, 5000), seed=0):
    """Heavy-tailed values over 6 decades, a run of zeros and one all-zero
    block (row 1 holds blocks 2-4 of 2048; the second is all zero)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * np.exp(3 * rng.normal(size=shape))).astype(np.float32)
    x.reshape(-1)[4096:6144] = 0.0
    x[0, :100] = 0.0
    return x


@pytest.mark.parametrize("power", [1, 3, 4])
def test_quantize_blockwise_bitwise_jax(power):
    x = _moments_input()
    assert x.size % t_quant.DEFAULT_BLOCK  # a padded tail
    want = j_quant.quantize_blockwise(jnp.asarray(x), 2048, power)
    got = t_quant.quantize_blockwise(torch.from_numpy(x), 2048, power)
    assert got.q.dtype == torch.int8 and got.shape == want.shape == x.shape and got.power == power
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.scale[2, 0] == 1.0 and not got.q[2].any()  # the all-zero block


@pytest.mark.parametrize("power", [1, 3, 4])
def test_dequantize_blockwise_equals_jax(power):
    x = _moments_input(seed=1)
    qt = j_quant.quantize_blockwise(jnp.asarray(x), 2048, power)
    want = np.asarray(j_quant.dequantize_blockwise(qt))
    got = t_quant.dequantize_blockwise(
        t_quant.QTensor(torch.from_numpy(np.asarray(qt.q)), torch.from_numpy(np.asarray(qt.scale)), x.shape, power)
    )
    assert got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _grad_sequence(shapes, steps, seed):
    rng = np.random.default_rng(seed)
    return [[(rng.normal(size=s) * 10.0 ** rng.uniform(-4, 0)).astype(np.float32) for s in shapes] for _ in range(steps)]


def _jax_adam8bit(params, grads_seq, schedule, **kw):
    tx = j_qadam.adamw8bit(schedule, **kw)
    p = [jnp.asarray(x) for x in params]
    state = tx.init(p)
    for grads in grads_seq:
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, p)
        p = optax.apply_updates(p, updates)
    return [np.asarray(x) for x in p], state


def _assert_moments_close(opt, leaves, jstate):
    """Each moment's payload at most one code from JAX's (count printed)
    and its scales within 1e-6 relative."""
    off = 0
    for p, mu, nu in zip(leaves, jstate.mu, jstate.nu):
        st = opt.state[p]
        for name, qt in (("mu", mu), ("nu", nu)):
            d = np.abs(st[name].numpy().astype(np.int32) - np.asarray(qt.q).astype(np.int32))
            assert d.max() <= 1, name
            off += int((d == 1).sum())
            np.testing.assert_allclose(st[f"{name}_scale"].numpy(), np.asarray(qt.scale), rtol=1e-6, atol=0)
    print(f"moment codes one apart: {off}")


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_five_adamw8bit_steps_match_jax(weight_decay):
    """Five updates on a fixed grad sequence with the bridge schedule's
    warmup shape (lr from the schedule at the count before the increment),
    one leaf larger than a block and one smaller."""
    shapes = [(3, 1500), (7, 5)]
    rng = np.random.default_rng(2)
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads_seq = _grad_sequence(shapes, 5, seed=3)
    sched_cfg = dict(first_cycle_steps=100, warmup_steps=3, min_lr=1e-6)
    want, jstate = _jax_adam8bit(
        params, grads_seq, j_sched.cosine_annealing_warmup_restarts(LR, **sched_cfg), weight_decay=weight_decay
    )
    schedule = t_sched.cosine_annealing_warmup_restarts(LR, **sched_cfg)
    leaves = [torch.from_numpy(p.copy()) for p in params]
    opt = t_qadam.AdamW8bit(leaves, weight_decay=weight_decay)
    for count, grads in enumerate(grads_seq):
        for p, g in zip(leaves, grads):
            p.grad = torch.from_numpy(g)
        opt.param_groups[0]["lr"] = schedule(count)
        opt.step()
    assert opt.param_groups[0]["count"] == int(jstate.count) == 5
    for a, b in zip(leaves, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    _assert_moments_close(opt, leaves, jstate)


def test_adamw8bit_slices_a_leaf_without_changing_a_number(monkeypatch):
    """A leaf updated a few blocks at a time equals the leaf updated at once."""
    rng = np.random.default_rng(4)
    shape = (5, 2048 + 300)  # 6 blocks, a padded tail
    p0 = rng.normal(size=shape).astype(np.float32)
    grads_seq = _grad_sequence([shape], 3, seed=5)
    runs = []
    for chunk in (t_qadam.CHUNK_BLOCKS, 4):
        monkeypatch.setattr(t_qadam, "CHUNK_BLOCKS", chunk)
        p = torch.from_numpy(p0.copy())
        opt = t_qadam.AdamW8bit([p], lr=LR)
        for (g,) in grads_seq:
            p.grad = torch.from_numpy(g)
            opt.step()
        runs.append((p.clone(), {k: v.clone() for k, v in opt.state[p].items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])


def test_adamw8bit_state_dict_round_trip():
    """torch's state_dict carries the payloads, scales and counts: a fresh
    optimizer loaded from it takes the next update bitwise alike."""
    rng = np.random.default_rng(6)
    p0 = rng.normal(size=(4, 700)).astype(np.float32)
    (g1,), (g2,) = _grad_sequence([p0.shape], 2, seed=7)
    a = torch.from_numpy(p0.copy())
    opt_a = t_qadam.AdamW8bit([a], lr=LR)
    a.grad = torch.from_numpy(g1)
    opt_a.step()
    b = a.detach().clone()
    opt_b = t_qadam.AdamW8bit([b], lr=LR)
    opt_b.load_state_dict(opt_a.state_dict())
    for p, opt in ((a, opt_a), (b, opt_b)):
        p.grad = torch.from_numpy(g2)
        opt.step()
    assert opt_b.param_groups[0]["count"] == 2
    assert torch.equal(a, b)
    # torch.equal promotes its operands: the int8 payloads must stay int8
    assert opt_a.state[a].keys() == opt_b.state[b].keys()
    for k in opt_a.state[a]:
        assert opt_a.state[a][k].dtype == opt_b.state[b][k].dtype and torch.equal(opt_a.state[a][k], opt_b.state[b][k])
    assert opt_b.state[b]["mu"].dtype == opt_b.state[b]["nu"].dtype == torch.int8


def test_adamw8bit_load_refuses_moments_not_int8():
    """A state whose payloads are not int8 blocks of the param (torch's own
    load would have cast them to the param's fp32) raises, naming the
    moment."""
    a = torch.zeros(3, 700)
    opt = t_qadam.AdamW8bit([a], lr=LR)
    a.grad = torch.ones_like(a)
    opt.step()
    sd = opt.state_dict()
    for bad in ({"mu": sd["state"][0]["mu"].float()}, {"nu_scale": sd["state"][0]["nu_scale"].double()},
                {"mu": sd["state"][0]["mu"][:, :1024]}):
        with pytest.raises(ValueError, match="AdamW8bit state"):
            t_qadam.AdamW8bit([a.clone()], lr=LR).load_state_dict({**sd, "state": {0: {**sd["state"][0], **bad}}})


def test_build_optimizer_quantized_states_matches_optax_chain():
    """``build_optimizer`` with ``quantize_optimizer_states`` (surgery ->
    clip -> per-group AdamW8bit) against JAX's optax chain over one clipped
    update of the tiny tree."""
    jcfg = j_config.tiny_pizero_config()
    jparams = j_pizero.init_params(jax.random.key(0), jcfg)
    sched = j_config.LRSchedulerConfig(warmup_steps=0)
    kw = dict(action_lr=LR, vlm_lr=LR, action_lr_scheduler=sched, vlm_lr_scheduler=sched, quantize_optimizer_states=True)
    j_train = j_config.TrainingConfig(**kw)
    t_train = torch_cfg(j_train)
    tx = j_opt.build_optimizer(j_train, jparams)
    rng = np.random.default_rng(8)
    grads = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), jparams)
    want_norm = float(optax.global_norm(j_opt.apply_freeze_surgery(grads)))
    updates, _ = jax.jit(tx.update)(grads, jax.jit(tx.init)(jparams), jparams)  # eager optax is slow
    want = optax.apply_updates(jparams, updates)

    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    optimizer = t_opt.build_optimizer(t_train, tparams)
    state = optimizer.init(tparams)
    assert isinstance(state, t_qadam.AdamW8bit)
    labels = t_opt.param_labels(tparams)
    for lab, p, g in zip(tree_leaves(labels), tree_leaves(tparams), jax.tree.leaves(grads)):
        if lab != "frozen":
            p.grad = torch.from_numpy(np.array(g))
    norm = optimizer.update(tparams, state, 0)
    assert want_norm > 1.0  # the clip took part
    np.testing.assert_allclose(float(norm), want_norm, rtol=1e-5)
    for a, b in zip(tree_leaves(tparams), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-6)
