"""The port's training path (open_pi_zero_torch/training, joint_forward,
flow_matching_loss and the attention VJP) against the JAX package on the
CPU, fp32, at the tiny config: the same numpy-seeded params (JAX's, through
``params_from_jax``), inputs, flow times and noise go through both.

Tolerances, each with its reason:
  - forward values and gradients 1e-4 (rtol and atol), as the port's
    model tests: both sides compute in fp32 and differ in summation order;
  - golden replays at the JAX replay's own tolerances (rtol 2e-4 / atol
    2e-5 for hiddens, rtol 2e-4 for the loss);
  - optimizer updates from the same grads atol 1e-3 * lr, and a whole
    step atol 5e-2 * lr: a first Adam update lr * g / (|g| + eps) moves by
    at most lr * |dg| / (4 eps) when g moves by dg, and grads near zero
    agree to about 1e-9 here (the step's measured max|dp| is 9.4e-3 * lr),
    while a wrong group, lr, clip or surgery moves a param by about lr;
  - sampling: the stratified times exactly; the beta draws within 5
    standard errors (mean) and the DKW bound at 1e-6 (quantiles).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open_pi_zero_torch import config as t_config
from open_pi_zero_torch.models import joint as t_joint
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models.from_jax import params_from_jax
from open_pi_zero_torch.models.tree import tree_leaves, tree_map
from open_pi_zero_torch.ops import fused_attention as t_fa
from open_pi_zero_torch.ops.attention import mot_attention, mot_attention_ref
from open_pi_zero_torch.training import averaging as t_avg
from open_pi_zero_torch.training import optimizer as t_opt
from open_pi_zero_torch.training import sampling as t_sampling
from open_pi_zero_torch.training import schedules as t_sched
from open_pi_zero_torch.training import train_step as t_train
from open_pi_zero_tpu import config as j_config
from open_pi_zero_tpu.models import joint as j_joint
from open_pi_zero_tpu.models import pizero as j_pizero
from open_pi_zero_tpu.ops import MASK_NEG, mot_attention_fused
from open_pi_zero_tpu.training import averaging as j_avg
from open_pi_zero_tpu.training import optimizer as j_opt
from open_pi_zero_tpu.training import sampling as j_sampling
from open_pi_zero_tpu.training import schedules as j_sched
from tests import golden
from tests.test_reference_parity import (
    GEOM, GEOM_MID, LENS, LENS_MID, MIX, MIX_MID, _convert_ref_state, _joint_config, _mask_and_pos,
)
from tests.test_reference_parity_pizero import build_our_cfg, convert_state
from tests.test_torch_models import torch_cfg

TOL = dict(rtol=1e-4, atol=1e-4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _leaves_with_paths(v, f"{prefix}/{k}")
        return out
    return [(prefix, tree)]


def _sched_cfg(warmup):
    return dict(
        action_lr_scheduler=j_config.LRSchedulerConfig(warmup_steps=warmup),
        vlm_lr_scheduler=j_config.LRSchedulerConfig(warmup_steps=warmup),
    )


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_config.tiny_pizero_config()
    jparams = j_pizero.init_params(jax.random.key(0), jcfg)
    return jcfg, torch_cfg(jcfg), jparams


def _tparams(jparams):
    return params_from_jax(_np_tree(jparams), device="cpu")


def _batch(cfg, b, seed, accum=None):
    """Numpy inputs for the loss: ids/pixels/mask/proprio/actions/t/x0,
    with one row padded further; with ``accum`` a leading accumulation
    axis."""
    rng = np.random.default_rng(seed)
    lead = (accum,) if accum else ()
    n_img = cfg.siglip.num_image_tokens
    ids = np.zeros((*lead, b, cfg.max_image_text_tokens), np.int32)
    ids[..., :n_img] = cfg.image_token_index
    ids[..., n_img] = 2
    ids[..., 0, n_img + 1 : n_img + 5] = [10, 11, 12, 13]
    ids[..., 1, n_img + 1] = 14
    size = cfg.siglip.image_size
    return {
        "input_ids": ids,
        "pixel_values": rng.normal(size=(*lead, b, size, size, 3)).astype(np.float32),
        "attention_mask": (ids != cfg.pad_token_id).astype(np.int32),
        "proprios": rng.normal(size=(*lead, b, cfg.cond_steps, cfg.proprio_dim)).astype(np.float32),
        "actions": rng.normal(size=(*lead, b, cfg.horizon_steps, cfg.action_dim)).astype(np.float32),
        "t": rng.uniform(0.05, 0.95, size=(*lead, b)).astype(np.float32),
        "x0": rng.normal(size=(*lead, b, cfg.horizon_steps, cfg.action_dim)).astype(np.float32),
    }


_LOSS_KEYS = ("input_ids", "pixel_values", "attention_mask", "proprios", "actions", "t")


def _jax_loss(jparams, jcfg, batch):
    return j_pizero.flow_matching_loss(
        jparams, jcfg, jax.random.key(0), *(jnp.asarray(batch[k]) for k in _LOSS_KEYS),
        x0=jnp.asarray(batch["x0"]),
    )


def _torch_loss(tparams, tcfg, batch):
    return t_pizero.flow_matching_loss(
        tparams, tcfg, None, *(torch.from_numpy(batch[k]) for k in _LOSS_KEYS),
        x0=torch.from_numpy(batch["x0"]),
    )


# --------------------------------------------------------------------------- #
# K1-vjp: attention grads
# --------------------------------------------------------------------------- #


def _attn_inputs(rng, b, lq, lkv, hq, hkv, d, fully_masked_row=False):
    q = rng.normal(size=(b, lq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, lkv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, lkv, hkv, d)).astype(np.float32)
    mask = np.where(rng.random((b, 1, lq, lkv)) > 0.3, 0.0, MASK_NEG).astype(np.float32)
    mask[..., 0] = 0.0
    if fully_masked_row:
        mask[0, 0, 1] = MASK_NEG
    return q, k, v, mask


def _sq_loss_grads(q, k, v, mask, attention):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    loss = (attention(q, k, v, torch.from_numpy(mask), 50.0) ** 2).sum()
    return torch.autograd.grad(loss, (q, k, v))


def test_mot_attention_grads_match_jax_pallas_vjp():
    """The port's attention grads on the CPU against jax.grad through the
    Pallas kernel's custom VJP (interpret mode), as
    tests/test_pallas_attention.py holds the VJP against XLA. No row is
    fully masked: there the Pallas kernel averages V over its padded
    columns, zeros included, where its XLA path and the port take the mean
    of the real ones."""
    q, k, v, mask = _attn_inputs(np.random.default_rng(13), 1, 10, 14, 4, 1, 16)

    def loss_fused(q, k, v):
        return jnp.sum(mot_attention_fused(q, k, v, jnp.asarray(mask), 50.0, True) ** 2)

    want = jax.grad(loss_fused, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    got = _sq_loss_grads(q, k, v, mask, mot_attention)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_vjp_function_backward_matches_plain_autograd(monkeypatch):
    """The autograd Function's own backward (recompute through the plain
    version) on the CPU, with its forward's launch stood in for by the plain
    version: grads equal plain autograd's."""
    monkeypatch.setattr(t_fa, "_launch", lambda q, k, v, mask, softcap: mot_attention_ref(q, k, v, mask, softcap))
    q, k, v, mask = _attn_inputs(np.random.default_rng(3), 2, 9, 12, 8, 1, 32, fully_masked_row=True)
    got = _sq_loss_grads(q, k, v, mask, t_fa.mot_attention_fused)
    want = _sq_loss_grads(q, k, v, mask, mot_attention_ref)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_mot_attention_fused_refuses_cpu_tensors_that_require_grad():
    q, k, v, mask = (torch.from_numpy(x) for x in _attn_inputs(np.random.default_rng(0), 1, 4, 6, 4, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        t_fa.mot_attention_fused(q.requires_grad_(), k, v, mask)


# --------------------------------------------------------------------------- #
# joint_forward
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("remat", [False, True])
def test_joint_forward_matches_jax(tiny, remat):
    """Outputs and the grads of the embeds, with and without remat."""
    jcfg, tcfg, jparams = tiny
    jjoint = dataclasses.replace(jcfg.joint, remat=remat)
    tjoint = dataclasses.replace(tcfg.joint, remat=remat)
    rng = np.random.default_rng(4)
    b = 2
    lens = {"vlm": jcfg.max_image_text_tokens, "proprio": jcfg.cond_steps, "action": jcfg.horizon_steps}
    embeds = {n: rng.normal(size=(b, ln, jcfg.mixture(n).hidden_size)).astype(np.float32) for n, ln in lens.items()}
    am = np.zeros((b, lens["vlm"]), np.int32)
    am[0, :10] = 1
    am[1, :6] = 1
    jfull, _, _, jpos = j_pizero.prepare_action_inputs(jcfg, jnp.asarray(am))
    tfull, _, _, tpos = t_pizero.prepare_action_inputs(tcfg, torch.from_numpy(am))

    def jloss(e):
        return jnp.sum(j_joint.joint_forward(jparams["joint"], jjoint, e, jpos, jfull)["action"] ** 2)

    want, jgrad = jax.value_and_grad(jloss)({n: jnp.asarray(x) for n, x in embeds.items()})
    temb = {n: torch.from_numpy(x).requires_grad_() for n, x in embeds.items()}
    tparams = _tparams(jparams)
    out = t_joint.joint_forward(tparams["joint"], tjoint, temb, tpos, tfull)
    assert set(out) == {"action"}
    got = (out["action"] ** 2).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for n in embeds:
        np.testing.assert_allclose(temb[n].grad.numpy(), np.asarray(jgrad[n]), **TOL)


@pytest.mark.parametrize(
    "fixture,geom,mix,lens",
    [
        ("joint_training_forward", GEOM, MIX, LENS),
        ("joint_training_forward_mid", GEOM_MID, MIX_MID, LENS_MID),
    ],
)
def test_golden_joint_training_forward_replay(fixture, geom, mix, lens):
    """The reference's training-mode JointModel outputs, through the JAX
    converter and params_from_jax, at the JAX replay's tolerances."""
    payload = golden.load_fixture_or_skip(fixture)
    jcfg = _joint_config(geom, mix)
    params = params_from_jax(_np_tree(_convert_ref_state(payload["state"], jcfg)), device="cpu")
    mask, pos = _mask_and_pos(payload["cnt"], lens)
    got = t_joint.joint_forward(
        params, torch_cfg(jcfg),
        {n: torch.from_numpy(v) for n, v in payload["embeds"].items()},
        {n: torch.from_numpy(np.array(p)) for n, p in pos.items()},
        torch.from_numpy(np.array(mask)),
    )["action"]
    np.testing.assert_allclose(got.detach().numpy(), payload["want"], rtol=2e-4, atol=2e-5)


# --------------------------------------------------------------------------- #
# flow_matching_loss
# --------------------------------------------------------------------------- #


def test_flow_matching_loss_and_every_grad_leaf_match_jax(tiny):
    jcfg, tcfg, jparams = tiny
    batch = _batch(jcfg, 2, seed=5)
    want, jgrads = jax.value_and_grad(lambda p: _jax_loss(p, jcfg, batch))(jparams)
    tparams = tree_map(lambda x: x.requires_grad_(), _tparams(jparams))
    got = _torch_loss(tparams, tcfg, batch)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    jleaves = dict(_leaves_with_paths(_np_tree(jgrads)))
    tleaves = _leaves_with_paths(tparams)
    assert [p for p, _ in tleaves] == list(jleaves)
    for path, leaf in tleaves:
        w = jleaves[path]
        scale = max(float(np.abs(w).max()), 1e-3)  # leaf-relative: grads span decades
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-4, atol=1e-4 * scale, err_msg=path)


def test_golden_flow_matching_loss_replay():
    """The reference's loss on its own weights and injected t / x0
    (pizero_flow_loss.npz), at the JAX replay's rtol 2e-4."""
    payload = golden.load_fixture_or_skip("pizero_flow_loss")
    jcfg = build_our_cfg()
    params = params_from_jax(_np_tree(convert_state(payload["state"], jcfg)), device="cpu")
    got = t_pizero.flow_matching_loss(
        params, torch_cfg(jcfg), None,
        torch.from_numpy(payload["ids"].astype(np.int32)),
        torch.from_numpy(np.ascontiguousarray(payload["pix"].transpose(0, 2, 3, 1))),  # NHWC
        torch.from_numpy(payload["am"].astype(np.int32)),
        torch.from_numpy(payload["prop"]), torch.from_numpy(payload["act"]),
        torch.from_numpy(payload["t"]), x0=torch.from_numpy(payload["x0"]),
    )
    np.testing.assert_allclose(float(got), float(payload["want"]), rtol=2e-4)


def test_remat_matches_no_remat(tiny):
    """Rematerialization changes memory, not numbers: the same loss and
    grads (the CPU's ops are deterministic, so the recompute is exact)."""
    jcfg, tcfg, jparams = tiny
    batch = _batch(jcfg, 2, seed=6)
    results = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, joint=dataclasses.replace(tcfg.joint, remat=remat))
        params = tree_map(lambda x: x.requires_grad_(), _tparams(jparams))
        loss = _torch_loss(params, cfg, batch)
        loss.backward()
        results.append((loss.detach(), [p.grad for p in tree_leaves(params)]))
    (l0, g0), (l1, g1) = results
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# sampling, schedules, labels, averaging
# --------------------------------------------------------------------------- #


def test_sample_flow_time_stratified_is_the_jax_formula():
    cfg = t_config.tiny_pizero_config(flow_sampling="uniform")
    got = t_sampling.sample_flow_time(torch.Generator().manual_seed(3), 37, cfg)
    offset = torch.rand((), generator=torch.Generator().manual_seed(3))
    want = (jnp.float32(offset.item()) + jnp.arange(37) / 37) % (1 - 1e-5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))


def test_sample_flow_time_beta_distribution():
    """t = (1-σmin)(1-z), z ~ Beta(1.5, 1): mean within 5 standard errors,
    every quantile within the DKW bound sqrt(ln(2/δ)/2n) at δ = 1e-6."""
    cfg = t_config.PiZeroConfig()
    n = 200_000
    t = t_sampling.sample_flow_time(torch.Generator().manual_seed(0), n, cfg).double().numpy()
    t_max = 1 - cfg.flow_sig_min
    z = 1 - t / t_max
    a = cfg.flow_alpha
    mean, var = a / (a + 1), a / ((a + 1) ** 2 * (a + 2))
    assert abs(z.mean() - mean) < 5 * np.sqrt(var / n)
    qs = np.linspace(0.01, 0.99, 99)
    emp = np.searchsorted(np.sort(z), qs) / n
    assert np.abs(emp - qs**a).max() < np.sqrt(np.log(2 / 1e-6) / (2 * n))
    # and JAX's sampler draws from the same law: means agree within 5 standard errors
    jt = np.asarray(j_sampling.sample_flow_time(jax.random.key(0), n, cfg), np.float64)
    assert abs(jt.mean() - t.mean()) < 5 * t_max * np.sqrt(2 * var / n)
    # beta != 1 draws Beta(alpha, beta) (its law: tests/test_torch_leftovers.py)
    b = 2.0
    t2 = t_sampling.sample_flow_time(torch.Generator().manual_seed(0), n, dataclasses.replace(cfg, flow_beta=b))
    z2 = 1 - t2.double().numpy() / t_max
    var2 = a * b / ((a + b) ** 2 * (a + b + 1))
    assert t2.dtype == torch.float32 and abs(z2.mean() - a / (a + b)) < 5 * np.sqrt(var2 / n)


@pytest.mark.parametrize(
    "kw",
    [
        dict(max_lr=5e-5, first_cycle_steps=10_000_000, min_lr=1e-8, warmup_steps=200),
        dict(max_lr=1e-3, first_cycle_steps=1000, min_lr=1e-6, warmup_steps=100, gamma=0.5),
        dict(max_lr=1e-4, first_cycle_steps=50, warmup_steps=0),
    ],
)
def test_schedule_matches_jax(kw):
    """The port computes in float64, JAX in float32, where min_lr + (1 + cos)
    cancels near the end of a cycle: atol 1e-6 * max_lr."""
    got, want = t_sched.cosine_annealing_warmup_restarts(**kw), j_sched.cosine_annealing_warmup_restarts(**kw)
    for count in list(range(0, 260)) + list(range(260, 5000, 37)):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=2e-6, atol=1e-6 * kw["max_lr"])


@pytest.mark.parametrize("train_vlm", [True, False])
def test_param_labels_and_counts_match_jax(tiny, train_vlm):
    jcfg, _, jparams = tiny
    tparams = _tparams(jparams)
    assert t_opt.param_labels(tparams, train_vlm) == j_opt.param_labels(jparams, train_vlm)
    got = t_opt.trainable_param_count(tparams, train_vlm)
    assert got == pytest.approx(j_opt.trainable_param_count(jparams, train_vlm), abs=1e-12)
    # a tree without adapters under lora=True: the VLM side all frozen, as in JAX
    assert t_opt.param_labels(tparams, train_vlm, lora=True) == j_opt.param_labels(jparams, train_vlm, lora=True)


@pytest.mark.parametrize("mode", ["ema", "swa"])
def test_averaging_matches_jax(tiny, mode):
    _, _, jparams = tiny
    cfg = t_config.TrainingConfig(**{f"use_{mode}": True, f"{mode}_start": 1, f"{mode}_freq": 2})
    jcfg = j_config.TrainingConfig(**{f"use_{mode}": True, f"{mode}_start": 1, f"{mode}_freq": 2})
    jstate, tstate = j_avg.init_averaging(jparams), t_avg.init_averaging(_tparams(jparams))
    rng = np.random.default_rng(8)
    for update in range(1, 6):
        live = jax.tree.map(lambda x: x + rng.normal(size=x.shape).astype(np.float32), _np_tree(jparams))
        jstate = j_avg.maybe_update(jstate, jax.tree.map(jnp.asarray, live), jnp.int32(update), jcfg)
        tstate = t_avg.maybe_update(tstate, params_from_jax(live, device="cpu"), update, cfg)
    assert tstate.n_averaged == int(jstate.n_averaged) == 3
    for (path, a), (_, b) in zip(_leaves_with_paths(tstate.avg_params), _leaves_with_paths(_np_tree(jstate.avg_params))):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6, err_msg=path)


# --------------------------------------------------------------------------- #
# optimizer and train step
# --------------------------------------------------------------------------- #


LR = 1e-3


def _train_cfgs(**kw):
    kw = dict(action_lr=LR, vlm_lr=LR, **_sched_cfg(0), **kw)
    jcfg = j_config.TrainingConfig(**kw)
    return jcfg, torch_cfg(jcfg)


def _assert_params_close(tparams, jparams, atol):
    for (path, a), (_, b) in zip(_leaves_with_paths(tparams), _leaves_with_paths(_np_tree(jparams))):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0, atol=atol, err_msg=path)


def test_two_optimizer_updates_match_optax(tiny):
    """Two updates from the same grads, the first clipped (norm > 1), the
    second not; the frozen leaves and slices stay bitwise unchanged."""
    jcfg, _, jparams = tiny
    j_train, t_train_cfg = _train_cfgs()
    tx = j_opt.build_optimizer(j_train, jparams)
    opt_state = tx.init(jparams)
    tparams = _tparams(jparams)
    optimizer = t_opt.build_optimizer(t_train_cfg, tparams)
    state = optimizer.init(tparams)
    rng = np.random.default_rng(9)
    labels = t_opt.param_labels(tparams)
    frozen_before = tparams["embed_tokens"].clone(), tparams["joint"]["mixtures"]["vlm"]["layers"]["mlp"]["down"][-1].clone()
    jp = jparams
    for count, scale in enumerate((1.0, 1e-3)):
        grads = jax.tree.map(lambda x: jnp.asarray((scale * rng.normal(size=x.shape)).astype(np.float32)), jp)
        want_norm = optax.global_norm(j_opt.apply_freeze_surgery(grads))
        updates, opt_state = tx.update(grads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for lab, p, g in zip(tree_leaves(labels), tree_leaves(tparams), jax.tree.leaves(grads)):
            if lab != "frozen":
                p.grad = torch.from_numpy(np.array(g))
        norm = optimizer.update(tparams, state, count)
        assert (float(want_norm) > 1.0) == (count == 0)
        np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-5)
        _assert_params_close(tparams, jp, atol=1e-3 * LR)
    assert all(p.grad is None for p in tree_leaves(tparams))
    assert torch.equal(tparams["embed_tokens"], frozen_before[0])
    assert torch.equal(tparams["joint"]["mixtures"]["vlm"]["layers"]["mlp"]["down"][-1], frozen_before[1])


def _jax_accum_update(jparams, jcfg, j_train, batch, accum):
    """The JAX package's step with injected t / x0: mean loss and grads over
    the microbatches, the norm after surgery, the optax update."""
    tx = j_opt.build_optimizer(j_train, jparams)
    grads, loss = None, 0.0
    for i in range(accum):
        mb = {k: v[i] for k, v in batch.items()}
        l, g = jax.value_and_grad(lambda p: _jax_loss(p, jcfg, mb))(jparams)
        loss += l / accum
        grads = jax.tree.map(lambda g_: g_ / accum, g) if grads is None else jax.tree.map(lambda a, b: a + b / accum, grads, g)
    norm = optax.global_norm(j_opt.apply_freeze_surgery(grads))
    updates, _ = tx.update(grads, tx.init(jparams), jparams)
    return float(loss), float(norm), optax.apply_updates(jparams, updates)


def test_grad_accum_step_matches_jax_reference(tiny):
    jcfg, tcfg, jparams = tiny
    j_train, t_train_cfg = _train_cfgs()
    batch = _batch(jcfg, 2, seed=10, accum=2)
    want_loss, want_norm, want_params = _jax_accum_update(jparams, jcfg, j_train, batch, 2)

    tparams = _tparams(jparams)
    optimizer = t_opt.build_optimizer(t_train_cfg, tparams)
    state = t_train.init_train_state(tparams, optimizer, torch.Generator(), t_train_cfg)
    step = t_train.make_train_step(tcfg, t_train_cfg, optimizer, grad_accum=2)
    metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm, rtol=1e-4)
    _assert_params_close(tparams, want_params, atol=5e-2 * LR)


def test_loss_falls_over_a_few_steps(tiny):
    """Five updates on one batch with fixed flow times and noise, remat on."""
    jcfg, tcfg, jparams = tiny
    tcfg = dataclasses.replace(tcfg, joint=dataclasses.replace(tcfg.joint, remat=True))
    _, t_train_cfg = _train_cfgs()
    tparams = _tparams(jparams)
    optimizer = t_opt.build_optimizer(t_train_cfg, tparams)
    state = t_train.init_train_state(tparams, optimizer, torch.Generator().manual_seed(0), t_train_cfg)
    step = t_train.make_train_step(tcfg, t_train_cfg, optimizer)
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg, 2, seed=11).items()}
    losses = [float(step(state, batch)["loss"]) for _ in range(5)]
    assert all(np.isfinite(losses)) and state.step == 5
    assert losses[-1] < 0.8 * losses[0], losses


def test_train_step_draws_its_flow_times_and_noise_from_the_generator(tiny):
    """Without injected t / x0 the step samples them from the state's
    generator: two states seeded alike take the same update."""
    jcfg, tcfg, jparams = tiny
    _, t_train_cfg = _train_cfgs()
    batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg, 2, seed=12).items() if k not in ("t", "x0")}
    runs = []
    for _ in range(2):
        tparams = _tparams(jparams)
        optimizer = t_opt.build_optimizer(t_train_cfg, tparams)
        state = t_train.init_train_state(tparams, optimizer, torch.Generator().manual_seed(7), t_train_cfg)
        metrics = t_train.make_train_step(tcfg, t_train_cfg, optimizer)(state, batch)
        runs.append((float(metrics["loss"]), tparams["action_decoder"]["kernel"].detach().clone()))
    assert runs[0][0] == runs[1][0] and np.isfinite(runs[0][0])
    assert torch.equal(runs[0][1], runs[1][1])
