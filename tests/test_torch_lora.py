"""LoRA and QLoRA in the port (``ops/lora.py``: lora_init, merge_lora,
lora_label_fn; adapters in ``init_params``; the LoRA labels
and quantized bases in ``training/optimizer.py``; a QLoRA train step with
8-bit Adam) against the JAX package on the CPU, fp32, at the tiny config:
the same numpy-seeded params (JAX's, through ``params_from_jax``, their B
matrices drawn off zero so that every adapter has a grad), inputs, flow
times and noise go through both.

Tolerances, each with its reason:
  - trees, labels and counts exactly;
  - merged kernels 1e-6: A @ B in fp32 summed in another order;
  - the golden LoRA forward at the JAX replay's tolerances (rtol 2e-4,
    atol 2e-5);
  - the loss and every trained grad 1e-4, as the port's other model
    tests (fp32 on both sides, other summation orders);
  - one QLoRA step: params 5e-2 * lr, as the float step test
    (tests/test_torch_training.py: a first Adam update moves a param by at
    most lr * |dg| / (4 eps) when its grad moves by dg, and grads near zero
    agree only to about 1e-9 in absolute terms), the grad norm over the
    trained leaves 1e-4 relative; with the clip active and eps 1e-4,
    params 1e-3 * lr (the larger eps damps that noise).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open_pi_zero_torch.models import joint as t_joint
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models.from_jax import params_from_jax
from open_pi_zero_torch.models.tree import tree_leaves
from open_pi_zero_torch.ops import lora as t_lora
from open_pi_zero_torch.training import optimizer as t_opt
from open_pi_zero_torch.training import quantized_adam as t_qadam
from open_pi_zero_torch.training import train_step as t_train
from open_pi_zero_tpu import config as j_config
from open_pi_zero_tpu.models import pizero as j_pizero
from open_pi_zero_tpu.ops import lora as j_lora
from open_pi_zero_tpu.training import optimizer as j_opt
from tests import golden
from tests.test_reference_parity import GEOM, LENS, MIX, _convert_ref_state, _joint_config, _mask_and_pos
from tests.test_torch_models import torch_cfg
from tests.test_torch_training import _batch, _jax_loss, _leaves_with_paths, _np_tree, _torch_loss

TOL = dict(rtol=1e-4, atol=1e-4)
LR = 1e-3


def lora_config(cfg, quantize: bool):
    """A config (JAX's or the port's) with LoRA on the vlm mixture and
    SigLIP, and with ``quantize`` their bases in NF4: the QLoRA recipe of
    configs/train/bridge.yaml (``quantize: true, lora: true``)."""
    joint = cfg.joint
    mixtures = tuple(
        dataclasses.replace(m, use_lora=True, use_quantize=quantize) if n == "vlm" else m
        for n, m in zip(joint.mixture_names, joint.mixtures)
    )
    return dataclasses.replace(
        cfg,
        joint=dataclasses.replace(joint, mixtures=mixtures),
        siglip=dataclasses.replace(cfg.siglip, use_lora=True, use_quantize=quantize),
    )


def _bump_b(tree, rng):
    """Every adapter's B drawn off zero (numpy leaves), so A has a grad."""
    if isinstance(tree, dict):
        return {
            k: {**v, "b": (0.1 * rng.normal(size=v["b"].shape)).astype(np.float32)} if k.endswith("_lora") else _bump_b(v, rng)
            for k, v in tree.items()
        }
    return tree


@functools.lru_cache(maxsize=None)
def _jax_lora_params(quantize: bool, seed: int):
    jcfg = lora_config(j_config.tiny_pizero_config(), quantize)
    params = _bump_b(_np_tree(j_pizero.init_params(jax.random.key(seed), jcfg)), np.random.default_rng(seed + 1))
    if quantize:
        params = _np_tree(j_lora.quantize_per_model_config(jax.tree.map(jnp.asarray, params), jcfg))
    return jcfg, params


def jax_lora_params(quantize: bool, seed: int = 0):
    """(JAX config, JAX params with numpy leaves, B off zero, bases in NF4
    with ``quantize``): a copy of the tree made once per (quantize, seed)."""
    jcfg, params = _jax_lora_params(quantize, seed)
    return jcfg, jax.tree.map(np.copy, params)


def _shapes(tree):
    return {p: (tuple(np.shape(x)), str(np.asarray(x).dtype) if not torch.is_tensor(x) else str(x.dtype)[6:])
            for p, x in _leaves_with_paths(tree)}


@pytest.mark.parametrize("quantize", [False, True])
def test_init_params_with_lora_matches_jax_tree(quantize):
    jcfg = lora_config(j_config.tiny_pizero_config(), quantize)
    tcfg = torch_cfg(jcfg)
    want = j_pizero.init_params(jax.random.key(0), jcfg)
    got = t_pizero.init_params(tcfg, seed=0, device="cpu")
    if quantize:
        want = j_lora.quantize_per_model_config(want, jcfg)
        got = t_lora.quantize_per_model_config(got, tcfg)
    assert _shapes(got) == _shapes(_np_tree(want))
    layers = got["joint"]["mixtures"]["vlm"]["layers"]
    assert list(layers["attn"]) == ["q", "k", "v", "o", "q_lora", "k_lora", "v_lora", "o_lora"]  # JAX's order
    assert "kernel_lora" in got["projector"] and "fc2_lora" in got["siglip"]["layers"]["mlp"]
    assert t_pizero.abstract_params(tcfg)["projector"]["kernel_lora"]["a"].shape == got["projector"]["kernel_lora"]["a"].shape


def test_lora_init_distribution():
    a = t_lora.lora_init(torch.Generator().manual_seed(0), 400, 30, 8, stack=3)
    assert a["a"].shape == (3, 400, 8) and a["b"].shape == (3, 8, 30)
    assert not a["b"].any() and a["a"].abs().max() <= 1 / 20
    assert a["a"].abs().max() > 0.95 / 20 and abs(float(a["a"].mean())) < 1e-3


def test_init_params_with_lora_starts_at_the_base_function():
    """B = 0: the LoRA tree's chunk is bitwise the tree without adapters'."""
    cfg = lora_config(torch_cfg(j_config.tiny_pizero_config()), quantize=False)
    params = t_pizero.init_params(cfg, seed=0, device="cpu")
    base = t_lora.merge_lora(params)  # B = 0: the bases as they were
    assert not t_lora.has_lora(base)
    rng = np.random.default_rng(0)
    batch = _batch(j_config.tiny_pizero_config(), 2, seed=2)
    a0 = torch.from_numpy(rng.normal(size=(2, cfg.horizon_steps, cfg.action_dim)).astype(np.float32))
    args = [torch.from_numpy(batch[k]) for k in ("input_ids", "pixel_values", "attention_mask", "proprios")]
    with_lora = t_pizero.infer_action(params, cfg, None, *args, action0=a0)
    without = t_pizero.infer_action(base, cfg, None, *args, action0=a0)
    assert torch.equal(with_lora, without)


@pytest.mark.parametrize("quantize", [False, True])
def test_merge_lora_matches_jax(quantize):
    jcfg, jparams = jax_lora_params(quantize)
    tparams = params_from_jax(jparams, device="cpu")
    for name in ("vlm",):
        scaling = jcfg.joint.mixture(name).lora_scaling
        want = _np_tree(j_lora.merge_lora(jax.tree.map(jnp.asarray, jparams["joint"]["mixtures"][name]), scaling))
        got = t_lora.merge_lora(tparams["joint"]["mixtures"][name], scaling)
        assert not t_lora.has_lora(got) and not t_lora.has_quantized_bases(got)
        got_leaves, want_leaves = dict(_leaves_with_paths(got)), dict(_leaves_with_paths(want))
        assert set(got_leaves) == set(want_leaves)
        for path, x in got_leaves.items():
            np.testing.assert_allclose(x.numpy(), want_leaves[path], rtol=0, atol=1e-6, err_msg=path)
    for key in ("siglip", "projector"):  # biased linears: the bias kept, an NF4 kernel decoded
        want = _np_tree(j_lora.merge_lora(jax.tree.map(jnp.asarray, jparams[key]), 0.5))
        got = dict(_leaves_with_paths(t_lora.merge_lora(tparams[key], 0.5)))
        assert set(got) == set(dict(_leaves_with_paths(want)))
        for path, x in _leaves_with_paths(want):
            np.testing.assert_allclose(got[path].numpy(), x, rtol=0, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("quantize", [False, True])
def test_lora_label_fn_and_extract_lora_match_jax(quantize):
    _, jparams = jax_lora_params(quantize)
    tparams = params_from_jax(jparams, device="cpu")
    labels = t_lora.lora_label_fn(tparams)
    assert labels == j_lora.lora_label_fn(jparams)
    # the leaves labelled "lora" are exactly the adapters JAX's extract_lora picks out
    lora_paths = {p for (p, _), lab in zip(_leaves_with_paths(tparams), tree_leaves(labels)) if lab == "lora"}
    assert lora_paths == set(_shapes(j_lora.extract_lora(jparams))) and all("_lora/" in p for p in lora_paths)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("lora", [False, True])
@pytest.mark.parametrize("train_vlm", [True, False])
def test_labels_and_counts_match_jax(quantize, lora, train_vlm):
    _, jparams = jax_lora_params(quantize)
    tparams = params_from_jax(jparams, device="cpu")
    assert t_opt.param_labels(tparams, train_vlm, lora=lora) == j_opt.param_labels(jparams, train_vlm, lora=lora)
    got = t_opt.trainable_param_count(tparams, train_vlm)
    assert got == pytest.approx(j_opt.trainable_param_count(jparams, train_vlm), abs=1e-12)
    if quantize:  # NF4 payloads and their absmax always frozen
        labels = t_opt.param_labels(tparams, train_vlm, lora=lora)
        assert labels["joint"]["mixtures"]["vlm"]["layers"]["mlp"]["gate"] == {"q4": "frozen", "absmax": "frozen"}
        assert labels["siglip"]["layers"]["attn"]["q"]["kernel"] == {"q4": "frozen", "absmax": "frozen"}


def test_golden_lora_forward_replay():
    """The reference's LoRA JointModel (unmerged adapters, train mode,
    dropout 0) through the JAX converter into the port."""
    payload = golden.load_fixture_or_skip("lora_forward")
    jcfg = _joint_config(GEOM, MIX, lora_vlm_r=4)
    params = params_from_jax(_np_tree(_convert_ref_state(payload["state"], jcfg)), device="cpu")
    assert "q_lora" in params["mixtures"]["vlm"]["layers"]["attn"]
    assert "gate_lora" in params["mixtures"]["vlm"]["layers"]["mlp"]
    mask, pos = _mask_and_pos(payload["cnt"], LENS)
    got = t_joint.joint_forward(
        params, torch_cfg(jcfg),
        {n: torch.from_numpy(v) for n, v in payload["embeds"].items()},
        {n: torch.from_numpy(np.array(p)) for n, p in pos.items()},
        torch.from_numpy(np.array(mask)),
    )["action"]
    np.testing.assert_allclose(got.detach().numpy(), payload["want"], rtol=2e-4, atol=2e-5)


def _trained(tparams, labels):
    """The trained leaves by path."""
    return {p: x for (p, x), lab in zip(_leaves_with_paths(tparams), tree_leaves(labels)) if lab != "frozen"}


@pytest.mark.parametrize("remat", [False, True])
def test_qlora_loss_and_trained_grads_match_jax(remat):
    jcfg, jparams = jax_lora_params(quantize=True)
    jcfg = dataclasses.replace(jcfg, joint=dataclasses.replace(jcfg.joint, remat=remat))
    tcfg = torch_cfg(jcfg)
    batch = _batch(jcfg, 2, seed=3)
    want_loss, want_grads = jax.value_and_grad(lambda p: _jax_loss(p, jcfg, batch), allow_int=True)(
        jax.tree.map(jnp.asarray, jparams)
    )
    tparams = params_from_jax(jparams, device="cpu")
    labels = t_opt.param_labels(tparams, lora=True)
    trained = _trained(tparams, labels)
    for x in trained.values():
        x.requires_grad_(True)
    loss = _torch_loss(tparams, tcfg, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **TOL)
    want = dict(_leaves_with_paths(_np_tree(want_grads)))
    assert any("_lora" in p for p in trained) and any(p.startswith("/joint/mixtures/action") for p in trained)
    assert not any("/q4" in p or "absmax" in p for p in trained)
    for path, x in trained.items():
        np.testing.assert_allclose(x.grad.numpy(), want[path], **TOL, err_msg=path)


def _jax_qlora_step(jparams, jcfg, j_train, batch, accum, zero_frozen=False):
    """The JAX package's step with injected t / x0 on a QLoRA tree: mean
    loss and grads over the microbatches (integer tangents zeroed, as its
    train step does), the optax update with 8-bit states. With
    ``zero_frozen`` the grads of the leaves labelled frozen are zeroed
    before the update, so that its clip norm counts the trained leaves
    only, as the port's does."""
    tx = j_opt.build_optimizer(j_train, jparams)
    value_and_grad = jax.jit(jax.value_and_grad(lambda p, mb: _jax_loss(p, jcfg, mb), allow_int=True))
    grads, loss = None, 0.0
    for i in range(accum):
        mb = {k: v[i] for k, v in batch.items()}
        l, g = value_and_grad(jparams, mb)
        g = jax.tree.map(lambda p, gg: gg if jnp.issubdtype(p.dtype, jnp.inexact) else jnp.zeros(p.shape, jnp.float32), jparams, g)
        loss += l / accum
        grads = jax.tree.map(lambda g_: g_ / accum, g) if grads is None else jax.tree.map(lambda a, b: a + b / accum, grads, g)
    if zero_frozen:
        labels = j_opt.param_labels(jparams, j_train.train_vlm, lora=j_train.lora)
        grads = jax.tree.map(lambda g_, lab: jnp.zeros_like(g_) if lab == "frozen" else g_, grads, labels)
    # jitted: eager optax over every leaf takes several times as long
    updates, opt_state = jax.jit(tx.update)(grads, jax.jit(tx.init)(jparams), jparams)
    return float(loss), grads, optax.apply_updates(jparams, updates), opt_state


def _check_qlora_step(max_grad_norm: float, zero_frozen: bool, adam_eps: float = 1e-8, atol: float = 5e-2 * LR) -> dict:
    """One QLoRA update (NF4 bases, LoRA adapters, int8 Adam moments,
    grad_accum 2) in the port against JAX's, params within ``atol``;
    returns the port's metrics."""
    jcfg, jparams = jax_lora_params(quantize=True)
    tcfg = torch_cfg(jcfg)
    sched = j_config.LRSchedulerConfig(warmup_steps=0)
    j_train = j_config.TrainingConfig(
        action_lr=LR, vlm_lr=LR, action_lr_scheduler=sched, vlm_lr_scheduler=sched,
        quantize_optimizer_states=True, lora=True, max_grad_norm=max_grad_norm, adam_eps=adam_eps,
    )
    t_train_cfg = torch_cfg(j_train)
    batch = _batch(jcfg, 2, seed=10, accum=2)
    jp = jax.tree.map(jnp.asarray, jparams)
    want_loss, grads, want_params, _ = _jax_qlora_step(jp, jcfg, j_train, batch, 2, zero_frozen)

    tparams = params_from_jax(jparams, device="cpu")
    before = {p: x.clone() for p, x in _leaves_with_paths(tparams)}
    optimizer = t_opt.build_optimizer(t_train_cfg, tparams)
    state = t_train.init_train_state(tparams, optimizer, torch.Generator(), t_train_cfg)
    assert isinstance(state.opt_state, t_qadam.AdamW8bit)
    step = t_train.make_train_step(tcfg, t_train_cfg, optimizer, grad_accum=2)
    metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-5)

    labels = t_opt.param_labels(tparams, lora=True)
    trained_grads = [g for g, lab in zip(jax.tree.leaves(j_opt.apply_freeze_surgery(grads)), tree_leaves(labels))
                     if lab != "frozen"]
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(trained_grads)), rtol=1e-4)
    want = dict(_leaves_with_paths(_np_tree(want_params)))
    moved = 0
    for path, x in _leaves_with_paths(tparams):
        np.testing.assert_allclose(x.detach().numpy(), want[path], rtol=0, atol=atol, err_msg=path)
        if not torch.equal(x, before[path]):
            moved += 1
            assert path in _trained(tparams, labels), path
    assert moved > 0
    # the NF4 bases and embed_tokens bitwise unchanged
    for path, x in _leaves_with_paths(tparams):
        if "/q4" in path or "absmax" in path or path == "/embed_tokens":
            assert torch.equal(x, before[path]), path
    return metrics


def test_qlora_grad_accum_step_with_8bit_states_matches_jax():
    """One QLoRA update (NF4 bases, LoRA adapters, int8 Adam moments,
    grad_accum 2). max_grad_norm is raised so that neither side clips: the
    JAX package clips over the frozen float leaves' grads as well (NF4
    absmax, SigLIP's biases; ROADMAP.md §3), the port over the trained
    leaves only, which is checked against JAX's grads of those leaves."""
    metrics = _check_qlora_step(max_grad_norm=1e6, zero_frozen=False)
    assert float(metrics["grad_norm"]) < 1e6


def test_qlora_step_with_clipping_matches_jax_on_trained_grads():
    """The same update with the clip active, as in the QLoRA recipe
    (max_grad_norm 1 against grad norms of tens at full width): the port
    against JAX's optax chain fed JAX's grads with the frozen leaves'
    zeroed, so that the two differ in nothing but the clip norm's leaves,
    the deliberate difference of ROADMAP.md §3.

    A first Adam update is g / (|g| + eps) and barely sees the clip's
    scale at eps 1e-8. eps 1e-4, near the clipped grads' median (about
    1e-4 at this size), makes the update follow the scale, and it damps the
    noise of grads near zero, so the params are held to 1e-3 * lr (they
    agree to about 4e-5 * lr). Fed its unzeroed grads, JAX's clip over all
    float leaves (the frozen grads add about 3.5% to the norm here) misses
    by about 9e-3 * lr."""
    max_grad_norm = 1.0
    metrics = _check_qlora_step(max_grad_norm, zero_frozen=True, adam_eps=1e-4, atol=1e-3 * LR)
    assert float(metrics["grad_norm"]) > 2 * max_grad_norm  # the clip scaled every grad


def test_ema_of_a_qlora_tree_matches_jax():
    """EMA over a QLoRA tree: the integer payloads pass through unaveraged
    (their dtype kept), the float leaves blend as JAX blends them."""
    from open_pi_zero_torch import config as t_config
    from open_pi_zero_torch.training import averaging as t_avg
    from open_pi_zero_tpu.training import averaging as j_avg

    _, jparams = jax_lora_params(quantize=True)
    kw = dict(use_ema=True, ema_start=0, ema_freq=1)
    jstate = j_avg.init_averaging(jax.tree.map(jnp.asarray, jparams))
    tstate = t_avg.init_averaging(params_from_jax(jparams, device="cpu"))
    rng = np.random.default_rng(5)
    j_update = jax.jit(j_avg.maybe_update, static_argnums=3)
    for update in range(3):
        live = jax.tree.map(
            lambda x: x + rng.normal(size=x.shape).astype(np.float32) if x.dtype == np.float32 else x, jparams)
        jstate = j_update(jstate, jax.tree.map(jnp.asarray, live), jnp.int32(update), j_config.TrainingConfig(**kw))
        tstate = t_avg.maybe_update(tstate, params_from_jax(live, device="cpu"), update, t_config.TrainingConfig(**kw))
    want = dict(_leaves_with_paths(_np_tree(jstate.avg_params)))
    for path, x in _leaves_with_paths(tstate.avg_params):
        assert str(x.dtype)[6:] == str(want[path].dtype), path
        np.testing.assert_allclose(x.numpy(), want[path], rtol=1e-6, atol=1e-6, err_msg=path)
