"""The port's models (open_pi_zero_torch/models) against the JAX package's
at the tiny config, fp32 on the CPU: JAX ``init_params`` -> numpy ->
``params_from_jax(..., device="cpu")``, the same numpy inputs and the same
injected noise through both.

Tolerances: 1e-4 absolute. Both sides compute in fp32; the sums run in
another order, and the differences grow through the stacked layers and
the flow steps (the action chunk agrees to about 2e-7 here)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pi_zero_torch import config as t_config
from open_pi_zero_torch.models import joint as t_joint
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models import siglip as t_siglip
from open_pi_zero_torch.models.from_jax import params_from_jax
from open_pi_zero_tpu.config import tiny_pizero_config
from open_pi_zero_tpu.models import joint as j_joint
from open_pi_zero_tpu.models import pizero as j_pizero
from open_pi_zero_tpu.models import siglip as j_siglip

TOL = dict(rtol=1e-4, atol=1e-4)


def torch_cfg(obj):
    """A JAX package config (dataclass tree) -> the port's equal config."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(t_config, type(obj).__name__)
        return cls(**{f.name: torch_cfg(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(torch_cfg(x) for x in obj)
    return obj


def example_inputs(cfg, b=2, seed=0):
    """ids/pixels/mask/proprio/noise as numpy, with one padded row."""
    rng = np.random.default_rng(seed)
    n_img = cfg.siglip.num_image_tokens
    ids = np.zeros((b, cfg.max_image_text_tokens), np.int32)
    ids[:, :n_img] = cfg.image_token_index
    ids[:, n_img] = 2
    ids[0, n_img + 1 : n_img + 4] = [10, 11, 12]
    ids[1, n_img + 1] = 13  # row 1 has more pad slots
    am = (ids != cfg.pad_token_id).astype(np.int32)
    size = cfg.siglip.image_size
    pix = rng.normal(size=(b, size, size, 3)).astype(np.float32)
    prop = rng.normal(size=(b, cfg.cond_steps, cfg.proprio_dim)).astype(np.float32)
    a0 = rng.normal(size=(b, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
    return ids, pix, am, prop, a0


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_pizero_config()
    jparams = j_pizero.init_params(jax.random.key(0), jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, torch_cfg(jcfg), jparams, tparams


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}


def test_init_params_tree_matches_jax(tiny):
    jcfg, tcfg, jparams, _ = tiny
    ours = t_pizero.init_params(tcfg, seed=0, device="cpu")
    assert _flat(ours) == _flat(jax.tree.map(np.asarray, jparams))
    assert float(ours["embed_tokens"][tcfg.pad_token_id].abs().sum()) == 0.0


def test_siglip_forward_and_project(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    pix = example_inputs(jcfg)[1]
    want = j_siglip.project(
        jparams["projector"], j_siglip.forward(jparams["siglip"], jcfg.siglip, jnp.asarray(pix))
    )
    got = t_siglip.project(
        tparams["projector"],
        t_siglip.forward(tparams["siglip"], tcfg.siglip, torch.from_numpy(pix)),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _prefix(jcfg, tcfg, jparams, tparams):
    ids, pix, am, prop, _ = example_inputs(jcfg)
    _, jpm, jam, jpos = j_pizero.prepare_action_inputs(jcfg, jnp.asarray(am))
    _, tpm, tam, tpos = t_pizero.prepare_action_inputs(tcfg, torch.from_numpy(am))
    jemb = {
        "vlm": j_pizero.embed_image_text(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pix)),
        "proprio": j_pizero.encode_proprio(jparams, jnp.asarray(prop)),
    }
    temb = {
        "vlm": t_pizero.embed_image_text(
            tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(pix)
        ),
        "proprio": t_pizero.encode_proprio(tparams, torch.from_numpy(prop)),
    }
    np.testing.assert_allclose(temb["vlm"].numpy(), np.asarray(jemb["vlm"]), **TOL)
    jkv = j_joint.joint_prefill(
        jparams["joint"], jcfg.joint, jemb,
        {"vlm": jpos["vlm"], "proprio": jpos["proprio"]}, jpm,
    )
    tkv = t_joint.joint_prefill(
        tparams["joint"], tcfg.joint, temb,
        {"vlm": tpos["vlm"], "proprio": tpos["proprio"]}, tpm,
    )
    return (jkv, jam, jpos), (tkv, tam, tpos)


def test_joint_prefill_kv_cache(tiny):
    (jkv, _, _), (tkv, _, _) = _prefix(*tiny)
    jcfg = tiny[0]
    shape = (
        jcfg.joint.num_hidden_layers, 2, jcfg.prefix_tokens,
        jcfg.joint.num_key_value_heads, jcfg.joint.head_dim,
    )
    for j, t in zip(jkv, tkv):
        assert tuple(t.shape) == shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_joint_action_step(tiny):
    jcfg, tcfg, jparams, tparams = tiny
    (jkv, jam, jpos), (tkv, tam, tpos) = _prefix(*tiny)
    rng = np.random.default_rng(1)
    act = rng.normal(size=(2, jcfg.horizon_steps, 32)).astype(np.float32)
    want = j_joint.joint_action_step(
        jparams["joint"], jcfg.joint, jnp.asarray(act), jkv, jpos["action"], jam
    )
    got = t_joint.joint_action_step(
        tparams["joint"], tcfg.joint, torch.from_numpy(act), tkv, tpos["action"], tam
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("integrator", ["euler", "midpoint"])
def test_infer_action_matches_jax(tiny, integrator):
    jcfg, tcfg, jparams, tparams = tiny
    jcfg = dataclasses.replace(jcfg, flow_integrator=integrator)
    tcfg = dataclasses.replace(tcfg, flow_integrator=integrator)
    ids, pix, am, prop, a0 = example_inputs(jcfg)
    want = j_pizero.infer_action(
        jparams, jcfg, jax.random.key(0), *(jnp.asarray(x) for x in (ids, pix, am, prop)),
        action0=jnp.asarray(a0),
    )
    got = t_pizero.infer_action(
        tparams, tcfg, None, *(torch.from_numpy(x) for x in (ids, pix, am, prop)),
        action0=torch.from_numpy(a0),
    )
    assert tuple(got.shape) == (2, jcfg.horizon_steps, jcfg.action_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_infer_action_segments_compose(tiny):
    """Resuming from the exact mid-trajectory state reproduces the full
    run (the t_start/t_end contract of the JAX package)."""
    jcfg, tcfg, _, tparams = tiny
    ids, pix, am, prop, a0 = (torch.from_numpy(x) for x in example_inputs(jcfg))
    full = t_pizero.infer_action(tparams, tcfg, None, ids, pix, am, prop, action0=a0)
    mid = t_pizero.infer_action(tparams, tcfg, None, ids, pix, am, prop, action0=a0, t_end=0.5)
    rest = t_pizero.infer_action(tparams, tcfg, None, ids, pix, am, prop, action0=mid, t_start=0.5)
    torch.testing.assert_close(rest, full, rtol=1e-6, atol=1e-6)


def test_entry_points_default_to_cuda_and_raise_without_it(tiny):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default does not raise")
    tcfg = tiny[1]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_pizero.init_params(tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"w": np.zeros(2, np.float32)})
