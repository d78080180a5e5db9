"""The refined steady-state tier and the no-cache oracle of the port
(``pizero.renoise_chunk``, ``infer_action_refined``,
``infer_action_naive``) against the JAX package's at the tiny config, fp32
on the CPU, with the same injected noise (JAX's own draws, handed over as
numpy): 1e-4, as the other ``infer_action`` comparisons. Then the port's
cached chunk against its naive chunk at JAX's tolerance for the same
oracle (``tests/test_pizero.py``), and the exact contracts: a run to
t = 0.5 resumed to 1 is bitwise the full run, and the refined chunk is the
chunk integrated from the re-noised one."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_tpu.models import pizero as j_pizero
from tests.test_torch_models import TOL, example_inputs, tiny  # noqa: F401 (a fixture)

NAIVE_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_pizero.py: the cached == naive oracle


def both(cfgs, **kw):
    return tuple(dataclasses.replace(c, **kw) for c in cfgs)


def as_jax(xs):
    return tuple(jnp.asarray(x) for x in xs)


def as_torch(xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


@pytest.mark.parametrize("t_start", [0.0, 0.3, 0.5, 1.0])
def test_renoise_chunk_matches_jax(tiny, t_start):
    jcfg, tcfg, _, _ = tiny
    prev = np.random.default_rng(0).normal(size=(2, jcfg.horizon_steps, jcfg.action_dim)).astype(np.float32)
    key = jax.random.key(3)
    x0 = np.array(jax.random.normal(key, prev.shape, jnp.float32))
    want = j_pizero.renoise_chunk(jcfg, key, jnp.asarray(prev), t_start)
    got = t_pizero.renoise_chunk(tcfg, None, torch.from_numpy(prev), t_start, x0=torch.from_numpy(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("integrator", ["euler", "midpoint"])
@pytest.mark.parametrize("t_start", [0.5, 0.3])
def test_infer_action_refined_matches_jax(tiny, integrator, t_start):
    jcfg, tcfg, jparams, tparams = both(tiny[:2], flow_integrator=integrator) + tiny[2:]
    ids, pix, am, prop, prev = example_inputs(jcfg, seed=1)
    key = jax.random.key(6)
    x0 = np.array(jax.random.normal(jax.random.split(key)[0], prev.shape, jnp.float32))  # JAX's draw
    want = j_pizero.infer_action_refined(jparams, jcfg, key, *as_jax((ids, pix, am, prop, prev)), t_start=t_start)
    got = t_pizero.infer_action_refined(
        tparams, tcfg, None, *as_torch((ids, pix, am, prop, prev)), t_start=t_start, x0=torch.from_numpy(x0)
    )
    assert tuple(got.shape) == (2, jcfg.horizon_steps, jcfg.action_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("integrator", ["euler", "midpoint"])
def test_infer_action_naive_matches_jax(tiny, integrator):
    jcfg, tcfg, jparams, tparams = both(tiny[:2], flow_integrator=integrator) + tiny[2:]
    ids, pix, am, prop, _ = example_inputs(jcfg, seed=2)
    key = jax.random.key(7)
    a0 = np.array(jax.random.normal(key, (2, jcfg.horizon_steps, jcfg.action_dim), jnp.float32))
    want = j_pizero.infer_action_naive(jparams, jcfg, key, *as_jax((ids, pix, am, prop)))
    got = t_pizero.infer_action_naive(tparams, tcfg, None, *as_torch((ids, pix, am, prop)), action0=torch.from_numpy(a0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("integrator,steps", [("euler", 10), ("midpoint", 8)])
def test_cached_matches_naive(tiny, integrator, steps):
    _, tcfg, _, tparams = tiny
    (tcfg,) = both((tcfg,), flow_integrator=integrator, num_inference_steps=steps)
    ids, pix, am, prop, a0 = as_torch(example_inputs(tcfg, seed=3))
    cached = t_pizero.infer_action(tparams, tcfg, None, ids, pix, am, prop, action0=a0)
    naive = t_pizero.infer_action_naive(tparams, tcfg, None, ids, pix, am, prop, action0=a0)
    np.testing.assert_allclose(cached.numpy(), naive.numpy(), **NAIVE_TOL)


def test_segment_resume_is_bitwise_the_full_run(tiny):
    """4 steps: delta_t = 0.25 is exact in fp32, so [0, 0.5] then [0.5, 1]
    runs the full run's velocity evals on the same values."""
    _, tcfg, _, tparams = tiny
    (cfg4,) = both((tcfg,), num_inference_steps=4)
    ids, pix, am, prop, a0 = as_torch(example_inputs(cfg4, seed=4))
    full = t_pizero.infer_action(tparams, cfg4, None, ids, pix, am, prop, action0=a0)
    mid = t_pizero.infer_action(tparams, cfg4, None, ids, pix, am, prop, action0=a0, t_end=0.5)
    resumed = t_pizero.infer_action(tparams, cfg4, None, ids, pix, am, prop, action0=mid, t_start=0.5)
    assert torch.equal(resumed, full)
    assert (mid - full).abs().max() > 1e-4  # the mid state is not the end


def test_refined_is_the_flow_from_the_renoised_chunk_and_draws_once(tiny):
    """The refined chunk is ``infer_action`` from ``renoise_chunk``'s state
    at t_start, bitwise; its one draw from the generator is the
    re-noising's, so a generator seeded alike then draws the same next."""
    _, tcfg, _, tparams = tiny
    ids, pix, am, prop, prev = as_torch(example_inputs(tcfg, seed=5))
    g1, g2 = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    refined = t_pizero.infer_action_refined(tparams, tcfg, g1, ids, pix, am, prop, prev, t_start=0.5)
    x0 = torch.randn(prev.shape, generator=g2)
    start = t_pizero.renoise_chunk(tcfg, None, prev, 0.5, x0=x0)
    want = t_pizero.infer_action(tparams, tcfg, None, ids, pix, am, prop, action0=start, t_start=0.5)
    assert torch.equal(refined, want)
    assert torch.equal(torch.randn(3, generator=g1), torch.randn(3, generator=g2))
    assert (refined - prev).abs().max() > 1e-5  # not an echo of the previous chunk
