"""The port's small leftovers against the JAX package on the CPU:
``ops/lora.extract_lora`` (the same paths and values as JAX's),
``training/checkpoint.save_params`` (read back bitwise by
``restore_params``, meta included), ``utils/spec.py`` (``create`` and
``to_string`` give JAX's output, ``instantiate`` the same result) and
``training/sampling.sample_flow_time`` for Beta(alpha, beta): its law
against ``scipy.stats.beta`` (mean within 5 standard errors, the 0.1, 0.5
and 0.9 quantiles within 0.01, Kolmogorov-Smirnov p > 1e-4, and a
two-sample KS against JAX's draws), the generators differing; beta = 1
draws bitwise what the sampler drew before Beta(alpha, beta) was added,
from the same generator state."""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import scipy.stats
import torch

from open_pi_zero_torch import config as t_config
from open_pi_zero_torch.models.from_jax import params_from_jax
from open_pi_zero_torch.ops import lora as t_lora
from open_pi_zero_torch.training import checkpoint as t_ckpt
from open_pi_zero_torch.training import sampling as t_sampling
from open_pi_zero_torch.utils import spec as t_spec
from open_pi_zero_tpu import config as j_config
from open_pi_zero_tpu.ops import lora as j_lora
from open_pi_zero_tpu.training import sampling as j_sampling
from open_pi_zero_tpu.utils import spec as j_spec
from tests.test_torch_lora import jax_lora_params

N_DRAWS = 200_000


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in paths(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("quantize", [False, True])
def test_extract_lora_is_jax_s(quantize):
    _, jparams = jax_lora_params(quantize)
    want = paths(j_lora.extract_lora(jparams))
    got = paths(t_lora.extract_lora(params_from_jax(jparams, device="cpu")))
    assert [p for p, _ in got] == [p for p, _ in want] and len(got) > 4
    assert all(p.split("/")[-2].endswith("_lora") for p, _ in got)
    for (p, a), (_, b) in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), p
    assert t_lora.extract_lora({"a": {"kernel": torch.zeros(2)}}) == j_lora.extract_lora({"a": {"kernel": 0}}) == {}


@pytest.mark.parametrize("quantize", [False, True])
def test_save_params_restores_bitwise_with_its_meta(tmp_path, quantize):
    _, jparams = jax_lora_params(quantize)
    params = params_from_jax(jparams, device="cpu")
    path = str(tmp_path / "export")
    t_ckpt.save_params(path, params, extra={"cnt_batch": 7})
    assert t_ckpt.is_checkpoint(path) and not os.path.exists(os.path.join(path, t_ckpt.STATE_DIR))
    with open(os.path.join(path, t_ckpt.META_FILE)) as f:
        meta = json.load(f)
    assert meta == {"cnt_batch": 7, **({"quant_layout_version": t_ckpt.QUANT_LAYOUT_VERSION} if quantize else {})}
    back = t_ckpt.restore_params(path, params, device="cpu")
    for (p, a), (q, b) in zip(paths(back), paths(params)):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b), p
    assert not [f for f in os.listdir(path) if f.endswith(".tmp")]


def test_spec_is_jax_s():
    cases = [(np.linspace, (0, 1), {"num": 5}), ("numpy:clip", (), {"a_min": 0.0, "a_max": 1.0}),
             (functools.reduce, (), {}), ("math:hypot", (3.0, 4.0), {})]
    for target, args, kwargs in cases:
        got, want = t_spec.create(target, *args, **kwargs), j_spec.create(target, *args, **kwargs)
        assert got == want and t_spec.to_string(got) == j_spec.to_string(want)
    spec = t_spec.create(np.linspace, 0, 1, num=5)
    assert np.array_equal(t_spec.instantiate(spec)(), j_spec.instantiate(spec)())
    clip = t_spec.create("numpy:clip", a_min=0.0, a_max=1.0)
    x = np.array([-1.0, 0.5, 2.0])
    assert np.array_equal(t_spec.instantiate(clip)(x), j_spec.instantiate(clip)(x))
    for bad in ("numpy.clip", "a:b:c"):
        for lib in (t_spec, j_spec):
            with pytest.raises(ValueError, match="fully qualified"):
                lib.create(bad)
    for lib in (t_spec, j_spec):
        with pytest.raises(ValueError, match="cannot infer"):
            lib.create(3)
        with pytest.raises(ValueError, match="ModuleSpec"):
            lib.instantiate({"module": "numpy"})


def beta_cfg(module, alpha, beta):
    return dataclasses.replace(module.PiZeroConfig(), flow_sampling="beta", flow_alpha=alpha, flow_beta=beta)


@pytest.mark.parametrize("alpha,beta", [(1.5, 1.0), (1.5, 2.0), (2.0, 3.0)])
def test_beta_flow_times_follow_the_law(alpha, beta):
    import jax

    cfg = beta_cfg(t_config, alpha, beta)
    t = t_sampling.sample_flow_time(torch.Generator().manual_seed(0), N_DRAWS, cfg)
    assert t.dtype == torch.float32 and t.shape == (N_DRAWS,)
    z = (1.0 - t.double().numpy() / (1.0 - cfg.flow_sig_min))
    law = scipy.stats.beta(alpha, beta)
    assert abs(z.mean() - law.mean()) < 5 * law.std() / np.sqrt(N_DRAWS)
    for q in (0.1, 0.5, 0.9):
        assert abs(np.quantile(z, q) - law.ppf(q)) < 0.01, q
    assert scipy.stats.kstest(z, law.cdf).pvalue > 1e-4
    jt = np.asarray(j_sampling.sample_flow_time(jax.random.key(0), N_DRAWS, beta_cfg(j_config, alpha, beta)))
    assert scipy.stats.ks_2samp(t.numpy(), jt).pvalue > 1e-4


def test_beta_one_draws_what_it_drew_before():
    """beta = 1 keeps the sampler's earlier branch: U^(1/alpha) from one
    uniform draw per sample, so resumed runs replay their stream."""
    cfg = beta_cfg(t_config, 1.5, 1.0)
    for device_seed in (0, 1234):
        g, ref = torch.Generator().manual_seed(device_seed), torch.Generator().manual_seed(device_seed)
        for bsz in (1, 16, 33):
            got = t_sampling.sample_flow_time(g, bsz, cfg)
            u = torch.rand((bsz,), generator=ref)
            want = ((1.0 - cfg.flow_sig_min) * (1.0 - u.pow(1.0 / cfg.flow_alpha))).to(torch.float32)
            assert torch.equal(got, want)
        assert torch.equal(g.get_state(), ref.get_state())
