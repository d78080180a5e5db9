"""The port in bf16 against the JAX package on the CPU: biased linears
round once, as JAX's ``linear`` does (the fp32 product plus the bias in
fp32, then one cast).

Inputs are made with numpy from a seed, the params with JAX's
``init_params`` and cast to bf16 on both sides.

Tolerances, with their reasons:
- bf16 ``linear`` with a bias: at most 0.1% of the elements differ, each by
  at most one bf16 ulp (counted at 2^-10 for smaller values). The port on
  the CPU widens the bf16 operands to fp32 and sums in another order than
  XLA, so an fp32 product that lies next to a bf16 rounding boundary may
  round the other way. Rounding the product and then adding the bias in
  bf16 differed in 27.5% of them.
- bf16 ``linear`` without a bias: bitwise (one rounding on both sides).
- SigLIP in bf16 against JAX's compiled tower: max|Δ| <= 0.02 on input
  seed 0. XLA's default ``xla_allow_excess_precision`` drops bf16 round
  trips inside its fusions, so the compiled tower rounds at other points
  than its ops say (tanh-GELU among them, which the port takes as
  ``F.gelu``, rounded once); no PyTorch op order follows XLA's fusions.
  On other seeds the gap reaches 0.0234, 1.5 bf16 ulps at the outputs'
  largest values (|y| ~ 3), as between JAX's own tower compiled with and
  without excess precision. So over input seeds 0-7 the port's bf16 tower
  is held to the fp32 tower (JAX's, on the same bf16 weights): no farther
  than JAX's bf16 tower is, plus one bf16 ulp of the largest output.
- ``infer_action`` in bf16, seeds 0-3: max|Δ| <= 1e-2, a bit more than one
  bf16 ulp of the largest action values (|a| ~ 1-2, ulp 0.0078).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models import siglip as t_siglip
from open_pi_zero_torch.models.from_jax import params_from_jax
from open_pi_zero_torch.ops import linear as t_lin
from open_pi_zero_tpu.config import tiny_pizero_config
from open_pi_zero_tpu.models import pizero as j_pizero
from open_pi_zero_tpu.models import siglip as j_siglip
from open_pi_zero_tpu.ops import linear as j_lin
from tests.test_torch_models import example_inputs, torch_cfg


def _bf16(a: np.ndarray):
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _bits(x) -> np.ndarray:
    """bf16 values as their int16 bit patterns (one ulp = 1 apart)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).view(np.int16).astype(np.int32)


ULP_FLOOR = 2.0**-10  # below it, fp32 summation noise exceeds a bf16 ulp


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits), counted at ULP_FLOOR for
    smaller values."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), ULP_FLOOR))) - 7)


def assert_rounds_once(got: torch.Tensor, want, share: float = 1e-3) -> None:
    """At most ``share`` of the bf16 elements differ, each by at most one
    bf16 ulp. Near zero an ulp is finer than the noise of the fp32 sums
    that both sides round (an output of 1e-5 can differ by 3 of its ulps,
    1.8e-7, from another summation order), so the ulp is counted at
    ``ULP_FLOOR`` there."""
    g, w = got.double().numpy(), np.asarray(want, np.float64)
    differ = g != w
    assert differ.mean() <= share, f"{differ.mean():.4%} of the elements differ"
    worst = float((np.abs(g - w) / bf16_ulp(np.maximum(np.abs(g), np.abs(w)))).max())
    assert worst <= 1.0, f"an element differs by {worst} bf16 ulps"


@pytest.fixture(scope="module")
def linear_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 1152)).astype(np.float32)
    w = (rng.normal(size=(1152, 1152)) / 34).astype(np.float32)
    b = (0.1 * rng.normal(size=1152)).astype(np.float32)
    return x, w, b


def test_bf16_biased_linear_rounds_once(linear_inputs):
    (jx, tx), (jw, tw), (jb, tb) = (_bf16(a) for a in linear_inputs)
    assert_rounds_once(t_lin.linear(tx, tw, tb), j_lin.linear(jx, jw, jb))


def test_bf16_unbiased_linear_is_bitwise_jax(linear_inputs):
    (jx, tx), (jw, tw) = (_bf16(a) for a in linear_inputs[:2])
    np.testing.assert_array_equal(_bits(t_lin.linear(tx, tw)), _bits(j_lin.linear(jx, jw)))


def test_fp32_paths_unchanged(linear_inputs):
    """fp32 keeps the arithmetic it had: one matmul plus the bias."""
    x, w, b = (torch.from_numpy(a) for a in linear_inputs)
    assert torch.equal(t_lin.linear(x, w, b), torch.matmul(x, w) + b)


@pytest.fixture(scope="module")
def tiny_bf16():
    jcfg = tiny_pizero_config()
    jparams = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16), j_pizero.init_params(jax.random.key(0), jcfg)
    )
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, torch_cfg(jcfg), jparams, tparams


@pytest.fixture(scope="module")
def siglip_towers(tiny_bf16):
    """JAX's compiled SigLIP tower in bf16 and in fp32 (the same bf16
    weights, widened), and the port's bf16 tower."""
    jcfg, tcfg, jparams, tparams = tiny_bf16
    forward = jax.jit(lambda p, x: j_siglip.forward(p, jcfg.siglip, x))
    jparams32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams["siglip"])

    def towers(seed: int):
        jpix, tpix = _bf16(example_inputs(jcfg, seed=seed)[1])
        jax_bf16 = np.asarray(forward(jparams["siglip"], jpix), np.float32)
        jax_fp32 = np.asarray(forward(jparams32, jpix.astype(jnp.float32)))
        port = t_siglip.forward(tparams["siglip"], tcfg.siglip, tpix).float().numpy()
        return port, jax_bf16, jax_fp32

    return towers


def test_bf16_siglip_tower_close_to_jax(siglip_towers):
    port, jax_bf16, _ = siglip_towers(0)
    err = float(np.abs(port - jax_bf16).max())
    assert err <= 0.02, f"bf16 SigLIP max|diff| {err}"


@pytest.mark.parametrize("seed", range(8))
def test_bf16_siglip_tower_as_close_to_fp32_as_jax(siglip_towers, seed):
    port, jax_bf16, jax_fp32 = siglip_towers(seed)
    port_err, jax_err = float(np.abs(port - jax_fp32).max()), float(np.abs(jax_bf16 - jax_fp32).max())
    ulp = float(bf16_ulp(np.abs(jax_fp32).max()))
    print(f"seed {seed}: max|diff| port vs JAX bf16 {np.abs(port - jax_bf16).max():.4f}, "
          f"port vs JAX fp32 {port_err:.4f}, JAX bf16 vs JAX fp32 {jax_err:.4f}, one ulp {ulp}")
    assert port_err <= jax_err + ulp, f"port bf16 {port_err} vs JAX bf16 {jax_err} from the fp32 tower"


@pytest.mark.parametrize("seed", range(4))
def test_bf16_infer_action_close_to_jax(tiny_bf16, seed):
    jcfg, tcfg, jparams, tparams = tiny_bf16
    ids, pix, am, prop, a0 = example_inputs(jcfg, seed=seed)
    (jpix, tpix), (jprop, tprop), (ja0, ta0) = (_bf16(a) for a in (pix, prop, a0))
    want = j_pizero.infer_action(
        jparams, jcfg, jax.random.key(0), jnp.asarray(ids), jpix, jnp.asarray(am), jprop, action0=ja0
    )
    got = t_pizero.infer_action(
        tparams, tcfg, None, torch.from_numpy(ids), tpix, torch.from_numpy(am), tprop, action0=ta0
    )
    assert got.dtype == torch.bfloat16
    err = float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max())
    assert err <= 1e-2, f"bf16 infer_action seed {seed}: max|diff| {err}"
