"""The port's random init (``models/pizero.init_params``: one torch
generator) against the JAX package's (``pizero.init_params``: split
``jax.random`` keys), leaf by leaf, at the reach recipe's geometry of
``scripts/demo_closed_loop.py`` (hidden 96, 3 layers, 1,370,791 params).
The two draw other numbers by design, so what is held is the law each leaf
is drawn from.

Each side draws ``DRAWS`` inits: the port from seeds 0, 1, ..., JAX from
``jax.random.key(0)``, ``key(1)``, .... Per leaf:

- the trees have the same paths, shapes and dtypes;
- the elements that hold one value in every draw (norm weights, LayerNorm
  scales and biases, the token embedding's padding row) are the same
  elements on both sides, with the same values;
- the other elements, pooled over the draws (n values a side), hold the
  same law: the means within ``SIGMAS`` standard errors of their
  difference; the standard deviations within ``SIGMAS`` standard errors
  (a standard deviation's is at most s / sqrt(n), a uniform's and a
  normal's alike); where n >= ``BOUND_MIN_N``, the largest |x| within a
  factor ``BOUND_RATIO`` (a uniform's bound is met to 1/n, and all n fall
  below 0.8 of it with probability 0.8^n; a normal's largest of n values
  varies by some 10%); and the two-sample Kolmogorov-Smirnov distance at most
  c(1e-6) * sqrt(2 / n), c(alpha) = sqrt(-ln(alpha / 2) / 2).

The same checks hold the port's seed-0 draw alone against JAX's
``key(0)`` draw: the two inits of the reach recipe's runs.
"""

import math

import jax
import numpy as np
import pytest

from open_pi_zero_torch import config as t_config
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.scripts import demo_closed_loop
from open_pi_zero_tpu import config as j_config
from open_pi_zero_tpu.models import pizero as j_pizero

DRAWS = 8
SIGMAS = 6.0
BOUND_RATIO = 1.25
BOUND_MIN_N = 100
KS_C = math.sqrt(-math.log(1e-6 / 2) / 2)
GEOMETRY = demo_closed_loop.model_geometry(96, 3)


def flat(tree, prefix=""):
    """{'/a/b': leaf} of a nested dict."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = value
    return out


PATHS = sorted(flat(t_pizero.abstract_params(t_config.pizero_config_from_dict(t_config.ConfigDict(GEOMETRY)))))


@pytest.fixture(scope="module")
def draws():
    """{'port' | 'jax': {path: [DRAWS, *shape] float64}}."""
    t_cfg = t_config.pizero_config_from_dict(t_config.ConfigDict(GEOMETRY))
    j_cfg = j_config.pizero_config_from_dict(j_config.ConfigDict(GEOMETRY))
    port = [flat(t_pizero.init_params(t_cfg, seed=s, device="cpu")) for s in range(DRAWS)]
    ref = [flat(jax.tree.map(np.asarray, j_pizero.init_params(jax.random.key(s), j_cfg))) for s in range(DRAWS)]
    return {
        "port": {p: np.stack([d[p].numpy() for d in port]).astype(np.float64) for p in port[0]},
        "jax": {p: np.stack([d[p] for d in ref]).astype(np.float64) for p in ref[0]},
        "dtypes": {p: (str(port[0][p].dtype)[6:], str(ref[0][p].dtype)) for p in port[0]},
    }


def ks_distance(a: np.ndarray, b: np.ndarray) -> float:
    """The two-sample Kolmogorov-Smirnov distance of two equal-sized samples."""
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    return float(np.abs(np.searchsorted(a, grid, "right") - np.searchsorted(b, grid, "right")).max()) / a.size


def assert_same_law(port: np.ndarray, ref: np.ndarray, label: str) -> None:
    n = port.size
    gap = abs(port.mean() - ref.mean())
    assert gap <= SIGMAS * math.sqrt((port.var() + ref.var()) / n), f"{label}: means {port.mean()} vs {ref.mean()}"
    assert abs(port.std() - ref.std()) <= SIGMAS * ref.std() * math.sqrt(2 / n), \
        f"{label}: standard deviations {port.std()} vs {ref.std()}"
    if n >= BOUND_MIN_N:
        ratio = np.abs(port).max() / np.abs(ref).max()
        assert 1 / BOUND_RATIO <= ratio <= BOUND_RATIO, \
            f"{label}: largest |x| {np.abs(port).max()} vs {np.abs(ref).max()}"
    ks = ks_distance(port, ref)
    assert ks <= KS_C * math.sqrt(2 / n), f"{label}: Kolmogorov-Smirnov distance {ks} at n = {n}"


def test_the_trees_have_the_same_paths_shapes_and_dtypes(draws):
    assert sorted(draws["jax"]) == PATHS == sorted(draws["port"])
    for path in PATHS:
        assert draws["port"][path].shape == draws["jax"][path].shape, path
        assert draws["dtypes"][path] == ("float32", "float32"), path


@pytest.mark.parametrize("path", PATHS)
def test_each_leaf_is_drawn_from_jax_s_law(draws, path):
    port, ref = draws["port"][path], draws["jax"][path]
    fixed = {name: (x == x[0]).all(axis=0) for name, x in (("port", port), ("jax", ref))}
    np.testing.assert_array_equal(fixed["port"], fixed["jax"], err_msg=f"{path}: the elements fixed in every draw")
    np.testing.assert_array_equal(port[0][fixed["port"]], ref[0][fixed["jax"]], err_msg=f"{path}: the fixed values")
    drawn = ~fixed["port"]
    if drawn.any():
        assert_same_law(port[:, drawn].ravel(), ref[:, drawn].ravel(), f"{path} over {DRAWS} draws")
        assert_same_law(port[0][drawn], ref[0][drawn], f"{path}, seed 0 against key(0)")
