"""The port's config loader (``open_pi_zero_torch/config.py`` with its YAML
subset reader, ``yaml_subset.py``) against the JAX package's
``load_config``, which reads YAML through PyYAML: every config in
``configs/`` loads to an equal dict with the same Python types, with
``_base_`` inheritance, overrides and ``${env:...}`` set and unset; the
typed ``PiZeroConfig`` is equal field by field; and what the loader must
refuse raises."""

import dataclasses
import math
from pathlib import Path

import pytest
import yaml

from open_pi_zero_torch import config as t_config
from open_pi_zero_torch import yaml_subset
from open_pi_zero_tpu import config as j_config

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.yaml"))
ENV_VARS = ("VLA_LOG_DIR", "TRANSFORMERS_CACHE", "VLA_DATA_DIR", "OPZ_DEMO_DIR", "OPZ_DRAWER_DIR")


def assert_same(got, want, path="cfg"):
    """Equal values of the same Python types, dicts in the same key order."""
    assert type(got) is type(want), f"{path}: {type(got).__name__} {got!r} vs {type(want).__name__} {want!r}"
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), path
    else:
        assert got == want, f"{path}: {got!r} vs {want!r}"


def test_every_repo_config_is_seen():
    assert "configs/eval/bridge.yaml" in CONFIGS and "configs/train/fractal.yaml" in CONFIGS
    assert len(CONFIGS) == 11


@pytest.mark.parametrize("env", ["unset", "set"])
@pytest.mark.parametrize("path", CONFIGS)
def test_load_config_matches_jax(path, env, monkeypatch):
    for var in ENV_VARS:
        if env == "set":
            monkeypatch.setenv(var, f"/data/{var.lower()}")
        else:
            monkeypatch.delenv(var, raising=False)
    got = t_config.load_config(str(REPO / path))
    want = j_config.load_config(str(REPO / path))
    assert isinstance(got, t_config.ConfigDict)
    assert_same(dict(got), dict(want))
    # the typed model config, field by field
    assert dataclasses.asdict(t_config.pizero_config_from_dict(got)) == dataclasses.asdict(
        j_config.pizero_config_from_dict(want)
    )


OVERRIDES = [
    ["use_bf16=true", "quantize=true", "refine_from_prev=0.5"],
    ["global_batch_size=512", "mixture.vlm.hidden_size=64", "name=a run"],
    ["seed=7", "flow_integrator=midpoint", "eval_thresholds=[0.1, 0.2]", "checkpoint_path=~/ckpt.pt"],
    ["new.nested.key=1e-6", "act_steps=0x10", "x={a: 1, b: [yes, off]}", "y=", "z='quoted: #1'"],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: o[0].split("=")[0])
@pytest.mark.parametrize("path", ["configs/eval/bridge.yaml", "configs/train/bridge.yaml", "configs/eval/fractal_apple.yaml"])
def test_overrides_match_jax(path, overrides):
    got = t_config.load_config(str(REPO / path), overrides=overrides)
    want = j_config.load_config(str(REPO / path), overrides=overrides)
    assert_same(dict(got), dict(want))
    assert dataclasses.asdict(t_config.pizero_config_from_dict(got)) == dataclasses.asdict(
        j_config.pizero_config_from_dict(want)
    )


def test_base_inheritance_and_flow_mapping_match_jax(tmp_path):
    (tmp_path / "base.yaml").write_text("env:\n  task: t0\n  adapter: {name: bridge}\nn: 1\nlr: 5e-5\n")
    leaf = tmp_path / "leaf.yaml"
    leaf.write_text("_base_: base.yaml  # inherit\nenv:\n  task: t1\nm: ${eval:'${n} * 4'}\n")
    got = t_config.load_config(str(leaf), overrides=["n=5"])
    want = j_config.load_config(str(leaf), overrides=["n=5"])
    assert_same(dict(got), dict(want))
    assert got.env.adapter.name == "bridge" and got.m == 20 and got.lr == "5e-5"


SCALARS = [
    "1e-6", "1.0e-6", "5e-5", "3.", ".5", "-.5", "1.5E+3", "1_000", "0", "-0", "017", "0o17", "0x1F",
    "0b101", "190:20:30", "1:30.5", ".inf", "-.INF", ".NaN", "yes", "No", "ON", "off", "True",
    "~", "null", "", "~/.cache/x", "a #comment", "a#b", "-5", "+3", "hello world",
    "'it''s'", '"a\\tb\\u00e9"', '"train[:95%]"', "[224, 224]", "[0.05, 0.1, 0.2, 0.3, 0.5]",
    "[[1, 2], {a: [x, y], b: }]", "[]", "{}", "${eval:'25 * 4 * 10'}", "${env:A,/tmp/x}/y_${b}",
]


@pytest.mark.parametrize("text", SCALARS)
def test_values_resolve_as_pyyaml(text):
    assert_same(yaml_subset.parse_scalar_document(text), yaml.safe_load(text))
    doc = f"k: {text}\n"
    assert_same(yaml_subset.load(doc), yaml.safe_load(doc))


OUTSIDE = [
    "a:\n  - 1\n  - 2\n",  # block sequence
    "a: |\n  text\n",  # block scalar
    "a: &x 1\nb: *x\n",  # anchor, alias
    "a: !!str 1\n",  # tag
    "a: b\n  c\n",  # multi-line plain scalar
    "a: [1,\n  2]\n",  # multi-line flow sequence
    "a: 1\na: 2\n",  # duplicate key
    "---\na: 1\n",  # document marker
    "a: 2001-12-14\n",  # timestamp
    "a: b: c\n",  # a mapping in a value
    "a:\n\tb: 1\n",  # tab indentation
    "a: 'open\n",  # unclosed quote
    "  a: 1\nb: 2\n",  # indented start
]


@pytest.mark.parametrize("doc", OUTSIDE)
def test_outside_the_subset_raises_with_file_and_line(doc, tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text(doc)
    with pytest.raises(yaml_subset.YamlError, match=r"bad\.yaml:\d+: "):
        t_config.load_config(str(path))


# the probes of the JAX package's config loader, each of which must raise
def test_bad_override_raises():
    with pytest.raises(ValueError, match="key=value"):
        t_config.load_config(str(REPO / "configs/eval/bridge.yaml"), overrides=["no_equals_sign"])
    with pytest.raises(yaml_subset.YamlError, match="override value"):
        t_config.load_config(str(REPO / "configs/eval/bridge.yaml"), overrides=["x=[1, 2"])


@pytest.mark.parametrize(
    "expr",
    ["__import__('os').system('true')", "().__class__", "open('/etc/passwd')", "(lambda: 1)()", "x[0]"],
)
def test_eval_injection_raises(expr, tmp_path):
    path = tmp_path / "inject.yaml"
    path.write_text(f'x: [1]\nv: "${{eval:{expr}}}"\n')
    with pytest.raises(ValueError, match="disallowed"):
        t_config.load_config(str(path))


def test_missing_env_var_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("OPZ_SURELY_UNSET", raising=False)
    path = tmp_path / "env.yaml"
    path.write_text("v: ${env:OPZ_SURELY_UNSET}\n")
    with pytest.raises(KeyError, match="OPZ_SURELY_UNSET"):
        t_config.load_config(str(path))


def test_interpolation_and_base_cycles_raise(tmp_path):
    path = tmp_path / "cycle.yaml"
    path.write_text("a: ${b}\nb: ${a}\n")
    with pytest.raises(ValueError, match="cycle"):
        t_config.load_config(str(path))
    (tmp_path / "x.yaml").write_text("_base_: y.yaml\n")
    (tmp_path / "y.yaml").write_text("_base_: x.yaml\n")
    with pytest.raises(ValueError, match="cycle"):
        t_config.load_config(str(tmp_path / "x.yaml"))
