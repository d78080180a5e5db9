"""Data-parallel training and ZeRO-1 in the port (``training/train_step.py``
under a data mesh, ``parallel/collectives.py``, ``training/optimizer.
Zero1Optimizer``, ``parallel/sharding.Zero1Shards``) on the CPU, at the
tiny config, fp32.

Ranks run in spawned processes over gloo (``parallel.run_ranks(...,
device="cpu")``; the rank program is ``parallel/ranks.train_rank``, which
imports no JAX); one world per size is shared by the checks (module
fixtures). The JAX package's step runs here, on the global batch.

Tolerances, each with its reason:
  - DP = 2 and 4, accumulation 1 and 2, injected flow times and noise,
    against the JAX package's global-batch step: loss rtol 1e-5, grad
    norm rtol 1e-4, params atol 5e-2 * lr, as the one-device step in
    tests/test_torch_training.py (the all-reduce only reassociates the
    mean over the rows);
  - DP = 2 without injection against one rank over the same global batch
    from the same train stream: the losses within 1e-6 (relative), the
    params within 5e-2 * lr; the draws themselves are bitwise one
    device's (``_rank_rows``);
  - ZeRO-1 against replicated DP over 3 updates: bitwise (params,
    moments with their dtypes, int8 payloads and scales, EMA, counts).
"""

import dataclasses
import functools

import jax
import numpy as np
import optax
import pytest
import torch

from open_pi_zero_torch import config as t_config
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models.tree import tree_leaves
from open_pi_zero_torch.ops import lora as t_lora
from open_pi_zero_torch.ops.quantization import DEFAULT_BLOCK
from open_pi_zero_torch.parallel import Mesh, ranks, run_ranks, set_mesh, shard_batch
from open_pi_zero_torch.parallel.sharding import zero1_ranges
from open_pi_zero_torch.training import optimizer as t_opt
from open_pi_zero_torch.training import seeds
from open_pi_zero_torch.training import train_step as t_train
from open_pi_zero_tpu import config as j_config
from open_pi_zero_tpu.models import pizero as j_pizero
from open_pi_zero_tpu.training import optimizer as j_opt
from tests.test_torch_models import torch_cfg
from tests.test_torch_training import LR, _batch, _jax_loss, _leaves_with_paths, _np_tree, _train_cfgs

TIMEOUT_S = 120
ROWS_PER_RANK = 2  # the zero1 recipes' rows per rank and microbatch
GLOBAL_ROWS = 8  # the injected global microbatch: 4 rows per rank at DP = 2, 2 at DP = 4
INJECTED = [(n, accum) for n in (2, 4) for accum in (1, 2)]


def _sched():
    return dict(action_lr_scheduler=t_config.LRSchedulerConfig(warmup_steps=0),
                vlm_lr_scheduler=t_config.LRSchedulerConfig(warmup_steps=0))


def _qlora_cfg(cfg):
    """JAX's ``test_qlora_zero1_remat_pod_recipe``: NF4 vlm bases with LoRA
    r 2, remat."""
    mixtures = tuple(dataclasses.replace(m, use_lora=name == "vlm", use_quantize=name == "vlm",
                                         lora=t_config.LoraConfig(r=2))
                     for name, m in zip(cfg.joint.mixture_names, cfg.joint.mixtures))
    return dataclasses.replace(cfg, joint=dataclasses.replace(cfg.joint, mixtures=mixtures, remat=True))


ZERO1_RECIPES = {
    # (model config, training config), each over 3 updates
    "fp32_ema": (lambda c: c, dict(use_ema=True, ema_start=0)),
    "int8": (lambda c: c, dict(quantize_optimizer_states=True, use_ema=True, ema_start=0)),
    "qlora_remat": (_qlora_cfg, dict(lora=True, quantize_optimizer_states=True, use_ema=True, ema_start=0)),
}


def _recipe(name):
    model, train = ZERO1_RECIPES[name]
    return model(t_config.tiny_pizero_config()), t_config.TrainingConfig(action_lr=LR, vlm_lr=LR, **_sched(), **train)


def _drawn_batches(cfg, n, count):
    """Global batches of n x ROWS_PER_RANK rows x accumulation 2, without
    injected t or x0: the train stream draws them."""
    out = []
    for seed in range(count):
        b = _batch(cfg, n * ROWS_PER_RANK, seed=30 + seed, accum=2)
        out.append({k: v for k, v in b.items() if k not in ("t", "x0")})
    return out


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_config.tiny_pizero_config()
    return jcfg, torch_cfg(jcfg), _np_tree(j_pizero.init_params(jax.random.key(0), jcfg))


def _injected(jcfg, accum):
    """The global batch with injected t and x0, with its [accum] axis."""
    return _batch(jcfg, GLOBAL_ROWS, seed=20 + accum, accum=accum)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(jcfg):
    return jax.jit(jax.value_and_grad(lambda p, mb: _jax_loss(p, jcfg, mb)))


def _jax_global_update(jparams, jcfg, j_train, batch, accum):
    """The JAX package's one-device step on the global batch with injected
    t / x0 (``tests/test_torch_training._jax_accum_update``, jitted): the
    mean loss and grads over the microbatches, the norm after the surgery,
    the optax update."""
    grads, loss = None, 0.0
    for i in range(accum):
        mb_loss, g = _jax_value_and_grad(jcfg)(jparams, {k: v[i] for k, v in batch.items()})
        loss += mb_loss / accum
        g = jax.tree.map(lambda x: x / accum, g)
        grads = g if grads is None else jax.tree.map(lambda a, b: a + b, grads, g)
    norm = optax.global_norm(j_opt.apply_freeze_surgery(grads))
    tx = j_opt.build_optimizer(j_train, jparams)
    updates, _ = tx.update(grads, tx.init(jparams), jparams)
    return float(loss), float(norm), optax.apply_updates(jparams, updates)


def _injected_calls(tiny, n):
    jcfg, tcfg, jparams = tiny
    _, t_train_cfg = _train_cfgs()
    calls = []
    for world, accum in INJECTED:
        if world == n:
            batch = _injected(jcfg, accum)
            if accum == 1:
                batch = {k: v[0] for k, v in batch.items()}
            calls.append((ranks.train_rank, (tcfg, t_train_cfg, [batch], accum, False, jparams)))
    return calls


def _zero1_calls(names, n):
    calls = []
    for name in names:
        cfg, train_cfg = _recipe(name)
        batches = _drawn_batches(cfg, n, 3)
        calls += [(ranks.train_rank, (cfg, train_cfg, batches, 2, zero1)) for zero1 in (False, True)]
    return calls


def _no_injection_call():
    cfg, train_cfg = _recipe("fp32_ema")
    return (ranks.train_rank, (cfg, train_cfg, _drawn_batches(cfg, 2, 2), 2, False))


@pytest.fixture(scope="module")
def world2(tiny):
    calls = _injected_calls(tiny, 2) + [_no_injection_call()] + _zero1_calls(list(ZERO1_RECIPES), 2)
    out = run_ranks(ranks.sequence, 2, 1, calls, device="cpu", timeout_s=TIMEOUT_S)
    injected, no_injection, zero1 = out[:2], out[2], out[3:]
    return {"injected": dict(zip((1, 2), injected)), "no_injection": no_injection,
            "zero1": {name: zero1[2 * i : 2 * i + 2] for i, name in enumerate(ZERO1_RECIPES)}}


@pytest.fixture(scope="module")
def world4(tiny):
    calls = _injected_calls(tiny, 4) + _zero1_calls(["int8"], 4)
    out = run_ranks(ranks.sequence, 4, 1, calls, device="cpu", timeout_s=TIMEOUT_S)
    return {"injected": dict(zip((1, 2), out[:2])), "zero1": {"int8": out[2:4]}}


@pytest.fixture(scope="module")
def world1():
    """One rank over the global batches of the 2-rank run without injection."""
    fn, args = _no_injection_call()
    return run_ranks(fn, 1, 1, *args, device="cpu", timeout_s=TIMEOUT_S)


def _world(request, n):
    return request.getfixturevalue(f"world{n}")


# --------------------------------------------------------------------------- #
# the DP step against the JAX package's global-batch step
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n,accum", INJECTED, ids=lambda v: str(v))
def test_dp_step_matches_the_jax_global_batch_step(request, tiny, n, accum):
    jcfg, _, jparams = tiny
    j_train, _ = _train_cfgs()
    want_loss, want_norm, want_params = _jax_global_update(jparams, jcfg, j_train, _injected(jcfg, accum), accum)
    got = _world(request, n)["injected"][accum]
    np.testing.assert_allclose(got["losses"][0], want_loss, rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"][0], want_norm, rtol=1e-4)
    for (path, a), (_, b) in zip(_leaves_with_paths(got["params"]), _leaves_with_paths(_np_tree(want_params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-2 * LR, err_msg=path)


def test_dp_without_injection_equals_one_rank_over_the_global_batch(world2, world1):
    got, want = world2["no_injection"], world1
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=1e-5)
    for (path, a), (_, b) in zip(_leaves_with_paths(got["params"]), _leaves_with_paths(want["params"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=5e-2 * LR, err_msg=path)


def _mesh(n_data, data_index):
    return Mesh(n_data, 1, data_index, 0, None, None, "gloo", torch.device("cpu"))


def test_the_ranks_draw_their_rows_of_one_devices_draw():
    """Every rank draws the global microbatch's flow times and noise from
    the train stream (seeded alike) and keeps its rows: the ranks' rows
    differ, and together they are one device's draw, bitwise; without a
    mesh the draw is the one-device draw of the rank's rows."""
    cfg = t_config.tiny_pizero_config()
    draws = {}
    for n, index in ((None, 0), (2, 0), (2, 1)):
        set_mesh(None if n is None else _mesh(n, index))
        try:
            g = seeds.stream_generator(3, seeds.TRAIN)
            b = 4 if n is None else 2
            t = t_train._rank_rows(lambda rows: t_train.sample_flow_time(g, rows, cfg), b)
            x0 = t_train._rank_rows(lambda rows: torch.randn((rows, 4, 7), generator=g), b)
            draws[(n, index)] = (t, x0)
        finally:
            set_mesh(None)
    for i in range(2):
        whole = draws[(None, 0)][i]
        a, b = draws[(2, 0)][i], draws[(2, 1)][i]
        assert not torch.equal(a, b)
        assert torch.equal(torch.cat([a, b]), whole)


def test_shard_batch_splits_the_batch_axis_after_the_accumulation_axis():
    batch = {"x": torch.arange(2 * 4 * 3).reshape(2, 4, 3)}
    rows = [shard_batch(_mesh(2, i), batch, axis=1)["x"] for i in range(2)]
    assert all(r.shape == (2, 2, 3) for r in rows)
    assert torch.equal(torch.cat(rows, 1), batch["x"])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(_mesh(2, 0), {"x": torch.zeros(2, 3, 1)}, axis=1)


# --------------------------------------------------------------------------- #
# ZeRO-1
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("numel,n", [(1, 2), (2048, 2), (2049, 2), (10 * 2048, 4), (10 * 2048 - 5, 4), (3, 4)])
def test_zero1_ranges_deal_whole_blocks(numel, n):
    for k in range(n):
        ranges = zero1_ranges(numel, n, k)
        parts = sorted(r for r in ranges if r[1] > r[0])
        assert parts[0][0] == 0 and parts[-1][1] == numel
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))  # disjoint, covering
        assert all(lo % DEFAULT_BLOCK == 0 and (hi % DEFAULT_BLOCK == 0 or hi == numel) for lo, hi in parts)
        blocks = [-(-(hi - lo) // DEFAULT_BLOCK) for lo, hi in ranges]
        assert max(blocks) - min(blocks) <= 1
        if numel <= DEFAULT_BLOCK:  # one block: the last part's rank holds it
            assert ranges[(k + n - 1) % n] == (0, numel)


def _assert_bitwise(a, b, what):
    assert type(a) is type(b), what
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_bitwise(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{what}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), what
    else:
        assert a == b, what


ZERO1_CASES = [(2, name) for name in ZERO1_RECIPES] + [(4, "int8")]


@pytest.mark.parametrize("n,name", ZERO1_CASES, ids=lambda v: str(v))
def test_zero1_is_bitwise_the_replicated_update(request, n, name):
    """Over 3 updates: the params, the moments (int8 payloads and scales
    with their dtypes), each group's counts, the EMA and the losses; each
    rank holds its share of the moment bytes."""
    replicated, zero1 = _world(request, n)["zero1"][name]
    for key in ("losses", "grad_norms", "params", "opt", "avg", "n_averaged"):
        _assert_bitwise(replicated[key], zero1[key], key)
    assert replicated["n_averaged"] == 3 and all(np.isfinite(zero1["losses"]))
    total = replicated["moment_bytes"][0]
    assert replicated["moment_bytes"] == [total] * n
    assert total <= sum(zero1["moment_bytes"]) <= 1.02 * total  # every moment held once (and the step counters)
    assert max(zero1["moment_bytes"]) <= 1.25 * total / n


def test_int8_zero1_splits_a_leaf_between_blocks_the_ranks_do_not_divide(world4):
    """At 4 ranks a trained leaf of 10 int8 blocks splits 2/3/2/3 (whole
    blocks; JAX would split its 2048 axis inside the blocks), and its
    gathered moments are the replicated ones (the test above)."""
    cfg, train_cfg = _recipe("int8")
    params = t_pizero.init_params(cfg, seed=0, device="cpu")
    labels = t_opt.param_labels(params)
    trained = [x for lab, x in zip(tree_leaves(labels), tree_leaves(params)) if lab != "frozen"]
    odd = [x for x in trained if (-(-x.numel() // DEFAULT_BLOCK)) % 4 and x.numel() > 4 * DEFAULT_BLOCK]
    assert odd
    leaf_blocks = -(-odd[0].numel() // DEFAULT_BLOCK)
    split = sorted(-(-(hi - lo) // DEFAULT_BLOCK) for lo, hi in zero1_ranges(odd[0].numel(), 4))
    assert sum(split) == leaf_blocks and split[0] < split[-1]
    state = world4["zero1"]["int8"][1]["opt"]["state"]
    mu = [st["mu"] for st in state.values()]
    assert all(m.dtype == np.int8 and m.shape[1] == DEFAULT_BLOCK for m in mu)


def test_qlora_zero1_keeps_the_nf4_payloads(world2):
    """JAX's pod recipe (QLoRA bases, LoRA r 2, remat, int8 moments, EMA)
    under ZeRO-1: the NF4 payloads and their absmax are bitwise those of
    the quantized init after 3 updates; the adapters moved."""
    cfg, _ = _recipe("qlora_remat")
    params = t_lora.quantize_per_model_config(t_pizero.init_params(cfg, seed=0, device="cpu"), cfg)
    before = dict(_leaves_with_paths(params))
    after = dict(_leaves_with_paths(world2["zero1"]["qlora_remat"][1]["params"]))
    payloads = [p for p in before if p.endswith("/q4") or p.endswith("/absmax")]
    assert payloads
    for p in payloads:
        assert np.array_equal(before[p].numpy(), after[p]), p
    adapters = [p for p in before if "_lora/" in p + "/" and not np.array_equal(before[p].numpy(), after[p])]
    assert adapters
