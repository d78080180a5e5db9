"""Multi-device inference in the port (open_pi_zero_torch/parallel, K1-shard)
against the JAX package, on the CPU.

The port runs one process per mesh position: ``run_ranks`` spawns them
over gloo with a process-group timeout, and the rank programs
(``parallel/ranks.py``) import no JAX. One world per mesh shape is shared
by the checks of that shape (module-scoped fixtures); the JAX side runs
here, in the test process, on the virtual 8-device CPU platform, with its
registered attention mesh cleared in ``finally``.

Tolerances:
  - K1-shard forward against JAX's ``mot_attention_fused_sharded``
    (interpret mode) on a 2x2 mesh: rtol/atol 2e-5, as JAX's own sharded
    test; its dq, dk, dv against ``jax.grad`` through the same call: rtol
    1e-4 / atol 1e-5 (``tests/test_pallas_attention.py``). Inside each
    rank, against the plain version on the whole inputs: 1e-5 (the same
    arithmetic, only dk/dv's all-reduce reassociates).
  - ``infer_action`` under a mesh against JAX's single-device chunk:
    1e-4, as tests/test_torch_models.py; against the port's own
    single-process chunk: 1e-5 (fp32; TP only reassociates the sums of the
    row-parallel projections, about 2e-7 here).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pi_zero_torch import config as t_config
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models.from_jax import params_from_jax
from open_pi_zero_torch.models.tree import tree_leaves
from open_pi_zero_torch.ops import attention as t_att
from open_pi_zero_torch.ops import fused_attention as t_fa
from open_pi_zero_torch.parallel import (
    MODEL_AXIS,
    Mesh,
    ranks,
    run_ranks,
    shard_batch,
    get_mesh,
    set_mesh,
    shard_params_tp,
    tp_param_specs,
)
from open_pi_zero_torch.parallel import sharding as t_sharding
from open_pi_zero_tpu.config import bridge_width_dryrun_config, tiny_pizero_config
from open_pi_zero_tpu.models import pizero as j_pizero
from open_pi_zero_tpu.ops import MASK_NEG
from open_pi_zero_tpu.ops import pallas_attention as j_pa
from open_pi_zero_tpu.parallel import make_mesh as j_make_mesh
from open_pi_zero_tpu.parallel.sharding import tp_param_specs as j_tp_param_specs
from tests.test_torch_models import example_inputs, torch_cfg

TIMEOUT_S = 120  # every collective of a world; a world takes a few seconds
# what a rank of data-parallel training imports (torchrun-launched ranks:
# tests/test_torch_dp_agent.py), and the multi-rank dryrun's ranks
DP_MODULES = (
    "open_pi_zero_torch.training.train_step", "open_pi_zero_torch.training.checkpoint",
    "open_pi_zero_torch.agents.train", "open_pi_zero_torch.scripts.run",
    "open_pi_zero_torch.scripts.dryrun_multiprocess", "open_pi_zero_torch.scripts.dryrun_multichip",
)

ATTENTION_CASES = {
    # (B, Lq, Lkv, Hq, Hkv, D) of tests/test_pallas_attention.py's sharded tests
    "mqa": (2, 37, 41, 8, 1, 32),  # the MoT trunk: one K/V head, replicated
    "sharded_kv": (2, 12, 20, 8, 4, 16),  # Hkv % tp == 0: K/V heads split too
}


def _attention_case(name, seed):
    b, lq, lkv, hq, hkv, d = ATTENTION_CASES[name]
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(b, lq, hq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, lkv, hkv, d)).astype(np.float32) for _ in range(2))
    mask = np.where(rng.random((b, 1, lq, lkv)) > 0.3, 0.0, MASK_NEG).astype(np.float32)
    mask[..., 0] = 0.0
    return dict(name=name, q=q, k=k, v=v, mask=mask, g=g, softcap=50.0, dtype="float32", tol=1e-5)


def _j_mesh(n_data, n_model):
    return j_make_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[: n_data * n_model])


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_pizero_config()
    jparams = jax.tree.map(np.asarray, j_pizero.init_params(jax.random.key(0), jcfg))
    ids, pix, am, prop, a0 = example_inputs(jcfg)
    batch = {"input_ids": ids, "pixel_values": pix, "attention_mask": am, "proprios": prop}
    return jcfg, torch_cfg(jcfg), jparams, batch, a0


def _infer_calls(tiny):
    _, tcfg, jparams, batch, a0 = tiny
    return [
        (ranks.infer_rank, (tcfg, batch, a0, jparams)),  # injected noise
        (ranks.infer_rank, (tcfg, batch, None, jparams, 3)),  # a generator seeded 3
    ]


def _tp_train_call(tiny):
    """One tensor-parallel update of the tiny model (``train_rank``, no
    reference), so that the world's last program sees what TP training
    imported."""
    _, tcfg, jparams, batch, _ = tiny
    actions = np.zeros((len(batch["input_ids"]), tcfg.horizon_steps, tcfg.action_dim), np.float32)
    return (ranks.train_rank, (tcfg, t_config.TrainingConfig(), [{**batch, "actions": actions}], 1, False, jparams))


@pytest.fixture(scope="module")
def world_2x2(tiny):
    """One (data=2, model=2) world: K1-shard on both attention cases, the
    tiny model's chunk with injected and with drawn noise, one TP update."""
    cases = [_attention_case(name, seed) for seed, name in enumerate(ATTENTION_CASES)]
    calls = [
        (ranks.attention_rank, (cases,)), *_infer_calls(tiny), _tp_train_call(tiny),
        (ranks.foreign_modules_rank, (DP_MODULES,)),
    ]
    attention, *infer, tp_train, foreign = run_ranks(
        ranks.sequence, 2, 2, calls, device="cpu", timeout_s=TIMEOUT_S
    )
    return {"cases": cases, "attention": attention, "infer": infer, "tp_train": tp_train, "foreign": foreign}


@pytest.fixture(scope="module", params=[(1, 2), (2, 1)], ids=lambda m: f"{m[0]}x{m[1]}")
def world_small(request, tiny):
    n_data, n_model = request.param
    infer = run_ranks(
        ranks.sequence, n_data, n_model, _infer_calls(tiny), device="cpu", timeout_s=TIMEOUT_S
    )
    return {"mesh": request.param, "infer": infer}


# --------------------------------------------------------------------------- #
# sharding rules
# --------------------------------------------------------------------------- #


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("config", ["tiny", "bridge"])
def test_tp_param_specs_match_jax_but_the_named_differences(config):
    jcfg = tiny_pizero_config() if config == "tiny" else bridge_width_dryrun_config()
    shapes = jax.eval_shape(lambda: j_pizero.init_params(jax.random.key(0), jcfg))
    mesh = _j_mesh(1, 2)
    try:
        want = {k: tuple(v) for k, v in _flat(j_tp_param_specs(shapes, mesh)).items()}
    finally:
        j_pa.set_attention_mesh(None)
    meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), shapes)
    got = _flat(tp_param_specs(meta, torch_cfg(jcfg), 2))
    assert got.keys() == want.keys()
    differ = {k for k in got if got[k] != want[k]}
    mixtures = [f"joint/mixtures/{n}/layers/attn" for n in ("vlm", "action")]
    # (a) the trunk's single K/V head stays whole (JAX splits its 2 x 128 halves)
    diff_a = {f"{m}/{p}" for m in mixtures for p in ("k", "v")}
    for k in diff_a:
        assert want[k] == (None, None, MODEL_AXIS) and got[k] == ()
    # (b) column-parallel biases split with their kernels (JAX: replicated)
    diff_b = {f"siglip/layers/attn/{p}/bias" for p in "qkv"} | {"siglip/layers/mlp/fc1/bias"}
    for k in diff_b:
        assert want[k] == () and got[k] == (None, MODEL_AXIS)
    assert differ == diff_a | diff_b
    # what does split, split as in JAX
    assert got["joint/mixtures/vlm/layers/attn/q"] == (None, None, MODEL_AXIS)
    assert got["joint/mixtures/vlm/layers/mlp/down"] == (None, MODEL_AXIS, None)
    assert got["siglip/layers/attn/o/bias"] == () and got["embed_tokens"] == ()


def test_tp_param_specs_split_attention_by_whole_heads():
    cfg = t_config.tiny_pizero_config()  # 4 query heads, 1 K/V head; SigLIP 4 heads
    params = t_pizero.init_params(cfg, seed=0, device="cpu")
    specs = _flat(tp_param_specs(params, cfg, 8))  # 8 ranks: no head splits evenly
    for k in ("joint/mixtures/vlm/layers/attn/q", "joint/mixtures/vlm/layers/attn/o",
              "siglip/layers/attn/q/kernel", "siglip/layers/attn/o/kernel"):
        assert specs[k] == (), k
    assert specs["joint/mixtures/vlm/layers/mlp/gate"] == (None, None, MODEL_AXIS)
    assert t_sharding.attention_split(8, 1, 2) == (True, False)
    assert t_sharding.attention_split(8, 4, 2) == (True, True)
    assert t_sharding.attention_split(8, 2, 4) == (False, False)  # JAX's non-shardable case


def test_tp_param_specs_refuse_lora_and_quantized_leaves():
    """LoRA adapters and NF4 bases are taken now (an adapter follows its
    base, an NF4 base stays whole); the int8 serving payloads are still
    refused."""
    lora = {"attn": {"q": {"kernel": torch.zeros(2, 4, 4)},
                     "q_lora": {"a": torch.zeros(2, 4, 1), "b": torch.zeros(2, 1, 4)},
                     "o_lora": {"a": torch.zeros(2, 4, 1), "b": torch.zeros(2, 1, 4)}},
            "mlp": {"fc1": {"q4": torch.zeros(2, 4, 2, dtype=torch.uint8), "absmax": torch.zeros(2, 4, 1)}}}
    specs = tp_param_specs({"siglip": {"layers": lora}}, t_config.tiny_pizero_config(), 2)["siglip"]["layers"]
    assert specs["attn"]["q_lora"] == {"a": (), "b": (None, None, MODEL_AXIS)}
    assert specs["attn"]["o_lora"] == {"a": (None, MODEL_AXIS, None), "b": ()}
    assert specs["mlp"]["fc1"] == {"q4": (), "absmax": ()}
    quant = {"mlp": {"fc1": {"q": torch.zeros(2, 4, 4, dtype=torch.int8), "scale": torch.zeros(2, 4)}}}
    with pytest.raises(NotImplementedError, match="quantized"):
        tp_param_specs({"siglip": {"layers": quant}}, t_config.tiny_pizero_config(), 2)


def _cpu_mesh(n_data, n_model, data_index, model_index):
    return Mesh(n_data, n_model, data_index, model_index, None, None, "gloo", torch.device("cpu"))


def test_shard_params_tp_concatenates_back():
    cfg = t_config.tiny_pizero_config()
    params = t_pizero.init_params(cfg, seed=0, device="cpu")
    specs = _flat(tp_param_specs(params, cfg, 2))
    shards = [_flat(shard_params_tp(params, cfg, _cpu_mesh(1, 2, 0, m))) for m in range(2)]
    n_split = 0
    for path, leaf in _flat(params).items():
        spec = specs[path]
        if not spec:
            assert all(s[path] is leaf for s in shards), path  # replicated: the same tensor
            continue
        n_split += 1
        dim = spec.index(MODEL_AXIS)
        assert all(s[path].is_contiguous() and s[path].data_ptr() != leaf.data_ptr() for s in shards)
        torch.testing.assert_close(torch.cat([s[path] for s in shards], dim=dim), leaf, rtol=0, atol=0)
    # q, o, gate, up, down of the vlm and action experts (proprio is tied):
    # 10; SigLIP q, k, v and fc1 kernels and biases, o and fc2 kernels: 10
    assert n_split == 20


def test_shard_batch_keeps_the_data_rows():
    batch = {"x": torch.arange(12).reshape(4, 3), "y": torch.arange(4)}
    got = [shard_batch(_cpu_mesh(2, 2, d, 1), batch) for d in range(2)]
    assert torch.equal(got[1]["x"], batch["x"][2:]) and torch.equal(got[0]["y"], batch["y"][:2])
    with pytest.raises(ValueError, match="split"):
        shard_batch(_cpu_mesh(3, 1, 0, 0), batch)


# --------------------------------------------------------------------------- #
# K1-shard
# --------------------------------------------------------------------------- #


def test_dispatch_under_a_mesh_goes_to_k1_shard(monkeypatch):
    case = _attention_case("mqa", 0)
    q, k, v, mask = (torch.from_numpy(case[n]) for n in ("q", "k", "v", "mask"))
    called = []
    orig = t_fa.mot_attention_fused_sharded
    monkeypatch.setattr(t_fa, "mot_attention_fused_sharded", lambda *a: called.append(a[5]) or orig(*a))
    set_mesh(_cpu_mesh(1, 2, 0, 0))  # what parallel.make_mesh registers
    try:
        got = t_att.mot_attention(q[:, :, :4], k, v, mask, 50.0, True)
        with pytest.raises(ValueError, match="K1-shard"):
            t_att.mot_attention(q[:, :, :4], torch.cat([k, k], dim=2), torch.cat([v, v], dim=2), mask, 50.0, True)
    finally:
        set_mesh(None)
    assert get_mesh() is None
    assert called == [True, True]
    torch.testing.assert_close(got, t_att.mot_attention_ref(q, k, v, mask)[:, :, :4], rtol=0, atol=0)
    t_att.mot_attention(q, k, v, mask)  # no mesh: the single-device path
    assert called == [True, True]


@pytest.mark.parametrize("name", list(ATTENTION_CASES))
def test_k1_shard_forward_matches_jax_sharded_kernel(world_2x2, name):
    i = list(ATTENTION_CASES).index(name)
    case, got = world_2x2["cases"][i], world_2x2["attention"][i]
    assert got["not_close_out"] == 0, got["max_abs_err_out"]  # each rank vs the plain version
    mesh = _j_mesh(2, 2)
    j_pa.set_attention_mesh(mesh)
    try:
        assert j_pa.shardable_attention(case["q"], case["k"])
        want = jax.jit(lambda *a: j_pa.mot_attention_fused_sharded(*a, interpret=True))(
            *(jnp.asarray(case[n]) for n in ("q", "k", "v", "mask"))
        )
    finally:
        j_pa.set_attention_mesh(None)
    np.testing.assert_allclose(got["out"], np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", list(ATTENTION_CASES))
def test_k1_shard_grads_match_jax_grad_through_the_sharded_kernel(world_2x2, name):
    """dk and dv of the replicated (MQA) K/V are summed over the model
    ranks by K1-shard's backward, as shard_map's transpose psums them."""
    i = list(ATTENTION_CASES).index(name)
    case, got = world_2x2["cases"][i], world_2x2["attention"][i]
    for n in ("dq", "dk", "dv"):
        assert got[f"not_close_{n}"] == 0, (n, got[f"max_abs_err_{n}"])
    q, k, v, mask, g = (jnp.asarray(case[n]) for n in ("q", "k", "v", "mask", "g"))
    mesh = _j_mesh(2, 2)
    j_pa.set_attention_mesh(mesh)
    try:
        _, vjp = jax.vjp(lambda q, k, v: j_pa.mot_attention_fused_sharded(q, k, v, mask, interpret=True), q, k, v)
        want = vjp(g)
    finally:
        j_pa.set_attention_mesh(None)
    for n, w in zip(("dq", "dk", "dv"), want):
        np.testing.assert_allclose(got[n], np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=n)


def test_k1_shard_launches_nothing_on_the_cpu(world_2x2):
    assert all(r["launches"] == 0 for r in world_2x2["infer"])


# --------------------------------------------------------------------------- #
# infer_action under a mesh
# --------------------------------------------------------------------------- #


def _single(tiny, noise_seed=None):
    jcfg, tcfg, jparams, batch, a0 = tiny
    params = params_from_jax(jparams, device="cpu")
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = None if noise_seed is None else torch.Generator().manual_seed(noise_seed)
    return t_pizero.infer_action(
        params, tcfg, gen, t["input_ids"], t["pixel_values"], t["attention_mask"], t["proprios"],
        action0=None if noise_seed is not None else torch.from_numpy(a0),
    ).numpy()


@pytest.fixture(scope="module")
def single_chunks(tiny):
    """The tiny chunk on one device: JAX's and the port's with the injected
    noise, and the port's with noise drawn from a generator seeded 3."""
    jcfg, _, jparams, batch, a0 = tiny
    want_jax = j_pizero.infer_action(
        jparams, jcfg, jax.random.key(0), *(jnp.asarray(batch[k]) for k in
        ("input_ids", "pixel_values", "attention_mask", "proprios")), action0=jnp.asarray(a0),
    )
    return np.asarray(want_jax), _single(tiny), _single(tiny, noise_seed=3)


def _check_infer(tiny, single_chunks, infer):
    jcfg = tiny[0]
    want_jax, want, want_drawn = single_chunks
    injected, drawn = infer
    assert injected["chunk"].shape == (2, jcfg.horizon_steps, jcfg.action_dim)
    np.testing.assert_allclose(injected["chunk"], want_jax, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(injected["chunk"], want, rtol=1e-5, atol=1e-5)
    # every rank draws the whole batch's noise and keeps its rows
    np.testing.assert_allclose(drawn["chunk"], want_drawn, rtol=1e-5, atol=1e-5)


def test_infer_action_on_a_2x2_mesh_matches_jax(tiny, single_chunks, world_2x2):
    _check_infer(tiny, single_chunks, world_2x2["infer"])


def test_infer_action_on_1x2_and_2x1_meshes_matches_jax(tiny, single_chunks, world_small):
    _check_infer(tiny, single_chunks, world_small["infer"])


FAULT_TIMEOUT_S = 10  # well above a world's start-up, well below rank 1's 60 s stall


@pytest.mark.parametrize("fault", ["raise", "stall"])
def test_a_failed_rank_fails_the_world_and_none_hangs(fault):
    """Once the world has started (a barrier), one rank raising, or
    waiting in a collective its peer never joins, ends the whole world
    with that rank's error in the caller: spawn ends the other ranks, and
    the model group's timeout ends the wait."""
    t0 = time.monotonic()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException) as err:
        run_ranks(ranks.fault_rank, 1, 2, fault, device="cpu", timeout_s=FAULT_TIMEOUT_S)
    msg = str(err.value)
    assert "fault_rank" in msg, msg  # the world had started: not a failed rendezvous
    if fault == "raise":  # rank 1's error, or rank 0's all-reduce losing its crashed peer
        assert "rank 1 fails" in msg or "Connection closed by peer" in msg, msg
    else:  # rank 0's all-reduce timed out; it did not wait out rank 1's 60 s
        assert "all_reduce" in msg and "Timed out" in msg, msg
        assert time.monotonic() - t0 < 45


def test_spawned_ranks_import_no_jax(world_2x2):
    """After K1-shard, TP inference and a TP update (``train_rank``),
    with the training and dryrun modules imported."""
    assert world_2x2["tp_train"]["replicated_bitwise"]
    assert world_2x2["foreign"] == []


def test_the_param_tree_is_unchanged_by_the_split_leaves():
    """Sharding copies: the caller's full tree keeps its values."""
    cfg = t_config.tiny_pizero_config()
    params = t_pizero.init_params(cfg, seed=0, device="cpu")
    before = [x.clone() for x in tree_leaves(params)]
    shard_params_tp(params, cfg, _cpu_mesh(1, 2, 1, 1))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))
