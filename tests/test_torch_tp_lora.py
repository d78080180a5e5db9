"""Tensor-parallel LoRA and QLoRA training in the port (``parallel/sharding.py``'s
adapter and NF4 rules, ``rank_kernel`` and ``partial_grads``; the models'
adapters under a split base; ``training/quantized_adam.AdamW8bit.split_over``
and ``ops/quantization.SliceBlocks``; the TP train step) on the CPU, at the
tiny config, fp32, against the JAX package.

Two recipes, each on meshes (1, 2), (2, 1) and (2, 2): LoRA (adapters on
the vlm mixture, SigLIP and the projector, fp32 moments) and QLoRA (the
same with NF4 bases and int8 Adam moments, configs/train/bridge.yaml's
``quantize: true, lora: true``). The params are the JAX package's
(``tests/test_torch_lora.jax_lora_params``), every adapter's B drawn off
zero from a seed, so that its A has a grad in the first update: with
LoRA's zero init a missing all-reduce of ``da`` could not show. Ranks run
in spawned processes over gloo (``parallel.run_ranks(..., device="cpu")``,
the rank programs ``parallel/ranks.train_rank`` and ``infer_rank``), one
world per mesh, shared by the checks (module fixtures). The port's update
in one process, the mesh cleared, runs once per recipe in the test
process.

Tolerances, each with its reason:
  - against the JAX package's one-device step on the global batch
    (injected flow times and noise, grad accumulation 2, the frozen
    leaves' grads zeroed so that its clip norm is the port's, over the
    trained leaves: ROADMAP.md §3): loss rtol 1e-5, grad norm rtol 1e-4,
    params atol 5e-2 * lr, as tests/test_torch_tp_training.py: TP
    reassociates the row-parallel sums and the norm's, nothing more;
  - the gathered TP grads of every trained leaf against the one process's:
    rtol 1e-5, atol 1e-6 (a misplaced or missing sum moves a grad by its
    own size);
  - the replicated leaves and the NF4 payloads over the model group, the
    NF4 payloads against their values before the update, and the int8
    blocks of TP slices against the whole leaf's: bitwise;
  - the TP chunk of an adapted NF4 tree against the JAX package's
    ``infer_action``: 1e-4, as the port's other TP serving tests.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open_pi_zero_torch.models.from_jax import params_from_jax
from open_pi_zero_torch.ops import lora as t_lora
from open_pi_zero_torch.ops import quantization as t_quant
from open_pi_zero_torch.parallel import ranks, run_ranks
from open_pi_zero_torch.training import quantized_adam as t_qadam
from open_pi_zero_tpu.models import pizero as j_pizero
from open_pi_zero_tpu.training import optimizer as j_opt
from tests.test_torch_lora import _jax_qlora_step, jax_lora_params
from tests.test_torch_models import example_inputs, torch_cfg
from tests.test_torch_training import LR, _batch, _leaves_with_paths, _np_tree, _train_cfgs

TIMEOUT_S = 120
GLOBAL_ROWS, ACCUM = 4, 2  # 2 rows per data rank at n_data = 2
MESHES = [(1, 2), (2, 1), (2, 2)]
TP_MESHES = [(1, 2), (2, 2)]  # a model axis above 1
RECIPES = {"lora": False, "qlora": True}  # name -> NF4 bases and int8 moments
CASES = [(m, r) for m in MESHES for r in RECIPES]


def _recipe(name):
    """(JAX config, JAX params as numpy, JAX and port training configs)."""
    quantize = RECIPES[name]
    jcfg, jparams = jax_lora_params(quantize)
    j_train, t_train = _train_cfgs(lora=True, quantize_optimizer_states=quantize)
    return jcfg, jparams, j_train, t_train


def _global_batch(jcfg):
    return _batch(jcfg, GLOBAL_ROWS, seed=60, accum=ACCUM)


def _serving_inputs(jcfg):
    ids, pix, am, prop, a0 = example_inputs(jcfg, b=2, seed=4)
    return {"input_ids": ids, "pixel_values": pix, "attention_mask": am, "proprios": prop}, a0


def _calls(mesh):
    calls = []
    for name in RECIPES:
        jcfg, jparams, _, t_train = _recipe(name)
        calls.append((ranks.train_rank, (torch_cfg(jcfg), t_train, [_global_batch(jcfg)], ACCUM, False, jparams)))
    if mesh == (1, 2):  # TP serving of the adapted NF4 tree
        jcfg, jparams, _, _ = _recipe("qlora")
        batch, a0 = _serving_inputs(jcfg)
        calls.append((ranks.infer_rank, (torch_cfg(jcfg), batch, a0, jparams)))
    return calls


def _run(mesh):
    out = run_ranks(ranks.sequence, *mesh, _calls(mesh), device="cpu", timeout_s=TIMEOUT_S)
    return {"lora": out[0], "qlora": out[1], **({"serving": out[2]} if len(out) > 2 else {})}


@pytest.fixture(scope="module")
def world12():
    return _run((1, 2))


@pytest.fixture(scope="module")
def world21():
    return _run((2, 1))


@pytest.fixture(scope="module")
def world22():
    return _run((2, 2))


def _world(request, mesh):
    return request.getfixturevalue(f"world{mesh[0]}{mesh[1]}")


@functools.lru_cache(maxsize=None)
def _one_process(name):
    """The port's update alone in this process (no mesh: one device's
    path), on the same params and global batch as the ranks: the trained
    leaves' grads by path (``parallel/ranks._one_process_updates``, which
    ``train_rank`` runs on rank 0 with a reference device)."""
    jcfg, jparams, _, t_train = _recipe(name)
    tcfg = torch_cfg(jcfg)
    params = t_lora.quantize_per_model_config(params_from_jax(jparams, device="cpu"), tcfg)
    got = ranks._one_process_updates(tcfg, t_train, params, [_global_batch(jcfg)], ACCUM, 0, everything=True)
    return {path: g.numpy() for path, g in got["grads"].items()}


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    """The JAX package's one-device step on the global batch: the loss,
    the norm over the trained leaves (the frozen ones' grads zeroed, as
    the clip then sees them) and the params after the update."""
    jcfg, jparams, j_train, _ = _recipe(name)
    jp = jax.tree.map(jnp.asarray, jparams)
    loss, grads, params, _ = _jax_qlora_step(jp, jcfg, j_train, _global_batch(jcfg), ACCUM, zero_frozen=True)
    return loss, float(optax.global_norm(j_opt.apply_freeze_surgery(grads))), dict(_leaves_with_paths(_np_tree(params)))


# --------------------------------------------------------------------------- #
# the TP step against the JAX package's step and the port's one process
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh,recipe", CASES, ids=str)
def test_tp_step_matches_the_jax_global_batch_step(request, mesh, recipe):
    want_loss, want_norm, want_params = _jax_step(recipe)
    got = _world(request, mesh)[recipe]
    for rank in got["ranks"]:
        np.testing.assert_allclose(rank["losses"][0], want_loss, rtol=1e-5)
        np.testing.assert_allclose(rank["grad_norms"][0], want_norm, rtol=1e-4)
    params = dict(_leaves_with_paths(got["params"]))
    assert params.keys() == want_params.keys()
    for path, b in want_params.items():
        np.testing.assert_allclose(params[path], b, rtol=0, atol=5e-2 * LR, err_msg=path)


@pytest.mark.parametrize("mesh,recipe", CASES, ids=str)
def test_gathered_tp_grads_are_the_one_process_grads(request, mesh, recipe):
    """Every trained leaf's grad, the TP slices gathered, against the one
    process's: a whole adapter factor's grad left partial (not summed
    over the model group) or summed twice shows here. The adapters' A
    grads are far from zero (their B drawn off zero)."""
    grads = dict(_leaves_with_paths(_world(request, mesh)[recipe]["grads"]))
    want = _one_process(recipe)
    assert want and set(want) <= set(grads)
    assert any(path.endswith("q_lora/a") and np.abs(g).max() > 1e-3 for path, g in want.items())
    for path, b in want.items():
        np.testing.assert_allclose(grads[path], b, rtol=1e-5, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("mesh,recipe", CASES, ids=str)
def test_every_attention_call_of_the_tp_step_goes_through_k1_shard(request, mesh, recipe):
    jcfg, *_ = _recipe(recipe)
    per_microbatch = jcfg.joint.num_hidden_layers * (2 if jcfg.joint.remat else 1)
    for rank in _world(request, mesh)[recipe]["ranks"]:
        assert rank["shard_calls"] == ([ACCUM * per_microbatch] if mesh[1] > 1 else [])


@pytest.mark.parametrize("mesh,recipe", [(m, r) for m in TP_MESHES for r in RECIPES], ids=str)
def test_replicated_leaves_and_nf4_payloads_are_bitwise_alike_over_the_model_group(request, mesh, recipe):
    got = _world(request, mesh)[recipe]
    assert got["replicated_bitwise"]
    assert len({tuple(r["losses"]) for r in got["ranks"]}) == len({tuple(r["grad_norms"]) for r in got["ranks"]}) == 1
    if RECIPES[recipe]:
        assert got["nf4"] == {"leaves": 26, "unchanged": True, "alike": True}  # JAX's QLoRA tree holds 26
    else:
        assert "nf4" not in got


@pytest.mark.parametrize("mesh", TP_MESHES, ids=str)
def test_int8_moments_of_the_tp_step_are_coded_in_the_whole_leafs_blocks(request, mesh):
    """Each rank's int8 moments of its TP slices, gathered whole, are the
    blockwise quantization of the whole leaf's values: every code and
    scale, and the scales alike on every rank."""
    check = _world(request, mesh)["qlora"]["int8_moments"]
    assert check["leaves"] > 0 and check["scales_alike"]
    assert (check["codes_differ"], check["scales_differ"]) == (0, 0)
    assert _world(request, mesh)["lora"]["int8_moments"] is None  # fp32 moments: elementwise already


def test_tp_serving_of_an_adapted_nf4_tree_matches_jax_infer_action(world12):
    jcfg, jparams, _, _ = _recipe("qlora")
    batch, a0 = _serving_inputs(jcfg)
    infer = jax.jit(lambda p, *x: j_pizero.infer_action(p, jcfg, jax.random.key(0), *x, action0=jnp.asarray(a0)))
    want = infer(jax.tree.map(jnp.asarray, jparams),
                 *(jnp.asarray(batch[k]) for k in ("input_ids", "pixel_values", "attention_mask", "proprios")))
    got = world12["serving"]
    np.testing.assert_allclose(got["chunk"], np.asarray(want), rtol=0, atol=1e-4)


# --------------------------------------------------------------------------- #
# the int8 blocks of a TP slice
# --------------------------------------------------------------------------- #

SPLITS = {  # name -> (whole leaf's shape, split dim)
    "aligned_column": ((2, 8, 4096), 2),  # 2048 columns per rank: every block in one rank's slice
    "straddling_column": ((2, 8, 1024), 2),  # 512 per rank: each block spread over both ranks
    "row": ((2, 6, 1000), 1),  # 3 rows per rank: blocks straddle the ranks' row ranges
}


@pytest.mark.parametrize("power", [t_qadam.M_POWER, t_qadam.V_POWER])
@pytest.mark.parametrize("split", list(SPLITS))
def test_tp_slices_coded_with_the_groups_block_maxima_are_the_whole_leafs_blocks(split, power):
    """Two ranks' slices of one leaf: each takes its part of the block
    maxima (``SliceBlocks.absmax_``), their MAX (the all-reduce) gives the
    scales, each codes its values with them (``quantize_scaled``); the
    gathered codes and the scales are bitwise the whole leaf's
    ``quantize_blockwise``."""
    shape, dim = SPLITS[split]
    whole = torch.from_numpy(np.random.default_rng(5).standard_normal(shape).astype(np.float32)) ** 3
    tp = 2
    parts = whole.chunk(tp, dim=dim)
    layouts = [t_quant.SliceBlocks.of(p.shape, dim, r, tp) for r, p in enumerate(parts)]
    maxima = []
    for part, blocks in zip(parts, layouts):
        ids = blocks.ids(0, part.numel(), part.device)
        maxima.append(blocks.absmax_(torch.zeros(blocks.n_blocks), part.reshape(-1), ids))
    scales = t_quant.block_scale(torch.stack(maxima).amax(dim=0))
    codes = [t_quant.quantize_scaled(part.reshape(-1), scales[blocks.ids(0, part.numel(), part.device)], power)
             .view(part.shape) for part, blocks in zip(parts, layouts)]
    want = t_quant.quantize_blockwise(whole, power=power)
    assert torch.equal(torch.cat(codes, dim=dim).reshape(-1), want.q.reshape(-1)[: whole.numel()])
    assert torch.equal(scales[:, None], want.scale)
    shared = ((maxima[0] > 0) & (maxima[1] > 0)).any()  # a block that both ranks hold part of
    assert bool(shared) == (split != "aligned_column")
