"""Tensor-parallel training in the port (``training/train_step.py`` under a
(data, model) mesh, ``parallel/collectives.py``'s autograd-aware operators,
the TP-aware ``optimizer.global_norm``, ``parallel/sharding.gather_tp``,
``scripts/dryrun_multichip.py``) on the CPU, at the tiny config, fp32.

Ranks run in spawned processes over gloo (``parallel.run_ranks(...,
device="cpu")``; the rank programs are ``parallel/ranks.train_rank`` and
``megatron_rank``, which import no JAX); one world per mesh is shared by
the checks (module fixtures). Each ``train_rank`` call first takes the
updates in one process (rank 0, the mesh cleared) and then on the mesh.
The JAX package's one-device step runs here, on the global batch.

Tolerances, each with its reason:
  - against the JAX package's global-batch step, injected flow times and
    noise: loss rtol 1e-5, grad norm rtol 1e-4, params atol 5e-2 * lr, as
    the one-device and DP steps (tests/test_torch_training.py,
    tests/test_torch_dp_training.py): TP reassociates the row-parallel sums
    and the norm's, nothing more;
  - the gathered TP grads against the one process's, leaf by leaf: rtol
    1e-5, atol 1e-6 (SigLIP's key bias has a grad of zero in exact
    arithmetic, rounding noise on both sides; every other grad is far above
    1e-6, and a misplaced copy or reduce moves a grad by its own size);
  - the replicated leaves over the model group, and every rank's norm:
    bitwise;
  - the Megatron pair against one process's autograd: rtol 1e-5, atol 1e-6
    (fp32 sums in another order).
"""

import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from open_pi_zero_torch import config as t_config
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.parallel import Mesh, ranks, run_ranks, set_mesh
from open_pi_zero_torch.training import seeds
from open_pi_zero_torch.training import train_step as t_train
from open_pi_zero_tpu import config as j_config
from open_pi_zero_tpu.models import pizero as j_pizero
from open_pi_zero_tpu.training import optimizer as j_opt
from tests.test_torch_dp_training import _jax_value_and_grad
from tests.test_torch_models import torch_cfg
from tests.test_torch_training import LR, _batch, _leaves_with_paths, _np_tree, _train_cfgs

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120
GLOBAL_ROWS = 4  # 2 rows per data rank at n_data = 2
MESHES = [(1, 2), (2, 1), (2, 2)]
INJECTED = [(m, accum) for m in MESHES for accum in (1, 2)]
DRAWN_MESHES = [(1, 2), (2, 2)]  # 2 updates, drawn t / x0, EMA: the model axis above 1
CLIP = dict(max_grad_norm=0.05, adam_eps=1e-3)  # eps 1e-3: Adam's step then shows the clip's scale


@pytest.fixture(scope="module")
def tiny():
    jcfg = j_config.tiny_pizero_config()
    return jcfg, torch_cfg(jcfg), _np_tree(j_pizero.init_params(jax.random.key(0), jcfg))


def _injected(jcfg, accum):
    batch = _batch(jcfg, GLOBAL_ROWS, seed=40 + accum, accum=accum)
    return batch if accum > 1 else {k: v[0] for k, v in batch.items()}


def _drawn(tcfg, count=2):
    return [{k: v for k, v in _batch(tcfg, GLOBAL_ROWS, seed=50 + i, accum=2).items() if k not in ("t", "x0")}
            for i in range(count)]


def _calls(tiny, mesh):
    jcfg, tcfg, jparams = tiny
    _, train_cfg = _train_cfgs()
    calls = [(ranks.train_rank, (tcfg, train_cfg, [_injected(jcfg, accum)], accum, False, jparams, 0, "cpu"))
             for m, accum in INJECTED if m == mesh]
    if mesh in DRAWN_MESHES:
        _, ema_cfg = _train_cfgs(use_ema=True, ema_start=0)
        calls.append((ranks.train_rank, (tcfg, ema_cfg, _drawn(tcfg), 2, False, jparams, 0, "cpu")))
    return calls


def _training_shape_case():
    """K1-shard's VJP at the training shape (Lq = Lkv = 281, 8 Q / 1 KV
    heads of 256, the block-causal training mask), B = 2, fp32."""
    cfg = t_config.PiZeroConfig()
    am = torch.zeros(2, cfg.max_image_text_tokens, dtype=torch.int32)
    am[0, :264], am[1, :200] = 1, 1
    mask = t_pizero.prepare_action_inputs(cfg, am)[0].numpy()
    rng = np.random.default_rng(8)
    q, k, v, g = (rng.normal(size=s).astype(np.float32) for s in ((2, 281, 8, 256), (2, 281, 1, 256),
                                                                   (2, 281, 1, 256), (2, 281, 8, 256)))
    return dict(name="train", q=q, k=k, v=v, mask=mask, g=g, softcap=50.0, dtype="float32", tol=1e-5)


def _megatron_inputs():
    rng = np.random.default_rng(3)
    return tuple(rng.normal(size=s).astype(np.float32) for s in ((2, 5, 8), (8, 12), (12, 8), (2, 5, 8)))


@pytest.fixture(scope="module")
def world12(tiny):
    _, clip_cfg = _train_cfgs(**CLIP)
    jcfg, tcfg, jparams = tiny
    calls = _calls(tiny, (1, 2)) + [
        (ranks.train_rank, (tcfg, clip_cfg, [_injected(jcfg, 1)], 1, False, jparams, 0, "cpu")),
        (ranks.megatron_rank, _megatron_inputs()),
        (ranks.attention_rank, ([_training_shape_case()],)),
    ]
    *injected, drawn, clip, megatron, (attention,) = run_ranks(ranks.sequence, 1, 2, calls, device="cpu",
                                                                timeout_s=TIMEOUT_S)
    return {"injected": dict(zip((1, 2), injected)), "drawn": drawn, "clip": clip, "megatron": megatron,
            "attention": attention}


@pytest.fixture(scope="module")
def world21(tiny):
    out = run_ranks(ranks.sequence, 2, 1, _calls(tiny, (2, 1)), device="cpu", timeout_s=TIMEOUT_S)
    return {"injected": dict(zip((1, 2), out))}


@pytest.fixture(scope="module")
def world22(tiny):
    *injected, drawn = run_ranks(ranks.sequence, 2, 2, _calls(tiny, (2, 2)), device="cpu", timeout_s=TIMEOUT_S)
    return {"injected": dict(zip((1, 2), injected)), "drawn": drawn}


def _world(request, mesh):
    return request.getfixturevalue(f"world{mesh[0]}{mesh[1]}")


@functools.lru_cache(maxsize=None)
def _jax_apply(j_train):
    """The norm after the surgery and the first optax update (clip
    included) of ``j_train``, jitted."""

    def apply(grads, params):
        tx = j_opt.build_optimizer(j_train, params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.global_norm(j_opt.apply_freeze_surgery(grads)), optax.apply_updates(params, updates)

    return jax.jit(apply)


def _jax_update(jparams, jcfg, j_train, batch, accum):
    """The JAX package's one-device step on the global batch with injected
    t / x0: the mean loss and grads over the microbatches, the norm after
    the surgery, the optax update (clip included)."""
    grads, loss = None, 0.0
    for i in range(accum):
        mb_loss, g = _jax_value_and_grad(jcfg)(jparams, {k: v[i] for k, v in batch.items()})
        loss += mb_loss / accum
        g = jax.tree.map(lambda x: x / accum, g)
        grads = g if grads is None else jax.tree.map(lambda a, b: a + b, grads, g)
    norm, params = _jax_apply(j_train)(grads, jparams)
    return float(loss), float(norm), _np_tree(params)


def _with_accum_axis(batch, accum):
    return batch if accum > 1 else {k: v[None] for k, v in batch.items()}


def _assert_params(got_tree, want_tree, atol):
    for (path, a), (_, b) in zip(_leaves_with_paths(got_tree), _leaves_with_paths(want_tree)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=path)


# --------------------------------------------------------------------------- #
# the TP step against the JAX package's step and the port's one process
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh,accum", INJECTED, ids=lambda v: str(v))
def test_tp_step_matches_the_jax_global_batch_step(request, tiny, mesh, accum):
    jcfg, _, jparams = tiny
    j_train, _ = _train_cfgs()
    want_loss, want_norm, want_params = _jax_update(jparams, jcfg, j_train,
                                                    _with_accum_axis(_injected(jcfg, accum), accum), accum)
    got = _world(request, mesh)["injected"][accum]
    for rank in got["ranks"]:
        np.testing.assert_allclose(rank["losses"][0], want_loss, rtol=1e-5)
        np.testing.assert_allclose(rank["grad_norms"][0], want_norm, rtol=1e-4)
    _assert_params(got["params"], want_params, 5e-2 * LR)


def _assert_grads_match(got):
    grads = dict(_leaves_with_paths(got["grads"]))
    want = got["reference_grads"]
    assert want and set(want) <= set(grads)
    for path, b in want.items():
        np.testing.assert_allclose(grads[path], b, rtol=1e-5, atol=1e-6, err_msg=path)


@pytest.mark.parametrize("mesh,accum", INJECTED, ids=lambda v: str(v))
def test_gathered_tp_grads_are_the_one_process_grads(request, mesh, accum):
    """Every trained leaf's grad, the TP slices gathered: a copy or reduce
    in the wrong place shows here (a replicated leaf's grad tp times too
    large, or a slice's partial)."""
    _assert_grads_match(_world(request, mesh)["injected"][accum])


@pytest.mark.parametrize("mesh", DRAWN_MESHES, ids=str)
def test_drawn_updates_with_ema_match_one_process(request, mesh):
    """Two updates, the train stream drawing t and x0, EMA on: the losses,
    norms, grads, params and the average against the one process's run."""
    got = _world(request, mesh)["drawn"]
    ref = got["reference"]
    for rank in got["ranks"]:
        np.testing.assert_allclose(rank["losses"], ref["losses"], rtol=1e-5)
        np.testing.assert_allclose(rank["grad_norms"], ref["grad_norms"], rtol=1e-4)
    _assert_grads_match(got)
    for name in ("params", "avg"):
        tree = dict(_leaves_with_paths(got[name]))
        for path, b in got[f"reference_{name}"].items():
            np.testing.assert_allclose(tree[path], b, rtol=0, atol=5e-2 * LR, err_msg=f"{name}{path}")


@pytest.mark.parametrize("mesh", DRAWN_MESHES, ids=str)
def test_replicated_leaves_stay_bitwise_equal_over_the_model_group(request, mesh):
    got = _world(request, mesh)["drawn"]
    assert got["replicated_bitwise"]
    assert len({tuple(r["losses"]) for r in got["ranks"]}) == 1
    assert len({tuple(r["grad_norms"]) for r in got["ranks"]}) == 1


def test_a_clip_that_bites_scales_every_rank_alike(tiny, world12):
    """max_grad_norm well under the norm, Adam's eps 1e-3 (so that the
    clip's scale shows in the step): every rank's norm bitwise the same and
    JAX's; the params JAX's clipped update, not its unclipped one."""
    jcfg, _, jparams = tiny
    got = world12["clip"]
    norms = {r["grad_norms"][0] for r in got["ranks"]}
    assert len(norms) == 1
    batch = _with_accum_axis(_injected(jcfg, 1), 1)
    j_clip, _ = _train_cfgs(**CLIP)
    _, want_norm, want = _jax_update(jparams, jcfg, j_clip, batch, 1)
    assert norms.pop() > 10 * CLIP["max_grad_norm"]
    np.testing.assert_allclose(got["ranks"][0]["grad_norms"][0], want_norm, rtol=1e-4)
    _assert_params(got["params"], want, 5e-2 * LR)
    j_free, _ = _train_cfgs(**{**CLIP, "max_grad_norm": 1e6})
    _, _, unclipped = _jax_update(jparams, jcfg, j_free, batch, 1)
    apart = max(float(np.abs(a - b).max()) for (_, a), (_, b) in
                zip(_leaves_with_paths(got["params"]), _leaves_with_paths(unclipped)))
    assert apart > 0.2 * LR


def test_the_tp_step_goes_through_k1_shard_on_every_attention_call(world12, tiny):
    """Each rank's every attention call of an update is a K1-shard call:
    two per layer and microbatch (remat reruns the forward) or one."""
    _, tcfg, _ = tiny
    for accum in (1, 2):
        for rank in world12["injected"][accum]["ranks"]:
            per_microbatch = tcfg.joint.num_hidden_layers * (2 if tcfg.joint.remat else 1)
            assert rank["shard_calls"] == [accum * per_microbatch]
            assert rank["model_allreduce_calls"][0] > 0


# --------------------------------------------------------------------------- #
# the operators, the draws, the refusals
# --------------------------------------------------------------------------- #


def test_copy_and_sum_row_parallel_are_one_linear_pair(world12):
    x, w1, w2, g = (torch.from_numpy(a) for a in _megatron_inputs())
    x, w1, w2 = (t.clone().requires_grad_() for t in (x, w1, w2))
    y = torch.nn.functional.gelu(x @ w1) @ w2
    dx, dw1, dw2 = torch.autograd.grad(y, (x, w1, w2), g)
    got = world12["megatron"]
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["y"], y.detach().numpy(), **tol)
    for rank_dx in got["dx"]:  # every rank holds the whole input grad
        np.testing.assert_allclose(rank_dx, dx.numpy(), **tol)
    np.testing.assert_allclose(got["dw1"], dw1.numpy(), **tol)
    np.testing.assert_allclose(got["dw2"], dw2.numpy(), **tol)


def test_k1_shard_vjp_sums_dk_dv_to_one_devices_at_the_training_shape(world12):
    """Replicated K/V (one KV head): each rank's dq on its 4 query heads,
    and dk, dv after the sum over the model group, against plain autograd
    on the whole inputs (1e-5: fp32, another summation order)."""
    row = world12["attention"]
    for part in ("out", "dq", "dk", "dv"):
        assert row[f"not_close_{part}"] == 0, (part, row[f"max_abs_err_{part}"])


def _mesh(n_data, n_model, data_index, model_index):
    return Mesh(n_data, n_model, data_index, model_index, None, None, "gloo", torch.device("cpu"))


def test_the_model_ranks_of_one_data_index_draw_the_same_t_and_x0():
    """On a (2, 2) mesh every rank draws the global microbatch from the
    train stream and keeps its data index's rows: the two model ranks of a
    data index bitwise alike, the two data indices apart, together one
    device's draw."""
    cfg = t_config.tiny_pizero_config()
    draws = {}
    for place in (None, (0, 0), (0, 1), (1, 0), (1, 1)):
        set_mesh(None if place is None else _mesh(2, 2, *place))
        try:
            g = seeds.stream_generator(3, seeds.TRAIN)
            b = 4 if place is None else 2
            t = t_train._rank_rows(lambda rows: t_train.sample_flow_time(g, rows, cfg), b)
            x0 = t_train._rank_rows(lambda rows: torch.randn((rows, 4, 7), generator=g), b)
            draws[place] = (t, x0)
        finally:
            set_mesh(None)
    for i in range(2):
        for d in range(2):
            assert torch.equal(draws[(d, 0)][i], draws[(d, 1)][i])
        assert not torch.equal(draws[(0, 0)][i], draws[(1, 0)][i])
        assert torch.equal(torch.cat([draws[(0, 0)][i], draws[(1, 0)][i]]), draws[None][i])


@pytest.mark.parametrize("name", ["zero1"])
def test_tp_training_refuses_what_it_does_not_take(name):
    """ZeRO-1 under a model axis: the JAX package's ZeRO-1 places the params
    replicated, so there is no ZeRO-1 over TP params to port."""
    with pytest.raises(NotImplementedError, match="ZeRO-1 under a model axis: the JAX package's "
                                                  "zero1_state_sharding places the params replicated"):
        t_train.shard_state_zero1(None, None, _mesh(1, 2, 0, 0))


# --------------------------------------------------------------------------- #
# the entry point
# --------------------------------------------------------------------------- #


def test_dryrun_multichip_passes_its_tiny_phases_on_four_cpu_ranks(tmp_path):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "TMPDIR": str(tmp_path), "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-m", "open_pi_zero_torch.scripts.dryrun_multichip", "--device", "cpu", "--tiny"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [json.loads(ln.split(" ", 1)[1]) for ln in proc.stdout.splitlines() if ln.startswith("DRYRUN_LEDGER ")]
    assert [ln["phase"] for ln in lines] == ["tiny_dp_step", "tiny_dp_tp_step", "tiny_dp_serving",
                                             "tiny_fp32_tp_serving"]
    assert all(ln["status"] == "ok" for ln in lines)
    assert lines[1]["loss_diff"] < 1e-3 and lines[2]["max_diff"] <= 1e-4 and lines[3]["max_diff"] <= 1e-4
    summary = next(ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun_multichip(4): COMPLETE "))
    assert json.loads(summary.split("COMPLETE ", 1)[1])["phases"] == [ln["phase"] for ln in lines]
