"""The compiled chunk (``models/compiled.py``: one CUDA graph per bucket)
against the eager chunk on the card, at the tiny config: bitwise, for the
full flow and the refined tier, two buckets sharing one memory pool,
three consecutive calls each, from generators seeded alike. Then the
serving layer's ``make_compiled_infer_fn`` behind a ``BatchingPolicy``,
and a capture while the cyclic GC collects often and a dead cycle holds
another graph.

Marked ``cuda``; imports no JAX, so that it runs on the card's machine:
``python -m pytest --noconftest tests/test_torch_compiled_card.py -q``."""

import gc

import numpy as np
import pytest
import torch

from open_pi_zero_torch import config as cfg_lib
from open_pi_zero_torch import serving
from open_pi_zero_torch.models import compiled, fuse, pizero
from open_pi_zero_torch.ops import fused_attention as fa

pytestmark = pytest.mark.cuda

# weight-only int8 expert without W8A8: the tiny prefill has 12 rows per
# sequence, and torch._int_mm on a card takes more than 16
LAYOUTS = {
    "float": lambda p: p,
    "int8_expert": lambda p: fuse.prepare_for_serving(p, **fuse.serving_layout_kwargs({"w8a8": False})),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def example_batch(cfg, b: int, seed: int, prev: bool) -> dict:
    rng = np.random.default_rng(seed)
    n_img = cfg.siglip.num_image_tokens
    ids = np.zeros((b, cfg.max_image_text_tokens), np.int32)
    ids[:, :n_img] = cfg.image_token_index
    ids[:, n_img] = 2
    ids[0, n_img + 1 : n_img + 4] = [10, 11, 12]  # row 0 longer than the others
    size = cfg.siglip.image_size
    batch = {
        "input_ids": ids,
        "pixel_values": rng.normal(size=(b, size, size, 3)).astype(np.float32),
        "attention_mask": (ids != cfg.pad_token_id).astype(np.int32),
        "proprios": rng.normal(size=(b, cfg.cond_steps, cfg.proprio_dim)).astype(np.float32),
    }
    if prev:
        batch["prev_chunk"] = rng.uniform(-1, 1, size=(b, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
    return batch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_graph_replays_are_bitwise_the_eager_chunks(cuda, layout, dtype):
    cfg = cfg_lib.tiny_pizero_config()
    params = LAYOUTS[layout](pizero.init_params(cfg, seed=0, device=cuda, dtype=dtype))
    L = cfg.joint.num_hidden_layers
    pool = None
    for b in (1, 2):
        for t_start in (0.0, 0.5):
            eager = serving.make_infer_fn(params, cfg, device=cuda, seed=5, t_start=t_start)
            before = fa.launches
            graph = compiled.compile_chunk(
                params, cfg, b, generator=torch.Generator(cuda).manual_seed(5), t_start=t_start,
                device=cuda, pool=pool,
            )
            pool = graph.pool
            steps = round(cfg.num_inference_steps * (1 - t_start))
            assert fa.launches - before == 2 * (L + L * steps)  # the warm-up and the capture
            before = fa.launches
            for call in range(3):
                batch = example_batch(cfg, b, seed=10 * b + call, prev=t_start > 0)
                got, want = graph(batch), eager(batch)
                assert got.shape == (b, cfg.horizon_steps, cfg.action_dim) and got.dtype == dtype
                assert torch.equal(got, want), (layout, b, t_start, call)
            assert fa.launches == before + 3 * (L + L * steps)  # the eager calls only


def test_graph_output_is_a_copy_and_shapes_are_checked(cuda):
    cfg = cfg_lib.tiny_pizero_config()
    params = pizero.init_params(cfg, seed=0, device=cuda)
    graph = compiled.compile_chunk(params, cfg, 2, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    first = graph(example_batch(cfg, 2, 0, prev=False))
    kept = first.clone()
    graph(example_batch(cfg, 2, 1, prev=False))
    assert torch.equal(first, kept)  # the next replay did not overwrite a returned chunk
    with pytest.raises(ValueError, match="shape"):
        graph(example_batch(cfg, 1, 0, prev=False))


def test_compiled_infer_fn_serves_both_tiers(cuda):
    cfg = cfg_lib.tiny_pizero_config()
    params = pizero.init_params(cfg, seed=0, device=cuda, dtype=torch.bfloat16)
    infer_fn, refine_fn = serving.make_compiled_infer_fn(params, cfg, (1, 2), refine_t=0.5, device=cuda)
    policy = serving.BatchingPolicy(infer_fn, batch_sizes=(1, 2), refine_fn=refine_fn, max_inflight=2)
    example = {k: v[0] for k, v in example_batch(cfg, 1, 0, prev=False).items()}
    policy.warmup(example)
    policy.start()
    try:
        fresh = policy.submit(example)
        refined = policy.submit({**example, "prev_chunk": fresh})
    finally:
        policy.stop()
    for r in (fresh, refined):
        assert r.shape == (cfg.horizon_steps, cfg.action_dim) and np.isfinite(r).all()
        assert np.abs(r).max() <= cfg.final_action_clip_value
    assert policy.n_refined == 1
    with pytest.raises(ValueError, match="no graph for batch size 3"):
        infer_fn(example_batch(cfg, 3, 0, prev=False))


def test_capture_survives_a_collection_of_a_dead_graph(cuda):
    """A reference cycle holding a CompiledChunk is dropped, and the GC set
    to collect at almost every allocation; the next capture must not see
    the dead graph's memory freed among its launches. _capture collects
    first and holds the GC off for the capture's length."""
    cfg = cfg_lib.tiny_pizero_config()
    params = pizero.init_params(cfg, seed=0, device=cuda)

    class Holder:
        pass

    dead = Holder()
    dead.graph = compiled.compile_chunk(params, cfg, 1, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
    dead.me = dead  # the cycle: only the GC frees it
    del dead
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        graph = compiled.compile_chunk(params, cfg, 1, generator=torch.Generator(cuda).manual_seed(0), device=cuda)
        assert gc.isenabled()
    finally:
        gc.set_threshold(*thresholds)
    eager = serving.make_infer_fn(params, cfg, device=cuda, seed=0)
    batch = example_batch(cfg, 1, 0, prev=False)
    assert torch.equal(graph(batch), eager(batch))
