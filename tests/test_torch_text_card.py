"""The compiled text decode and the adaLN chunk on the card, at the tiny
config: the decode graph's tokens bitwise the eager decode's (float,
production, bf16), the W8A8 trunk's decode at B = 1 (its rows padded to
17 for ``torch._int_mm``), the facade's compiled ``generate``, and the
adaLN-Zero ``CompiledChunk`` replay bitwise the eager chunk.

Marked ``cuda``; imports no JAX, so that it runs on the card's machine:
``python -m pytest --noconftest tests/test_torch_text_card.py -q``."""

import numpy as np
import pytest
import torch

from open_pi_zero_torch import config as cfg_lib
from open_pi_zero_torch import serving
from open_pi_zero_torch.models import compiled, fuse, pizero
from open_pi_zero_torch.models.paligemma import PaliGemmaForConditionalGeneration, paligemma_config
from open_pi_zero_torch.models.tree import tree_map
from open_pi_zero_torch.ops import fused_attention as fa

pytestmark = pytest.mark.cuda

LAYOUTS = {
    "float": lambda p: p,
    "production": lambda p: fuse.prepare_for_serving(p, **fuse.serving_layout_kwargs({})),  # W8A8 vlm trunk
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def lively_params(cfg, device, dtype):
    """Params whose greedy decode leaves the init's fixed point (the tied
    head copying the last prompt token back): the vlm trunk's attention and
    MLP kernels times 8."""
    params = pizero.init_params(cfg, seed=0, device=device, dtype=dtype)
    vlm = params["joint"]["mixtures"]["vlm"]["layers"]
    for group in ("attn", "mlp"):
        vlm[group] = tree_map(lambda x: x * 8, vlm[group])
    return params


def prompts(cfg, b: int, seed: int, device):
    rng = np.random.default_rng(seed)
    n_img = cfg.siglip.num_image_tokens
    ids = np.zeros((b, n_img + 5), np.int64)
    ids[:, :n_img] = cfg.image_token_index
    ids[:, n_img] = 2
    ids[:, n_img + 1 :] = rng.integers(3, cfg.image_token_index, size=(b, 4))
    pix = rng.normal(size=(b, cfg.siglip.image_size, cfg.siglip.image_size, 3)).astype(np.float32)
    return torch.from_numpy(ids).to(device), torch.from_numpy(pix).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_decode_graph_tokens_are_bitwise_the_eager_decode(cuda, layout, dtype):
    cfg = paligemma_config(cfg_lib.tiny_pizero_config())
    params = LAYOUTS[layout](lively_params(cfg, cuda, dtype))
    L, max_new, pool = cfg.joint.num_hidden_layers, 6, None
    for b in (1, 2):
        ids, pix = prompts(cfg, b, seed=b, device=cuda)
        decoder = compiled.CompiledDecode(params, cfg, b, ids.shape[1] + max_new, device=cuda, pool=pool)
        pool = decoder.pool
        for call in range(2):
            ids, pix = prompts(cfg, b, seed=10 * b + call, device=cuda)
            before = fa.launches
            got = decoder(ids, pix.to(dtype), max_new)
            assert fa.launches == before + L  # the eager prefill only: replays do not count
            want = pizero.generate_text(params, cfg, ids, pix.to(dtype), max_new)
            assert fa.launches == before + 2 * L + max_new * L
            assert got.shape == (b, max_new) and torch.equal(got, want), (layout, b, call)


def test_decode_graph_pads_after_eos_as_eager(cuda):
    cfg = paligemma_config(cfg_lib.tiny_pizero_config())
    params = lively_params(cfg, cuda, torch.float32)
    ids, pix = prompts(cfg, 2, seed=3, device=cuda)
    free = pizero.generate_text(params, cfg, ids, pix, 6)
    eos = int(free[0, 1])
    decoder = compiled.CompiledDecode(params, cfg, 2, ids.shape[1] + 6, eos_token_id=eos, device=cuda)
    got = decoder(ids, pix, 6)
    assert torch.equal(got, pizero.generate_text(params, cfg, ids, pix, 6, eos_token_id=eos))
    assert int(got[0, 1]) == eos and bool((got[0, 2:] == cfg.pad_token_id).all())


def test_w8a8_decode_runs_at_b1(cuda):
    """The production tree's decode step has one row per sequence: the W8A8
    trunk's products pad it to 17 rows. Full depth of the tiny config, bf16."""
    cfg = paligemma_config(cfg_lib.tiny_pizero_config())
    params = LAYOUTS["production"](lively_params(cfg, cuda, torch.bfloat16))
    assert "qa" in params["joint"]["mixtures"]["vlm"]["layers"]["attn"]["qkv"]
    ids, pix = prompts(cfg, 1, seed=4, device=cuda)
    toks = pizero.generate_text(params, cfg, ids, pix.bfloat16(), 5)
    assert toks.shape == (1, 5) and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    logits = pizero.infer_text_logits(params, cfg, ids, pix.bfloat16())
    assert bool(torch.isfinite(logits).all()) and int(logits[0, -1].argmax()) == int(toks[0, 0])


def test_facade_generates_through_the_compiled_decode(cuda):
    cfg = cfg_lib.tiny_pizero_config()
    model = PaliGemmaForConditionalGeneration.init(cfg, device=cuda)
    ids, pix = prompts(model.cfg, 2, seed=5, device=cuda)
    got = model.generate(ids.cpu().numpy(), pix.cpu().numpy(), max_new_tokens=4)
    assert list(model._decoders) == [(2, ids.shape[1] + 4)]
    assert torch.equal(got, pizero.generate_text(model.params, model.cfg, ids, pix, 4))
    model.generate(ids, pix, max_new_tokens=4)
    assert len(model._decoders) == 1  # the graph is reused for the same (B, T_max)


@pytest.mark.parametrize("mode", ["adaLN", "adaLN-Zero"])
def test_adaln_chunk_graph_replays_are_bitwise_the_eager_chunk(cuda, mode):
    cfg = cfg_lib.tiny_pizero_config(action_expert_adaptive_mode=mode)
    params = pizero.init_params(cfg, seed=0, device=cuda, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    n_img = cfg.siglip.num_image_tokens
    ids = np.zeros((1, cfg.max_image_text_tokens), np.int32)
    ids[:, :n_img] = cfg.image_token_index
    ids[:, n_img : n_img + 3] = [2, 10, 11]
    for t_start in (0.0, 0.5):
        eager = serving.make_infer_fn(params, cfg, device=cuda, seed=5, t_start=t_start)
        graph = compiled.compile_chunk(params, cfg, 1, generator=torch.Generator(cuda).manual_seed(5),
                                       t_start=t_start, device=cuda)
        for call in range(2):
            batch = {
                "input_ids": ids, "attention_mask": (ids != cfg.pad_token_id).astype(np.int32),
                "pixel_values": rng.normal(size=(1, 28, 28, 3)).astype(np.float32),
                "proprios": rng.normal(size=(1, cfg.cond_steps, cfg.proprio_dim)).astype(np.float32),
            }
            if t_start:
                batch["prev_chunk"] = rng.uniform(-1, 1, size=(1, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
            assert torch.equal(graph(batch), eager(batch)), (mode, t_start, call)
