"""The PaliGemma text path of the port against the JAX package, on the CPU:
``joint_text_forward`` at an int and a tensor offset, ``infer_text_logits``
(fp32 and bf16), greedy ``generate_text`` with its EOS padding, the top-p
filter and sampler, the reference's golden text logits, the
``PaliGemmaForConditionalGeneration`` facade, generation on the serving
trees, and the W8A8 product's row padding.

Params come from JAX's ``init_params`` of ``paligemma_config`` at the tiny
config. At init the tied head copies each prompt's last token back at
every step, so the tests that compare tokens scale the vlm trunk's kernels
by 8 (``lively``): the decode then leaves that fixed point and each token
depends on the steps before it. That trunk also amplifies the two sides'
fp32 rounding (its logits differ by up to 3e-4), so values are compared
on the params at init.

Tolerances, with their reasons:
- fp32 hidden states and logits: 1e-4, as ``infer_action``
  (tests/test_torch_models.py); greedy tokens equal.
- bf16 logits: the port's no farther from JAX's fp32 logits (the same bf16
  weights, widened) than JAX's own bf16 logits are, plus one bf16 ulp of
  the largest logit (tests/test_torch_bf16.py holds SigLIP so).
- The top-p filter: exactly JAX's (the threshold is one of the logits, so
  the kept logits and MASK_NEG elsewhere are the same values); the draws by
  their frequencies (torch's generator is not JAX's), as
  tests/test_pizero.py holds JAX's.
- The golden text logits: rtol 2e-3 / atol 2e-3, the JAX replay's
  (tests/test_reference_parity_pizero.py).
- A tensor offset against an int offset, and the padded int8 product
  against the unpadded one: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pi_zero_torch import config as t_config
from open_pi_zero_torch.models import compiled as t_compiled
from open_pi_zero_torch.models import convert as t_convert
from open_pi_zero_torch.models import fuse as t_fuse
from open_pi_zero_torch.models import joint as t_joint
from open_pi_zero_torch.models import pizero as t_pizero
from open_pi_zero_torch.models.paligemma import PaliGemmaForConditionalGeneration, paligemma_config
from open_pi_zero_torch.ops import linear as t_lin
from open_pi_zero_tpu.config import tiny_pizero_config
from open_pi_zero_tpu.models import fuse as j_fuse
from open_pi_zero_tpu.models import joint as j_joint
from open_pi_zero_tpu.models import paligemma as j_paligemma
from open_pi_zero_tpu.models import pizero as j_pizero
from open_pi_zero_tpu.ops import MASK_NEG
from open_pi_zero_tpu.ops import lora as j_lora
from open_pi_zero_tpu.ops import quantization as j_quant
from tests import golden
from tests.test_torch_bf16 import bf16_ulp
from tests.test_torch_convert import fixture_cfg
from tests.test_torch_models import TOL, torch_cfg
from tests.test_torch_serving_layout import PRODUCTION, jax_to_port


def lively(tree):
    """The vlm trunk's attention and MLP kernels times 8 (a numpy tree)."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if path[:3] == ("joint", "mixtures", "vlm") and path[4:5] in (("attn",), ("mlp",)):
            return node * np.float32(8.0)
        return node

    return walk(tree, ())


@pytest.fixture(scope="module")
def text():
    """(JAX cfg, port cfg, JAX params, port params) of the tiny PaliGemma."""
    jcfg = j_paligemma.paligemma_config(tiny_pizero_config())
    jparams = j_pizero.init_params(jax.random.key(0), jcfg)
    return jcfg, torch_cfg(jcfg), jparams, jax_to_port(jparams)


@pytest.fixture(scope="module")
def lively_text(text):
    """``text`` with the vlm trunk's kernels times 8, for the token tests."""
    jcfg, tcfg, jparams, _ = text
    jparams = jax.tree.map(jnp.asarray, lively(jax.tree.map(np.asarray, jparams)))
    return jcfg, tcfg, jparams, jax_to_port(jparams)


def prompts(cfg, b=2, text_len=4, seed=0):
    """[B, S] prompts (image tokens, BOS, text; unpadded) and pixels."""
    rng = np.random.default_rng(seed)
    n_img = cfg.siglip.num_image_tokens
    ids = np.zeros((b, n_img + 1 + text_len), np.int32)
    ids[:, :n_img] = cfg.image_token_index
    ids[:, n_img] = 2
    ids[:, n_img + 1 :] = rng.integers(3, cfg.image_token_index, size=(b, text_len))
    size = cfg.siglip.image_size
    return ids, rng.normal(size=(b, size, size, 3)).astype(np.float32)


def _generate_both(jcfg, tcfg, jtree, ttree, ids, pix, **kw):
    want = j_pizero.generate_text(jtree, jcfg, jnp.asarray(ids), jnp.asarray(pix), **kw)
    got = t_pizero.generate_text(ttree, tcfg, torch.from_numpy(ids), torch.from_numpy(pix), **kw)
    return got.numpy(), np.asarray(want)


# --------------------------------------------------------------------------- #
# the trunk's text mode
# --------------------------------------------------------------------------- #


def test_paligemma_config_matches_jax():
    base = tiny_pizero_config()
    assert paligemma_config(torch_cfg(base)) == torch_cfg(j_paligemma.paligemma_config(base))
    cfg = paligemma_config(torch_cfg(base))
    assert cfg.use_lm_head and cfg.joint.mixtures[0].use_final_norm
    assert paligemma_config().joint.mixtures[0].hidden_size == 2048  # PiZeroConfig() by default


def test_joint_text_forward_matches_jax_at_int_and_tensor_offsets(text):
    """Two new tokens written at offset 3 of a cache of 9 slots whose first
    3 hold earlier K/V: the hidden states and the whole cache as JAX's, and
    a 0-d tensor offset bitwise as the int."""
    jcfg, tcfg, jparams, tparams = text
    rng = np.random.default_rng(1)
    b, q, t_max, offset = 2, 2, 9, 3
    dv = tcfg.mixture("vlm").hidden_size
    embeds = rng.normal(size=(b, q, dv)).astype(np.float32)
    positions = np.broadcast_to(np.arange(offset + 1, offset + q + 1, dtype=np.int32), (b, q)).copy()
    shape = (tcfg.joint.num_hidden_layers, b, t_max, tcfg.joint.num_key_value_heads, tcfg.joint.head_dim)
    cache = [np.zeros(shape, np.float32) for _ in range(2)]
    for c in cache:
        c[:, :, :offset] = rng.normal(size=c[:, :, :offset].shape)
    cols = np.arange(t_max)
    rows = offset + np.arange(q)[:, None]  # causal over the new tokens
    mask = np.where(cols[None, :] <= rows, 0.0, MASK_NEG).astype(np.float32)
    mask = np.broadcast_to(mask, (b, 1, q, t_max)).copy()
    want, (wk, wv) = j_joint.joint_text_forward(
        jparams["joint"], jcfg.joint, jnp.asarray(embeds), jnp.asarray(positions), jnp.asarray(mask),
        tuple(jnp.asarray(c) for c in cache), offset,
    )
    results = []
    for off in (offset, torch.tensor(offset)):
        tcache = tuple(torch.from_numpy(c.copy()) for c in cache)
        hidden, (tk, tv) = t_joint.joint_text_forward(
            tparams["joint"], tcfg.joint, torch.from_numpy(embeds), torch.from_numpy(positions),
            torch.from_numpy(mask), tcache, off,
        )
        assert tk is tcache[0] and tv is tcache[1]  # written in place
        np.testing.assert_allclose(hidden.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(tk.numpy(), np.asarray(wk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(wv), **TOL)
        results.append((hidden, tk, tv))
    assert all(torch.equal(a, b) for a, b in zip(*results))


def test_init_text_cache_is_zeroed_and_static():
    cfg = t_config.tiny_pizero_config().joint
    k, v = t_joint.init_text_cache(cfg, 3, 11, torch.bfloat16, "cpu")
    assert k.shape == v.shape == (cfg.num_hidden_layers, 3, 11, cfg.num_key_value_heads, cfg.head_dim)
    assert k.dtype == torch.bfloat16 and not k.any() and not v.any()


# --------------------------------------------------------------------------- #
# logits and greedy decoding
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("seed", range(2))
def test_infer_text_logits_matches_jax(text, seed):
    jcfg, tcfg, jparams, tparams = text
    ids, pix = prompts(jcfg, seed=seed)
    want = j_pizero.infer_text_logits(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pix))
    got = t_pizero.infer_text_logits(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(pix))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, ids.shape[1], tcfg.vocab_size)
    print(f"text logits seed {seed}: max|diff| {np.abs(got.numpy() - np.asarray(want)).max():.3e}")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed", range(2))
def test_bf16_infer_text_logits_as_close_to_fp32_as_jax(text, seed):
    jcfg, tcfg, jparams, _ = text
    jbf16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    ids, pix = prompts(jcfg, seed=seed)
    pix = np.array(jnp.asarray(pix).astype(jnp.bfloat16).astype(jnp.float32))

    def jax_logits(params, dtype):
        return np.asarray(j_pizero.infer_text_logits(params, jcfg, jnp.asarray(ids), jnp.asarray(pix, dtype)))

    jax_fp32 = jax_logits(jax.tree.map(lambda a: a.astype(jnp.float32), jbf16), jnp.float32)
    jax_bf16 = jax_logits(jbf16, jnp.bfloat16)
    port = t_pizero.infer_text_logits(
        jax_to_port(jbf16), tcfg, torch.from_numpy(ids), torch.from_numpy(pix).bfloat16()
    ).numpy()
    port_err, jax_err = float(np.abs(port - jax_fp32).max()), float(np.abs(jax_bf16 - jax_fp32).max())
    ulp = float(bf16_ulp(np.abs(jax_fp32).max()))
    print(f"bf16 text logits seed {seed}: from JAX fp32, port {port_err:.4f}, JAX bf16 {jax_err:.4f}, one ulp {ulp}")
    assert port_err <= jax_err + ulp, f"port bf16 {port_err} vs JAX bf16 {jax_err} from fp32 (ulp {ulp})"


def test_generate_text_greedy_matches_jax(lively_text):
    jcfg, tcfg, jparams, tparams = lively_text
    ids, pix = prompts(jcfg)
    got, want = _generate_both(jcfg, tcfg, jparams, tparams, ids, pix, max_new_tokens=5)
    assert got.shape == (2, 5)
    np.testing.assert_array_equal(got, want)
    assert len(set(got.ravel().tolist())) > 2  # not the init's fixed point


def test_generate_text_pads_after_eos_as_jax(lively_text):
    """With EOS set to row 0's second token: row 0 emits it, then pads; row 1
    runs on unless it meets it too."""
    jcfg, tcfg, jparams, tparams = lively_text
    ids, pix = prompts(jcfg)
    free, _ = _generate_both(jcfg, tcfg, jparams, tparams, ids, pix, max_new_tokens=5)
    eos = int(free[0, 1])
    got, want = _generate_both(jcfg, tcfg, jparams, tparams, ids, pix, max_new_tokens=5, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    assert got[0, 1] == eos and (got[0, 2:] == tcfg.pad_token_id).all()


def test_first_generated_token_is_the_prefill_logits_argmax(lively_text):
    _, tcfg, _, tparams = lively_text
    ids, pix = (torch.from_numpy(x) for x in prompts(tcfg, seed=3))
    logits = t_pizero.infer_text_logits(tparams, tcfg, ids, pix)
    toks = t_pizero.generate_text(tparams, tcfg, ids, pix, max_new_tokens=3)
    assert torch.equal(toks[:, 0], logits[:, -1].argmax(dim=-1))


# --------------------------------------------------------------------------- #
# top-p
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("top_p", [0.3, 0.6, 0.9, 0.95])
def test_top_p_filter_is_jaxs(monkeypatch, top_p):
    """JAX's filtered logits, captured where its sampler hands them to
    ``jax.random.categorical``, against the port's filter on the same
    logits: the same kept set and values. (At top_p = 1 the tail's
    exclusive mass sits on the rounding of the total, 1.0, so the order of
    the two sides' sums decides it.)"""
    logits = np.random.default_rng(2).normal(size=(6, 50)).astype(np.float32) * 3
    captured = []

    def categorical(key, filtered, axis=-1):
        captured.append(np.asarray(filtered))
        return jnp.argmax(filtered, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    j_pizero.sample_top_p(jax.random.key(0), jnp.asarray(logits), 0.8, top_p)
    got = t_pizero.top_p_filter(torch.from_numpy(logits), 0.8, top_p).numpy()
    np.testing.assert_array_equal(got, captured[0])
    assert ((got > MASK_NEG).sum(axis=-1) >= 1).all()


def test_sample_top_p_support_and_frequencies():
    """probs (.5, .3, .15, .05) at top_p 0.6 keep exactly {0, 1}
    (exclusive cumulative mass 0 and .5), renormalized to (.625, .375)."""
    logits = torch.log(torch.tensor([0.5, 0.3, 0.15, 0.05]))[None].repeat(4000, 1)
    toks = t_pizero.sample_top_p(torch.Generator().manual_seed(0), logits, 1.0, 0.6)
    counts = np.bincount(toks.numpy(), minlength=4)
    assert counts[2] == 0 and counts[3] == 0
    assert abs(counts[0] / counts.sum() - 0.625) < 0.03


def test_sampled_decode_reproducible_and_top_p_to_zero_is_greedy(lively_text):
    _, tcfg, _, tparams = lively_text
    ids, pix = (torch.from_numpy(x) for x in prompts(tcfg, seed=4))

    def sampled(seed, top_p):
        return t_pizero.generate_text(tparams, tcfg, ids, pix, max_new_tokens=5,
                                      generator=torch.Generator().manual_seed(seed), temperature=0.8, top_p=top_p)

    assert torch.equal(sampled(11, 0.9), sampled(11, 0.9))
    greedy = t_pizero.generate_text(tparams, tcfg, ids, pix, max_new_tokens=5)
    assert torch.equal(sampled(3, 1e-6), greedy)


# --------------------------------------------------------------------------- #
# the reference's golden text logits and the facade
# --------------------------------------------------------------------------- #


def _check_golden_text(model: PaliGemmaForConditionalGeneration, payload) -> None:
    ids, pix = payload["ids"].astype(np.int32), np.ascontiguousarray(payload["pix"].transpose(0, 2, 3, 1))  # NHWC
    got = model.logits(ids, pix)
    print(f"golden text logits: max|diff| {np.abs(got.numpy() - payload['want']).max():.3e}")
    np.testing.assert_allclose(got.numpy(), payload["want"], rtol=2e-3, atol=2e-3)
    toks = model.generate(ids, pix, max_new_tokens=3)
    assert int(toks[0, 0]) == int(payload["want"][0, -1].argmax())


def test_golden_text_logits_replay():
    """The reference's ``infer_text`` logits: its state dict through the
    port's VLA converter."""
    payload = golden.load_fixture_or_skip("pizero_text_logits")
    cfg = fixture_cfg(lm_head=True)
    params = t_convert.to_dtype(t_convert.convert_vla_state_dict(payload["state"], cfg), torch.float32)
    _check_golden_text(PaliGemmaForConditionalGeneration(cfg, params), payload)


def test_golden_text_logits_through_from_pretrained(tmp_path):
    """The same state under the HF PaliGemma names, in a safetensors file,
    through the facade's ``from_pretrained`` (the port's reader and
    ``convert_paligemma``)."""
    pytest.importorskip("safetensors")
    from safetensors.torch import save_file

    payload = golden.load_fixture_or_skip("pizero_text_logits")
    hf = {}
    for k, v in payload["state"].items():
        if k.startswith("joint_model.mixtures.vlm."):
            hf["language_model.model." + k[len("joint_model.mixtures.vlm."):]] = v
        elif k == "embed_tokens.weight":
            hf["language_model.model.embed_tokens.weight"] = v
        elif k.startswith(("vision_tower.", "multi_modal_projector.")):
            hf[k] = v
    save_file({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in hf.items()}, str(tmp_path / "model.safetensors"))
    model = PaliGemmaForConditionalGeneration.from_pretrained(str(tmp_path), base=fixture_cfg(), device="cpu")
    assert model.cfg == fixture_cfg(lm_head=True)
    assert set(model.params) == {"embed_tokens", "siglip", "projector", "joint"}
    _check_golden_text(model, payload)


def test_facade_generate_and_logits():
    """tests/test_paligemma_facade.py's checks on the port's facade."""
    model = PaliGemmaForConditionalGeneration.init(t_config.tiny_pizero_config(), device="cpu")
    assert model.cfg.use_lm_head and model.cfg.joint.mixtures[0].use_final_norm
    n_img = model.cfg.siglip.num_image_tokens
    ids = np.full((1, n_img + 3), 7, np.int32)
    ids[:, :n_img] = model.cfg.image_token_index
    ids[:, n_img] = 2
    pix = np.random.default_rng(0).normal(size=(1, 28, 28, 3)).astype(np.float32)
    toks = model.generate(ids, pix, max_new_tokens=5)
    assert toks.shape == (1, 5) and toks.dtype == torch.int64
    logits = model.logits(ids, pix)
    assert logits.shape == (1, ids.shape[1], model.cfg.vocab_size) and torch.isfinite(logits).all()
    assert int(logits[0, -1].argmax()) == int(toks[0, 0])


def test_compiled_decode_needs_a_card(text):
    _, tcfg, _, tparams = text
    with pytest.raises(RuntimeError, match="needs a card"):
        t_compiled.CompiledDecode(tparams, tcfg, 1, 16, device="cpu")


class _EagerGraph:
    """Stands in for a captured graph on the CPU: a replay runs the step."""

    def __init__(self, fn):
        self.replay, self.pool = fn, lambda: None


def test_compiled_decode_state_machine_is_generate_texts(lively_text, monkeypatch):
    """``CompiledDecode``'s step on its static buffers (the token, the
    offset and step index as 0-d tensors, the done flags, the emitted
    tokens), run eagerly where a card would replay it: ``generate_text``'s
    greedy tokens, EOS padding included, over two calls of one decoder."""
    _, tcfg, _, tparams = lively_text
    monkeypatch.setattr(t_compiled, "_graph_device", lambda device, on_cpu: torch.device(device))
    monkeypatch.setattr(t_compiled, "_capture", lambda fn, device, pool: (_EagerGraph(fn), fn(), None))
    ids, pix = (torch.from_numpy(x) for x in prompts(tcfg, seed=6))
    free = t_pizero.generate_text(tparams, tcfg, ids, pix, max_new_tokens=6)
    eos = int(free[1, 2])
    decoder = t_compiled.CompiledDecode(tparams, tcfg, 2, ids.shape[1] + 6, eos_token_id=eos, device="cpu")
    for seed in (6, 7):
        ids, pix = (torch.from_numpy(x) for x in prompts(tcfg, seed=seed))
        want = t_pizero.generate_text(tparams, tcfg, ids, pix, max_new_tokens=6, eos_token_id=eos)
        assert torch.equal(decoder(ids, pix, 6), want)
    with pytest.raises(ValueError, match="must fit"):
        decoder(ids, pix, 7)


# --------------------------------------------------------------------------- #
# the serving trees
# --------------------------------------------------------------------------- #


TREES = {
    "fused": {},
    "int8_vlm": dict(quantize_mixtures=("vlm",)),  # scripts/bench_textgen.py's tier
    "production": PRODUCTION,  # W8A8 vlm trunk
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_generation_on_serving_trees_matches_jax(text, lively_text, tree):
    """Greedy tokens on the lively tree; logits on the tree at init (1e-4),
    but for W8A8's (the next test)."""
    jcfg, tcfg = text[:2]
    ids, pix = prompts(jcfg, seed=5)
    (jtree, ttree), (jlive, tlive) = (
        (j_fuse.prepare_for_serving(j, **TREES[tree]), t_fuse.prepare_for_serving(t, **TREES[tree]))
        for j, t in (text[2:], lively_text[2:])
    )
    got, want = _generate_both(jcfg, tcfg, jlive, tlive, ids, pix, max_new_tokens=5)
    np.testing.assert_array_equal(got, want)
    if tree != "production":
        want = j_pizero.infer_text_logits(jtree, jcfg, jnp.asarray(ids), jnp.asarray(pix))
        got = t_pizero.infer_text_logits(ttree, tcfg, torch.from_numpy(ids), torch.from_numpy(pix))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_w8a8_text_logits_match_jax_on_the_same_int8_activations(text, monkeypatch):
    """The W8A8 trunk quantizes each token's activations to int8. Where the
    two sides' fp32 sums put an activation on either side of a rounding
    boundary, the int8 values differ by one and the logits by up to 5e-2
    here. So: JAX's quantizer on each activation the port quantized gives
    the port's int8 values and scales bitwise, and JAX's logits with those
    int8 activations handed in are the port's within 1e-4."""
    jcfg, tcfg, jparams, tparams = text
    jtree, ttree = j_fuse.prepare_for_serving(jparams, **PRODUCTION), t_fuse.prepare_for_serving(tparams, **PRODUCTION)
    ids, pix = prompts(jcfg, seed=5)
    recorded, quantize = [], t_lin.quantize_act_per_token

    def recording(x):
        q, scale = quantize(x)
        recorded.append((x.numpy().copy(), q.numpy().copy(), scale.numpy().copy()))
        return q, scale

    monkeypatch.setattr(t_lin, "quantize_act_per_token", recording)
    got = t_pizero.infer_text_logits(ttree, tcfg, torch.from_numpy(ids), torch.from_numpy(pix))
    assert len(recorded) == 4 * tcfg.joint.num_hidden_layers  # qkv, o, gateup, down
    for x, q, scale in recorded:
        jq, jscale = j_quant.quantize_act_per_token(jnp.asarray(x))
        np.testing.assert_array_equal(np.asarray(jq), q)
        np.testing.assert_array_equal(np.asarray(jscale), scale)
    replay = iter(recorded)

    def handing_in(x):
        _, q, scale = next(replay)
        assert q.shape == x.shape
        return jnp.asarray(q), jnp.asarray(scale)

    monkeypatch.setattr(j_lora, "quantize_act_per_token", handing_in)
    monkeypatch.setattr(j_quant, "quantize_act_per_token", handing_in)
    with jax.disable_jit():  # JAX's layer scan as a Python loop: one call per layer
        want = j_pizero.infer_text_logits(jtree, jcfg, jnp.asarray(ids), jnp.asarray(pix))
    assert next(replay, None) is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m", range(1, 17))
def test_int8_row_padding_is_exact(m):
    """``int8_matmul`` pads a W8A8 product's rows to 17 with zeros (the
    card's ``torch._int_mm`` takes more than 16): its [M, N] result is
    bitwise the unpadded product."""
    gen = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, 64), dtype=torch.int8, generator=gen)
    b = torch.randint(-127, 128, (64, 40), dtype=torch.int8, generator=gen)
    got = t_lin.int8_matmul(a[None], b)
    assert got.shape == (1, m, 40) and got.dtype == torch.int32
    assert torch.equal(got[0], torch._int_mm(a, b))
