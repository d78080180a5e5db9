"""The port's env adapters (``agents/env_adapter.py``), its Lanczos-4
resize (``utils/image.py``) and statistics reader
(``data/normalization.py``) against the JAX package and OpenCV.

- ``resize_lanczos4`` is bitwise ``cv2.resize(..., INTER_LANCZOS4)`` (the
  JAX adapters' resize) on random uint8 frames at the sizes the adapters
  see, and at edge cases one pixel wide.
- The bridge and EDR adapters' ``preprocess`` and ``postprocess`` are
  bitwise the JAX adapters' on the same obs dicts and action chunks
  (the same numpy arithmetic; the JAX side resizes through cv2), with both
  normalization types, ``pad_proprio_to``, and the EDR sticky gripper
  across a reset.
"""

import json
import os

import numpy as np
import pytest

from open_pi_zero_torch import processing as t_proc
from open_pi_zero_torch.agents import env_adapter as t_ea
from open_pi_zero_torch.data import normalization as t_norm
from open_pi_zero_torch.envs import make_env as t_make_env
from open_pi_zero_torch.envs import warm_tokenizer as t_warm
from open_pi_zero_torch.utils import image as t_image
from open_pi_zero_tpu import processing as j_proc
from open_pi_zero_tpu.agents import env_adapter as j_ea
from open_pi_zero_tpu.envs import warm_tokenizer as j_warm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATS = {
    "bridge": os.path.join(ROOT, "configs/statistics/bridge_statistics.json"),
    "fractal": os.path.join(ROOT, "configs/statistics/fractal_statistics.json"),
}

# (source H, W) -> (destination w, h), cv2's dsize order
RESIZES = [((112, 112), (224, 224)), ((480, 640), (224, 224)), ((512, 640), (224, 224)), ((112, 112), (56, 56))]
EDGES = [((1, 1), (4, 3)), ((1, 37), (224, 224)), ((40, 1), (5, 9)), ((9, 6), (1, 1)), ((112, 112), (1, 224))]


@pytest.mark.parametrize("src,size", RESIZES + EDGES)
def test_resize_is_bitwise_opencv_lanczos4(src, size):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(sum(src) + sum(size))
    for _ in range(3):
        img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
        got = t_image.resize_lanczos4(img, size)
        want = cv2.resize(img, size, interpolation=cv2.INTER_LANCZOS4)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    # a flat frame stays flat (the weights sum to 2048 per tap row)
    flat = np.full(src + (3,), 77, np.uint8)
    np.testing.assert_array_equal(t_image.resize_lanczos4(flat, size), cv2.resize(flat, size, interpolation=cv2.INTER_LANCZOS4))


def test_resize_tables_are_cached_and_read_only():
    a = t_image.resize_matrix(112, 224)
    assert t_image.resize_matrix(112, 224) is a and not a.flags.writeable
    # each row's integer weights sum to the fixed-point one (2048)
    np.testing.assert_array_equal(a.sum(axis=1), np.full(224, 2048.0))
    with pytest.raises(ValueError, match="uint8"):
        t_image.resize_lanczos4(np.zeros((4, 4, 3), np.float32), (2, 2))


def test_statistics_reader_matches():
    from open_pi_zero_tpu.data.normalization import load_statistics_file as j_load

    for path in STATS.values():
        assert t_norm.load_statistics_file(path) == j_load(path)
        with open(path) as f:
            raw = json.load(f)
        for key in raw:
            assert t_norm.load_statistics_file(path, key) == j_load(path, key)


def test_normalization_helpers_are_bitwise():
    rng = np.random.default_rng(0)
    x, lo, hi = rng.normal(size=(5, 7)), rng.normal(size=7) - 1, rng.normal(size=7) + 1
    mean, std = rng.normal(size=7), rng.uniform(0.1, 2, 7)
    t, j = t_ea.BaseEnvAdapter, j_ea.BaseEnvAdapter
    np.testing.assert_array_equal(t.normalize_bound(x, lo, hi), j.normalize_bound(x, lo, hi))
    np.testing.assert_array_equal(t.denormalize_bound(x, lo, hi), j.denormalize_bound(x, lo, hi))
    np.testing.assert_array_equal(t.normalize_gaussian(x, mean, std), j.normalize_gaussian(x, mean, std))
    np.testing.assert_array_equal(t.denormalize_gaussian(x, mean, std), j.denormalize_gaussian(x, mean, std))


def test_warm_tokenizer_gives_the_jax_vocabulary():
    t_tok, j_tok = t_proc.FakeTokenizer(image_token_id=500), j_proc.FakeTokenizer(image_token_id=500)
    t_warm(t_tok)
    j_warm(j_tok)
    assert t_tok.vocab == j_tok.vocab and t_tok._next_word_id == j_tok._next_word_id
    assert len(t_tok.vocab) > 10


def _pair(kind, **kw):
    """The port's and the JAX package's adapter of ``kind`` on the same
    arguments; each builds its own warmed FakeTokenizer (no
    pretrained_model_path), as eval configs without weights do."""
    stats = STATS["bridge" if kind == "bridge" else "fractal"]
    kw = dict(dataset_statistics_path=stats, num_image_tokens=16, max_seq_len=24, image_token_index=500, **kw)
    kw.setdefault("image_size", (56, 56))
    return t_ea.make_adapter(kind, **kw), j_ea.make_adapter(kind, **kw)


def _assert_inputs_equal(a, b):
    assert a.keys() == b.keys() == {"input_ids", "attention_mask", "pixel_values", "proprios"}
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _obs_stream(task, seed):
    """Observations of a SimplerLite env under random commands, then ones
    with random orientations and gripper states (the envs hold the
    orientation fixed)."""
    env = t_make_env(task, seed=seed)
    rng = np.random.default_rng(seed)
    obs, _ = env.reset(options={"obj_init_options": {"episode_id": 1}})
    for i in range(6):
        yield env, obs, env.get_language_instruction()
        obs = env.step(np.concatenate([rng.uniform(-0.03, 0.03, 2), np.zeros(4), rng.uniform(-1, 1, 1)]))[0]
    for _ in range(6):
        q = rng.normal(size=4)
        eef = np.concatenate([rng.normal(0, 0.1, 3), q / np.linalg.norm(q), rng.uniform(0, 1, 1)])
        yield env, {"agent": {"eef_pos": eef}, "image": obs["image"]}, "a new instruction word"


@pytest.mark.parametrize("kind,task", [("bridge", "simpler_lite_reach"), ("edr", "simpler_lite_drawer"),
                                       ("fractal", "simpler_lite_drawer_top")])
@pytest.mark.parametrize("norm", ["bound", "gaussian"])
def test_preprocess_is_bitwise_the_jax_adapters(kind, task, norm):
    for image_size, pad in (((56, 56), None), ((224, 224), 10)):
        t_ad, j_ad = _pair(kind, image_size=image_size, proprio_normalization_type=norm,
                           action_normalization_type=norm, pad_proprio_to=pad)
        for env, obs, instruction in _obs_stream(task, 3):
            got, want = t_ad.preprocess(env, obs, instruction), j_ad.preprocess(env, obs, instruction)
            _assert_inputs_equal(got, want)
            if pad is not None:
                assert got["proprios"].shape[-1] == pad
        assert t_ad.processor.tokenizer.vocab == j_ad.processor.tokenizer.vocab


@pytest.mark.parametrize("kind", ["bridge", "edr"])
@pytest.mark.parametrize("norm", ["bound", "gaussian"])
def test_postprocess_is_bitwise_the_jax_adapters(kind, norm):
    """Action chunks -> simulator commands; for EDR the sticky gripper's
    state runs on across chunks and is cleared by reset, on both sides
    alike."""
    t_ad, j_ad = _pair(kind, action_normalization_type=norm, proprio_normalization_type=norm)
    rng = np.random.default_rng(1)
    for i in range(12):
        chunk = rng.uniform(-1, 1, (4, 7)).astype(np.float32)
        chunk[:, -1] = rng.choice([0.0, 0.1, 0.5, 0.9, 1.0, rng.uniform()], 4)
        if i == 6:
            t_ad.reset()
            j_ad.reset()
        got, want = t_ad.postprocess(chunk), j_ad.postprocess(chunk)
        assert got.dtype == want.dtype and got.shape == want.shape == (4, 7)
        np.testing.assert_array_equal(got, want)
        if kind == "edr":
            for attr in ("sticky_action_is_on", "gripper_action_repeat", "sticky_gripper_action"):
                assert getattr(t_ad, attr) == getattr(j_ad, attr), (i, attr)


def test_sticky_gripper_repeats_then_releases():
    t_ad, _ = _pair("edr")
    close = np.zeros((1, 7), np.float32)  # gripper 0 -> relative +1 (close)
    hold = np.full((1, 7), 0.5, np.float32)  # relative 0
    assert t_ad.postprocess(close)[0, -1] == 1.0
    outs = [t_ad.postprocess(hold)[0, -1] for _ in range(t_ad.STICKY_NUM_REPEAT)]
    assert outs[: t_ad.STICKY_NUM_REPEAT - 1] == [1.0] * (t_ad.STICKY_NUM_REPEAT - 1) and outs[-1] == 0.0
    t_ad.postprocess(close)
    t_ad.reset()
    assert t_ad.postprocess(hold)[0, -1] == 0.0


def test_make_adapter_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="unknown env adapter"):
        t_ea.make_adapter("nope")
    with pytest.raises(ValueError, match="normalization"):
        _pair("bridge", action_normalization_type="minmax")
    assert isinstance(_pair("fractal")[0], t_ea.EDRSimplerAdapter)
