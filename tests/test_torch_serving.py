"""The port's serving layer (``open_pi_zero_torch/serving.py``) with the
cases of the JAX package's ``tests/test_serving.py``: bucketing and
padding, error propagation, the tiny model over TCP, a malformed request,
draining on stop, both codecs, the refined tier's routing and the
stripping of ``prev_chunk``. Then the serve CLI's policy
(``open_pi_zero_torch/scripts/serve.py``) built on the CPU from a tiny
config with ``_base_`` and a reference ``.pt`` checkpoint, answering
fresh and refined requests as ``infer_action`` and
``infer_action_refined`` do on the same weights; and ``compile_chunk``,
which needs a card, refusing the CPU."""

import json
import socket
import threading
import time
from io import BytesIO

import numpy as np
import pytest
import torch

from open_pi_zero_torch import config as t_config
from open_pi_zero_torch import serving
from open_pi_zero_torch.models import compiled, pizero
from open_pi_zero_torch.scripts import serve
from open_pi_zero_torch.serving import (
    ActionServer,
    BatchingPolicy,
    open_action_connection,
    pack_frame,
    read_frame,
    request_action,
)
from tests import golden


def serve_in_thread(policy):
    srv = ActionServer(("127.0.0.1", 0), policy)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def close(srv, policy):
    srv.shutdown()
    srv.server_close()
    policy.stop()


def queue_then_start(policy, reqs):
    """Submit ``reqs`` from threads, wait until all are queued, then start
    the worker: the batching is deterministic however slow the host."""
    results = [None] * len(reqs)

    def call(i):
        results[i] = policy.submit(dict(reqs[i]))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    while policy._q.qsize() < len(reqs):
        time.sleep(0.01)
    policy.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    return results


def test_policy_buckets_pads_and_batches():
    seen = []

    def infer(batch):
        seen.append(batch["x"].shape[0])
        return np.tile(batch["x"][:, None, :], (1, 2, 1))  # [B, 2, d]

    policy = BatchingPolicy(infer, batch_sizes=(1, 4), batch_window_ms=30)
    try:
        xs = [np.full((3,), i, np.float32) for i in range(3)]
        results = queue_then_start(policy, [{"x": x} for x in xs])
        for x, r in zip(xs, results):
            np.testing.assert_array_equal(r, np.tile(x, (2, 1)))
        policy.stop()  # joins the completion thread, which counts after it wakes the callers
        assert policy.n_requests == 3 and policy.n_batches == 1
        assert seen == [4]  # 3 queued requests -> one bucket, padded to 4
    finally:
        policy.stop()


def test_policy_propagates_errors():
    def infer(batch):
        raise ValueError("boom")

    policy = BatchingPolicy(infer, batch_sizes=(1,), batch_window_ms=1).start()
    try:
        with pytest.raises(RuntimeError, match="boom"):
            policy.submit({"x": np.zeros(2, np.float32)})
    finally:
        policy.stop()


def _tiny_obs(cfg):
    ids = np.zeros((cfg.max_image_text_tokens,), np.int32)
    ids[: cfg.siglip.num_image_tokens] = cfg.image_token_index
    size = cfg.siglip.image_size
    return {
        "input_ids": ids,
        "pixel_values": np.zeros((size, size, 3), np.float32),
        "attention_mask": (ids != 0).astype(np.int32),
        "proprios": np.full((1, cfg.proprio_dim), 0.1, np.float32),
    }


def test_tcp_server_end_to_end_tiny_model():
    """The tiny model's eager chunk on the CPU, fused layout, 4 concurrent
    robots over TCP, with the refined tier on."""
    from open_pi_zero_torch.models import fuse

    cfg = t_config.tiny_pizero_config(num_inference_steps=2)
    params = fuse.prepare_for_serving(pizero.init_params(cfg, seed=0, device="cpu"))
    policy = BatchingPolicy(
        serving.make_infer_fn(params, cfg, device="cpu", seed=1), batch_sizes=(1, 4), batch_window_ms=20,
        refine_fn=serving.make_infer_fn(params, cfg, device="cpu", seed=2, t_start=0.5),
    ).start()
    srv, port = serve_in_thread(policy)
    try:
        obs = _tiny_obs(cfg)
        results = [None] * 4

        def call(i):
            results[i] = request_action("127.0.0.1", port, obs, timeout=60)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        for r in results:
            assert r is not None and r.shape == (cfg.horizon_steps, cfg.action_dim)
            assert np.isfinite(r).all() and np.abs(r).max() <= cfg.final_action_clip_value
        refined = request_action("127.0.0.1", port, {**obs, "prev_chunk": results[0]}, timeout=60)
        assert refined.shape == results[0].shape and np.isfinite(refined).all()
        assert np.abs(refined - results[0]).max() > 0  # not an echo
        policy.stop()  # joins the completion thread, which counts after it wakes the callers
        assert policy.n_requests == 5 and policy.n_refined == 1
    finally:
        close(srv, policy)


def test_tcp_malformed_request_gets_error_reply():
    """Bad JSON and missing keys get an error reply on that request without
    killing the connection or the server."""

    def infer(batch):
        return np.zeros((batch["input_ids"].shape[0], 2, 7), np.float32)

    policy = BatchingPolicy(infer, batch_sizes=(1,), batch_window_ms=1).start()
    srv, port = serve_in_thread(policy)
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            f = s.makefile("rwb")
            for bad in (b"this is not json\n", b'{"input_ids": [1]}\n'):
                f.write(bad)
                f.flush()
                assert "error" in json.loads(f.readline())
            ok = {"input_ids": [1, 2], "pixel_values": [[[0.0, 0.0, 0.0]]], "attention_mask": [1, 1],
                  "proprios": [[0.0]]}
            f.write((json.dumps(ok) + "\n").encode())
            f.flush()
            assert "action_chunk" in json.loads(f.readline())
    finally:
        close(srv, policy)


def test_stop_drains_pending_requests():
    """stop() fails still-queued requests fast, instead of leaving their
    submitters blocked for the whole submit() timeout."""
    policy = BatchingPolicy(lambda b: np.zeros((b["x"].shape[0], 2, 3), np.float32), batch_sizes=(1,))
    errors = []

    def call():
        try:
            policy.submit({"x": np.zeros(2, np.float32)}, timeout=30)
        except RuntimeError as e:
            errors.append(str(e))

    t = threading.Thread(target=call)
    t.start()
    while policy._q.qsize() < 1:
        time.sleep(0.01)
    t0 = time.monotonic()
    policy.stop()
    t.join(timeout=5)
    assert not t.is_alive() and time.monotonic() - t0 < 10
    assert errors == ["server shutting down"]


def test_pack_read_frame_roundtrip():
    arrays = {
        "a": np.arange(12, dtype=np.int32).reshape(3, 4),
        "b": np.random.default_rng(0).normal(size=(2, 2, 2)).astype(np.float32),
        "s": np.float32(3.5).reshape(()),
    }
    out = read_frame(BytesIO(pack_frame(arrays)))
    assert set(out) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(out[k], arrays[k])
        assert out[k].dtype == arrays[k].dtype


def _echo_obs(d=3):
    return {
        "input_ids": np.zeros((7,), np.int32),
        "pixel_values": np.zeros((4, 4, 3), np.float32),
        "attention_mask": np.zeros((7,), np.int32),
        "proprios": np.arange(d, dtype=np.float32).reshape(1, d),
    }


def _echo_policy(refine_fn=None):
    def infer(batch):  # doubles proprios: [B, 1, d] -> [B, 2, d]
        p = batch["proprios"][:, 0, :]
        return np.stack([p, 2 * p], axis=1)

    return BatchingPolicy(infer, batch_sizes=(1, 4), batch_window_ms=5, refine_fn=refine_fn).start()


def test_binary_and_json_codecs_interop():
    policy = _echo_policy()
    srv, port = serve_in_thread(policy)
    try:
        want = np.stack([np.arange(3), 2 * np.arange(3)]).astype(np.float32)
        np.testing.assert_allclose(request_action("127.0.0.1", port, _echo_obs(), binary=True), want)
        np.testing.assert_allclose(request_action("127.0.0.1", port, _echo_obs(), binary=False), want, atol=1e-6)
    finally:
        close(srv, policy)


def test_binary_error_reply_and_connection_survives():
    policy = _echo_policy()
    srv, port = serve_in_thread(policy)
    try:
        send, close_conn = open_action_connection("127.0.0.1", port)
        bad = _echo_obs()
        del bad["proprios"]
        with pytest.raises(RuntimeError, match="KeyError"):
            send(bad)
        assert send(_echo_obs()).shape == (2, 3)
        close_conn()
    finally:
        close(srv, policy)


def test_policy_routes_refined_requests():
    """With refine_fn set, each drain is split into a fresh and a refined
    sub-batch; results come from the right program, rows back to their
    callers."""
    calls = {"fresh": [], "refined": []}

    def infer(batch):
        calls["fresh"].append(batch["x"].shape[0])
        assert "prev_chunk" not in batch
        return np.tile(batch["x"][:, None, :], (1, 2, 1))

    def refine(batch):
        calls["refined"].append(batch["x"].shape[0])
        return batch["prev_chunk"] + 1.0

    policy = BatchingPolicy(infer, batch_sizes=(1, 4), batch_window_ms=30, refine_fn=refine)
    try:
        xs = [np.full((3,), i, np.float32) for i in range(4)]
        prev = np.full((2, 3), 10.0, np.float32)
        reqs = [{"x": xs[0]}, {"x": xs[1], "prev_chunk": prev}, {"x": xs[2]}, {"x": xs[3], "prev_chunk": prev + 5}]
        results = queue_then_start(policy, reqs)
        np.testing.assert_array_equal(results[0], np.tile(xs[0], (2, 1)))
        np.testing.assert_array_equal(results[2], np.tile(xs[2], (2, 1)))
        np.testing.assert_array_equal(results[1], prev + 1)
        np.testing.assert_array_equal(results[3], prev + 6)
        assert calls == {"fresh": [4], "refined": [4]}  # each: 2 requests padded to 4
        policy.stop()  # joins the completion thread, which counts after it wakes the callers
        assert policy.n_requests == 4 and policy.n_batches == 2 and policy.n_refined == 2
    finally:
        policy.stop()


def test_policy_strips_prev_chunk_when_refine_disabled():
    def infer(batch):
        assert "prev_chunk" not in batch
        return np.tile(batch["x"][:, None, :], (1, 2, 1))

    policy = BatchingPolicy(infer, batch_sizes=(1,), batch_window_ms=1).start()
    try:
        x = np.arange(3, dtype=np.float32)
        out = policy.submit({"x": x, "prev_chunk": np.zeros((2, 3), np.float32)})
        np.testing.assert_array_equal(out, np.tile(x, (2, 1)))
        assert policy.n_refined == 0
    finally:
        policy.stop()


def test_prev_chunk_passes_through_both_codecs():
    policy = _echo_policy(refine_fn=lambda batch: batch["prev_chunk"] * 10.0)
    srv, port = serve_in_thread(policy)
    try:
        obs = {**_echo_obs(), "prev_chunk": np.arange(6, dtype=np.float32).reshape(2, 3)}
        want = obs["prev_chunk"] * 10
        np.testing.assert_allclose(request_action("127.0.0.1", port, obs, binary=True), want)
        np.testing.assert_allclose(request_action("127.0.0.1", port, obs, binary=False), want, atol=1e-6)
        assert request_action("127.0.0.1", port, _echo_obs(), binary=True).shape == (2, 3)
    finally:
        close(srv, policy)


# --------------------------------------------------------------------------- #
# the serve CLI's policy on the CPU, from a config and a .pt checkpoint
# --------------------------------------------------------------------------- #

BASE_YAML = """\
# the reference fixtures' geometry (tests/test_reference_parity_pizero.py)
seed: 3
use_bf16: false
vocab_size: 64
pad_token_id: 0
image_token_index: 50
max_image_text_tokens: 7
cond_steps: 1
horizon_steps: 4
action_dim: 3
proprio_dim: 5
num_inference_steps: 2
time_hidden_size: 16
time_max_period: 100.0
mixture:
  vlm: {hidden_size: 32, intermediate_size: 64, use_final_norm: false, cache: true, rope_theta: 10000.0}
  proprio: {hidden_size: 16, intermediate_size: 32, use_final_norm: true, cache: true, rope_theta: 100.0}
  action: {hidden_size: 16, intermediate_size: 32, use_final_norm: true, cache: false, rope_theta: 100.0}
vision:
  config:
    hidden_size: 24
    intermediate_size: 48
    num_hidden_layers: 2
    num_attention_heads: 4
    image_size: 28
    patch_size: 14
    num_image_tokens: 4
vision_projector:
  config:
    vision_config: {projection_dim: 32}
joint:
  config: {num_hidden_layers: 2, num_attention_heads: 4, num_key_value_heads: 1, head_dim: 8}
"""


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    (tmp / "base.yaml").write_text(BASE_YAML)
    (tmp / "serve.yaml").write_text("_base_: base.yaml\nname: fixture_serving\ncheckpoint_path:\n")
    state = golden.load_fixture_or_skip("pizero_infer_action")["state"]
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}}, tmp / "ckpt.pt")
    return tmp


def cli_args(cli_files, *overrides):
    return serve.parse_args(["--config", str(cli_files / "serve.yaml"), "--device", "cpu", "--batch-sizes", "1,2",
                             f"checkpoint_path={cli_files / 'ckpt.pt'}", *overrides])


def test_cli_policy_serves_the_checkpoint_on_cpu(cli_files):
    """The production layout of the fixture's weights (quantize defaults to
    true), full and refined tiers: each reply equals the eager chunk on the
    same weights with the CLI's generators (seed, and seed + 1)."""
    args = cli_args(cli_files, "refine_from_prev=0.5")
    policy, cfg = serve.build_policy(args)
    assert cfg.joint.head_dim == 8 and cfg.siglip.hidden_size == 24
    obs = serve.example_request(cfg)
    obs["pixel_values"] = np.random.default_rng(0).normal(size=obs["pixel_values"].shape).astype(np.float32)
    policy.start()
    try:
        fresh = policy.submit(obs)
        refined = policy.submit({**obs, "prev_chunk": fresh})
    finally:
        policy.stop()
    assert policy.n_requests == 2 and policy.n_refined == 1

    config = t_config.load_config(args.config, overrides=args.overrides)
    assert config.name == "fixture_serving" and config.seed == 3  # _base_ inherited
    params = serve.load_params(config, cfg, torch.float32, torch.device("cpu"), random_init=False)
    assert "qa" in params["joint"]["mixtures"]["vlm"]["layers"]["attn"]["qkv"]  # W8A8 trunk
    x = {k: torch.from_numpy(v[None]) for k, v in obs.items()}
    inputs = (x["input_ids"], x["pixel_values"], x["attention_mask"], x["proprios"])
    want = pizero.infer_action(params, cfg, torch.Generator().manual_seed(3), *inputs)
    np.testing.assert_array_equal(fresh, want[0].numpy())
    want_refined = pizero.infer_action_refined(
        params, cfg, torch.Generator().manual_seed(4), *inputs, torch.from_numpy(fresh[None]), t_start=0.5
    )
    np.testing.assert_array_equal(refined, want_refined[0].numpy())


def test_cli_policy_refuses_what_is_not_ported(cli_files, tmp_path):
    with pytest.raises(NotImplementedError, match="orbax"):
        serve.build_policy(cli_args(cli_files, f"checkpoint_path={tmp_path}"))
    with pytest.raises(ValueError, match="checkpoint_path"):
        serve.build_policy(serve.parse_args(["--config", str(cli_files / "base.yaml"), "--device", "cpu"]))


def test_cli_loads_a_lora_pt_by_merging_its_adapters(cli_files, tmp_path):
    """A reference .pt with LoRA adapters loads: the adapters are merged
    into their bases before the serving layout. The fixture's adapters
    are (A, B) = (ones, 0.5) on vlm layer 0's q_proj, so the merged kernel
    is the base plus scaling * A @ B = the base + 16 everywhere."""
    state = golden.load_fixture_or_skip("pizero_infer_action")["state"]
    lora = {k: torch.from_numpy(v) for k, v in state.items()}
    lora["joint_model.mixtures.vlm.layers.0.self_attn.q_proj.lora_A"] = torch.ones(32, 32)
    lora["joint_model.mixtures.vlm.layers.0.self_attn.q_proj.lora_B"] = torch.full((32, 32), 0.5)
    lora["joint_model.mixtures.vlm.layers.1.self_attn.q_proj.lora_A"] = torch.zeros(32, 32)
    lora["joint_model.mixtures.vlm.layers.1.self_attn.q_proj.lora_B"] = torch.zeros(32, 32)
    torch.save(lora, tmp_path / "lora.pt")
    config = t_config.load_config(str(cli_files / "serve.yaml"), overrides=[f"checkpoint_path={tmp_path / 'lora.pt'}"])
    cfg = t_config.pizero_config_from_dict(config)
    plain = serve.load_params(
        t_config.load_config(str(cli_files / "serve.yaml"), overrides=["quantize=false", f"checkpoint_path={cli_files / 'ckpt.pt'}"]),
        cfg, torch.float32, torch.device("cpu"), random_init=False,
    )
    merged = serve.load_params(
        t_config.load_config(str(cli_files / "serve.yaml"), overrides=["quantize=false", f"checkpoint_path={tmp_path / 'lora.pt'}"]),
        cfg, torch.float32, torch.device("cpu"), random_init=False,
    )
    want, got = plain["joint"]["mixtures"]["vlm"]["layers"]["attn"]["qkv"], merged["joint"]["mixtures"]["vlm"]["layers"]["attn"]["qkv"]
    q_out = cfg.joint.num_attention_heads * cfg.joint.head_dim
    assert torch.equal(got[0, :, :q_out], want[0, :, :q_out] + 16.0) and torch.equal(got[1], want[1])
    assert torch.equal(got[:, :, q_out:], want[:, :, q_out:])
    served = serve.load_params(config, cfg, torch.float32, torch.device("cpu"), random_init=False)
    assert "qa" in served["joint"]["mixtures"]["vlm"]["layers"]["attn"]["qkv"]  # then the production layout


def test_compile_chunk_needs_a_card():
    cfg = t_config.tiny_pizero_config()
    params = pizero.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="needs a card"):
        compiled.compile_chunk(params, cfg, 1, generator=torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="needs a card"):
        serving.make_compiled_infer_fn(params, cfg, (1,), device="cpu")
