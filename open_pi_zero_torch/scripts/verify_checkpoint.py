"""Checkpoint-arrival readiness harness (counterpart of the JAX package's
``scripts/verify_checkpoint.py``): one command that, given weights, chains
every acceptance check in order, the hour-one procedure when real weights
land.

Stages (each prints PASS, FAIL or SKIP; the exit code is nonzero on any
FAIL):

  load      checkpoint -> float params: a reference ``.pt`` trainer
            checkpoint (``models/convert.load_vla_checkpoint``), a
            safetensors PaliGemma directory (``convert.load_safetensors_dir``)
            or a checkpoint directory of the port's trainer
            (``training/checkpoint.restore_params``; a JAX package's orbax
            directory raises with the command line of
            ``convert_jax_checkpoint.py``, which converts it); LoRA adapters
            merged, NF4 bases decoded
  textgen   greedy tokens on a fixed input against a recorded expectation
            (``--expected-tokens``); ``--tokenizer`` raises, since the
            PaliGemma tokenizer needs transformers, which the port does not
            use
  oracle    KV-cached ``infer_action`` against the no-cache
            ``infer_action_naive`` on the same noise (the reference's
            cache-vs-naive band: 5e-4 to 2.5e-3 mean L1 in bf16)
  drift     the production serving layout (fused, int8 action expert, W8A8
            VLM trunk and SigLIP) against the fused layout on the same
            chunk
  refine    ``infer_action_refined`` from t = 0.5 against the full flow on
            the same observation; report-only unless ``--refine-band``
  episodes  with ``simpler_env``, a closed-loop smoke of N episodes through
            the EvalAgent; else SKIP

``--self-test`` replays ``tests/fixtures/verify_selftest.npz`` (the
reference's tiny state_dict, its prefill logits and its action chunk, as
the JAX script replays it where the reference is not mounted): the state
goes through a ``.pt`` and the real load path, textgen's first greedy token
is held against the reference's logits, a parity stage holds
``infer_action`` against the reference's chunk (injected noise), then
oracle, drift and refine.

It runs on the card unless ``--device cpu``.

  python -m open_pi_zero_torch.scripts.verify_checkpoint --self-test [--device cpu]
  python -m open_pi_zero_torch.scripts.verify_checkpoint CKPT --config configs/eval/bridge.yaml \\
      [--bf16] [--expected-tokens toks.json] [--episodes 10] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from open_pi_zero_torch.models.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_CONFIG = os.path.join(REPO, "configs", "eval", "bridge.yaml")
SELFTEST_FIXTURE = os.path.join(REPO, "tests", "fixtures", "verify_selftest.npz")
DEFAULT_BAND = 2.5e-3

_RESULTS = []
_VALUES = {}  # stage -> the number it held against its band


def _report(stage: str, status: str, detail: str = "") -> None:
    _RESULTS.append((stage, status))
    print(f"[{stage:9s}] {status:4s}  {detail}", flush=True)


def _check(stage: str, ok: bool, detail: str) -> bool:
    _report(stage, "PASS" if ok else "FAIL", detail)
    return ok


# --------------------------------------------------------------------------- #
# stages
# --------------------------------------------------------------------------- #


def stage_load(path: str, cfg, dtype, device) -> dict:
    """Any supported weight format -> the float params on ``device``."""
    from open_pi_zero_torch.models import convert
    from open_pi_zero_torch.ops import lora as lora_lib
    from open_pi_zero_torch.scripts import serve
    from open_pi_zero_torch.training import checkpoint as ckpt_lib

    if path.endswith(".pt"):
        params = convert.load_vla_checkpoint(path, cfg, dtype)
        kind = "torch .pt trainer checkpoint"
    elif os.path.isdir(path) and any(f.endswith(".safetensors") for f in os.listdir(path)):
        params = convert.convert_paligemma(convert.load_safetensors_dir(path), cfg)
        kind = "safetensors (PaliGemma)"
    elif ckpt_lib.is_checkpoint(path):
        params = ckpt_lib.restore_params(path, serve.abstract_params(cfg), device)
        kind = "checkpoint directory of the port's trainer"
    else:
        ckpt_lib.refuse_orbax(path)
        raise FileNotFoundError(f"{path}: not a .pt, a safetensors directory or a checkpoint directory")
    if lora_lib.has_lora(params):
        kind += " + merged LoRA"
    if lora_lib.has_quantized_bases(params):
        kind += " + dequantized bases"
    params = convert.to_dtype(serve.merge_and_decode(params, cfg, dtype), dtype, device)
    n = sum(t.numel() for t in tree_leaves(params))
    size = f"{n / 1e9:.2f}B" if n >= 1e8 else f"{n / 1e6:.2f}M"
    _report("load", "PASS", f"{kind}, {size} params")
    return params


def example_inputs(cfg, device, dtype, b: int = 1, seed: int = 0):
    """The JAX script's example observation: all image tokens, <bos> and
    three text tokens, a normal image and proprio from the seed."""
    rng = np.random.default_rng(seed)
    n_img = cfg.siglip.num_image_tokens
    ids = np.zeros((b, cfg.max_image_text_tokens), np.int32)
    ids[:, :n_img] = cfg.image_token_index
    ids[:, n_img] = 2
    ids[:, n_img + 1: min(n_img + 4, cfg.max_image_text_tokens)] = 10
    am = (ids != cfg.pad_token_id).astype(np.int32)
    img = rng.normal(size=(b, cfg.siglip.image_size, cfg.siglip.image_size, 3)).astype(np.float32)
    prop = rng.normal(size=(b, cfg.cond_steps, cfg.proprio_dim)).astype(np.float32)
    return (torch.from_numpy(ids).to(device), torch.from_numpy(img).to(device, dtype), torch.from_numpy(am).to(device),
            torch.from_numpy(prop).to(device, dtype))


def _noise(cfg, seed: int, device, dtype) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((1, cfg.horizon_steps, cfg.action_dim), generator=g).to(device, dtype)


def stage_textgen(params, cfg, expected, tokenizer=None, max_new: int = 8) -> bool:
    """Greedy tokens on a fixed input against a recorded expectation (the
    tokens are printed for recording without one). A caption of a real
    image needs the PaliGemma tokenizer, which the port does not have:
    ``tokenizer`` raises."""
    from open_pi_zero_torch.models import pizero
    from open_pi_zero_torch.processing import load_paligemma_tokenizer

    if not cfg.use_lm_head:
        _report("textgen", "SKIP", "checkpoint has no lm head (VLA fine-tune)")
        return True
    if tokenizer is not None:
        load_paligemma_tokenizer(tokenizer)  # raises: the port has no PaliGemma tokenizer
    ids, img, _, _ = example_inputs(cfg, tree_leaves(params)[0].device, _dtype(params))
    ids = ids[:, : cfg.siglip.num_image_tokens + 3]
    with torch.no_grad():
        toks = pizero.generate_text(params, cfg, ids, img, max_new_tokens=max_new)[0].tolist()
    detail = f"tokens={toks}"
    if expected is None:
        _report("textgen", "PASS", detail + "  (no expectation recorded: save these tokens as the golden)")
        return True
    return _check("textgen", list(toks[: len(expected)]) == list(expected), f"{detail} vs expected {expected}")


def _dtype(params) -> torch.dtype:
    return next(t.dtype for t in tree_leaves(params) if t.is_floating_point())


def stage_oracle(params, cfg, band: float, seed: int = 1) -> bool:
    """Cached ``infer_action`` against the no-cache forward on the same
    noise."""
    from open_pi_zero_torch.models import pizero

    dtype = _dtype(params)
    device = tree_leaves(params)[0].device
    args = example_inputs(cfg, device, dtype, seed=seed)
    x0 = _noise(cfg, seed, device, dtype)
    with torch.no_grad():
        cached = pizero.infer_action(params, cfg, None, *args, action0=x0)
        naive = pizero.infer_action_naive(params, cfg, None, *args, action0=x0)
    drift = _VALUES["oracle"] = float((cached.float() - naive.float()).abs().mean())
    return _check("oracle", drift <= band, f"cached-vs-naive mean L1 {drift:.2e} (band {band:.1e})")


def stage_drift(params, cfg, band: float, seed: int = 2) -> bool:
    """The production serving layout against the fused layout on the same
    chunk. The fused copy is freed before the production one is built."""
    from open_pi_zero_torch.models import fuse, pizero

    dtype = _dtype(params)
    device = tree_leaves(params)[0].device
    args = example_inputs(cfg, device, dtype, seed=seed)
    x0 = _noise(cfg, 7, device, dtype)
    with torch.no_grad():
        want = pizero.infer_action(fuse.prepare_for_serving(params), cfg, None, *args, action0=x0).float()
        served = fuse.prepare_for_serving(params, quantize_mixtures=("action",), w8a8_mixtures=("vlm",),
                                          w8a8_siglip=True)
        got = pizero.infer_action(served, cfg, None, *args, action0=x0).float()
    drift = _VALUES["drift"] = float((got - want).abs().mean())
    return _check("drift", drift <= band, f"serving-vs-fused chunk L1 {drift:.2e} (band {band:.1e})")


def stage_refine(params, cfg, band, t_start: float = 0.5, seed: int = 3) -> bool:
    """The refined tier, warm-started from the full chunk re-noised to
    ``t_start``, against the full flow on the same observation:
    report-only unless ``band`` is given."""
    from open_pi_zero_torch.models import pizero

    dtype = _dtype(params)
    device = tree_leaves(params)[0].device
    args = example_inputs(cfg, device, dtype, seed=seed)
    with torch.no_grad():
        full = pizero.infer_action(params, cfg, torch.Generator(device).manual_seed(seed), *args)
        refined = pizero.infer_action_refined(params, cfg, torch.Generator(device).manual_seed(seed + 1), *args,
                                              full, t_start=t_start)
    gap = _VALUES["refine"] = float((refined.float() - full.float()).abs().mean())
    finite = bool(torch.isfinite(refined).all())
    if band is None:
        _report("refine", "PASS" if finite else "FAIL",
                f"refined(t={t_start})-vs-full chunk L1 {gap:.2e} (report-only; set --refine-band to enforce)")
        return finite
    return _check("refine", finite and gap <= band, f"refined(t={t_start})-vs-full chunk L1 {gap:.2e} (band {band:.1e})")


def stage_episodes(params, cfg_dict, episodes: int, device) -> bool:
    """A closed-loop Simpler smoke (reference eval.py:60-179)."""
    try:
        import simpler_env  # noqa: F401
    except ImportError:
        _report("episodes", "SKIP",
                f"simpler_env not installed: when an env is available, rerun with --episodes {episodes or 10}")
        return True
    from open_pi_zero_torch.agents.eval import EvalAgent

    cfg_dict["n_eval_episode"] = int(episodes or 10)
    stats = EvalAgent(cfg_dict, params=params, device=device).run()
    return _check("episodes", stats["n_episode"] >= int(episodes or 10),
                  f"success rate {stats.get('success_rate', float('nan')):.3f} over {stats['n_episode']} episodes")


# --------------------------------------------------------------------------- #
# self-test: the chain against the reference's recorded fixture
# --------------------------------------------------------------------------- #


def selftest_config():
    """The reference fixtures' tiny geometry with the lm head
    (``tests/test_reference_parity_pizero.build_our_cfg(lm_head=True)``)."""
    from open_pi_zero_torch.config import JointConfig, MixtureConfig, PiZeroConfig, SiglipConfig

    mixtures = (
        MixtureConfig(hidden_size=32, intermediate_size=64, use_final_norm=True, cache=True, rope_theta=10000.0),
        MixtureConfig(hidden_size=16, intermediate_size=32, use_final_norm=True, cache=True, rope_theta=100.0),
        MixtureConfig(hidden_size=16, intermediate_size=32, use_final_norm=True, cache=False, rope_theta=100.0),
    )
    joint = JointConfig(time_hidden_size=16, mixtures=mixtures, tie_proprio=False, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=1, head_dim=8, rms_norm_eps=1e-6,
                        attention_bias=False, attention_dropout=0.0)
    siglip = SiglipConfig(hidden_size=24, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
                          image_size=28, patch_size=14, num_image_tokens=4, projection_dim=32)
    return PiZeroConfig(vocab_size=64, pad_token_id=0, image_token_index=50, max_image_text_tokens=7, cond_steps=1,
                        horizon_steps=4, action_dim=3, proprio_dim=5, num_inference_steps=2,
                        final_action_clip_value=1.0, flow_sig_min=0.001, time_hidden_size=16, time_max_period=100.0,
                        siglip=siglip, joint=joint, use_lm_head=True)


def selftest_inputs(cfg):
    """The JAX script's self-test inputs (its draw order is part of the
    fixture): a text prompt and its image, then two observations and their
    noise."""
    n_img = cfg.siglip.num_image_tokens
    rng = np.random.default_rng(9)
    ids = np.full((1, n_img + 3), 7, np.int64)
    ids[:, :n_img] = cfg.image_token_index
    ids[:, n_img] = 2
    pix = rng.normal(size=(1, 3, cfg.siglip.image_size, cfg.siglip.image_size)).astype(np.float32)
    b = 2
    idsv = np.zeros((b, cfg.max_image_text_tokens), np.int64)
    idsv[:, :n_img] = cfg.image_token_index
    idsv[:, n_img] = 2
    idsv[0, n_img + 1: n_img + 3] = [10, 11]
    idsv[1, n_img + 1] = 12
    am = (idsv != 0).astype(np.int64)
    pixv = rng.normal(size=(b, 3, cfg.siglip.image_size, cfg.siglip.image_size)).astype(np.float32)
    prop = rng.normal(size=(b, cfg.cond_steps, cfg.proprio_dim)).astype(np.float32)
    a0 = rng.normal(size=(b, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)
    return ids, pix, idsv, am, pixv, prop, a0


def load_selftest_fixture(path: str = SELFTEST_FIXTURE) -> dict:
    """{"state": {dotted key: array}, "want_logits", "want_action"} from
    the fixture's flat ``a/b`` keys."""
    with np.load(path) as z:
        state = {k[len("state/"):]: z[k] for k in z.files if k.startswith("state/")}
        return {"state": state, "want_logits": z["want_logits"], "want_action": z["want_action"]}


def self_test(device) -> bool:
    from open_pi_zero_torch.models import pizero

    cfg = selftest_config()
    if not os.path.exists(SELFTEST_FIXTURE):
        _report("self-test", "SKIP", f"no fixture at {SELFTEST_FIXTURE}")
        return True
    payload = load_selftest_fixture()
    _report("self-test", "PASS", "recorded fixture of the reference")
    ids, pix, idsv, am, pixv, prop, a0 = selftest_inputs(cfg)

    # 1) the real load path: state_dict -> .pt -> load_vla_checkpoint
    state = {k: torch.from_numpy(v) for k, v in payload["state"].items()}
    with tempfile.TemporaryDirectory() as td:
        pt = os.path.join(td, "ckpt.pt")
        torch.save({"model": state, "cnt_update": 0}, pt)
        params = stage_load(pt, cfg, torch.float32, device)
    ok = True

    # 2) textgen: the first greedy token against the reference's prefill logits
    expected_first = int(payload["want_logits"][0, -1].argmax())
    with torch.no_grad():
        toks = pizero.generate_text(params, cfg, torch.from_numpy(ids).to(device),
                                    torch.from_numpy(pix.transpose(0, 2, 3, 1)).to(device), max_new_tokens=3)
    first = int(toks[0, 0])
    ok &= _check("textgen", first == expected_first, f"first greedy token {first} vs torch {expected_first}")

    # 3) infer_action against the reference's chunk (injected noise)
    with torch.no_grad():
        got = pizero.infer_action(
            params, cfg, None, torch.from_numpy(idsv).to(device),
            torch.from_numpy(pixv.transpose(0, 2, 3, 1)).to(device), torch.from_numpy(am).to(device),
            torch.from_numpy(prop).to(device), action0=torch.from_numpy(a0).to(device),
        ).cpu().numpy()
    err = float(np.max(np.abs(got - payload["want_action"])))
    ok &= _check("parity", err < 2e-4, f"infer_action max|diff| {err:.2e} vs torch")

    # 4) the oracle (fp32 here, so tight) and 5) the serving drift budget
    ok &= stage_oracle(params, cfg, band=1e-5)
    ok &= stage_drift(params, cfg, band=DEFAULT_BAND)
    ok &= stage_refine(params, cfg, band=None)
    stage_episodes(None, None, 0, device)  # skips without simpler_env
    return ok


# --------------------------------------------------------------------------- #


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint", nargs="?", help=".pt / safetensors dir / checkpoint dir of the port's trainer")
    p.add_argument("--self-test", action="store_true",
                   help="run the whole chain against the reference's recorded fixture at tiny geometry")
    p.add_argument("--config", default=DEFAULT_CONFIG)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--expected-tokens", help="JSON file: list of golden token ids")
    p.add_argument("--tokenizer", help="PaliGemma dir with tokenizer.model (raises: not ported)")
    p.add_argument("--image", help="image file for the caption check (with --tokenizer)")
    p.add_argument("--prompt", default="this image shows ", help="the caption's prompt (with --tokenizer)")
    p.add_argument("--oracle-band", type=float, default=DEFAULT_BAND,
                   help="cached-vs-naive mean-L1 budget (reference README.md:116)")
    p.add_argument("--drift-band", type=float, default=DEFAULT_BAND, help="quantized-serving chunk-L1 budget")
    p.add_argument("--refine-band", type=float, default=None,
                   help="refined-tier chunk-L1 budget; omitted = report-only")
    p.add_argument("--episodes", type=int, default=0, help="closed-loop episodes to run when simpler_env exists")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("overrides", nargs="*", help="key=value config overrides")
    return p.parse_intermixed_args(argv)  # key=value overrides may follow the options


def main(argv=None) -> dict:
    """Run the stages; returns {"ok", "results": [(stage, status)],
    "values": {stage: mean L1}, "seconds": {stage: s}}. Exits 1 on any
    FAIL when run as a script."""
    from open_pi_zero_torch import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    _RESULTS.clear()
    _VALUES.clear()
    seconds = {}

    def timed(stage, fn, *a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds[stage] = time.perf_counter() - t

    if args.self_test:
        ok = timed("self-test", self_test, device)
    else:
        if not args.checkpoint:
            raise SystemExit("checkpoint path required (or --self-test)")
        from open_pi_zero_torch.config import load_config, pizero_config_from_dict

        cfg_dict = load_config(args.config, [*args.overrides, f"checkpoint_path={args.checkpoint}"])
        model_cfg = pizero_config_from_dict(cfg_dict)
        dtype = torch.bfloat16 if args.bf16 else torch.float32
        params = timed("load", stage_load, os.path.expanduser(args.checkpoint), model_cfg, dtype, device)
        expected = None
        if args.expected_tokens:
            with open(args.expected_tokens) as f:
                expected = json.load(f)
        ok = timed("textgen", stage_textgen, params, model_cfg, expected, args.tokenizer)
        ok &= timed("oracle", stage_oracle, params, model_cfg, args.oracle_band)
        ok &= timed("drift", stage_drift, params, model_cfg, args.drift_band)
        ok &= timed("refine", stage_refine, params, model_cfg, args.refine_band)
        ok &= timed("episodes", stage_episodes, params, cfg_dict, args.episodes, device)

    n_fail = sum(1 for _, s in _RESULTS if s == "FAIL")
    ok = bool(ok) and not n_fail
    print(f"\n{'ALL STAGES PASSED' if ok else f'{n_fail} FAILURES'}", flush=True)
    return {"ok": ok, "results": list(_RESULTS), "values": dict(_VALUES), "seconds": seconds}


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
