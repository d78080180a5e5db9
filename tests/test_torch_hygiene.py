"""The port's boundaries: it imports neither jax, yaml, safetensors, optax,
orbax, tensorflow, transformers, cv2, PIL nor the JAX package; its source
names none of them (simpler_env and imageio only inside the functions that
need them); its host C++ (``csrc/*.cc``, the JPEG codec) includes no
libjpeg header and its build links no library; neither the port nor
``chip_smoke.py`` imports or names the module ``convert_jax_checkpoint``
(only its command line, ``python convert_jax_checkpoint.py ...``, in the
loaders' errors); and its serving loop answers concurrent requests with a
tiny model on the CPU.

The converter itself (``convert_jax_checkpoint.py`` at the repository's
root) is not scanned: it is not part of the port, and it imports JAX and
the JAX package by design, running where they are installed."""

import json
import os
import re
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from open_pi_zero_torch import config as t_config
from open_pi_zero_torch import serving
from open_pi_zero_torch.models import pizero as t_pizero

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "open_pi_zero_torch"


def _port_sources():
    files = sorted(p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh", ".cc"))
    return files + [REPO / "chip_smoke.py"]


def test_import_leaves_jax_and_yaml_out():
    # a subprocess: this test process has jax loaded by tests/conftest.py
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name != "__init__.py"
    )
    # the training slice's, the serving entry point's and the text path's
    # modules are among them
    for name in ("sampling", "schedules", "optimizer", "averaging", "train_step"):
        assert f"open_pi_zero_torch.training.{name}" in modules
    for name in ("yaml_subset", "config", "models.convert", "models.compiled", "scripts.serve", "models.paligemma"):
        assert f"open_pi_zero_torch.{name}" in modules
    # and single-device fine-tuning's
    for name in ("training.checkpoint", "training.quantized_adam", "agents.train", "processing", "utils.metric",
                 "utils.monitor"):
        assert f"open_pi_zero_torch.{name}" in modules
    # and closed-loop evaluation's and the launcher's
    for name in ("agents.eval", "agents.env_adapter", "envs.reach_env", "envs.pick_place_env", "envs.drawer_env",
                 "utils.geometry", "utils.image", "data.normalization", "scripts.run",
                 "scripts.try_checkpoint_in_simpler"):
        assert f"open_pi_zero_torch.{name}" in modules
    # and the demonstration scripts'
    for name in ("scripts.demo_closed_loop", "scripts.eval_scaleup_ckpt", "scripts.e2e_tier_sweep"):
        assert f"open_pi_zero_torch.{name}" in modules
    # and the TF-free data pipeline's
    for name in ("data.tfrecord", "data.tf_example", "data.images", "data.rlds", "data.oxe", "data.traj_transforms",
                 "data.obs_transforms", "data.pipeline", "data.streams", "data.goal_relabeling",
                 "data.task_augmentation", "agents.dataset"):
        assert f"open_pi_zero_torch.{name}" in modules
    # and the JPEG codec's, the offline resize's and the extended registry's
    for name in ("data.jpeg", "data.preprocess", "data.oxe_registry", "scripts.modify_rlds_dataset"):
        assert f"open_pi_zero_torch.{name}" in modules
    # and data-parallel training's (the mesh, the collectives, ZeRO-1's
    # layout, the rank programs, the multi-process dryrun)
    for name in ("parallel.mesh", "parallel.collectives", "parallel.sharding", "parallel.ranks",
                 "scripts.dryrun_multiprocess"):
        assert f"open_pi_zero_torch.{name}" in modules
    # and the last leftovers: module specs, the readiness harness and the
    # checking scripts
    for name in ("utils.spec", "scripts.verify_checkpoint", "scripts.model_memory", "scripts.check_sampling",
                 "scripts.check_data"):
        assert f"open_pi_zero_torch.{name}" in modules
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'yaml', 'safetensors', 'open_pi_zero_tpu', 'optax', 'orbax', 'tensorflow', "
        "'transformers', 'cv2', 'PIL', 'simpler_env', 'imageio'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_import_no_jax_package():
    # the JAX package's name may appear in notes that say which TPU kernel
    # a kernel replaces; what is refused is any import of it, jax, yaml,
    # safetensors, optax, orbax, tensorflow, transformers, cv2 or PIL (the
    # card's machine has none of them)
    names = "jax|jaxlib|yaml|safetensors|open_pi_zero_tpu|optax|orbax|tensorflow|transformers|cv2|PIL"
    bad = re.compile(
        rf"^\s*(import|from)\s+({names})\b|import_module\(\s*['\"]({names})\b",
        re.M,
    )
    # simpler_env and imageio only inside the functions that need them (real
    # Simpler tasks, video), never at a module's top level
    top_level = re.compile(r"^(import|from)\s+(simpler_env|imageio)\b", re.M)
    hits = [
        f"{p.relative_to(REPO)}: {m.group(0).strip()}"
        for p in _port_sources()
        for pattern in (bad, top_level)
        for m in pattern.finditer(p.read_text())
    ]
    assert hits == []
    lazy = [p.relative_to(REPO).as_posix() for p in _port_sources()
            if re.search(r"^\s+(import|from)\s+(simpler_env|imageio)\b", p.read_text(), re.M)]
    assert lazy == ["open_pi_zero_torch/agents/env_adapter.py", "open_pi_zero_torch/agents/eval.py",
                    "open_pi_zero_torch/scripts/verify_checkpoint.py"]


def test_sources_neither_import_nor_name_the_converter():
    # the loaders' errors give the converter's command line, which names
    # its file; any other mention (an import, an attribute, a module name
    # handed to importlib or runpy) ties the port to a script that needs JAX
    assert (REPO / "convert_jax_checkpoint.py").exists()
    assert REPO / "convert_jax_checkpoint.py" not in _port_sources()
    pattern = re.compile(r"\bconvert_jax_checkpoint\b(?!\.py)")
    hits = [f"{p.relative_to(REPO)}:{i + 1}: {line.strip()}" for p in _port_sources()
            for i, line in enumerate(p.read_text().splitlines()) if pattern.search(line)]
    assert hits == []
    assert any("python convert_jax_checkpoint.py" in p.read_text() for p in _port_sources())


def test_host_sources_need_no_libjpeg():
    from open_pi_zero_torch.ops import _build

    sources = sorted((PORT / "csrc").glob("*.cc"))
    assert [p.name for p in sources] == ["jpeg_codec.cc"]
    for p in sources:
        assert not re.search(r"#\s*include\s*[<\"](jpeglib|turbojpeg|jconfig|jmorecfg)\.h", p.read_text()), p
        command = _build.compile_command(p.stem, _build.BUILD_DIR / "x.so")
        assert not [arg for arg in command if arg.startswith("-l")], command


def _tiny_request(cfg, rng):
    n_img = cfg.siglip.num_image_tokens
    ids = np.zeros(cfg.max_image_text_tokens, np.int32)
    ids[:n_img] = cfg.image_token_index
    ids[n_img : n_img + 3] = [2, 10, 11]
    size = cfg.siglip.image_size
    return {
        "input_ids": ids,
        "pixel_values": rng.normal(size=(size, size, 3)).astype(np.float32),
        "attention_mask": (ids != cfg.pad_token_id).astype(np.int32),
        "proprios": rng.normal(size=(cfg.cond_steps, cfg.proprio_dim)).astype(np.float32),
    }


def test_batching_policy_serves_concurrent_requests_on_cpu():
    cfg = t_config.tiny_pizero_config()
    params = t_pizero.init_params(cfg, seed=0, device="cpu")
    policy = serving.BatchingPolicy(
        serving.make_infer_fn(params, cfg, device="cpu"), batch_sizes=(1, 2, 4)
    ).start()
    rng = np.random.default_rng(0)
    requests = [_tiny_request(cfg, rng) for _ in range(3)]
    results = [None] * 3
    try:
        threads = [
            threading.Thread(target=lambda i=i: results.__setitem__(i, policy.submit(requests[i])))
            for i in range(3)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)

        server = serving.ActionServer(("127.0.0.1", 0), policy)
        srv = threading.Thread(target=server.serve_forever, daemon=True)
        srv.start()
        try:
            port = server.server_address[1]
            over_tcp = serving.request_action("127.0.0.1", port, requests[0], timeout=60)
        finally:
            server.shutdown()
            server.server_close()
            srv.join(timeout=10)
    finally:
        policy.stop()
    for r in results + [over_tcp]:
        assert r.shape == (cfg.horizon_steps, cfg.action_dim)
        assert np.isfinite(r).all() and np.abs(r).max() <= cfg.final_action_clip_value
    assert policy.n_requests == 4
