"""Inputs from the JAX package for diagnostic runs of the port's closed-loop
demonstration (``open_pi_zero_torch/scripts/demo_closed_loop.py``), written
where JAX is (this repo's CPU test host), in the port's formats, so that
the card's machine, which has no JAX, can train from them:

- ``jax_init_export``: the JAX package's init of
  ``model_geometry(hidden, layers)`` from ``jax.random.key(seed)`` (the
  init of the JAX script's runs, whose seed is 0) as a checkpoint
  directory with a ``params/`` export, which ``demo_closed_loop
  --init-params`` trains from;

and back: ``jax_closed_loop`` scores a ``params/`` export of the port's
trainer in the JAX package's closed loop (its ``run_eval``), which tells
a weak policy from a fault in the port's eval.

  python -m tests.demo_reference_inputs --init build/jax_init [--seed 0]
  python -m tests.demo_reference_inputs --jax-eval path/to/ckpt_8000 \\
      --stats path/to/statistics.json
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np


def jax_script():
    """The JAX package's ``scripts/demo_closed_loop.py`` as a module (it
    imports JAX inside its functions only)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "demo_closed_loop.py")
    spec = importlib.util.spec_from_file_location("jax_demo_closed_loop", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_model_geometry(hidden: int, layers: int) -> dict:
    """``model_geometry`` of the JAX script."""
    return jax_script().model_geometry(hidden, layers)


def jax_init_export(out_dir: str, hidden: int = 96, layers: int = 3, seed: int = 0) -> dict:
    """Write the JAX package's init as ``out_dir/params/`` (with its
    ``meta.json``); returns the JAX tree (numpy leaves)."""
    import jax

    from open_pi_zero_torch.models.from_jax import params_from_jax
    from open_pi_zero_torch.training import checkpoint as ckpt_lib
    from open_pi_zero_tpu.config import ConfigDict, pizero_config_from_dict
    from open_pi_zero_tpu.models import pizero

    cfg = pizero_config_from_dict(ConfigDict(jax_model_geometry(hidden, layers)))
    tree = jax.tree.map(np.asarray, pizero.init_params(jax.random.key(seed), cfg))
    params = params_from_jax(tree, device="cpu")
    os.makedirs(os.path.join(out_dir, ckpt_lib.PARAMS_DIR), exist_ok=True)
    ckpt_lib._save(params, os.path.join(out_dir, ckpt_lib.PARAMS_DIR, ckpt_lib.PARAMS_FILE))
    ckpt_lib._write_meta(out_dir, {"source": f"open_pi_zero_tpu init, jax.random.key({seed})"})
    return tree


def jax_closed_loop(ckpt_dir: str, stats_path: str, n_episodes: int = 40, seed: int = 1000,
                    hidden: int = 96, layers: int = 3) -> dict:
    """The JAX package's closed-loop result (``scripts/demo_closed_loop.py``'s
    ``run_eval`` on the reach task) for the port's params export at
    ``ckpt_dir``."""
    import jax.numpy as jnp

    from open_pi_zero_torch.models.tree import tree_map
    from open_pi_zero_torch.training import checkpoint as ckpt_lib
    from open_pi_zero_tpu.envs import warm_tokenizer
    from open_pi_zero_tpu.processing import FakeTokenizer

    params = tree_map(lambda t: jnp.asarray(t.numpy()), ckpt_lib.restore_params(ckpt_dir, None, "cpu"))
    tokenizer = FakeTokenizer(image_token_id=500)
    warm_tokenizer(tokenizer)
    return jax_script().run_eval(jax_model_geometry(hidden, layers), params, stats_path, tokenizer, n_episodes, seed)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init", default=None, help="write the JAX init's params export here")
    ap.add_argument("--jax-eval", default=None, help="score this params export in the JAX package's closed loop")
    ap.add_argument("--stats", default=None, help="the statistics.json of --jax-eval's run")
    ap.add_argument("--seed", type=int, default=0, help="--init's key: jax.random.key(seed)")
    args = ap.parse_args()
    if args.init:
        jax_init_export(args.init, seed=args.seed)
    if args.jax_eval:
        print("JAX closed loop:", jax_closed_loop(args.jax_eval, args.stats))
