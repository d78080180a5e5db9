"""Inputs from the JAX package for diagnostic runs of the port's closed-loop
demonstration (``open_pi_zero_torch/scripts/demo_closed_loop.py``), written
where JAX is (this repo's CPU test host), in the port's formats, so that
the card's machine, which has no JAX, can train from them:

- ``jax_init_export``: the JAX package's init of the JAX script's
  ``model_geometry(hidden, layers, proprio_dim, heads, kv_heads,
  head_dim)`` from ``jax.random.key(seed)`` (the init of the JAX script's
  runs, whose seed is 0) as a checkpoint directory with a ``params/``
  export, which ``demo_closed_loop --init-params`` trains from;

and back: ``jax_closed_loop`` scores a ``params/`` export of the port's
trainer in the JAX package's closed loop (its ``run_eval``) on one leg
(``task`` reach, pick_place or drawer, with that leg's statistics file),
which tells a weak policy from a fault in the port's eval.

  python -m tests.demo_reference_inputs --init build/jax_init [--seed 0] \\
      [--proprio-dim 8] [--heads 8 --kv-heads 1 --head-dim 32]
  python -m tests.demo_reference_inputs --jax-eval path/to/ckpt_8000 \\
      --stats path/to/statistics.json [--task drawer] [--proprio-dim 8]

A cross-family checkpoint (``tri_lever``, ``multi_family``) has proprio 8:
its bridge legs pad their 7-dim proprio to 8, as the JAX script's eval does;
``drawer_lever``'s drawer leg is proprio 8 unpadded.
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np

BRIDGE_PROPRIO = 7  # POS_EULER; the fractal family's POS_QUAT is 8


def jax_script():
    """The JAX package's ``scripts/demo_closed_loop.py`` as a module (it
    imports JAX inside its functions only)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "demo_closed_loop.py")
    spec = importlib.util.spec_from_file_location("jax_demo_closed_loop", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_model_geometry(hidden: int, layers: int, proprio_dim: int = BRIDGE_PROPRIO, heads: int = 4,
                       kv_heads: int = 1, head_dim: int = 0) -> dict:
    """``model_geometry`` of the JAX script."""
    return jax_script().model_geometry(hidden, layers, proprio_dim=proprio_dim, heads=heads, kv_heads=kv_heads,
                                       head_dim=head_dim)


def jax_init_export(out_dir: str, hidden: int = 96, layers: int = 3, seed: int = 0, proprio_dim: int = BRIDGE_PROPRIO,
                    heads: int = 4, kv_heads: int = 1, head_dim: int = 0) -> dict:
    """Write the JAX package's init as ``out_dir/params/`` (with its
    ``meta.json``); returns the JAX tree (numpy leaves)."""
    import jax

    from open_pi_zero_torch.models.from_jax import params_from_jax
    from open_pi_zero_torch.training import checkpoint as ckpt_lib
    from open_pi_zero_tpu.config import ConfigDict, pizero_config_from_dict
    from open_pi_zero_tpu.models import pizero

    geometry = jax_model_geometry(hidden, layers, proprio_dim, heads, kv_heads, head_dim)
    cfg = pizero_config_from_dict(ConfigDict(geometry))
    tree = jax.tree.map(np.asarray, pizero.init_params(jax.random.key(seed), cfg))
    params = params_from_jax(tree, device="cpu")
    os.makedirs(os.path.join(out_dir, ckpt_lib.PARAMS_DIR), exist_ok=True)
    ckpt_lib._save(params, os.path.join(out_dir, ckpt_lib.PARAMS_DIR, ckpt_lib.PARAMS_FILE))
    ckpt_lib._write_meta(out_dir, {"source": f"open_pi_zero_tpu init, jax.random.key({seed})",
                                   "geometry": {"hidden": hidden, "layers": layers, "proprio_dim": proprio_dim,
                                                "heads": heads, "kv_heads": kv_heads,
                                                "head_dim": geometry["joint"]["config"]["head_dim"]}})
    return tree


def jax_closed_loop(ckpt_dir: str, stats_path: str, n_episodes: int = 40, seed: int = 1000, hidden: int = 96,
                    layers: int = 3, task: str = "reach", proprio_dim: int = BRIDGE_PROPRIO, heads: int = 4,
                    kv_heads: int = 1, head_dim: int = 0) -> dict:
    """The JAX package's closed-loop result (``scripts/demo_closed_loop.py``'s
    ``run_eval``) on leg ``task`` for the port's params export at
    ``ckpt_dir``, with that leg's statistics at ``stats_path``: the drawer
    through the EDR adapter, a bridge leg through the bridge adapter, its
    proprio padded to ``proprio_dim`` where that is wider than bridge's."""
    import jax.numpy as jnp

    from open_pi_zero_torch.models.tree import tree_map
    from open_pi_zero_torch.training import checkpoint as ckpt_lib
    from open_pi_zero_tpu.envs import warm_tokenizer
    from open_pi_zero_tpu.processing import FakeTokenizer

    if task not in ("reach", "pick_place", "drawer"):
        raise ValueError(f"task {task!r}: one of reach, pick_place, drawer")
    params = tree_map(lambda t: jnp.asarray(t.numpy()), ckpt_lib.restore_params(ckpt_dir, None, "cpu"))
    tokenizer = FakeTokenizer(image_token_id=500)
    warm_tokenizer(tokenizer)
    drawer = task == "drawer"
    pad_to = proprio_dim if not drawer and proprio_dim > BRIDGE_PROPRIO else None
    geometry = jax_model_geometry(hidden, layers, proprio_dim, heads, kv_heads, head_dim)
    return jax_script().run_eval(geometry, params, stats_path, tokenizer, n_episodes, seed, task=task,
                                 adapter_name="edr" if drawer else "bridge", pad_proprio_to=pad_to)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init", default=None, help="write the JAX init's params export here")
    ap.add_argument("--jax-eval", default=None, help="score this params export in the JAX package's closed loop")
    ap.add_argument("--stats", default=None, help="the statistics file of --jax-eval's leg")
    ap.add_argument("--task", default="reach", choices=["reach", "pick_place", "drawer"], help="--jax-eval's leg")
    ap.add_argument("--n-eval-episodes", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0, help="--init's key: jax.random.key(seed)")
    ap.add_argument("--hidden", type=int, default=96)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--proprio-dim", type=int, default=BRIDGE_PROPRIO,
                    help="8 for the drawer family and the cross-family mixes")
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=1)
    ap.add_argument("--head-dim", type=int, default=0, help="0 = max(16, hidden//4); the scale-up's is 32")
    return ap.parse_args(argv)


def main(argv=None):
    """Writes ``--init``; returns ``--jax-eval``'s result (None without it)."""
    args = parse_args(argv)
    geometry = dict(hidden=args.hidden, layers=args.layers, proprio_dim=args.proprio_dim, heads=args.heads,
                    kv_heads=args.kv_heads, head_dim=args.head_dim)
    if args.init:
        jax_init_export(args.init, seed=args.seed, **geometry)
    if not args.jax_eval:
        return None
    result = jax_closed_loop(args.jax_eval, args.stats, args.n_eval_episodes, task=args.task, **geometry)
    print("JAX closed loop:", result)
    return result


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
