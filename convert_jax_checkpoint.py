#!/usr/bin/env python
"""Convert a checkpoint of the JAX package (``open_pi_zero_tpu``, orbax)
into the format of the PyTorch port (``open_pi_zero_torch``), so that a
model trained with JAX is served, evaluated or fine-tuned by the port.

Run it where JAX and orbax are installed (the port's own machine needs
neither); it uses the host's CPU and no accelerator:

  python convert_jax_checkpoint.py SRC DST [--config configs/eval/bridge.yaml] [key=value ...]

SRC is a JAX checkpoint directory with a ``params/`` export (the
TrainAgent's ``ckpt_N``, or ``training/checkpoint.save_params``'s); a
directory with only ``state/`` raises the JAX package's own
FileNotFoundError. ``--config`` (with ``key=value`` overrides) is the
model's YAML, the one the checkpoint was trained or evaluated with: the
abstract tree is built from it as the JAX package's loaders build theirs
(``pizero.init_params`` under ``jax.eval_shape``, so no model is
initialised, then ``lora.quantize_per_model_config``: NF4 bases and LoRA
adapters where the config has them), in float32. The params are restored
through the JAX package's ``training/checkpoint.restore_params``, mapped
leaf by leaf by the port's ``models/from_jax.params_from_jax`` (each JAX
leaf released once converted, so one copy of the tree is alive), and
written by the port's ``training/checkpoint.save_params`` to ``DST``
(``params/params.pt``, ``meta.json`` with SRC's metadata, the NF4 layout
version included).

The port's loaders (``scripts/serve.py``, the EvalAgent, the TrainAgent's
``base_params_checkpoint``, ``scripts/verify_checkpoint.py``) then read
DST. This script is not part of the port: nothing in ``open_pi_zero_torch``
imports it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
DEFAULT_CONFIG = os.path.join(REPO, "configs", "eval", "bridge.yaml")

log = logging.getLogger("convert_jax_checkpoint")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("src", help="the JAX package's checkpoint directory (orbax)")
    parser.add_argument("dst", help="the port's checkpoint directory to write")
    parser.add_argument("--config", default=DEFAULT_CONFIG, help="the model's YAML")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides")
    return parser.parse_args(argv)


def abstract_params(model_cfg):
    """The JAX loaders' abstract tree of ``model_cfg`` (float32, NF4 bases
    and adapters per the config), as shapes and dtypes only."""
    import jax

    from open_pi_zero_tpu.models import pizero
    from open_pi_zero_tpu.ops import lora

    return jax.eval_shape(
        lambda: lora.quantize_per_model_config(pizero.init_params(jax.random.key(0), model_cfg), model_cfg)
    )


def to_port(tree: dict) -> dict:
    """The restored JAX tree as the port's tree of CPU tensors, converted
    leaf by leaf (a quantized kernel's dict at once, for its payload
    layout); each JAX leaf is dropped from ``tree`` once converted."""
    from open_pi_zero_torch.models.from_jax import params_from_jax
    from open_pi_zero_torch.ops.lora import is_quantized_base

    out = {}
    for key in list(tree):
        node = tree.pop(key)
        out[key] = to_port(node) if isinstance(node, dict) and not is_quantized_base(node) else \
            params_from_jax(node, device="cpu")
        del node
    return out


def read_meta(path: str) -> dict:
    meta = os.path.join(path, "meta.json")
    if not os.path.exists(meta):
        return {}
    with open(meta) as f:
        return json.load(f)


def convert(src: str, dst: str, config: str = DEFAULT_CONFIG, overrides=()) -> dict:
    """Convert ``src`` into ``dst``; returns the metadata written."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from open_pi_zero_tpu.config import load_config, pizero_config_from_dict
    from open_pi_zero_tpu.training import checkpoint as jax_ckpt

    from open_pi_zero_torch.training import checkpoint as port_ckpt

    src, dst = os.path.abspath(os.path.expanduser(src)), os.path.abspath(os.path.expanduser(dst))
    model_cfg = pizero_config_from_dict(load_config(config, list(overrides)))
    params = jax_ckpt.restore_params(src, abstract_params(model_cfg))
    meta = read_meta(src)
    port_ckpt.save_params(dst, to_port(params), extra=meta)
    written = read_meta(dst)
    if written.get("quant_layout_version") != meta.get("quant_layout_version"):
        raise ValueError(f"{src}: NF4 layout version {meta.get('quant_layout_version')!r}, but the port "
                         f"writes {written.get('quant_layout_version')!r}")
    return written


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    args = parse_args(argv)
    meta = convert(args.src, args.dst, args.config, args.overrides)
    log.info("%s -> %s (meta %s)", args.src, args.dst, meta)


if __name__ == "__main__":
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    main()
