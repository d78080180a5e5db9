"""One profiled window (``chip_smoke.profiled_window``) of the full-width bf16
chunk at B = 1, taken with device events only and with the host ops too,
twice each in turn: the seconds each window takes (the first of a process
also pays the profiler's set-up), the busy ms, the device events, K1's
launches and ms, the copies. Needs a card; imports nothing of JAX:

  python -m tests.profiler_window_probe
"""

import time

import numpy as np
import torch

import chip_smoke as cs
from open_pi_zero_torch import config as cfg_lib
from open_pi_zero_torch.models import pizero
from open_pi_zero_torch.ops import _build
from open_pi_zero_torch.ops import fused_attention as fa

# no annotate() range is named so: asking for it turns the host ops on
HOST_OPS = ("no_such_range",)


def main() -> None:
    t0 = time.time()
    _build.build(fa.SOURCE)
    print(f"build {time.time() - t0:.1f} s; card: {cs.card()}", flush=True)
    dev = torch.device("cuda", 0)
    cfg = cfg_lib.PiZeroConfig()
    params = pizero.init_params(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    batch = cs.example_batch(cfg, 1, rng)
    a0 = rng.normal(size=(1, cfg.horizon_steps, cfg.action_dim)).astype(np.float32)

    def chunk():
        cs.run_infer(params, cfg, batch, a0, dev, torch.bfloat16)

    chunk()
    torch.cuda.synchronize()
    per_chunk = cfg.joint.num_hidden_layers * (1 + cfg.num_inference_steps)
    expected = {None: None, cs.KERNEL_SYMBOL: per_chunk, "Memcpy": None, "Memset": None}
    for ranges in ((), HOST_OPS, (), HOST_OPS):
        t0 = time.time()
        got, events, wall = cs.profiled_window(chunk, expected, counted=(per_chunk, 0), ranges=ranges)
        print(f"ranges {ranges}: window {time.time() - t0:.2f} s, wall {wall:.1f} ms, events {len(events)}, "
              f"busy {got[None]}, K1 {got[cs.KERNEL_SYMBOL]}, memcpy {got['Memcpy']}, memset {got['Memset']}",
              flush=True)


if __name__ == "__main__":
    main()
