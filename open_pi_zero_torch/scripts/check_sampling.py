"""Flow-time sampling distribution check (counterpart of the JAX package's
``scripts/check_sampling.py``; reference scripts/tests/sampling.py:1-48):
draws N samples from the stratified uniform and the π0 Beta(1.5, 1)
samplers (``training/sampling.sample_flow_time``, on the CPU), prints a
text histogram and the moments of each, checks their shapes, and
optionally saves a matplotlib figure.

  python -m open_pi_zero_torch.scripts.check_sampling [--n 100000] [--plot /tmp/sampling.png]

``--plot`` needs matplotlib, which the port does not otherwise use: where
it is missing the script raises, saying so.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from open_pi_zero_torch.config import PiZeroConfig
from open_pi_zero_torch.training.sampling import sample_flow_time


def main(argv: Optional[List[str]] = None) -> Dict[str, np.ndarray]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=100_000)
    parser.add_argument("--bins", type=int, default=20)
    parser.add_argument("--plot", type=str, default="")
    args = parser.parse_args(argv)

    cfg = PiZeroConfig()
    results = {}
    for mode in ("uniform", "beta"):
        c = dataclasses.replace(cfg, flow_sampling=mode)
        t = sample_flow_time(torch.Generator().manual_seed(0), args.n, c).numpy()
        results[mode] = t
        hist, edges = np.histogram(t, bins=args.bins, range=(0.0, 1.0))
        peak = hist.max()
        print(f"\n{mode}: mean={t.mean():.4f} std={t.std():.4f} min={t.min():.4f} max={t.max():.4f}")
        for h, lo in zip(hist, edges[:-1]):
            print(f"  {lo:4.2f} {'#' * int(40 * h / peak)} {h}")

    # Beta(1.5, 1), flipped and shifted, emphasizes early timesteps
    assert results["beta"].mean() < 0.45, "beta sampler should skew early"
    u_hist, _ = np.histogram(results["uniform"], bins=args.bins, range=(0, 1))
    assert u_hist.min() > 0.8 * u_hist.max(), "stratified uniform should be flat"
    print("\nsampling distributions ok")

    if args.plot:
        try:
            import matplotlib
        except ImportError as e:
            raise ImportError(f"--plot needs matplotlib, which is not installed here ({e}); "
                              "run without --plot for the text histogram") from e
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 3))
        for mode, t in results.items():
            ax.hist(t, bins=50, range=(0, 1), alpha=0.5, density=True, label=mode)
        ax.set_xlabel("flow time t")
        ax.legend()
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        print(f"saved {args.plot}")
    return results


if __name__ == "__main__":
    main()
