"""Flow-matching timestep sampling (counterpart of the JAX package's
``training/sampling.py``; reference src/agent/train.py:239-247).

  uniform: stratified — one shared uniform offset + per-sample stride,
           modulo (1 - eps), so the batch covers [0,1) evenly.
  beta:    π0 paper — z ~ Beta(alpha, beta), t = (1-σmin)(1-z),
           emphasizing early (noisier) timesteps.

Draws come from an explicit ``torch.Generator``. ``torch.distributions.Beta``
takes no generator, so the beta branch draws Beta(alpha, 1) as U^(1/alpha)
with U uniform from the generator (its CDF is z^alpha). Every config has
``flow_beta: 1.0``; any other beta raises.
"""

from __future__ import annotations

import torch

from open_pi_zero_torch.config import PiZeroConfig

STRATIFIED_EPS = 1e-5


def sample_flow_time(generator: torch.Generator, bsz: int, cfg: PiZeroConfig) -> torch.Tensor:
    """[bsz] float32 flow times on the generator's device."""
    device = generator.device
    if cfg.flow_sampling == "uniform":
        offset = torch.rand((), generator=generator, device=device)
        i = torch.arange(bsz, dtype=torch.float32, device=device)
        return torch.remainder(offset + i / bsz, 1 - STRATIFIED_EPS)
    if cfg.flow_sampling == "beta":
        if cfg.flow_beta != 1.0:
            raise NotImplementedError(
                f"flow_beta={cfg.flow_beta}: only Beta(alpha, 1) is ported (every config uses 1.0)"
            )
        u = torch.rand((bsz,), generator=generator, device=device)
        z = u.pow(1.0 / cfg.flow_alpha)
        return ((1.0 - cfg.flow_sig_min) * (1.0 - z)).to(torch.float32)
    raise ValueError(f"invalid flow_sampling: {cfg.flow_sampling}")
