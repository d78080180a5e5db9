"""Flow-matching timestep sampling (counterpart of the JAX package's
``training/sampling.py``; reference src/agent/train.py:239-247).

  uniform: stratified — one shared uniform offset + per-sample stride,
           modulo (1 - eps), so the batch covers [0,1) evenly.
  beta:    π0 paper — z ~ Beta(alpha, beta), t = (1-σmin)(1-z),
           emphasizing early (noisier) timesteps.

Draws come from an explicit ``torch.Generator``. ``torch.distributions.Beta``
takes no generator, so the beta branch draws Beta(alpha, 1) as U^(1/alpha)
with U uniform from the generator (its CDF is z^alpha; every config has
``flow_beta: 1.0``, and resumes replay this stream), and Beta(alpha, beta)
for beta != 1 as X / (X + Y) with X ~ Gamma(alpha) and Y ~ Gamma(beta),
both from the generator (``torch._standard_gamma``). JAX draws from its
own generator: the two match in law, not draw by draw.
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
        if cfg.flow_beta == 1.0:
            u = torch.rand((bsz,), generator=generator, device=device)
            z = u.pow(1.0 / cfg.flow_alpha)
        else:
            shape = torch.full((2, bsz), cfg.flow_alpha, dtype=torch.float32, device=device)
            shape[1] = cfg.flow_beta
            x, y = torch._standard_gamma(shape, generator=generator)
            z = x / (x + y)
        return ((1.0 - cfg.flow_sig_min) * (1.0 - z)).to(torch.float32)
    raise ValueError(f"invalid flow_sampling: {cfg.flow_sampling}")
