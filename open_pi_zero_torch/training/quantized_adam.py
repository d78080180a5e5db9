"""AdamW with blockwise-int8 moments (counterpart of the JAX package's
``training/quantized_adam.py``; the reference's ``bnb.optim.AdamW8bit``,
src/agent/train.py:171,194).

Each moment lives as an int8 payload plus one fp32 absmax scale per block
of 2048 (``ops/quantization.py``): a quarter of fp32 Adam's state. An
update dequantizes, applies AdamW in fp32 (bias correction, eps outside
the sqrt, decay added to the step), and quantizes again, with the JAX
package's codes: power 3 for the first moment (signed, near-log), power 4
for the second. The arithmetic is the JAX package's, op for op; the lr is
the group's, which ``training/optimizer.Optimizer`` sets from the schedule
at the count before the increment, as optax does.

A leaf is updated a slice of ``CHUNK_BLOCKS`` whole blocks at a time, so
that the fp32 temporaries of the 0.6 B-element VLM MLP kernels take 64 MB
each, not 2.4 GB. Blocks are independent, so the slicing changes no
number. A trained leaf without a grad steps as one with a zero grad, as in
JAX.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from open_pi_zero_torch.ops.quantization import DEFAULT_BLOCK, dequantize_blocks, quantize_blocks
from open_pi_zero_torch.utils.monitor import annotate

M_POWER, V_POWER = 3, 4  # the first and second moments' codes
CHUNK_BLOCKS = 8192  # blocks of a leaf updated at once


def _bias_correction(beta: float, count: int) -> float:
    """1 - beta^count in fp32, as JAX computes it from the fp32 count."""
    return float(np.float32(1.0) - np.power(np.float32(beta), np.float32(count)))


class AdamW8bit(torch.optim.Optimizer):
    """AdamW whose per-leaf state is the two moments' int8 payloads
    (``mu``, ``nu``: [n_blocks, DEFAULT_BLOCK]) and fp32 scales
    (``mu_scale``, ``nu_scale``: [n_blocks, 1]). Each param group counts
    its updates in ``count``; ``state_dict`` is torch's, so a checkpoint
    carries the payloads and the counts."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay, count=0))

    def load_state_dict(self, state_dict: dict) -> None:
        """torch's load, but each moment keeps its saved dtype: torch's own
        casts every state tensor of a float param to the param's dtype,
        which would turn the int8 payloads into fp32 for the rest of the
        run (4x the state and every later checkpoint)."""
        super().load_state_dict({**state_dict, "state": {}})  # the groups: hyperparameters and counts
        saved_ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        params = [p for g in self.param_groups for p in g["params"]]
        for i, p in zip(saved_ids, params):
            if i not in state_dict["state"]:
                continue
            st = state_dict["state"][i]
            n_blocks = -(-p.numel() // DEFAULT_BLOCK)
            for m in ("mu", "nu"):
                q, scale = st[m], st[f"{m}_scale"]
                if (q.dtype, scale.dtype) != (torch.int8, torch.float32) or (
                    tuple(q.shape), tuple(scale.shape)) != ((n_blocks, DEFAULT_BLOCK), (n_blocks, 1)):
                    raise ValueError(
                        f"AdamW8bit state {m} of param {i}: {q.dtype} {tuple(q.shape)} with {scale.dtype} scales "
                        f"{tuple(scale.shape)}, want int8 {(n_blocks, DEFAULT_BLOCK)} with float32 {(n_blocks, 1)}")
            self.state[p] = {k: v.to(p.device) for k, v in st.items()}

    def _leaf_state(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        if not st:  # zero moments: an all-zero block quantizes to q = 0, scale = 1
            n_blocks = -(-p.numel() // DEFAULT_BLOCK)
            for m in ("mu", "nu"):
                st[m] = torch.zeros((n_blocks, DEFAULT_BLOCK), dtype=torch.int8, device=p.device)
                st[f"{m}_scale"] = torch.ones((n_blocks, 1), dtype=torch.float32, device=p.device)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW8bit takes no closure")
        with annotate("opz_adam8bit_step"):
            for group in self.param_groups:
                group["count"] += 1
                for p in group["params"]:
                    self._update_leaf(p, group)

    def _update_leaf(self, p: torch.Tensor, group: dict) -> None:
        b1, b2 = group["betas"]
        eps, wd, lr, block = group["eps"], group["weight_decay"], group["lr"], DEFAULT_BLOCK
        st = self._leaf_state(p)
        full = lambda v: torch.full((), v, dtype=torch.float32, device=p.device)  # noqa: E731
        bc1, bc2 = full(_bias_correction(b1, group["count"])), full(_bias_correction(b2, group["count"]))
        flat_p = p.view(-1)
        flat_g = None if p.grad is None else p.grad.reshape(-1)
        n, n_blocks = p.numel(), st["mu"].shape[0]
        # the new moments go to new tensors, never into ones that a
        # state_dict handed out may share
        new = {}
        for m in ("mu", "nu"):
            new[m] = torch.empty((n_blocks, block), dtype=torch.int8, device=p.device)
            new[f"{m}_scale"] = torch.empty((n_blocks, 1), dtype=torch.float32, device=p.device)
        for b0 in range(0, n_blocks, CHUNK_BLOCKS):
            b_end = min(b0 + CHUNK_BLOCKS, n_blocks)
            lo, hi = b0 * block, min(b_end * block, n)
            g = torch.zeros(hi - lo, device=p.device) if flat_g is None else flat_g[lo:hi].to(torch.float32)
            rows = slice(b0, b_end)
            mu_old = dequantize_blocks(st["mu"][rows], st["mu_scale"][rows], M_POWER).reshape(-1)[: hi - lo]
            nu_old = dequantize_blocks(st["nu"][rows], st["nu_scale"][rows], V_POWER).reshape(-1)[: hi - lo]
            mu = b1 * mu_old + (1 - b1) * g
            nu = b2 * nu_old + (1 - b2) * g * g
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            if wd:
                upd = upd + wd * flat_p[lo:hi].to(torch.float32)
            flat_p[lo:hi].add_((-lr * upd).to(p.dtype))
            pad = (b_end - b0) * block - (hi - lo)  # the tail's padding stays zero, as JAX pads
            new["mu"][rows], new["mu_scale"][rows] = quantize_blocks(F.pad(mu, (0, pad)).reshape(-1, block), M_POWER)
            new["nu"][rows], new["nu_scale"][rows] = quantize_blocks(F.pad(nu, (0, pad)).reshape(-1, block), V_POWER)
        st.update(new)
