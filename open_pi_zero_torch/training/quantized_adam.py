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

Under tensor parallelism (``split_over``) a param may be this rank's slice
of a leaf split over the model group. JAX quantizes the whole leaf's
moments in blocks of its flat order, and GSPMD keeps that meaning on a
sharded leaf; a rank's slice of a column-split leaf is not contiguous in
that order, and its blocks may straddle ranks. So such a leaf's moments
are its slice's codes, shaped as the param, each coded by the scale of its
whole-leaf block (``ops/quantization.SliceBlocks``), and the whole leaf's
scales, the same on every rank: each rank takes its part of every block's
absmax, one all-reduce (MAX) over the group for all such leaves gives the
blocks' maxima, and each rank codes its values with them. The payloads and
scales are then JAX's, with no gather of the moments. The update takes two
passes over a sliced leaf, each ``CHUNK_BLOCKS`` blocks' worth of its
elements at a time: the first steps the param and takes the maxima, the
second recomputes the moments (the same ops on the same inputs) and codes
them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from open_pi_zero_torch.ops.quantization import (
    DEFAULT_BLOCK,
    SliceBlocks,
    block_scale,
    dequantize_blocks,
    quantize_blocks,
    quantize_scaled,
)
from open_pi_zero_torch.parallel import collectives
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
    carries the payloads and the counts. A param that ``split_over`` names
    holds its payloads shaped as itself and the whole leaf's scales."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay, count=0))
        self.slices: Dict[torch.Tensor, SliceBlocks] = {}
        self.group = None  # the model group the sliced params are split over

    def split_over(self, dims: Dict[torch.Tensor, int], mesh) -> None:
        """Tensor parallelism: each param in ``dims`` is this rank's slice
        of a leaf split along ``dims[p]`` (counted from the front) over the
        model group of ``mesh``; its moments are coded in the whole leaf's
        blocks. Call it before the first step."""
        self.slices = {p: SliceBlocks.of(p.shape, d, mesh.model_index, mesh.n_model) for p, d in dims.items()}
        self.group = mesh.model_group

    def load_state_dict(self, state_dict: dict) -> None:
        """torch's load, but each moment keeps its saved dtype: torch's own
        casts every state tensor of a float param to the param's dtype,
        which would turn the int8 payloads into fp32 for the rest of the
        run (4x the state and every later checkpoint). The one-device
        layout only: TP states are not saved."""
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
            sliced = self.slices.get(p)
            n_blocks = sliced.n_blocks if sliced else -(-p.numel() // DEFAULT_BLOCK)
            for m in ("mu", "nu"):
                st[m] = torch.zeros(p.shape if sliced else (n_blocks, DEFAULT_BLOCK), dtype=torch.int8,
                                    device=p.device)
                st[f"{m}_scale"] = torch.ones((n_blocks, 1), dtype=torch.float32, device=p.device)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW8bit takes no closure")
        with annotate("opz_adam8bit_step"):
            sliced = []
            for group in self.param_groups:
                group["count"] += 1
                for p in group["params"]:
                    if p in self.slices:
                        sliced.append((p, group, self._step_slice(p, group)))
                    else:
                        self._update_leaf(p, group)
            if sliced:  # every sliced leaf's blocks' maxima in one all-reduce over the model group
                maxima = collectives.all_reduce(torch.cat([m.reshape(-1) for *_, m in sliced]), self.group,
                                                op=dist.ReduceOp.MAX)
                offset = 0
                for p, group, m in sliced:
                    self._code_slice(p, group, block_scale(maxima[offset : offset + m.numel()].view_as(m)))
                    offset += m.numel()

    def _hyper(self, p: torch.Tensor, group: dict) -> tuple:
        full = lambda v: torch.full((), v, dtype=torch.float32, device=p.device)  # noqa: E731
        return (*group["betas"], full(_bias_correction(group["betas"][0], group["count"])),
                full(_bias_correction(group["betas"][1], group["count"])))

    @staticmethod
    def _grad(p: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        if p.grad is None:
            return torch.zeros(hi - lo, device=p.device)
        return p.grad.reshape(-1)[lo:hi].to(torch.float32)

    @staticmethod
    def _moments(b1: float, b2: float, mu_old: torch.Tensor, nu_old: torch.Tensor, g: torch.Tensor) -> tuple:
        return b1 * mu_old + (1 - b1) * g, b2 * nu_old + (1 - b2) * g * g

    @staticmethod
    def _step_param(p: torch.Tensor, group: dict, lo: int, hi: int, mu, nu, bc1, bc2) -> None:
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + group["eps"])
        flat_p = p.view(-1)
        if group["weight_decay"]:
            upd = upd + group["weight_decay"] * flat_p[lo:hi].to(torch.float32)
        flat_p[lo:hi].add_((-group["lr"] * upd).to(p.dtype))

    def _update_leaf(self, p: torch.Tensor, group: dict) -> None:
        b1, b2, bc1, bc2 = self._hyper(p, group)
        block = DEFAULT_BLOCK
        st = self._leaf_state(p)
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
            rows = slice(b0, b_end)
            mu_old = dequantize_blocks(st["mu"][rows], st["mu_scale"][rows], M_POWER).reshape(-1)[: hi - lo]
            nu_old = dequantize_blocks(st["nu"][rows], st["nu_scale"][rows], V_POWER).reshape(-1)[: hi - lo]
            mu, nu = self._moments(b1, b2, mu_old, nu_old, self._grad(p, lo, hi))
            self._step_param(p, group, lo, hi, mu, nu, bc1, bc2)
            pad = (b_end - b0) * block - (hi - lo)  # the tail's padding stays zero, as JAX pads
            new["mu"][rows], new["mu_scale"][rows] = quantize_blocks(F.pad(mu, (0, pad)).reshape(-1, block), M_POWER)
            new["nu"][rows], new["nu_scale"][rows] = quantize_blocks(F.pad(nu, (0, pad)).reshape(-1, block), V_POWER)
        st.update(new)

    def _slice_chunks(self, p: torch.Tensor):
        """(lo, hi, moments' old values, block ids) of each chunk of the
        sliced param ``p``'s flat order."""
        st, blocks = self._leaf_state(p), self.slices[p]
        step = CHUNK_BLOCKS * DEFAULT_BLOCK
        for lo in range(0, p.numel(), step):
            hi = min(lo + step, p.numel())
            ids = blocks.ids(lo, hi, p.device)
            old = [dequantize_blocks(st[m].view(-1)[lo:hi], st[f"{m}_scale"].view(-1)[ids], power)
                   for m, power in (("mu", M_POWER), ("nu", V_POWER))]
            yield lo, hi, old, ids

    def _step_slice(self, p: torch.Tensor, group: dict) -> torch.Tensor:
        """The first pass over a sliced param: steps it; returns this rank's
        part of the new moments' block maxima, [2, n_blocks] (zeros in the
        blocks it holds nothing of)."""
        b1, b2, bc1, bc2 = self._hyper(p, group)
        blocks = self.slices[p]
        maxima = torch.zeros((2, blocks.n_blocks), dtype=torch.float32, device=p.device)
        for lo, hi, (mu_old, nu_old), ids in self._slice_chunks(p):
            mu, nu = self._moments(b1, b2, mu_old, nu_old, self._grad(p, lo, hi))
            self._step_param(p, group, lo, hi, mu, nu, bc1, bc2)
            blocks.absmax_(maxima[0], mu, ids)
            blocks.absmax_(maxima[1], nu, ids)
        return maxima

    def _code_slice(self, p: torch.Tensor, group: dict, scales: torch.Tensor) -> None:
        """The second pass: the new moments coded by the whole leaf's block
        ``scales`` [2, n_blocks]."""
        b1, b2, _, _ = self._hyper(p, group)
        new = {m: torch.empty(p.shape, dtype=torch.int8, device=p.device) for m in ("mu", "nu")}
        for lo, hi, (mu_old, nu_old), ids in self._slice_chunks(p):
            mu, nu = self._moments(b1, b2, mu_old, nu_old, self._grad(p, lo, hi))
            new["mu"].view(-1)[lo:hi] = quantize_scaled(mu, scales[0][ids], M_POWER)
            new["nu"].view(-1)[lo:hi] = quantize_scaled(nu, scales[1][ids], V_POWER)
        self.state[p].update(new, mu_scale=scales[0][:, None].clone(), nu_scale=scales[1][:, None].clone())

