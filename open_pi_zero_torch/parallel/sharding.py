"""Tensor-parallel sharding rules for the PiZero param tree (counterpart of
the JAX package's ``parallel/sharding.py``): Megatron-style TP over the
``model`` axis of the mesh. At the end, ZeRO-1's layout over the ``data``
axis (``Zero1Shards``; the JAX package's is ``training/train_step.py``'s
``zero1_state_sharding``).

Rules (kernels are stored ``[(L,) in, out]``), as in JAX:
  column-parallel (split the out dim): attn q/k/v, mlp gate/up, SigLIP fc1
  row-parallel (split the in dim):     attn o, mlp down, SigLIP fc2
  replicated:                          norms (adaLN's too), adaLN-Zero's
                                       gates, embeddings, encoders, decoders
and a dim that does not divide over the model axis stays replicated. A
LoRA adapter ``<name>_lora: {a [(L,) in, r], b [(L,) r, out]}`` follows
its base (JAX's ``_spec_for``): where the base splits, a column-parallel
base's ``b`` splits on its out dim and a row-parallel base's ``a`` on its
in dim; the rank dim r never splits, and the other factor stays whole.
That whole factor's grad is partial on each rank (column-parallel
``da = xᵀ(dy_local b_localᵀ)``, row-parallel ``db = (x_local a_local)ᵀ
dy``): ``partial_grads`` names those leaves, and the TP train step sums
their grads over the model group once per update, after the backward.

A spec is a tuple like JAX's ``PartitionSpec``: ``()`` for a replicated
leaf, else one entry per dim with ``MODEL_AXIS`` at the split dim.

Deliberate differences from JAX, which can leave the split to GSPMD while
each rank here runs its own program on whole heads:
  (a) attention projections split by whole heads. Query heads (q, o) split
      when the attention is shardable (``attention_split``, JAX's
      ``shardable_attention``); K/V (k, v) only when Hkv % tp == 0. JAX
      splits the trunk's 256-wide k/v out dim at tp = 2 (Hkv = 1) and
      GSPMD gathers it again before RoPE, which rotates pairs across the
      two halves of a head; K1-shard replicates K/V in that case anyway
      (``pallas_attention.py:236``), so the function is the same. Their
      adapters follow: ``k_lora`` and ``v_lora`` stay whole at Hkv = 1.
  (b) biases: JAX leaves every stacked bias replicated. Here a
      column-parallel bias is split with its kernel, and a row-parallel
      bias (SigLIP o, fc2) stays whole and is added once, after the
      reduce: added on every rank it would count tp times.
  (c) quantized kernels. QLoRA's NF4 bases ``{q4, absmax}`` are taken and
      stay whole on every rank, as JAX leaves them (its rules match
      ``kernel``, int8 ``q`` and LoRA's ``a`` and ``b`` only): a slice of
      the payload is not a slice of the kernel, since the nibbles pack
      column c with column c + out/2 and the blocks (gcd(64, out) wide)
      straddle a column split (SigLIP's fc1: blocks of 16 across a
      2152-column split). A split projection multiplies by its rank's
      slice of the decoded kernel (``rank_kernel``). Refused: the int8
      serving payloads ``{q|qa, scale}``, which JAX shards like the float
      kernel and which would here be taken for the query kernel under
      ``q``, and the fused serving layout (models/fuse.py), whose split of
      a concatenated out dim would cut across the q|k|v and gate|up
      segments; TP serving keeps the canonical layout.
  (d) training: a rank's Adam moments and EMA average are shaped as its
      slices of the split leaves (``torch.optim`` over the rank's params),
      where JAX places the optimizer state replicated and lets GSPMD
      propagate the params' sharding into the update. Both rules are
      elementwise, so the numbers are the same; ``gather_tp`` puts whole
      leaves back together for a check. int8 moments are the exception
      to elementwise: their blocks run over the whole leaf's flat order,
      and a rank codes its slice with the whole leaf's block scales
      (``training/quantized_adam.AdamW8bit.split_over``), so the payloads
      and scales are JAX's. Taken under a model axis: LoRA adapters, NF4
      bases, int8 moments. Refused: ZeRO-1, which the JAX package does
      with replicated params only (``shard_state_zero1``).
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple

import torch

from open_pi_zero_torch.config import PiZeroConfig
from open_pi_zero_torch.models.tree import tree_leaves, tree_map
from open_pi_zero_torch.ops.lora import is_quantized_base
from open_pi_zero_torch.ops.quantization import DEFAULT_BLOCK, dequantize_kernel_nf4
from open_pi_zero_torch.parallel import collectives
from open_pi_zero_torch.parallel.mesh import MODEL_AXIS, Mesh, get_mesh
from open_pi_zero_torch.utils.monitor import annotate

COLUMN = frozenset({"q", "k", "v", "gate", "up", "fc1"})
ROW = frozenset({"o", "down", "fc2"})
FUSED = frozenset({"qkv", "gateup"})


def attention_split(num_heads: int, num_kv_heads: int, tp: int) -> Tuple[bool, bool]:
    """(query heads split, K/V heads split) over ``tp`` model ranks. Query
    heads split when the attention is shardable as in JAX: Hq % tp == 0
    with K/V either split (Hkv % tp == 0) or one replicated head (MQA, the
    MoT trunk), so each rank's GQA grouping stays whole."""
    q_split = num_heads % tp == 0 and (num_kv_heads % tp == 0 or num_kv_heads == 1)
    return q_split, q_split and num_kv_heads % tp == 0


def model_ranks() -> int:
    """The registered mesh's model-axis size (1 without a mesh)."""
    mesh = get_mesh()
    return 1 if mesh is None else mesh.n_model


def _splits(path: Tuple[str, ...], name: str, width: int, cfg: PiZeroConfig, tp: int) -> bool:
    """Whether projection ``name`` at ``path`` splits over ``tp`` model
    ranks, ``width`` wide along its split dim."""
    if "attn" in path:  # (a): whole heads
        if path[0] == "siglip":
            return cfg.siglip.num_attention_heads % tp == 0
        q_split, kv_split = attention_split(cfg.joint.num_attention_heads, cfg.joint.num_key_value_heads, tp)
        return kv_split if name in ("k", "v") else q_split
    return width % tp == 0


def _split_dim(path: Tuple[str, ...], leaf, cfg: PiZeroConfig, tp: int) -> Optional[int]:
    """The dim (counted from the end) a leaf splits along, or None."""
    last, parent = path[-1], (path[-2] if len(path) >= 2 else None)
    if parent is not None and parent.endswith("_lora"):  # an adapter: b's out dim or a's in dim, as its base
        name = parent[: -len("_lora")]
        if name not in COLUMN | ROW or (last == "b") != (name in COLUMN):
            return None  # the projector's, or the factor that stays whole
        dim = -1 if name in COLUMN else -2
        return dim if _splits(path, name, leaf.shape[dim], cfg, tp) else None
    if parent in COLUMN | ROW:
        name, part = parent, last
    elif last in COLUMN | ROW:
        name, part = last, "kernel"
    else:
        return None
    if part == "kernel" and leaf.ndim < 2:
        return None
    dim = -1 if name in COLUMN else -2
    if part == "bias":
        if name in ROW:
            return None  # (b): added once, after the reduce
        dim = -1
    return dim if _splits(path, name, leaf.shape[dim], cfg, tp) else None


def tp_param_specs(params: dict, cfg: PiZeroConfig, tp: int) -> dict:
    """Spec tree matching ``params`` for TP over ``tp`` model ranks."""

    def walk(node, path):
        if isinstance(node, dict):
            where = "/".join(path)
            if is_quantized_base(node):
                if "q4" in node:  # (c): NF4 stays whole
                    return {k: () for k in node}
                raise NotImplementedError(f"{where}: an int8 quantized serving kernel {sorted(node)} under "
                                          "tensor parallelism; TP takes float kernels and NF4 bases (models/fuse.py)")
            if FUSED & set(node):
                raise ValueError(f"{where}: the fused serving layout ({sorted(FUSED & set(node))}) under "
                                 "tensor parallelism; TP serving keeps the canonical layout (models/fuse.py)")
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        dim = _split_dim(path, node, cfg, tp) if tp > 1 else None
        if dim is None:
            return ()
        spec = [None] * node.ndim
        spec[node.ndim + dim] = MODEL_AXIS
        return tuple(spec)

    return walk(params, ())


def partial_grads(specs: dict) -> dict:
    """A tree of bools over ``specs``: True at a LoRA adapter's whole factor
    beside a split one (``a`` beside a column-parallel base's split ``b``,
    ``b`` beside a row-parallel base's split ``a``), whose grad each rank
    holds only its part of: the sum over the model group is the grad."""

    def walk(node, name):
        if name.endswith("_lora"):
            return {"a": bool(node["b"]), "b": bool(node["a"])}
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return False

    return walk(specs, "")


def rank_kernel(w, dim: int, split: bool, dtype: torch.dtype):
    """The kernel this rank multiplies by for a projection whose kernel is
    ``w``, when the TP rules ``split`` it along ``dim`` (-1 the out dim, -2
    the in dim), under a registered model axis: ``w`` as stored (a float
    kernel is the rank's slice already, ``shard_params_tp``), but a whole
    quantized one cut to the rank's slice: an NF4 base (c) decoded in
    ``dtype`` first (the single-device decode, so the slice holds the
    unsharded kernel's values); the weight-only int8 copy that
    ``infer_action`` decodes once per call from a whole NF4 base sliced as
    it is (its scales are per output column)."""
    mesh = get_mesh()
    if not (split and isinstance(w, dict) and mesh is not None and mesh.n_model > 1):
        return w

    def part(x: torch.Tensor, along: int) -> torch.Tensor:
        size = x.shape[along] // mesh.n_model
        return x.narrow(along, mesh.model_index * size, size)

    if "q4" in w:
        with annotate("opz_nf4_dequant"):
            return part(dequantize_kernel_nf4(w, dtype), dim)
    if "q" in w:
        return {"q": part(w["q"], dim), "scale": part(w["scale"], -1) if dim == -1 else w["scale"]}
    raise ValueError(f"a {sorted(w)} kernel under tensor parallelism: TP takes float kernels and NF4 bases")


def shard_params_tp(params: dict, cfg: PiZeroConfig, mesh: Mesh) -> dict:
    """This rank's params: its slice of every split leaf, copied so that
    the full tree can be freed; replicated leaves are the same tensors."""
    specs = tp_param_specs(params, cfg, mesh.n_model)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if not spec:
            return node
        dim = spec.index(MODEL_AXIS)
        size = node.shape[dim] // mesh.n_model
        part = node.narrow(dim, mesh.model_index * size, size)
        return part.clone(memory_format=torch.contiguous_format)

    return walk(params, specs)


def gather_tp(tree: dict, specs: dict, mesh: Mesh) -> dict:
    """Whole leaves from this rank's TP tree (params, grads or an average;
    ``specs`` from ``tp_param_specs`` of the whole tree): each split leaf
    all-gathered over the model group along its split dim, detached; the
    replicated leaves (and None) as they are. A collective: every rank of
    the model group calls it."""

    def leaf(x, spec):
        if x is None or not spec:
            return x
        return collectives.all_gather(x, mesh.model_group, dim=spec.index(MODEL_AXIS))

    return tree_map(leaf, tree, specs)


# --------------------------------------------------------------------------- #
# ZeRO-1: a leaf's optimizer state and average split over the data ranks
# --------------------------------------------------------------------------- #


def zero1_ranges(numel: int, n: int, k: int = 0) -> List[Tuple[int, int]]:
    """Rank r's (lo, hi) flat element range of a leaf of ``numel`` elements
    under ZeRO-1 over ``n`` data ranks: whole blocks of ``DEFAULT_BLOCK``
    (an int8 moment's scale block is never split), the leaf's blocks dealt
    in order as evenly as n allows, the first part to rank ``k % n``, so
    that leaves of a block or two (norms, biases, adapters) spread over the
    ranks. JAX splits each leaf's first axis that divides by n instead:
    the layout differs, not the numbers (ROADMAP.md §3)."""
    n_blocks = -(-numel // DEFAULT_BLOCK)
    out: List[Tuple[int, int]] = [(0, 0)] * n
    for part in range(n):
        b0, b1 = part * n_blocks // n, (part + 1) * n_blocks // n
        out[(part + k) % n] = (min(b0 * DEFAULT_BLOCK, numel), min(b1 * DEFAULT_BLOCK, numel))
    return out


def _leaves(tensors) -> list:
    return list(tensors) if isinstance(tensors, (list, tuple)) else tree_leaves(tensors)


class Zero1Shards:
    """ZeRO-1's layout of a list (or tree) of contiguous tensors over the
    data group of ``mesh``: ``ranges[i][r]`` is rank r's range of tensor
    i (``zero1_ranges``, the i-th tensor's parts starting at rank i).
    ``local`` takes this rank's parts as flat views; ``gather`` puts full
    tensors back together from every rank's parts (a collective: every
    rank of the data group calls it); ``select`` is the layout of some of
    the tensors, their ranges kept."""

    def __init__(self, tensors, mesh: Mesh):
        self.n, self.rank, self.group = mesh.n_data, mesh.data_index, mesh.data_group
        self.ranges = [zero1_ranges(t.numel(), self.n, k) for k, t in enumerate(_leaves(tensors))]

    def select(self, indices: Sequence[int]) -> "Zero1Shards":
        out = copy.copy(self)
        out.ranges = [self.ranges[i] for i in indices]
        return out

    def local(self, tensors) -> List[torch.Tensor]:
        """This rank's part of each tensor: a flat view into it."""
        return [t.detach().view(-1)[slice(*r[self.rank])] for t, r in zip(_leaves(tensors), self.ranges)]

    def gather(self, parts: Sequence[torch.Tensor], like) -> List[torch.Tensor]:
        """Full tensors shaped as ``like``'s leaves from every rank's
        ``parts`` (this rank's, as ``local`` lays them out)."""
        full = [torch.empty(t.shape, dtype=p.dtype, device=p.device) for t, p in zip(_leaves(like), parts)]
        for f, p, r in zip(full, parts, self.ranges):
            f.view(-1)[slice(*r[self.rank])] = p
        collectives.all_gather_ranges_(full, self.ranges, self.group)
        return full
