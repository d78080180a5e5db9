"""Dual-group optimizer with freeze surgery (counterpart of the JAX
package's ``training/optimizer.py``; reference src/agent/train.py:169-210):

  - "action" group: action encoder/decoder, proprio encoder, action-expert
    mixture (proprio shares its weights) — AdamW at ``action_lr``.
  - "vlm" group: SigLIP tower, projector, vlm mixture — AdamW at ``vlm_lr``,
    or frozen entirely when ``train_vlm=False``.
  - "frozen": embed_tokens (reference pizero.py:251-256).

Frozen leaves take ``requires_grad=False``, so they get no grad buffer and
no Adam state, and the clip's global norm counts the trained leaves only,
as the reference's ``clip_grad_norm_`` does. (The JAX package differentiates
every float leaf and clips over all of them but embed_tokens: with LoRA
that includes the frozen float bases and an NF4 base's absmax. The port
does not compute those grads; ROADMAP.md §3 lists the difference.) A
LoRA tree trains only the VLM side's ``*_lora`` adapters, and a quantized
base is always frozen. The reference also leaves the *last layer's* vlm
post-attention norm, MLP, o_proj and v_proj untrained; with stacked
``[L, ...]`` params those are slices, not leaves, so their grads are zeroed
by surgery before the global-norm clip, and Adam, whose moments then stay
zero, leaves them bitwise unchanged.

One update: freeze surgery -> global-norm clip -> AdamW per group, each
group's lr set from its schedule at the update count first. Where optax
differs from ``torch.optim``, the port writes optax's arithmetic: the first
update takes ``schedule(0)``; the clip scales by ``max_norm / norm`` only
when ``norm >= max_norm`` (``clip_grad_norm_`` would scale by
``max_norm / (norm + 1e-6)`` always). ``torch.optim.AdamW`` is
optax.adamw's update (eps outside the sqrt, the same bias corrections,
decoupled decay ``p * (1 - lr * wd)``); the vlm decay must stay 0, as in
the JAX package. With ``quantize_optimizer_states`` the moments are int8
(``training/quantized_adam.AdamW8bit``, the JAX package's ``adamw8bit``). The surgery and the clip work in place on the ``.grad``
tensors, where JAX builds new trees.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from open_pi_zero_torch.config import TrainingConfig
from open_pi_zero_torch.models.tree import tree_leaves, tree_map
from open_pi_zero_torch.ops.lora import is_quantized_base, lora_label_fn
from open_pi_zero_torch.ops.quantization import DEFAULT_BLOCK
from open_pi_zero_torch.parallel import collectives
from open_pi_zero_torch.parallel.mesh import MODEL_AXIS, Mesh
from open_pi_zero_torch.parallel.sharding import Zero1Shards
from open_pi_zero_torch.training import schedules
from open_pi_zero_torch.training.quantized_adam import AdamW8bit

# vlm layer-stacked leaves whose last-layer slice is untrained
# (path inside joint.mixtures.vlm.layers)
UNUSED_LAST_LAYER_PATHS = (
    ("post_norm", "weight"),
    ("mlp", "gate"),
    ("mlp", "up"),
    ("mlp", "down"),
    ("attn", "o"),
    ("attn", "v"),
)
GROUPS = ("action", "vlm")


def _at(tree: dict, path):
    for key in path:
        tree = tree[key]
    return tree


def zero_unused_vlm_last_layer(grads: dict) -> dict:
    """Zero, in place, the last-layer slices of the untrained vlm leaves in
    a tree of grads (None leaves are skipped). Returns the tree."""
    vlm_layers = grads["joint"]["mixtures"]["vlm"]["layers"]
    for path in UNUSED_LAST_LAYER_PATHS:
        for g in tree_leaves(_at(vlm_layers, path)):  # a quantized kernel's are all None
            if g is not None:
                g[-1] = 0.0
    return grads


def apply_freeze_surgery(grads: dict) -> dict:
    """Zero, in place, the grads of the permanently frozen parts:
    embed_tokens (when it has a grad at all) and the unused last-layer vlm
    slices. Returns the tree."""
    if grads["embed_tokens"] is not None:
        grads["embed_tokens"].zero_()
    return zero_unused_vlm_last_layer(grads)


def param_labels(params: dict, train_vlm: bool = True, lora: bool = False) -> dict:
    """Label tree ("action" | "vlm" | "frozen"), the JAX package's routing
    (reference pizero.py:114-158). Quantized bases ({q4, absmax},
    {q|qa, scale}) are always frozen (the reference keeps bnb-quantized
    modules fully frozen, train.py:90-93). With ``lora`` the VLM side
    (SigLIP, the projector, the vlm mixture) trains only its ``*_lora``
    adapters (reference freeze_non_lora_weights_in_vlm, train.py:101-102);
    the action expert trains fully."""
    vlm_label = "vlm" if train_vlm else "frozen"
    top = {
        "embed_tokens": "frozen",
        "siglip": vlm_label,
        "projector": vlm_label,
        "action_encoder": "action",
        "proprio_encoder": "action",
        "action_decoder": "action",
    }

    def label_tree(subtree, label):
        if is_quantized_base(subtree):
            return tree_map(lambda _: "frozen", subtree)
        if isinstance(subtree, dict):
            return {k: label_tree(v, label) for k, v in subtree.items()}
        return label

    def vlm_side(subtree):
        return lora_label_fn(subtree, vlm_label, "frozen") if lora else label_tree(subtree, vlm_label)

    out = {}
    for k, sub in params.items():
        if k == "joint":
            out[k] = {
                "mixtures": {
                    name: vlm_side(t) if name == "vlm" else label_tree(t, "action")
                    for name, t in sub["mixtures"].items()
                }
            }
        elif k in ("siglip", "projector"):
            out[k] = vlm_side(sub)
        else:
            out[k] = label_tree(sub, top[k])
    return out


def trainable_param_count(params: dict, train_vlm: bool = True) -> Dict[str, float]:
    """Param counts per group in units of 1e9, as the JAX package counts
    them (reference train.py:167-208): by ``param_labels`` without the
    LoRA flag, a quantized payload by its stored elements, the surgically
    frozen last-layer vlm slices moved to "frozen" unless the kernel is
    quantized (then its whole dict is frozen already). The action group
    includes proprio via weight tying exactly once."""
    labels = param_labels(params, train_vlm)
    counts = {"action": 0, "vlm": 0, "frozen": 0}
    for lab, leaf in zip(tree_leaves(labels), tree_leaves(params)):
        counts[lab] += leaf.numel()
    if train_vlm:
        vlm_layers = params["joint"]["mixtures"]["vlm"]["layers"]
        for path in UNUSED_LAST_LAYER_PATHS:
            node = _at(vlm_layers, path)
            if isinstance(node, dict):
                continue
            counts["vlm"] -= node[0].numel()
            counts["frozen"] += node[0].numel()
    return {k: v / 1e9 for k, v in counts.items()}


def global_norm(tensors: List[Optional[torch.Tensor]], split: Optional[List[bool]] = None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (None skipped), in fp32:
    the norm of the per-tensor norms, which needs no squared copy of a
    tensor. Under tensor parallelism (``split``: per tensor, whether it is
    this rank's slice of a leaf split over the model ``group``) the norm of
    the whole tree: the slices' squared norms summed over the group, the
    replicated tensors counted once, so that every rank clips alike."""
    kept = [(t, s) for t, s in zip(tensors, split or [False] * len(tensors)) if t is not None]
    norms = [torch.linalg.vector_norm(t.detach(), dtype=torch.float32) for t, _ in kept]
    if split is None:
        return torch.linalg.vector_norm(torch.stack(norms))

    def sum_of_squares(sliced: bool) -> torch.Tensor:
        mine = [n for n, (_, s) in zip(norms, kept) if s == sliced]
        return torch.stack(mine).square().sum() if mine else norms[0].new_zeros(())

    return torch.sqrt(sum_of_squares(False) + collectives.all_reduce(sum_of_squares(True).reshape(1), group)[0])


class Optimizer:
    """freeze surgery -> global-norm clip -> per-group AdamW with
    cosine-warmup schedules: the counterpart of ``build_optimizer``'s optax
    chain. Like an optax transformation it holds no state: ``init`` returns
    the state (a ``torch.optim.AdamW`` over the trained leaves, whose
    moments are the Adam state) and ``update`` applies one update."""

    def __init__(self, cfg: TrainingConfig, labels: dict):
        if cfg.train_vlm and cfg.vlm_weight_decay:
            raise NotImplementedError(
                "nonzero vlm weight decay would decay the frozen last-layer "
                "slices; mask it per-slice before enabling"
            )
        self.cfg = cfg
        self.labels = labels
        self.schedules = {
            "action": schedules.from_config(cfg.action_lr, cfg.action_lr_scheduler),
            "vlm": schedules.from_config(cfg.vlm_lr, cfg.vlm_lr_scheduler),
        }

    def init(self, params: dict) -> torch.optim.Optimizer:
        """Mark each leaf trained or frozen (``requires_grad``) and return
        the AdamW state over the trained leaves, one param group per label:
        ``torch.optim.AdamW``, or ``AdamW8bit`` (int8 moments) with
        ``quantize_optimizer_states``."""
        groups = {g: [] for g in GROUPS}
        for lab, leaf in zip(tree_leaves(self.labels), tree_leaves(params)):
            leaf.requires_grad_(lab != "frozen")
            if lab != "frozen":
                groups[lab].append(leaf)
        return self.make(groups)

    def make(self, groups: Dict[str, List[torch.Tensor]]) -> torch.optim.Optimizer:
        """The AdamW state over ``groups`` (label -> tensors): one param
        group per nonempty label, at the label's decay."""
        cfg = self.cfg
        decay = {"action": cfg.action_weight_decay, "vlm": cfg.vlm_weight_decay}
        adam = AdamW8bit if cfg.quantize_optimizer_states else torch.optim.AdamW
        return adam(
            [{"params": groups[g], "name": g, "weight_decay": decay[g]} for g in GROUPS if groups[g]],
            lr=0.0, betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
        )

    def update(self, params: dict, state: torch.optim.Optimizer, count: int, split: Optional[dict] = None,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
        """Apply one update from the params' ``.grad`` (then cleared), the
        ``count``-th (0 for the first). Returns the global grad norm after
        the surgery and before the clip. Under tensor parallelism ``split``
        is the spec tree over ``params`` (``parallel.tp_param_specs``),
        truthy where the rank holds a slice of a leaf split over the model
        group of ``mesh``: the norm is then the whole tree's
        (``global_norm``), and int8 moments of those slices are coded in
        their whole leaves' blocks (``AdamW8bit.split_over``)."""
        grads = apply_freeze_surgery(tree_map(lambda p: p.grad, params))
        leaves = tree_leaves(grads)
        flat = [g for g in leaves if g is not None]
        if split is None:
            norm = global_norm(flat)
        else:
            flags = [bool(s) for g, s in zip(leaves, tree_leaves(split)) if g is not None]
            norm = global_norm(flat, flags, mesh.model_group)
            if isinstance(state, AdamW8bit):
                state.split_over({p: s.index(MODEL_AXIS) for p, s in zip(tree_leaves(params), tree_leaves(split))
                                  if s and p.requires_grad}, mesh)
        # optax.clip_by_global_norm: t if norm < max_norm else (t / norm) * max_norm
        max_norm = self.cfg.max_grad_norm
        if float(norm) >= max_norm:
            for g in flat:
                g.div_(norm).mul_(max_norm)
        for group in state.param_groups:
            group["lr"] = self.schedules[group["name"]](count)
        state.step()
        state.zero_grad(set_to_none=True)
        return norm


def build_optimizer(cfg: TrainingConfig, params: dict) -> Optimizer:
    """The optimizer for ``params``' tree under ``cfg`` (labels from
    ``param_labels``)."""
    return Optimizer(cfg, param_labels(params, cfg.train_vlm, lora=cfg.lora))


class Zero1Optimizer:
    """ZeRO-1 over the data group of a mesh: the AdamW state of this rank's
    slice of every trained leaf (``parallel.sharding.Zero1Shards``: whole
    blocks of 2048, so that int8 moments split between their scale
    blocks). It stands where the ``torch.optim`` state stands
    (``Optimizer.update`` drives it alike): ``step`` hands the inner
    optimizer, built over flat views of the slices, the slices of the
    all-reduced grads, updates the slices in place, then all-gathers the
    updated params. The update is elementwise, so it is bitwise the
    replicated one. ``state_dict`` gathers the state into the one-device
    layout of ``full``'s type and ``load_state_dict`` takes that layout and
    keeps the slices: both are collectives of the data group. ``shards``
    is the layout of ``full``'s params, in its param groups' order."""

    def __init__(self, full: torch.optim.Optimizer, optimizer: Optimizer, shards: Zero1Shards):
        self.leaves = [p for group in full.param_groups for p in group["params"]]
        self.shards = shards
        self.views = self.shards.local(self.leaves)
        view_of = {id(p): v for p, v in zip(self.leaves, self.views)}
        self.inner = optimizer.make({g["name"]: [view_of[id(p)] for p in g["params"]] for g in full.param_groups})
        self.blocks = isinstance(self.inner, AdamW8bit)  # state in blocks of DEFAULT_BLOCK, else per element
        if full.state:
            self.load_state_dict(full.state_dict())

    @property
    def param_groups(self) -> list:
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.leaves:
            p.grad = None
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        me = self.shards.rank
        for p, v, r in zip(self.leaves, self.views, self.shards.ranges):
            v.grad = None if p.grad is None else p.grad.reshape(-1)[slice(*r[me])]
        self.inner.step()
        collectives.all_gather_ranges_([p.detach() for p in self.leaves], self.shards.ranges, self.shards.group)

    def _rows(self, i: int, r: int) -> Tuple[int, int]:
        """Rank r's rows of leaf i's state tensors: blocks or elements."""
        lo, hi = self.shards.ranges[i][r]
        return (lo // DEFAULT_BLOCK, -(-hi // DEFAULT_BLOCK)) if self.blocks else (lo, hi)

    def shard_state_dict(self, full: dict) -> dict:
        """This rank's slices of a state dict in the one-device layout."""
        state = {}
        for i, st in full["state"].items():
            lo, hi = self._rows(i, self.shards.rank)
            state[i] = {k: v if v.dim() == 0 else (v if self.blocks else v.reshape(-1))[lo:hi] for k, v in st.items()}
        return {"state": state, "param_groups": full["param_groups"]}

    def load_state_dict(self, full: dict) -> None:
        self.inner.load_state_dict(self.shard_state_dict(full))

    @torch.no_grad()
    def state_dict(self) -> dict:
        """The state in the one-device layout, on the CPU, on every rank,
        gathered one tensor at a time."""
        own = self.inner.state_dict()
        n = self.shards.n
        state = {}
        for i, st in own["state"].items():
            leaf, rows = self.leaves[i], [self._rows(i, r) for r in range(n)]
            state[i] = {}
            for k, v in st.items():
                if v.dim() == 0:
                    state[i][k] = v.cpu()
                    continue
                width = v.shape[1] if self.blocks else 1  # elements per row
                full = torch.empty(max(hi for _, hi in rows) * width, dtype=v.dtype, device=v.device)
                lo, hi = rows[self.shards.rank]
                full[lo * width : hi * width] = v.reshape(-1)
                collectives.all_gather_ranges_([full], [[(a * width, b * width) for a, b in rows]], self.shards.group)
                shape = (-1, *v.shape[1:]) if self.blocks else leaf.shape
                state[i][k] = full.view(shape).cpu()
        return {"state": state, "param_groups": own["param_groups"]}
