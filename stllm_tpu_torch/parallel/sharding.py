"""Sharding rules for the ST-LLM parameter tree: FSDP ('data') x tensor
parallel ('model') (stllm_tpu/parallel/sharding.py).

The rules are the reference's, computed from the mesh's shape and each
leaf's global shape alone, so a spec here equals the reference's
``NamedSharding.spec`` leaf for leaf:
  - each 2-D weight gets its TP axis from the table below (None = replicated
    over 'model');
  - FSDP then splits the LARGEST remaining divisible axis over 'data';
  - small leaves (< min_size) replicate fully.

So the slice each rank stores, and the memory a mesh saves, are the
reference's. What each rank COMPUTES is the port's: ``gather_leaves``
gathers the leaves over 'data' before use, and over 'model' too unless the
LLaMA stack runs tensor-parallel on them (``llama_tp_plan``);
``grads_to_slices`` is its transpose, which reduce-scatters the gradients
back to the rank's slices.
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from stllm_tpu_torch.parallel.collectives import (
    all_reduce_many, gather_many, reduce_scatter_many, slice_dim)
from stllm_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, Spec, by_path, map_tree, shard_params)

# (path regex, axis index sharded over 'model') — contraction-friendly:
# column-parallel (out axis) for fan-out matmuls, row-parallel (in axis) for
# the projections that follow them, so each attn/MLP pair needs ONE psum.
_TP_RULES: Tuple[Tuple[str, int], ...] = (
    # LLaMA attention + MLP
    (r"llama/layers/\d+/(q|k|v)/w$", 1),
    (r"llama/layers/\d+/o/w$", 0),
    (r"llama/layers/\d+/(gate|up)/w$", 1),
    (r"llama/layers/\d+/down/w$", 0),
    (r"llama/embed_tokens$", 1),          # (vocab, d): shard d
    (r"llama/lm_head/w$", 1),             # (d, vocab): shard vocab
    # ViT blocks
    (r"vit/blocks/\d+/qkv/w$", 1),
    (r"vit/blocks/\d+/proj/w$", 0),
    (r"vit/blocks/\d+/fc1/w$", 1),
    (r"vit/blocks/\d+/fc2/w$", 0),
    # BTAdapter branch mirrors ViT block layout
    (r"vit/btadapter/.*/qkv/w$", 1),
    (r"vit/btadapter/.*/proj/w$", 0),
    (r"vit/btadapter/.*/fc1/w$", 1),
    (r"vit/btadapter/.*/fc2/w$", 0),
    # Q-Former attention / FFN
    (r"qformer/layers/\d+/(attention|crossattention)/(q|k|v)/w$", 1),
    (r"qformer/layers/\d+/(attention|crossattention)/out/w$", 0),
    (r"qformer/layers/\d+/intermediate(_query)?/w$", 1),
    (r"qformer/layers/\d+/(output|output_query)/dense/w$", 0),
)

_COMPILED = [(re.compile(pat), dim) for pat, dim in _TP_RULES]


def tp_dim_for(path: str) -> Optional[int]:
    for pat, dim in _COMPILED:
        if pat.search(path):
            return dim
    return None


def stllm_param_shardings(mesh: Mesh, params, min_size: int = 2 ** 14):
    """Spec tree: TP per the rule table + FSDP over the largest remaining
    divisible axis. Works for any subtree of the stllm param dict (paths are
    matched by suffix patterns)."""
    data_n = mesh.shape[DATA_AXIS]
    model_n = mesh.shape[MODEL_AXIS]

    def spec_for(path: str, leaf) -> Spec:
        if not hasattr(leaf, "dim") or leaf.numel() < min_size:
            return ()
        spec = [None] * leaf.dim()
        tp = tp_dim_for(path)
        if tp is not None and model_n > 1 and leaf.dim() >= 2:
            # patterns index the last two dims (stacked trees keep leading dims)
            dim = leaf.dim() - 2 + tp
            if leaf.shape[dim] % model_n == 0:
                spec[dim] = MODEL_AXIS
        if data_n > 1:
            for d in sorted(range(leaf.dim()), key=lambda d: -leaf.shape[d]):
                if spec[d] is None and leaf.shape[d] % data_n == 0:
                    spec[d] = DATA_AXIS
                    break
        return tuple(spec)

    return map_tree(spec_for, params)


def batch_shardings(mesh: Mesh, batch: Dict) -> Dict[str, Spec]:
    """Split every batch leaf's leading (batch) axis over 'data' where it
    divides; replicate it elsewhere."""
    def spec_for(leaf) -> Spec:
        spec = [None] * leaf.ndim
        if leaf.ndim and leaf.shape[0] % mesh.shape[DATA_AXIS] == 0:
            spec[0] = DATA_AXIS
        return tuple(spec)

    return {k: spec_for(v) for k, v in batch.items()}


def shard_tree(mesh: Mesh, tree, specs):
    """This rank's slice of every leaf of ``tree`` by ``specs``."""
    return shard_params(tree, specs, mesh)


def gather_tree(mesh: Mesh, local, specs):
    """The inverse of ``shard_tree``: every leaf whole, on every rank."""
    return compute_tree(mesh, local, specs)


def local_batch(mesh: Mesh, batch: Dict[str, torch.Tensor], accum_steps: int = 1
                ) -> Tuple[Dict[str, torch.Tensor], bool]:
    """This rank's rows of a global batch, and whether the rows were split.
    With ``accum_steps`` > 1 the batch is accum_steps micro-batches one after
    the other, and each micro-batch is split, so a rank's micro-batch i is
    its share of the global micro-batch i. Where a micro-batch's rows do not
    divide over 'data' (``batch_shardings`` would replicate the leaves),
    every rank keeps the whole batch."""
    n = mesh.shape[DATA_AXIS]
    rows = next(iter(batch.values())).shape[0]
    if n == 1 or rows % (accum_steps * n):
        return batch, False
    i = mesh.coords[DATA_AXIS]
    micro = rows // (accum_steps * n)
    out = {}
    for k, v in batch.items():
        parts = v.reshape((accum_steps, n, micro) + tuple(v.shape[1:]))[:, i]
        out[k] = parts.reshape((accum_steps * micro,) + tuple(v.shape[1:]))
    return out, True


# ---------------------------------------------------------------------------
# what a rank computes with: the tensor-parallel plan of the LLaMA stack
# ---------------------------------------------------------------------------

_COLUMN = ("q", "k", "v", "gate", "up")
_ROW = ("o", "down")


class TPPlan(NamedTuple):
    """Which LLaMA leaves keep their 'model' slice in the computation:
    ``layers`` every decoder layer's seven projections (q, k, v, gate, up by
    column, o and down by row), ``head`` the lm_head (by vocab)."""
    layers: bool = False
    head: bool = False

    def keeps(self, path: str) -> bool:
        if self.layers and re.search(r"(^|/)layers/\d+/(q|k|v|o|gate|up|down)/w$", path):
            return True
        return self.head and re.search(r"(^|/)lm_head/w$", path) is not None


def _split_on(spec: Spec, dim: int) -> bool:
    return len(spec) > dim and spec[dim] == MODEL_AXIS


def llama_tp_plan(mesh: Mesh, llama, llama_specs, heads: int) -> TPPlan:
    """The layers run tensor-parallel when the rules split all seven
    projections of every layer over 'model' (dense ``w`` without bias,
    whole heads a rank, no LoRA adapter or fused ``qkv``); the head when
    they split ``lm_head/w``. Quantized and fused trees match no rule, so
    they gather whole, as in the reference. ``llama`` and ``llama_specs``
    are the LLaMA subtree and its spec subtree."""
    m = mesh.shape[MODEL_AXIS]
    if m == 1 or llama is None:
        return TPPlan()
    layers = heads % m == 0 and len(llama["layers"]) > 0
    for layer, specs in zip(llama["layers"], llama_specs["layers"]):
        for name in _COLUMN + _ROW:
            p, s = layer.get(name), specs.get(name)
            if (not isinstance(p, dict) or set(p) != {"w"}
                    or not _split_on(s["w"], 1 if name in _COLUMN else 0)):
                layers = False
        if any(k.endswith("_lora") for k in layer):
            layers = False
    head = set(llama["lm_head"]) == {"w"} and _split_on(llama_specs["lm_head"]["w"], 1)
    return TPPlan(layers=layers, head=head)


def _layout_of(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` column-major where the stored slice ``like`` is a
    column-major matrix (the int8 ``w_q`` layout the card's products read)."""
    if full is not like and like.dim() == 2 and like.stride(0) == 1 and like.shape[0] > 1:
        return full.t().contiguous().t()
    return full


def gather_leaves(mesh: Mesh, leaves: Dict[str, torch.Tensor], specs: Dict[str, Spec],
                  keep_model=lambda path: False) -> Dict[str, torch.Tensor]:
    """Each leaf as this rank computes with it: gathered over 'data', and
    over 'model' unless ``keep_model(path)``; the stored leaf itself where
    nothing is gathered. One all-gather an axis carries every leaf."""
    out = dict(leaves)
    for axis in (DATA_AXIS, MODEL_AXIS):
        paths = [p for p, spec in specs.items() if p in out and axis in spec
                 and (axis == DATA_AXIS or not keep_model(p))]
        got = gather_many([out[p] for p in paths], [specs[p].index(axis) for p in paths],
                          mesh.groups[axis])
        out.update(zip(paths, got))
    return {p: _layout_of(t, leaves[p]) for p, t in out.items()}


def compute_tree(mesh: Mesh, local, specs, plan: TPPlan = TPPlan()):
    """``gather_leaves`` over a tree: every leaf gathered but those ``plan``
    keeps split over 'model'."""
    full = gather_leaves(mesh, by_path(local, local), by_path(local, specs), plan.keeps)
    return map_tree(lambda path, _: full[path], local)


def grads_to_slices(mesh: Mesh, grads: Dict[str, torch.Tensor], specs: Dict[str, Spec],
                    keep_model=lambda path: False) -> Dict[str, torch.Tensor]:
    """The transpose of ``gather_leaves`` on gradients: over 'model' a
    gathered leaf's gradient is the same on every rank of the row (its
    computation runs replicated there), so the rank keeps its slice; over
    'data' the ranks' gradients are summed and scattered to the slices, or
    summed whole where the leaf is replicated (one collective a dtype)."""
    out = {}
    for p, g in grads.items():
        spec = specs[p]
        if MODEL_AXIS in spec and not keep_model(p):
            g = slice_dim(g, mesh.groups[MODEL_AXIS], spec.index(MODEL_AXIS))
        out[p] = g
    group = mesh.groups[DATA_AXIS]
    split = [p for p in out if DATA_AXIS in specs[p]]
    whole = [p for p in out if DATA_AXIS not in specs[p]]
    out.update(zip(split, reduce_scatter_many([out[p] for p in split],
                                              [specs[p].index(DATA_AXIS) for p in split],
                                              group)))
    out.update(zip(whole, all_reduce_many([out[p] for p in whole], group)))
    return out


def replication(mesh: Mesh, spec: Spec) -> int:
    """How many ranks store the same slice of a leaf under ``spec``."""
    out = 1
    for axis, n in mesh.shape.items():
        if axis not in spec:
            out *= n
    return out
