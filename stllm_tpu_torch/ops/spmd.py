"""The SPMD context of the sharded train step and the tensor-parallel LLaMA
(stllm_tpu/ops/spmd.py).

The reference wraps each Pallas kernel in a ``shard_map`` over the mesh's
'data' axis, because GSPMD cannot partition a Mosaic call; since shard_map
needs the batch to divide over the shards, its dispatchers decline a kernel
whose GLOBAL batch does not. The port has no such constraint: every rank
already holds its rows of the batch (all of them where ``batch_shardings``
left it replicated), and a kernel runs on any row count. So the port's
dispatchers keep no mesh clause, and under a mesh a shape the reference
sends to plain XLA still launches the port's kernel on the rank's rows
(a departure listed in ROADMAP.md, queue 3). The sharded train step and the
sharded encode activate

    with kernel_sharding(mesh):          # the batch is split over 'data'

only where they split the batch; the losses then sum their global counts
over ``batch_group()``.

``model_parallel`` is the second half of the context: it names the 'model'
group over which the LLaMA stack runs tensor-parallel, and which of its
parts do (``parallel.sharding.TPPlan``). Under it a layer holds this rank's
heads and MLP columns, so the reference's global head count is the local
one times the group's size.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

import torch.distributed as dist

_state = threading.local()


def _get(name: str, default):
    return getattr(_state, name, default)


@contextmanager
def kernel_sharding(mesh):
    """Mark the batch dim 0 of every kernel operand as split over the 'data'
    axis of ``mesh``. Pass mesh=None to disable; nested scopes restore the
    outer setting."""
    prev = _get("mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def kernel_shard_count() -> int:
    """Number of shards the active context splits the batch dim into
    (1 = no active mesh)."""
    mesh = _get("mesh", None)
    return 1 if mesh is None else mesh.shape["data"]


def batch_group():
    """The process group the batch is split over under the active kernel
    mesh, or None: the group over which a loss's global counts are summed."""
    mesh = _get("mesh", None)
    return None if mesh is None else mesh.groups["data"]


def shard_batched(fn, *args):
    """Run ``fn(*args)``. The reference maps the kernel over the batch
    shards; in the port each rank already holds its shard of every batched
    operand, so the call on those operands IS the mapped call."""
    return fn(*args)


def constrain_batched(x):
    """The identity. The reference pins ``x`` to batch-over-'data' so that
    GSPMD does not replicate and repartition it; the port's ranks hold their
    rows already and nothing repartitions them."""
    return x


@contextmanager
def model_parallel(group, plan):
    """Run the LLaMA stack tensor-parallel over ``group`` (the mesh's
    'model' group) where ``plan`` (``TPPlan``) says: ``plan.layers`` the
    decoder layers, ``plan.head`` the lm_head. A None group disables it."""
    prev = (_get("tp_group", None), _get("tp_plan", None))
    _state.tp_group, _state.tp_plan = group, plan
    try:
        yield
    finally:
        _state.tp_group, _state.tp_plan = prev


def _tp(part: str) -> Optional[object]:
    plan = _get("tp_plan", None)
    return _get("tp_group", None) if plan is not None and getattr(plan, part) else None


def layer_group():
    """The group the decoder layers run tensor-parallel over, or None."""
    return _tp("layers")


def head_group():
    """The group the lm_head runs vocab-parallel over, or None."""
    return _tp("head")


def layer_shards() -> int:
    """How many ranks share each decoder layer's heads (1 without TP)."""
    g = layer_group()
    return 1 if g is None else dist.get_world_size(g)
