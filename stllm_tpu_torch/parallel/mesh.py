"""Process groups over a (data, model) grid of ranks (stllm_tpu/parallel/mesh.py).

The reference builds a ``jax.sharding.Mesh`` and lets XLA insert the
collectives. Here every rank is one process with one device; ``make_mesh``
lays the ranks out row-major on a (data, model) grid, as the reference
reshapes its device list, and opens one process group per row and per
column:

  - ``data``  : data parallel + FSDP (a leaf's slices and the batch's rows
                are split over it; the ZeRO-3 equivalent);
  - ``model`` : tensor parallel (attention heads, MLP hidden, vocab).

A spec, the ``PartitionSpec`` counterpart, is a tuple with one axis name or
None per dimension of a leaf; ``()`` replicates the leaf whatever its rank.
``shard_params`` cuts this rank's slice of each leaf by its spec.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from stllm_tpu_torch.common.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
Spec = Tuple[Optional[str], ...]

# how long a collective waits for a missing rank before it fails
GROUP_TIMEOUT = datetime.timedelta(seconds=600)


def init_distributed(device=None, timeout: datetime.timedelta = GROUP_TIMEOUT) -> torch.device:
    """Join the process group that ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return the device this rank runs on. The backend
    follows the device: NCCL on the card (rank ``LOCAL_RANK`` takes card
    ``LOCAL_RANK``; fewer cards than local ranks raise), gloo for
    ``device="cpu"``. A world of one, or a group that is already up, opens
    nothing. Every group waits at most ``timeout`` for a rank."""
    dev = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dev.type == "cuda" and world > 1:
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local} needs card {local}, but "
                               f"{torch.cuda.device_count()} are visible")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    if world > 1 and not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                                rank=int(os.environ["RANK"]), world_size=world,
                                timeout=timeout)
    return dev


class Mesh:
    """This rank's place on the (data, model) grid and its two groups.

    ``shape`` is {"data": d, "model": m}; rank r sits at (r // m, r % m).
    ``groups[axis]`` holds the ranks that differ only along ``axis`` (this
    rank's column for "data", its row for "model"); it is None where that
    axis has one rank, and every collective of the port is the identity on a
    None group. ``world`` is the default group, None in a world of one."""

    def __init__(self, data: int, model: int, rank: int, groups: Dict[str, Any], world):
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.rank = rank
        self.coords = {DATA_AXIS: rank // model, MODEL_AXIS: rank % model}
        self.groups = groups
        self.world = world

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(data: Optional[int] = None, model: int = 1,
              timeout: datetime.timedelta = GROUP_TIMEOUT) -> Mesh:
    """The (data, model) mesh over every rank of the default process group
    (one rank when none is initialized). ``data=None`` takes every rank
    that ``model`` leaves. Every rank must call it, in the same order as any
    other group it opens."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        if n % model:
            raise ValueError(f"{n} ranks do not divide into model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(
            f"make_mesh(data={data}, model={model}) needs {data * model} ranks but the "
            f"process group has {n}. Start one process per rank, e.g. `torchrun "
            f"--nproc-per-node {data * model} ...` on a host with {data * model} cards, and "
            f"call init_distributed() in each (init_distributed(device='cpu') runs the "
            f"ranks on the CPU over gloo).")
    rank = dist.get_rank() if dist.is_initialized() else 0
    grid = np.arange(n).reshape(data, model)
    groups: Dict[str, Any] = {DATA_AXIS: None, MODEL_AXIS: None}
    # new_group is collective: every rank opens every group, in one order
    for axis, lines in ((DATA_AXIS, grid.T), (MODEL_AXIS, grid)):
        if lines.shape[1] > 1:
            for line in lines:
                g = dist.new_group([int(r) for r in line], timeout=timeout)
                if rank in line:
                    groups[axis] = g
    return Mesh(data, model, rank, groups, dist.group.WORLD if n > 1 else None)


def replicated(mesh: Mesh) -> Spec:
    return ()


def data_sharded(mesh: Mesh, ndim: int = 1) -> Spec:
    """Shard the leading (batch) axis over ``data``."""
    return (DATA_AXIS,) + (None,) * (ndim - 1)


def map_tree(fn, tree, *others, prefix: str = ""):
    """``fn(path, leaf, *other_leaves)`` over a nested dict/list tree and
    trees of the same structure, paths as '/'-joined keys and indices; None
    leaves stay None."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(o[k] for o in others), prefix=f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(o[i] for o in others), prefix=f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix[:-1], tree, *others)


def by_path(tree, other) -> Dict[str, Any]:
    """{path: the leaf of ``other`` there} over the leaves of ``tree`` (a
    tree of the same structure: its specs, its gathered leaves)."""
    out: Dict[str, Any] = {}
    map_tree(lambda path, _, o: out.__setitem__(path, o), tree, other)
    return out


def fsdp_param_sharding(mesh: Mesh, params, min_size: int = 2 ** 16):
    """FSDP spec tree: each large leaf's largest axis that divides over
    ``data`` is split over it; small leaves replicate."""
    n = mesh.shape[DATA_AXIS]

    def spec_for(_, leaf) -> Spec:
        if leaf.numel() < min_size:
            return ()
        for d in sorted(range(leaf.dim()), key=lambda d: -leaf.shape[d]):
            if leaf.shape[d] % n == 0:
                return tuple(DATA_AXIS if i == d else None for i in range(leaf.dim()))
        return ()

    return map_tree(spec_for, params)


def _owned(view: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A copy of ``view`` that owns its storage, column-major where ``like``
    is a column-major matrix (the int8 ``w_q`` layout)."""
    if like.dim() == 2 and like.stride(0) == 1 and like.shape[0] > 1:
        return view.t().contiguous().t()
    return view.contiguous().clone() if view.is_contiguous() else view.contiguous()


def local_slice(mesh: Mesh, leaf: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's slice of ``leaf`` under ``spec``; the leaf itself where
    the spec splits nothing over an axis of more than one rank."""
    view = leaf
    for d, axis in enumerate(spec):
        if axis is None or mesh.shape[axis] == 1:
            continue
        n = mesh.shape[axis]
        if leaf.shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(leaf.shape)} does not split over "
                             f"{axis}={n}")
        c = leaf.shape[d] // n
        view = view.narrow(d, mesh.coords[axis] * c, c)
    return leaf if view is leaf else _owned(view, leaf)


def shard_params(params, shardings, mesh: Mesh):
    """This rank's slice of every leaf of ``params`` by the spec tree
    ``shardings``."""
    return map_tree(lambda _, leaf, spec: local_slice(mesh, leaf, spec), params, shardings)
