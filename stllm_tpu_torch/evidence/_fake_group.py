"""One rank of a mesh in a lone process, for the 7B scale checks
(``mem7b``, ``tp7b_check``, ``tp7b_serve_check``).

The reference checks its 7B stacks by compiling them ahead of time against
a TPU topology description (``get_topology_desc`` in script/mem7b_v5e8.py,
script/tp7b_check.py and script/tp7b_serve_check.py) and reading the
compiler's memory analysis and module text. The port has no such compiler,
so it runs one rank of the mesh for real: torch's fake process group
(backend ``"fake"``, ``torch.testing._internal.distributed.fake_pg``) gives
the process any rank of any world size, ``parallel.mesh.make_mesh`` lays the
mesh on it, the rank builds its shards and runs its step with the real
kernels, and every collective returns at once without moving data. A
buffer a collective fills keeps whatever it held, so every value downstream
is meaningless: the checks read specs, counts, bytes and peak memory only,
and nothing on their path branches on a value.

What a check counts: the kernel launches of ``ops.kernels.LAUNCHES``, the
collectives ``parallel.collectives`` issues (``record_collectives``), and
``torch.cuda.max_memory_allocated`` from a reset just before the step. The
expected collectives of a train step are derived here from the plan in the
code (``train_step_collectives``), call for call and byte for byte.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from stllm_tpu_torch.ops import kernels
from stllm_tpu_torch.parallel.collectives import KINDS, RECOMPUTE, record_collectives
from stllm_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, by_path
from stllm_tpu_torch.parallel.sharding import TPPlan

GIB = 2 ** 30


@contextmanager
def fake_group(rank: int, world: int) -> Iterator[None]:
    """This process as rank ``rank`` of a fake group of ``world`` ranks,
    closed on exit. Fails where a group is already up: each check runs in a
    process of its own (``python -m stllm_tpu_torch.evidence.<name>``)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: run the check in a "
                           "process of its own")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def state_bytes(opt_state: Dict[str, Any]) -> int:
    """Bytes of an optimizer state's tensors (its moments or statistics)."""
    return sum(nbytes(t) for v in opt_state.values() if isinstance(v, dict)
               for t in v.values())


def measured(fn: Callable[[], Any], device) -> Tuple[Any, Dict[str, Any]]:
    """``fn()`` with what it did counted: its kernel launches, its
    collectives and, on the card, the peak of allocated memory from a reset
    just before it (None on the CPU)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    with record_collectives() as coll:
        out = fn()
        if cuda:
            torch.cuda.synchronize(device)
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    return out, {"launches": launches,
                 "collectives": {k: dict(v) for k, v in coll.items()},
                 "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else None}


def card_memory_bytes(device) -> Optional[int]:
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory


def _add(out: Dict[str, Dict[str, int]], kind: str, nbytes_: int, calls: int = 1) -> None:
    out[kind]["calls"] += calls
    out[kind]["bytes"] += nbytes_ * calls


def empty_counts() -> Dict[str, Dict[str, int]]:
    """No collective of any kind, and none re-run by a recompute."""
    return {k: {"calls": 0, "bytes": 0} for k in KINDS + (RECOMPUTE,)}


def collectives_match(got: Dict, want: Dict) -> bool:
    """Counted collectives against a derivation: every kind, and the
    recompute's re-run ones, call for call and byte for byte."""
    return all(got[k] == want[k] for k in KINDS + (RECOMPUTE,))


def gather_collectives(mesh: Mesh, local: Dict[str, torch.Tensor], specs: Dict[str, Any],
                       plan: TPPlan, out: Dict[str, Dict[str, int]]) -> None:
    """``parallel.sharding.gather_leaves``: one all-gather over 'data' of
    every leaf split there (its whole bytes: ranks x the slices), then one
    over 'model' of every leaf split there that the plan does not keep (the
    leaf whole)."""
    n_data, n_model = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    split = [p for p in local if DATA_AXIS in specs[p]]
    if n_data > 1 and split:
        _add(out, "all_gather", n_data * sum(nbytes(local[p]) for p in split))
    over_model = [p for p in local if MODEL_AXIS in specs[p] and not plan.keeps(p)]
    if n_model > 1 and over_model:
        _add(out, "all_gather", n_model * sum(
            nbytes(local[p]) * (n_data if DATA_AXIS in specs[p] else 1) for p in over_model))


def train_step_collectives(mesh: Mesh, state, plan: TPPlan, llama_cfg, rows: int, seq: int,
                           accum_steps: int, split: bool, teacher: bool,
                           loss_keys: int) -> Dict[str, Dict[str, int]]:
    """The collectives one step of ``train.step``'s sharded train step
    issues, from its code: ``rows`` are this rank's rows a micro-batch,
    ``split`` whether the batch was split over 'data', ``teacher`` whether
    the MVM teacher pass runs, ``loss_keys`` the loss metrics it reports.

      - ``compute_tree``: ``gather_collectives`` of the whole tree;
      - a micro-batch: with the layers tensor-parallel, two all-reduces a
        layer (``reduce_from`` after o and after down) in the student's
        forward and again in the teacher's, and two in the backward
        (``copy_to`` in front of q|k|v and of gate|up), each of (rows, seq,
        hidden) activations; with ``cfg.remat`` the backward's recompute
        of a layer re-runs o's reduction (RECOMPUTE) and not down's: torch's
        checkpoint stops at the layer's last saved tensor, down's input,
        which lies between the two (on every device: the recompute runs in
        the forward's context, ``spmd.recompute_context``);
        with the head vocab-parallel, one all-gather of the student's fp32
        logits and one all-reduce of their input's gradient; on a split
        batch one all-reduce of each loss's global count (CE: an int64
        token count; MVM: an fp32 weight sum);
      - the gradients: one reduce-scatter over 'data' a dtype of the leaves
        split there, one all-reduce a dtype of the others (each its whole
        bytes), the squared norms' fp64 sum over the world, and on a split
        batch the loss metrics' all-reduces (fp32)."""
    out = empty_counts()
    local = by_path(state.tree, state.tree)
    specs = by_path(state.tree, state.specs)
    gather_collectives(mesh, local, specs, plan, out)
    n_data = mesh.shape[DATA_AXIS]
    tp = mesh.shape[MODEL_AXIS] > 1
    act = rows * seq * llama_cfg.hidden * torch.empty((), dtype=llama_cfg.dtype).element_size()
    layers = llama_cfg.num_layers
    per_layer = 0
    if tp and plan.layers:
        per_layer = 2 * (1 + int(teacher)) + 2
        if llama_cfg.remat:
            _add(out, RECOMPUTE, act, accum_steps * layers)
    head = tp and plan.head
    _add(out, "all_reduce", act, accum_steps * layers * per_layer)
    if head:
        _add(out, "all_gather", rows * seq * llama_cfg.vocab_size * 4, accum_steps)
        _add(out, "all_reduce", act, accum_steps)
    if split:
        _add(out, "all_reduce", 8, accum_steps)
        if teacher:
            _add(out, "all_reduce", 4, accum_steps)
    grads = {p: g for p, g in local.items() if p in state.params}
    if n_data > 1:
        for kind, chosen, factor in (("reduce_scatter", True, n_data), ("all_reduce", False, 1)):
            paths = [p for p in grads if (DATA_AXIS in specs[p]) == chosen]
            for dtype in {grads[p].dtype for p in paths}:
                _add(out, kind, factor * sum(nbytes(grads[p]) for p in paths
                                             if grads[p].dtype == dtype))
    if mesh.world is not None:
        _add(out, "all_reduce", 8)
    if split:
        _add(out, "all_reduce", 4, loss_keys)
    return out


def train_step_launches(cfg, accum_steps: int, teacher: bool) -> Dict[str, int]:
    """The attention launches of one train step on the card: a micro-batch
    runs the packed kernel once a ViT trunk block and once a BTAdapter
    spatial and temporal layer (nothing upstream of the frozen trunk needs
    a gradient, so it is never recomputed, and the branch's backward
    recomputes through the plain reference), and the single-pass kernel
    once a LLaMA layer in the student's forward, in the backward's
    recompute and in the teacher's pass (its backward is plain)."""
    packed = cfg.vit.depth + (2 * cfg.btadapter_depth if cfg.vit_model == "eva_btadapter_g"
                              else 0)
    short = cfg.llama.num_layers * (1 + int(cfg.llama.remat) + int(teacher))
    return {"packed_qkv_attention": accum_steps * packed,
            "fused_short_attention": accum_steps * short}


def gib(n: Optional[int]) -> Optional[float]:
    return None if n is None else n / GIB

