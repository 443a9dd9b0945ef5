"""The training step: loss = CE + MVM, the trainable/frozen partition, AdamW
with global-norm clipping, gradient accumulation (stllm_tpu/train/step.py).

The reference partitions its immutable parameter pytree into a trainable and
a frozen tree and differentiates with respect to the first. Here the one
parameter tree stays whole: ``partition_params`` names every leaf by its key
path, sets ``requires_grad`` on the trainable ones, and returns the two
halves as flat ``{path: tensor}`` dicts over the same tensors. The optimizer
is the reference's optax chain written out: clip by global norm, Adam
moments with bias correction, decoupled weight decay on leaves of two or more
dimensions, times minus the learning rate of the step. It updates the
parameters and its moments IN PLACE (the reference returns new trees), so a
``TrainState`` is advanced, not replaced.

On a mesh (``parallel/mesh.py``) the state holds this rank's slice of every
leaf by ``stllm_param_shardings`` (AdamW's moments too), and a step:
  - gathers every leaf over 'data' at its start, and over 'model' but for
    the LLaMA projections and head that run tensor-parallel
    (``parallel.sharding.compute_tree``);
  - takes the rank's rows of the global batch (``parallel.sharding.local_batch``)
    and runs the micro-batches on them, under the kernel mesh context where
    the rows were split, with CE and MVM normalized by the global counts;
  - reduce-scatters the gradients back to the slices, clips by the global
    norm of the whole tree and updates the slices.
The peak is the gathered tree and its gradients beside the slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch

from stllm_tpu_torch.models.stllm import STLLMConfig, stllm_forward
from stllm_tpu_torch.ops.spmd import kernel_sharding, model_parallel
from stllm_tpu_torch.parallel.collectives import all_reduce
from stllm_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, by_path, map_tree
from stllm_tpu_torch.parallel.sharding import (
    compute_tree, grads_to_slices, llama_tp_plan, local_batch, replication, shard_tree,
    stllm_param_shardings)

LearningRate = Union[float, Callable[[int], float]]


def tree_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) for every tensor of a nested dict/list tree, the path
    being the keys and list indices joined by '/', in tree order. None
    leaves are skipped."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def default_trainable(
    freeze_vit: bool = True,
    freeze_qformer: bool = True,
    freeze_llm: bool = True,
    train_btadapter: bool = True,
) -> Callable[[str], bool]:
    """The reference's freezing policy: llama_proj, the residual module and
    mvm_decoder always train; BTAdapter params inside a frozen ViT still
    train; LoRA adapters train under a frozen LLM (their stored alpha is a
    constant)."""

    def trainable(path: str) -> bool:
        if path.startswith("vit/"):
            if train_btadapter and "btadapter" in path:
                return True
            return not freeze_vit
        if path.startswith("ln_vision"):
            return not freeze_vit
        if path.startswith("qformer"):
            return not freeze_qformer
        if path.startswith("llama/"):
            if "_lora" in path:
                return not path.endswith("alpha")
            return not freeze_llm
        return True  # llama_proj, residual, mvm_decoder
    return trainable


def partition_params(params: Any, trainable_fn: Callable[[str], bool]
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Split the leaves of one tree into (trainable, frozen) ``{path:
    tensor}`` dicts and set ``requires_grad`` to match. Only floating-point
    leaves can train: quantized codes stay frozen whatever the policy says."""
    train: Dict[str, torch.Tensor] = {}
    frozen: Dict[str, torch.Tensor] = {}
    for path, leaf in tree_paths(params):
        want = bool(trainable_fn(path)) and leaf.is_floating_point()
        leaf.requires_grad_(want)
        (train if want else frozen)[path] = leaf
    return train, frozen


def merge_params(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Any:
    """The nested tree of two disjoint ``{path: tensor}`` halves (the
    inverse of ``partition_params``): all-digit path parts become list
    positions."""
    root: Dict = {}
    for path, leaf in {**a, **b}.items():
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def weight_decay_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """True (decay) only for leaves of two or more dimensions: biases, norm
    scales and scalars are exempt."""
    return {path: p.dim() >= 2 for path, p in params.items()}


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, accumulated in fp32."""
    sq = [torch.linalg.vector_norm(g, 2, dtype=torch.float32).square() for g in grads]
    return torch.stack(sq).sum().sqrt()


@dataclasses.dataclass
class AdamW:
    """The reference's optimizer chain, applied in place by ``update``:

      g    <- g                      if ||g|| < max_grad_norm, else g / ||g|| * max_grad_norm
      mu   <- b1 * mu + (1 - b1) * g
      nu   <- b2 * nu + (1 - b2) * g^2
      p    <- p - lr(step) * ((mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd * p)

    with t = step + 1, wd only where ``weight_decay_mask`` says (on every
    leaf with ``decay_all``, optax.adamw's default), and ``lr`` a constant
    or a function of the 0-based step. Leaves whose path starts
    with ``projector_prefix`` take ``projector_lr`` when it is given. The
    moments have the parameters' dtypes."""

    learning_rate: LearningRate
    weight_decay: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: Optional[float] = 1.0
    projector_lr: Optional[LearningRate] = None
    projector_prefix: str = "llama_proj"
    decay_all: bool = False

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def _lr(self, path: str, count: int) -> float:
        lr = self.learning_rate
        if self.projector_lr is not None and path.startswith(self.projector_prefix):
            lr = self.projector_lr
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], opt_state: Dict[str, Any],
               params: Dict[str, torch.Tensor], grad_norm: Optional[torch.Tensor] = None
               ) -> None:
        """One step on ``params`` from ``grads`` (which it may scale in
        place). ``grad_norm``: the gradients' global norm if the caller has
        it already."""
        if self.max_grad_norm:
            norm = global_norm(list(grads.values())) if grad_norm is None else grad_norm
            coef = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                               self.max_grad_norm / norm)
            for g in grads.values():
                g.mul_(coef.to(g.dtype))
        count = opt_state["count"]
        t = count + 1
        bc1, root_bc2 = 1.0 - self.beta1 ** t, math.sqrt(1.0 - self.beta2 ** t)
        decay = ({path: True for path in params} if self.decay_all
                 else weight_decay_mask(params))
        # the update with both bias corrections folded into two scalars,
        #   (mu / bc1) / (sqrt(nu / bc2) + eps)
        #     = (sqrt(bc2) / bc1) * mu / (sqrt(nu) + eps * sqrt(bc2)),
        # so each leaf takes six passes over memory (the step is bound by them)
        for path, p in params.items():
            g, mu, nu = grads[path], opt_state["mu"][path], opt_state["nu"][path]
            lr = self._lr(path, count)
            mu.lerp_(g, 1.0 - self.beta1)
            nu.mul_(self.beta2).addcmul_(g, g, value=1.0 - self.beta2)
            denom = nu.sqrt().add_(self.eps * root_bc2)
            if self.weight_decay and decay[path]:
                p.mul_(1.0 - lr * self.weight_decay)
            p.addcdiv_(mu, denom, value=-lr * root_bc2 / bc1)
        opt_state["count"] = t


def make_optimizer(
    learning_rate: LearningRate,
    weight_decay: float = 0.05,
    beta1: float = 0.9,
    beta2: float = 0.999,
    max_grad_norm: Optional[float] = 1.0,
    projector_lr: Optional[LearningRate] = None,
    projector_prefix: str = "llama_proj",
) -> AdamW:
    """AdamW with the weight-decay exemption and global-norm clipping;
    ``projector_lr`` gives the projection its own learning rate."""
    return AdamW(learning_rate, weight_decay=weight_decay, beta1=beta1, beta2=beta2,
                 max_grad_norm=max_grad_norm, projector_lr=projector_lr,
                 projector_prefix=projector_prefix)


@dataclasses.dataclass
class TrainState:
    step: int
    tree: Any                            # the whole parameter tree, as the models take it
    params: Dict[str, torch.Tensor]      # its trainable leaves by path
    frozen: Dict[str, torch.Tensor]      # its frozen leaves by path
    opt_state: Dict[str, Any]
    specs: Any = None                    # on a mesh: the spec tree; the leaves are slices


def create_train_state(params: Any, optimizer: AdamW,
                       trainable_fn: Optional[Callable[[str], bool]] = None,
                       mesh: Optional[Mesh] = None, min_size: int = 2 ** 14) -> TrainState:
    """On a ``mesh`` the state keeps this rank's slice of each leaf of
    ``params`` by ``stllm_param_shardings(mesh, params, min_size)``."""
    specs = None
    if mesh is not None:
        specs = stllm_param_shardings(mesh, params, min_size)
        params = shard_tree(mesh, params, specs)
    train, frozen = partition_params(params, trainable_fn or default_trainable())
    return TrainState(0, params, train, frozen, optimizer.init(train), specs)


def make_train_step(
    cfg: STLLMConfig,
    optimizer: AdamW,
    accum_steps: int = 1,
    loss_fn: Optional[Callable[[Any, Dict, STLLMConfig], Dict]] = None,
    mesh: Optional[Mesh] = None,
):
    """Returns train_step(state, batch) -> (state, metrics): the same state,
    advanced in place, and the ``loss*`` values plus ``grad_norm`` (the norm
    of the unclipped mean gradient) as 0-d tensors.

    With accum_steps > 1 every batch leaf has leading dimension accum_steps *
    micro and is run in micro-batch slices, one after the other; gradients
    and metrics are the means over the slices.

    On a ``mesh`` the state comes from ``create_train_state(..., mesh=)``,
    ``batch`` is the global batch, the same on every rank (on any device: the
    step moves its rows to the state's), and the metrics are the global
    batch's."""
    fwd = loss_fn or stllm_forward
    if mesh is not None:
        return _sharded_train_step(cfg, optimizer, accum_steps, fwd, mesh)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        metrics: Dict[str, torch.Tensor] = {}
        for p in state.params.values():
            p.grad = None
        for i in range(accum_steps):
            out = fwd(state.tree, _micro(batch, accum_steps, i), cfg)
            out["loss"].backward()       # accumulates into .grad, in place
            for k, v in out.items():
                if k.startswith("loss"):
                    metrics[k] = metrics.get(k, 0.0) + v.detach()
            del out
        grads = {}
        for path, p in state.params.items():
            # a leaf the loss does not reach has a zero gradient, as in the reference
            grads[path] = torch.zeros_like(p) if p.grad is None else p.grad
            p.grad = None
        if accum_steps > 1:
            for g in grads.values():
                g.div_(accum_steps)
            metrics = {k: v / accum_steps for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(list(grads.values()))
        optimizer.update(grads, state.opt_state, state.params, grad_norm=metrics["grad_norm"])
        state.step += 1
        return state, metrics

    return train_step


def _micro(batch: Dict[str, torch.Tensor], accum_steps: int, i: int) -> Dict[str, torch.Tensor]:
    if accum_steps == 1:
        return batch
    return {k: v.reshape((accum_steps, -1) + tuple(v.shape[1:]))[i] for k, v in batch.items()}


def _sharded_train_step(cfg: STLLMConfig, optimizer: AdamW, accum_steps: int, fwd, mesh: Mesh):
    data_group = mesh.groups[DATA_AXIS]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        batch, split = local_batch(mesh, batch, accum_steps)
        device = next(tree_paths(state.tree))[1].device
        batch = {k: v.to(device) for k, v in batch.items()}
        specs = by_path(state.tree, state.specs)
        llama = state.tree.get("llama")
        plan = llama_tp_plan(mesh, llama, state.specs.get("llama"), cfg.llama.heads)
        tree = compute_tree(mesh, state.tree, state.specs, plan)
        compute = by_path(state.tree, tree)   # {path: the leaf this rank computes with}
        for path, p in state.params.items():
            c = compute[path]
            if c is p:
                p.grad = None
            else:
                compute[path] = c.detach().requires_grad_(True)
        tree = map_tree(lambda path, _: compute[path], state.tree)
        # a replicated batch runs whole on every rank of 'data': its gradient
        # is summed over them below, so each rank's loss counts 1 / d of it
        scale = 1.0 if split else 1.0 / mesh.shape[DATA_AXIS]
        metrics: Dict[str, torch.Tensor] = {}
        with kernel_sharding(mesh if split else None), \
                model_parallel(mesh.groups[MODEL_AXIS], plan):
            for i in range(accum_steps):
                out = fwd(tree, _micro(batch, accum_steps, i), cfg)
                (out["loss"] * scale).backward()
                for k, v in out.items():
                    if k.startswith("loss"):
                        metrics[k] = metrics.get(k, 0.0) + v.detach()
                del out
        del tree
        grads = {}
        for path in state.params:
            c = compute.pop(path)
            grads[path] = torch.zeros_like(c) if c.grad is None else c.grad
            c.grad = None
        del compute
        grads = grads_to_slices(mesh, grads, specs, plan.keeps)
        sq = []
        for path, g in grads.items():
            if accum_steps > 1:
                g.div_(accum_steps)
            sq.append(torch.linalg.vector_norm(g, 2, dtype=torch.float32).square()
                      / replication(mesh, specs[path]))
        metrics = {k: (all_reduce(v, data_group) if split else v) / accum_steps
                   for k, v in metrics.items()}
        metrics["grad_norm"] = all_reduce(torch.stack(sq).sum(), mesh.world).sqrt()
        optimizer.update(grads, state.opt_state, state.params, grad_norm=metrics["grad_norm"])
        state.step += 1
        return state, metrics

    return train_step
