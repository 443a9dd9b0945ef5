"""Checkpoints of a TrainState and of serving trees (stllm_tpu/train/checkpoint.py).

The reference writes orbax checkpoints; orbax is not a dependency of the
port, so it writes its own format, which the two packages do not share: one
``torch.save`` file a step of flat ``{path: tensor}`` dicts.

  - like the reference, ONLY the trainable leaves, the optimizer state
    (``count`` and every {path: tensor} dict of it: AdamW's ``mu``, ``nu``,
    Adafactor's ``v_row``, ``v_col``, ``v``) and ``meta.step`` are saved: the
    frozen backbone comes from the pretrained weights;
  - a save is atomic: the step is written under a temporary name and moved
    into place with ``os.replace``, so a run killed mid-save leaves no
    ``checkpoint_<step>`` that ``latest_step`` would pick and ``restore``
    could not read;
  - ``restore`` copies into the state's existing tensors: a ``TrainState``'s
    ``tree``, ``params`` and ``frozen`` share them, so the model sees the
    restored values;
  - on a mesh (``CheckpointManager(mesh=)``) every rank takes part in a
    save, which gathers one leaf at a time, keeps it in host memory on rank
    0 only and writes the single-device format from there, so a card holds
    at most one whole leaf beside its slices; a restore maps the file
    (``mmap``) and cuts each rank's slice of the saved leaves, so a run saved
    on one mesh resumes on another or on one device.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from stllm_tpu_torch.parallel.mesh import Mesh, by_path, local_slice
from stllm_tpu_torch.parallel.sharding import gather_leaves
from stllm_tpu_torch.train.step import TrainState, tree_paths

_STEP_DIR = re.compile(r"^checkpoint_(\d+)$")
_FILE = "state.pt"


def flatten_tree(tree) -> Dict[str, Any]:
    """{path: leaf} for every leaf of a nested dict/list tree (None leaves
    skipped), paths as ``train.step.tree_paths`` names them."""
    return dict(tree_paths(tree))


def unflatten_like(template, flat: Dict[str, Any], strict: bool = True):
    """``template``'s structure with the leaves of ``flat`` by path. A path
    missing from ``flat`` raises ``KeyError`` when ``strict``, else keeps
    the template's leaf (the reference's strict=False load)."""
    missing: List[str] = []

    def pick(node, prefix: str):
        if isinstance(node, dict):
            return {k: pick(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(pick(v, f"{prefix}{i}/") for i, v in enumerate(node))
        if node is None:
            return None
        key = prefix[:-1]
        if key in flat:
            return flat[key]
        missing.append(key)
        return node

    out = pick(template, "")
    if missing and strict:
        raise KeyError(f"checkpoint missing {len(missing)} keys, e.g. {missing[:5]}")
    return out


def _column_major(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(0) == 1 else t.t().contiguous().t()


def _atomic_save(payload: Dict, final_dir: str) -> None:
    """torch.save ``payload`` into ``final_dir``/state.pt, the directory
    appearing only once the file is whole."""
    parent, name = os.path.split(final_dir)
    tmp = os.path.join(parent, f".{name}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, _FILE))
    if os.path.exists(final_dir):       # the same step saved again: replace it
        old = os.path.join(parent, f".{name}.old-{os.getpid()}")
        os.replace(final_dir, old)
        os.replace(tmp, final_dir)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, final_dir)


def save_serving_params(directory: str, params) -> None:
    """Persist an inference tree, quantized forms included (int4 codes, int8
    weights and scales are ordinary leaves), so quantizing and calibrating
    is paid once."""
    os.makedirs(directory, exist_ok=True)
    _atomic_save(flatten_tree(params), os.path.join(os.path.abspath(directory), "serving"))


def load_serving_params(directory: str, template):
    """A tree saved by ``save_serving_params`` in ``template``'s structure,
    each leaf on its template leaf's device. Saved strides come back as
    they were; a 2-D int8 ``w_q`` is made column-major (``stride(0) ==
    1``) in any case, the layout the int8 products on the card read."""
    flat = torch.load(os.path.join(os.path.abspath(directory), "serving", _FILE),
                      map_location="cpu", weights_only=True)
    tmpl = flatten_tree(template)
    for key, t in flat.items():
        if key in tmpl:
            t = t.to(tmpl[key].device)
        if key.endswith("/w_q") and t.dim() == 2 and t.dtype == torch.int8:
            t = _column_major(t)
        flat[key] = t
    return unflatten_like(template, flat)


@torch.no_grad()
def _copy_into(dst: Dict[str, torch.Tensor], flat: Dict[str, torch.Tensor], what: str,
               strict: bool = True) -> None:
    missing = [k for k in dst if k not in flat]
    if missing and strict:
        raise KeyError(f"checkpoint {what} missing {len(missing)} keys, e.g. {missing[:5]}")
    for k, t in dst.items():
        if k in flat:
            src = flat[k]
            if src.shape != t.shape or src.dtype != t.dtype:
                raise ValueError(f"checkpoint {what} {k}: {tuple(src.shape)} {src.dtype}, the "
                                 f"state holds {tuple(t.shape)} {t.dtype}")
            t.copy_(src)


class CheckpointManager:
    """Step-indexed checkpoints under output_dir/checkpoint_<step>/, the
    newest ``max_to_keep`` kept. With a ``mesh``, every rank calls ``save``
    and ``restore`` (collectives); the directory must be one that every
    rank sees."""

    def __init__(self, output_dir: str, max_to_keep: int = 3, mesh: Optional[Mesh] = None):
        self.directory = os.path.abspath(output_dir)
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)

    @staticmethod
    def _specs(state: TrainState, name: Optional[str] = None) -> Dict[str, Any]:
        """{path: spec} of the trainable leaves, or of optimizer state ``name``."""
        if name is not None and state.opt_specs is not None:
            return state.opt_specs[name]
        return by_path(state.tree, state.specs)

    def _whole(self, state: TrainState, leaves: Dict[str, torch.Tensor],
               name: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """Each leaf of ``leaves`` (trainable paths; of optimizer state
        ``name``) whole: on a mesh gathered one at a time, in host memory on
        rank 0 (the other ranks keep none)."""
        if self.mesh is None:
            return leaves
        specs = self._specs(state, name)
        out = {}
        for k, v in leaves.items():
            whole = gather_leaves(self.mesh, {k: v.detach()}, {k: specs[k]})[k]
            if self.mesh.rank == 0:
                out[k] = whole.cpu()
            del whole
        return out

    def _slices(self, state: TrainState, flat: Dict[str, torch.Tensor],
                name: Optional[str] = None) -> Dict[str, torch.Tensor]:
        """This rank's slice of each saved leaf (of optimizer state ``name``)."""
        if self.mesh is None or state.specs is None:
            return flat
        specs = self._specs(state, name)
        return {k: local_slice(self.mesh, v, specs[k]) if k in specs else v
                for k, v in flat.items()}

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{step}")

    def all_steps(self) -> List[int]:
        """Steps with a whole checkpoint, oldest first."""
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name, _FILE)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, state: TrainState, extra: Optional[Dict] = None) -> None:
        step = int(state.step)
        opt = {name: self._whole(state, leaves, name)
               for name, leaves in state.opt_state.items() if name != "count"}
        opt["count"] = torch.tensor(int(state.opt_state["count"]), dtype=torch.int64)
        payload = {
            "params": self._whole(state, {k: v.detach() for k, v in state.params.items()}),
            "opt_state": opt,
            "meta": {"step": step, **(extra or {})},
        }
        if self.mesh is None or self.mesh.rank == 0:
            _atomic_save(payload, self._path(step))
            if self.max_to_keep:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(self._path(old), ignore_errors=True)
        if self.mesh is not None and self.mesh.world is not None:
            dist.barrier(self.mesh.world)      # the step is on disk for every rank

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Copy the checkpoint of ``step`` (default the newest) into
        ``state``'s tensors and set its step and optimizer count; the
        same state is returned. Without a checkpoint nothing changes."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state
        payload = torch.load(os.path.join(self._path(step), _FILE), map_location="cpu",
                             weights_only=True, mmap=True)
        _copy_into(state.params, self._slices(state, payload["params"]), "params")
        opt = payload["opt_state"]
        if set(opt) != set(state.opt_state):
            raise KeyError(f"checkpoint optimizer state {sorted(opt)}, the state holds "
                           f"{sorted(state.opt_state)}: another optimizer")
        for name, leaves in state.opt_state.items():
            if name != "count":
                _copy_into(leaves, self._slices(state, opt[name], name), name)
        state.opt_state["count"] = int(opt["count"])
        state.step = int(payload["meta"]["step"])
        return state

    def close(self) -> None:
        """Saves are synchronous; nothing is left to finish."""
