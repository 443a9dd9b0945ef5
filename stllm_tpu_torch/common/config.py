"""YAML experiment configs, as in stllm_tpu/common/config.py.

An experiment YAML (``model:`` / ``datasets:`` / ``run:``) is deep-merged over
the per-model-type default YAML named by the model class'
``PRETRAINED_MODEL_CONFIG_DICT``, then ``--options a.b=c`` dotlist
overrides apply last. ``ConfigValidator`` holds the runner flag schema.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional

import yaml


class ConfigDict(dict):
    """dict with attribute access and recursive wrapping."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getitem__(self, key):
        value = dict.__getitem__(self, key)
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
            dict.__setitem__(self, key, value)
        return value

    def get(self, key, default=None):
        if key in self:
            return self[key]
        return default

    def copy(self) -> "ConfigDict":
        return wrap(copy.deepcopy(unwrap(self)))


def wrap(obj: Any) -> Any:
    if isinstance(obj, Mapping):
        return ConfigDict({k: wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [wrap(v) for v in obj]
    return obj


def unwrap(obj: Any) -> Any:
    if isinstance(obj, Mapping):
        return {k: unwrap(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [unwrap(v) for v in obj]
    return obj


def deep_merge(base: Dict, override: Mapping) -> Dict:
    """Recursively merge ``override`` into ``base`` (override wins). Returns base."""
    for key, value in override.items():
        if key in base and isinstance(base[key], dict) and isinstance(value, Mapping):
            deep_merge(base[key], value)
        else:
            base[key] = copy.deepcopy(unwrap(value) if isinstance(value, Mapping) else value)
    return base


def _parse_scalar(text: str) -> Any:
    """A CLI override value: YAML scalar rules, plus the float forms YAML
    1.1 leaves as strings ('1e-4')."""
    try:
        value = yaml.safe_load(text)
    except yaml.YAMLError:
        return text
    if isinstance(value, str):
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                pass
    return value


def apply_dotlist(cfg: Dict, overrides: Iterable[str]) -> Dict:
    """Apply ``a.b.c=value`` overrides in place; ``k=v`` strings and
    alternating ``[k, v, k, v]`` lists are both accepted."""
    items: List[str] = []
    buf = list(overrides or [])
    i = 0
    while i < len(buf):
        if "=" in buf[i]:
            items.append(buf[i])
            i += 1
        else:
            if i + 1 >= len(buf):
                raise ValueError(f"dangling override key {buf[i]!r}")
            items.append(f"{buf[i]}={buf[i + 1]}")
            i += 2
    for item in items:
        key, _, raw = item.partition("=")
        node = cfg
        parts = key.strip().split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _parse_scalar(raw)
    return cfg


def load_yaml(path: str | Path) -> Dict:
    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


class Config:
    """Experiment config: model + datasets + run sections, fully merged.
    Lowest priority first: the model type's default YAML, the experiment
    YAML at ``cfg_path``, ``cfg_dict`` merged over it, then the ``options``
    dotlist."""

    def __init__(self, cfg_path: str | Path | None = None,
                 options: Optional[Iterable[str]] = None,
                 cfg_dict: Optional[Mapping] = None):
        user: Dict = {}
        if cfg_path is not None:
            user = load_yaml(cfg_path)
        if cfg_dict is not None:
            deep_merge(user, cfg_dict)
        if options:
            apply_dotlist(user, options)
        merged: Dict = {}
        deep_merge(merged, {"model": self._model_defaults(user.get("model", {}))})
        deep_merge(merged, user)
        self._cfg = wrap(merged)

    @staticmethod
    def _model_defaults(model_cfg: Mapping) -> Dict:
        arch = model_cfg.get("arch")
        model_type = model_cfg.get("model_type")
        if not arch or not model_type:
            return {}
        from stllm_tpu_torch.common.registry import registry
        from stllm_tpu_torch.models import zoo  # noqa: F401  (registers st_llm_hf)

        try:
            model_cls = registry.get_model_class(arch)
        except KeyError:
            return {}
        default_path = getattr(model_cls, "PRETRAINED_MODEL_CONFIG_DICT", {}).get(model_type)
        if not default_path:
            return {}
        defaults = load_yaml(Path(__file__).resolve().parent.parent / default_path)
        return defaults.get("model", defaults)

    @property
    def model_cfg(self) -> ConfigDict:
        return self._cfg.get("model", ConfigDict())

    @property
    def datasets_cfg(self) -> ConfigDict:
        return self._cfg.get("datasets", ConfigDict())

    @property
    def run_cfg(self) -> ConfigDict:
        return self._cfg.get("run", ConfigDict())

    @property
    def config(self) -> ConfigDict:
        return self._cfg

    def get(self, key, default=None):
        return self._cfg.get(key, default)

    def pretty_print(self) -> str:
        return json.dumps(unwrap(self._cfg), indent=2, default=str)

    def to_dict(self) -> Dict:
        return unwrap(self._cfg)


class ConfigValidator:
    """Validates a ``run:`` section against a declared flag schema: an
    unknown key, a value its type cannot take, or a value outside its
    choices raises ValueError."""

    def __init__(self, description: str, schema: Mapping[str, tuple]):
        # schema: name -> (type | None, choices | None, help)
        self.description = description
        self.schema = dict(schema)

    def validate(self, config: Mapping) -> Mapping:
        for k, v in config.items():
            if k not in self.schema:
                raise ValueError(f"{k} is not a valid argument. Supported arguments are "
                                 f"{sorted(self.schema)}")
            typ, choices, _ = self.schema[k]
            if typ is not None and not isinstance(v, typ):
                try:
                    typ(v)
                except (TypeError, ValueError):
                    raise ValueError(f"{k} is not a valid {typ}.")
            if choices is not None and v not in choices:
                raise ValueError(f"{k} must be one of {choices}.")
        return config

    def format_help(self) -> str:
        lines = [self.description]
        for k in sorted(self.schema):
            typ, choices, help_ = self.schema[k]
            s = f"  {k}"
            if typ is not None:
                s += f" ({getattr(typ, '__name__', typ)})"
            if choices is not None:
                s += f" choices={list(choices)}"
            if help_:
                s += f" — {help_}"
            lines.append(s)
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.format_help()


def create_runner_config_validator() -> ConfigValidator:
    """The reference's runner flag schema; the ``lr_sched`` and ``task``
    choices are the names registered when it is called."""
    from stllm_tpu_torch import tasks  # noqa: F401  (registers the tasks)
    from stllm_tpu_torch.common import optim  # noqa: F401  (registers the schedulers)
    from stllm_tpu_torch.common.registry import registry

    t = lambda typ, choices=None, help_="": (typ, choices, help_)  # noqa: E731
    schema = {
        "runner": t(str, ["runner_base", "runner_iter"], "runner flavor"),
        "train_dataset_ratios": t(dict, None, "iter-runner dataset ratios"),
        "max_iters": t(float, None, "max iterations"),
        "max_epoch": t(int, None, "max epochs"),
        "iters_per_inner_epoch": t(float, None, "iters per inner epoch"),
        "lr_sched": t(str, registry.list_lr_schedulers(), "LR scheduler"),
        "task": t(str, registry.list_tasks(), "task name"),
        "init_lr": t(float, None, "post-warmup initial LR"),
        "min_lr": t(float, None, "LR after decay"),
        "warmup_lr": t(float, None, "warmup starting LR"),
        "lr_decay_rate": t(float, None, "decay rate"),
        "weight_decay": t(float, None, "weight decay"),
        "batch_size_train": t(int, None, "train batch size"),
        "batch_size_eval": t(int, None, "eval batch size"),
        "num_workers": t(None, None, "data-loading workers"),
        "warmup_steps": t(int, None, "warmup steps"),
        "seed": t(int, None, "random seed"),
        "output_dir": t(str, None, "checkpoint/log dir"),
        "evaluate": t(None, None, "eval-only mode"),
        "train_splits": t(list, None, "training splits"),
        "valid_splits": t(list, None, "validation splits"),
        "test_splits": t(list, None, "test splits"),
        "accum_grad_iters": t(int, None, "gradient accumulation"),
        "device": t(str, ["cpu", "cuda", "tpu"], "compute device"),
        "world_size": t(int, None, "process count"),
        "dist_url": t(str, None, ""),
        "distributed": t(bool, None, ""),
        "use_dist_eval_sampler": t(bool, None, "distributed eval sampler"),
        "max_len": t(int, None, "max text output length"),
        "min_len": t(int, None, "min text output length"),
        "num_beams": t(int, None, "beam count"),
        "num_ans_candidates": t(int, None, "answer-ranking candidates"),
        "inference_method": t(str, ["genearte", "rank"],
                              "QA inference method (typo as in reference)"),
        "k_test": t(int, None, "ITC/VTC top-k to test"),
    }
    return ConfigValidator("Runner configurations", schema)
