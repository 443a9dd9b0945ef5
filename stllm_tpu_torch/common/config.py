"""YAML experiment configs, as in stllm_tpu/common/config.py.

An experiment YAML (``model:`` / ``datasets:`` / ``run:``) is deep-merged over
the per-model-type default YAML named by the model class'
``PRETRAINED_MODEL_CONFIG_DICT``. Dotlist overrides and the runner-flag
validator come with the corpus-driven training CLI (``train/train.py``).
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Dict, Mapping

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


def load_yaml(path: str | Path) -> Dict:
    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


class Config:
    """Experiment config: model + datasets + run sections, fully merged
    (model-type defaults, then the experiment YAML)."""

    def __init__(self, cfg_path: str | Path):
        user = load_yaml(cfg_path)
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
