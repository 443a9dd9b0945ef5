"""Registry mapping string names to classes and values, as in
stllm_tpu/common/registry.py: every layer looks up the layer below by name,
so that a YAML config describes a whole experiment.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    """String -> object maps, one namespace per component kind."""

    _maps: Dict[str, Dict[str, Any]] = {
        "model": {},
        "task": {},
        "processor": {},
        "dataset_builder": {},
        "lr_scheduler": {},
        "runner": {},
        "paths": {},
        "state": {},
    }

    # ---- generic ----
    @classmethod
    def _register(cls, kind: str, name: str, obj: Any, force: bool = False) -> None:
        table = cls._maps[kind]
        if name in table and not force and table[name] is not obj:
            raise KeyError(f"{kind} '{name}' already registered to {table[name]!r}")
        table[name] = obj

    @classmethod
    def _decorator(cls, kind: str, name: str) -> Callable:
        def wrap(obj):
            cls._register(kind, name, obj)
            return obj

        return wrap

    # ---- decorators ----
    @classmethod
    def register_model(cls, name: str) -> Callable:
        return cls._decorator("model", name)

    @classmethod
    def register_task(cls, name: str) -> Callable:
        return cls._decorator("task", name)

    @classmethod
    def register_processor(cls, name: str) -> Callable:
        return cls._decorator("processor", name)

    @classmethod
    def register_builder(cls, name: str) -> Callable:
        return cls._decorator("dataset_builder", name)

    @classmethod
    def register_lr_scheduler(cls, name: str) -> Callable:
        return cls._decorator("lr_scheduler", name)

    @classmethod
    def register_runner(cls, name: str) -> Callable:
        return cls._decorator("runner", name)

    # ---- values ----
    @classmethod
    def register_path(cls, name: str, path: str) -> None:
        cls._register("paths", name, path)

    @classmethod
    def register(cls, name: str, obj: Any) -> None:
        cls._maps["state"][name] = obj

    # ---- getters ----
    @classmethod
    def get_model_class(cls, name: str):
        return cls._maps["model"][name]

    @classmethod
    def get_task_class(cls, name: str):
        return cls._maps["task"][name]

    @classmethod
    def get_processor_class(cls, name: str):
        return cls._maps["processor"][name]

    @classmethod
    def get_builder_class(cls, name: str):
        return cls._maps["dataset_builder"][name]

    @classmethod
    def get_lr_scheduler_class(cls, name: str):
        return cls._maps["lr_scheduler"][name]

    @classmethod
    def get_runner_class(cls, name: str):
        return cls._maps["runner"][name]

    @classmethod
    def get_path(cls, name: str, default: Any = None):
        return cls._maps["paths"].get(name, default)

    @classmethod
    def get(cls, name: str, default: Any = None):
        return cls._maps["state"].get(name, default)

    @classmethod
    def list_models(cls):
        return sorted(cls._maps["model"])

    @classmethod
    def list_tasks(cls):
        return sorted(cls._maps["task"])

    @classmethod
    def list_processors(cls):
        return sorted(cls._maps["processor"])

    @classmethod
    def list_lr_schedulers(cls):
        return sorted(cls._maps["lr_scheduler"])

    @classmethod
    def list_runners(cls):
        return sorted(cls._maps["runner"])


registry = Registry
