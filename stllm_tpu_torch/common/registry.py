"""Registry mapping string names to classes, as in stllm_tpu/common/registry.py.

Models, processors and learning-rate schedulers register here; the
namespaces for tasks, datasets and runners come with the slices that port
those components.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    """String -> object maps, one namespace per component kind."""

    _maps: Dict[str, Dict[str, Any]] = {"model": {}, "processor": {}, "lr_scheduler": {}}

    @classmethod
    def _register(cls, kind: str, name: str, obj: Any) -> None:
        table = cls._maps[kind]
        if name in table and table[name] is not obj:
            raise KeyError(f"{kind} '{name}' already registered to {table[name]!r}")
        table[name] = obj

    @classmethod
    def _decorator(cls, kind: str, name: str) -> Callable:
        def wrap(obj):
            cls._register(kind, name, obj)
            return obj

        return wrap

    @classmethod
    def register_model(cls, name: str) -> Callable:
        return cls._decorator("model", name)

    @classmethod
    def register_processor(cls, name: str) -> Callable:
        return cls._decorator("processor", name)

    @classmethod
    def register_lr_scheduler(cls, name: str) -> Callable:
        return cls._decorator("lr_scheduler", name)

    @classmethod
    def get_lr_scheduler_class(cls, name: str):
        return cls._maps["lr_scheduler"][name]

    @classmethod
    def get_model_class(cls, name: str):
        return cls._maps["model"][name]

    @classmethod
    def get_processor_class(cls, name: str):
        return cls._maps["processor"][name]

    @classmethod
    def list_processors(cls):
        return sorted(cls._maps["processor"])

    @classmethod
    def list_models(cls):
        return sorted(cls._maps["model"])


registry = Registry
