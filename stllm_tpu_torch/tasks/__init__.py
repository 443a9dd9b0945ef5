"""Tasks layer: ``setup_task`` looks up ``run.task`` in the registry
(stllm_tpu/tasks/__init__.py)."""

from stllm_tpu_torch.common.registry import Registry
from stllm_tpu_torch.tasks.base_task import BaseTask  # noqa: F401
from stllm_tpu_torch.tasks.video_text_it import (  # noqa: F401  (registration)
    ImageTextPretrainTask,
    VideoTextItTask,
)


def setup_task(cfg):
    assert "task" in cfg.run_cfg, "Task name must be provided."
    task_name = cfg.run_cfg.task
    task = Registry.get_task_class(task_name).setup_task(cfg=cfg)
    assert task is not None, f"Task {task_name} not properly registered."
    return task
