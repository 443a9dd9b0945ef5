"""BaseTask: the config-driven build surface (model, datasets) and the
distributed-eval conventions of stllm_tpu/tasks/base_task.py: rank-sharded
JSON results merged by rank 0.

Ranks come from ``torch.distributed`` when its process group is
initialized; otherwise the process is rank 0 of 1 and ``barrier`` does
nothing. The training loop itself is ``train.trainer.Trainer``.
"""

from __future__ import annotations

import functools
import json
import logging
import os
from typing import Dict, List

import torch.distributed as dist

from stllm_tpu_torch.common.logging import dist_initialized, is_main_process
from stllm_tpu_torch.common.registry import Registry

logger = logging.getLogger(__name__)


def get_rank() -> int:
    return dist.get_rank() if dist_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist_initialized() else 1


def main_process(func):
    """Run ``func`` on rank 0 only; other ranks get None."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return func(*args, **kwargs)
        return None

    return wrapper


def barrier() -> None:
    if get_world_size() > 1:
        dist.barrier()


class BaseTask:
    def __init__(self):
        self.inst_id_key = "instance_id"

    @classmethod
    def setup_task(cls, **kwargs):
        return cls()

    def build_model(self, cfg, device=None):
        """The model named by ``cfg.model_cfg.arch``, built by its
        ``from_config`` on ``device``: the CUDA card unless "cpu" is named."""
        model_cfg = cfg.model_cfg
        model_cls = Registry.get_model_class(model_cfg["arch"])
        return model_cls.from_config(model_cfg, device=device)

    def build_datasets(self, cfg) -> Dict:
        raise NotImplementedError

    def valid_step(self, model, samples) -> List[Dict]:
        raise NotImplementedError

    def evaluation(self, model, data_loader, print_freq: int = 10) -> List[Dict]:
        from stllm_tpu_torch.common.logging import MetricLogger

        metric_logger = MetricLogger()
        results: List[Dict] = []
        for samples in metric_logger.log_every(data_loader, print_freq, "Evaluation"):
            results.extend(self.valid_step(model=model, samples=samples))
        barrier()
        return results

    @staticmethod
    def save_result(result: List[Dict], result_dir: str, filename: str,
                    remove_duplicate: str = "") -> str:
        """Each rank writes ``<filename>_rank<r>.json``; rank 0 merges them
        into ``<filename>.json``, keeping the first result of each
        ``remove_duplicate`` value when that key is given."""
        os.makedirs(result_dir, exist_ok=True)
        result_file = os.path.join(result_dir, f"{filename}_rank{get_rank()}.json")
        final_result_file = os.path.join(result_dir, f"{filename}.json")
        with open(result_file, "w") as f:
            json.dump(result, f)
        barrier()
        if is_main_process():
            logger.info("rank %d starts merging results.", get_rank())
            merged: List[Dict] = []
            for rank in range(get_world_size()):
                with open(os.path.join(result_dir, f"{filename}_rank{rank}.json")) as f:
                    merged += json.load(f)
            if remove_duplicate:
                seen, dedup = set(), []
                for res in merged:
                    if res[remove_duplicate] not in seen:
                        seen.add(res[remove_duplicate])
                        dedup.append(res)
                merged = dedup
            with open(final_result_file, "w") as f:
                json.dump(merged, f)
            logger.info("result file saved to %s", final_result_file)
        return final_result_file
