"""The training loop: the train step inside a thin Python loop
(stllm_tpu/train/trainer.py), on one device.

  - optimizer with the learning-rate schedule baked in (``train.step.AdamW``,
    ``common.optim``);
  - the train step (CE + MVM, gradient accumulation inside: ``train/step.py``);
  - MetricLogger with step and data timing (``common/logging.py``);
  - stats appended as JSON lines to output_dir/log.txt.

Saving and resuming checkpoints is not ported yet: ``train`` keeps the
state in memory only and ``resume_if_available`` raises.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from stllm_tpu_torch.common.device import resolve_device
from stllm_tpu_torch.common.logging import MetricLogger, SmoothedValue
from stllm_tpu_torch.train.step import (
    create_train_state, default_trainable, make_optimizer, make_train_step)

logger = logging.getLogger(__name__)


class Trainer:
    def __init__(
        self,
        cfg,                            # STLLMConfig
        params,
        optimizer=None,
        *,
        output_dir: str = "output",
        device=None,
        accum_steps: int = 1,
        trainable_fn: Optional[Callable[[str], bool]] = None,
        learning_rate=1e-4,
        weight_decay: float = 0.05,
        max_grad_norm: Optional[float] = 1.0,
        log_freq: int = 10,
    ):
        """``params``: the parameter tree on ``device`` (default: the CUDA
        card; pass "cpu" to train there). Batches from the loader are moved
        to ``device``."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.output_dir = output_dir
        self.log_freq = log_freq
        os.makedirs(output_dir, exist_ok=True)
        optimizer = optimizer or make_optimizer(
            learning_rate, weight_decay=weight_decay, max_grad_norm=max_grad_norm)
        self.optimizer = optimizer
        self.state = create_train_state(params, optimizer, trainable_fn or default_trainable())
        for path, leaf in {**self.state.params, **self.state.frozen}.items():
            if leaf.device.type != self.device.type:
                raise ValueError(f"parameter {path} is on {leaf.device}, the trainer on "
                                 f"{self.device}")
        self._step_fn = make_train_step(cfg, optimizer, accum_steps)

    def resume_if_available(self) -> int:
        raise NotImplementedError("saving and resuming checkpoints is not ported yet")

    def _put(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}

    def log_stats(self, stats: Dict) -> None:
        with open(os.path.join(self.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(stats) + "\n")

    def train(
        self,
        loader: Iterable,
        max_steps: int,
        start_step: Optional[int] = None,
        eval_fn: Optional[Callable[[], float]] = None,
        eval_freq: Optional[int] = None,
        best_mode: str = "max",
    ) -> Dict[str, float]:
        """Run up to ``max_steps`` optimizer steps; returns final averages.

        ``eval_fn`` (returns a scalar metric) runs every ``eval_freq`` steps
        and at the end; when the metric improves, the step is recorded in
        output_dir/best.json."""
        start = self.state.step if start_step is None else start_step
        metric_logger = MetricLogger()
        metric_logger.add_meter("loss", SmoothedValue(fmt="{value:.4f}"))
        best = None

        def run_eval(step: int) -> None:
            nonlocal best
            metric = float(eval_fn())
            improved = (best is None
                        or (metric > best if best_mode == "max" else metric < best))
            logger.info("eval @%d: %.5f%s", step, metric, " (best)" if improved else "")
            self.log_stats({"step": step, "eval_metric": metric, "best": improved})
            if improved:
                best = metric
                with open(os.path.join(self.output_dir, "best.json"), "w") as f:
                    json.dump({"step": step, "metric": metric}, f)

        it = iter(loader)
        data_t0 = time.perf_counter()
        for step in range(start, max_steps):
            batch = self._put(next(it))
            data_time = time.perf_counter() - data_t0
            self.state, metrics = self._step_fn(self.state, batch)
            # the device runs behind the host: only wait for it when printing
            if (step + 1) % self.log_freq == 0 or step + 1 == max_steps:
                host = {k: float(v) for k, v in metrics.items()}
                metric_logger.update(data_time=data_time, **host)
                logger.info("step %d/%d  %s", step + 1, max_steps, metric_logger)
                self.log_stats({"step": step + 1, **host})
            if eval_fn is not None and eval_freq and (step + 1) % eval_freq == 0:
                run_eval(step + 1)
            data_t0 = time.perf_counter()
        if eval_fn is not None and not (
                eval_freq and max_steps > start and max_steps % eval_freq == 0):
            run_eval(max_steps)
        return {k: m.global_avg for k, m in metric_logger.meters.items()}
