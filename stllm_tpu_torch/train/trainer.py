"""The training loop: the train step inside a thin Python loop
(stllm_tpu/train/trainer.py), on one device or on a mesh.

  - optimizer with the learning-rate schedule baked in (``train.step.AdamW``,
    ``common.optim``);
  - the train step (CE + MVM, gradient accumulation inside: ``train/step.py``);
  - MetricLogger with step and data timing (``common/logging.py``);
  - checkpoints every ``save_freq`` steps, at the last step and at each
    improved eval, and ``resume_if_available`` (``train/checkpoint.py``);
  - a ``torch.profiler`` window over steps ``profile_steps``, written to
    ``profile_dir`` as a Chrome trace (the reference's jax.profiler window);
  - stats appended as JSON lines to output_dir/log.txt.

The optimizer's ``count`` drives the learning-rate schedule and is saved
with the moments, so a resumed run continues the schedule.

On a mesh (``Trainer(mesh=)``, ``parallel/mesh.py``) every rank runs the
loop on the same global batches: the state holds the rank's slices
(``create_train_state(mesh=)``), the step takes the rank's rows of each
batch (``parallel.sharding.local_batch``), checkpoints gather and write from
rank 0, and the logs and the profiler window run on rank 0 only.
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
from stllm_tpu_torch.train.checkpoint import CheckpointManager
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
        mesh=None,
        accum_steps: int = 1,
        trainable_fn: Optional[Callable[[str], bool]] = None,
        learning_rate=1e-4,
        weight_decay: float = 0.05,
        max_grad_norm: Optional[float] = 1.0,
        log_freq: int = 10,
        save_freq: int = 1000,
        max_keep: int = 3,
        profile_dir: Optional[str] = None,
        profile_steps: tuple = (2, 5),
    ):
        """``params``: the parameter tree on ``device`` (default: the CUDA
        card; pass "cpu" to train there). Batches from the loader are moved
        to ``device``. Checkpoints go to ``output_dir``, the newest
        ``max_keep`` kept. ``mesh``: train on this rank's slices of
        ``params`` (the whole tree, the same on every rank)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.accum_steps = accum_steps
        self.is_main = mesh is None or mesh.rank == 0
        self.output_dir = output_dir
        self.log_freq = log_freq
        self.save_freq = save_freq
        os.makedirs(output_dir, exist_ok=True)
        optimizer = optimizer or make_optimizer(
            learning_rate, weight_decay=weight_decay, max_grad_norm=max_grad_norm)
        self.optimizer = optimizer
        self.state = create_train_state(params, optimizer, trainable_fn or default_trainable(),
                                        mesh=mesh)
        for path, leaf in {**self.state.params, **self.state.frozen}.items():
            if leaf.device.type != self.device.type:
                raise ValueError(f"parameter {path} is on {leaf.device}, the trainer on "
                                 f"{self.device}")
        self._step_fn = make_train_step(cfg, optimizer, accum_steps, mesh=mesh)
        self.ckpt = CheckpointManager(output_dir, max_to_keep=max_keep, mesh=mesh)
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps

    def resume_if_available(self) -> int:
        """Restore the newest checkpoint of ``output_dir`` into the state, if
        there is one; returns the step training continues from."""
        step = self.ckpt.latest_step()
        if step is not None:
            logger.info("Resuming from checkpoint step %d", step)
            self.state = self.ckpt.restore(self.state)
        return int(self.state.step)

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, first: int, last: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.profile_dir, f"trace_steps_{first}_{last}.json"))

    def _put(self, batch: Dict) -> Dict[str, torch.Tensor]:
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        if self.mesh is not None:     # the sharded step moves its own rows of the batch
            return batch
        return {k: v.to(self.device) for k, v in batch.items()}

    def log_stats(self, stats: Dict) -> None:
        if not self.is_main:
            return
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
        and at the end; when the metric improves, the state is saved and the
        step recorded in output_dir/best.json."""
        start = self.state.step if start_step is None else start_step
        metric_logger = MetricLogger()
        metric_logger.add_meter("loss", SmoothedValue(fmt="{value:.4f}"))
        best = None

        def run_eval(step: int) -> None:
            nonlocal best
            metric = float(eval_fn())
            improved = (best is None
                        or (metric > best if best_mode == "max" else metric < best))
            if self.is_main:
                logger.info("eval @%d: %.5f%s", step, metric, " (best)" if improved else "")
            self.log_stats({"step": step, "eval_metric": metric, "best": improved})
            if improved:
                best = metric
                self.ckpt.save(self.state)
                if self.is_main:
                    with open(os.path.join(self.output_dir, "best.json"), "w") as f:
                        json.dump({"step": step, "metric": metric}, f)

        it = iter(loader)
        prof = None
        data_t0 = time.perf_counter()
        for step in range(start, max_steps):
            if self.profile_dir and self.is_main and step == self.profile_steps[0]:
                prof = self._start_profile()
            batch = self._put(next(it))
            data_time = time.perf_counter() - data_t0
            self.state, metrics = self._step_fn(self.state, batch)
            if prof is not None and step + 1 == self.profile_steps[1]:
                self._stop_profile(prof, self.profile_steps[0], step + 1)
                prof = None
            # the device runs behind the host: only wait for it when printing
            if (step + 1) % self.log_freq == 0 or step + 1 == max_steps:
                host = {k: float(v) for k, v in metrics.items()}
                metric_logger.update(data_time=data_time, **host)
                if self.is_main:
                    logger.info("step %d/%d  %s", step + 1, max_steps, metric_logger)
                self.log_stats({"step": step + 1, **host})
            if (step + 1) % self.save_freq == 0 or step + 1 == max_steps:
                self.ckpt.save(self.state)
            if eval_fn is not None and eval_freq and (step + 1) % eval_freq == 0:
                run_eval(step + 1)
            data_t0 = time.perf_counter()
        if prof is not None:       # the run ended inside the window
            self._stop_profile(prof, self.profile_steps[0], max_steps)
        if eval_fn is not None and not (
                eval_freq and max_steps > start and max_steps % eval_freq == 0):
            run_eval(max_steps)
        return {k: m.global_avg for k, m in metric_logger.meters.items()}
