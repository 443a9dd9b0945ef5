"""The LAVIS-style runner (stllm_tpu/runners/runner_base.py), registered as
"runner_base": an epoch loop over the datasets a task built from the
config. The step, checkpoints and logging are ``train.trainer.Trainer``'s;
the runner adds the registry name and the epoch surface (``max_epoch``,
``iters_per_epoch``, ``output_dir``) of configs written for the runner path.

The trainer runs on the model's own device. A second runner over the same
``output_dir`` resumes from the newest checkpoint there.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

from stllm_tpu_torch.common.registry import Registry

logger = logging.getLogger(__name__)


@Registry.register_runner("runner_base")
class RunnerBase:
    def __init__(self, cfg, task, model, datasets: Dict, job_id: str = "job"):
        self.cfg = cfg
        self.task = task
        self.model = model
        self.datasets = datasets
        self.job_id = job_id
        self._trainer = None
        self._loader = None

    @property
    def trainer(self):
        """Built on first use: AdamW under optax's warmup-cosine schedule
        from ``warmup_lr`` (0 when absent or -1) to ``init_lr`` over
        ``warmup_steps`` (else ``warmup_ratio`` of the steps, at least one),
        then down to ``min_lr`` at ``max_steps``."""
        if self._trainer is None:
            from stllm_tpu_torch.common.optim import warmup_cosine_decay
            from stllm_tpu_torch.train.step import make_optimizer
            from stllm_tpu_torch.train.trainer import Trainer

            run = self.cfg.run_cfg
            max_steps = self.max_steps
            warmup = int(run.get("warmup_steps",
                                 max_steps * float(run.get("warmup_ratio", 0.0))))
            lr = warmup_cosine_decay(
                float(run.get("warmup_lr", 0.0)) if run.get("warmup_lr", -1) != -1 else 0.0,
                float(run.get("init_lr", run.get("learning_rate", 1e-4))),
                max(warmup, 1), max_steps, end_value=float(run.get("min_lr", 0.0)))
            optimizer = make_optimizer(lr, weight_decay=float(run.get("weight_decay", 0.05)))
            self._trainer = Trainer(
                self.model.cfg, self.model.params, optimizer,
                output_dir=str(run.get("output_dir", "output")),
                device=self.model.device,
                accum_steps=int(run.get("accum_grad_iters", 1)),
                trainable_fn=self.model.trainable_fn(),
                log_freq=int(run.get("log_freq", 50)),
                save_freq=int(run.get("save_freq", self.iters_per_epoch)),
            )
        return self._trainer

    @property
    def iters_per_epoch(self) -> int:
        run = self.cfg.run_cfg
        if run.get("iters_per_epoch"):
            return int(run.iters_per_epoch)
        return max(1, sum(len(d["train"]) for d in self.datasets.values())
                   // int(run.get("batch_size_train", 4)))

    @property
    def max_steps(self) -> int:
        return int(self.cfg.run_cfg.get("max_epoch", 1)) * self.iters_per_epoch

    def build_loader(self, collate_fn, num_workers: Optional[int] = None):
        from stllm_tpu_torch.data.loaders import DataLoader, IterLoader, MetaLoader

        run = self.cfg.run_cfg
        loaders = [
            IterLoader(DataLoader(
                d["train"], int(run.get("batch_size_train", 4)), collate_fn,
                num_workers=num_workers or int(run.get("num_workers", 4)),
                seed=int(run.get("seed", 42))))
            for d in self.datasets.values()
        ]
        self._loader = iter(MetaLoader(loaders, seed=int(run.get("seed", 42))))
        return self._loader

    def train(self, collate_fn=None) -> Dict:
        """Resume from ``output_dir`` if it holds a checkpoint, then train
        epoch by epoch to ``max_epoch * iters_per_epoch`` steps, with a
        checkpoint at each epoch's end. The trainer already saves at its
        last step, so the epoch's save is skipped when that step is the
        newest checkpoint: each step is written once."""
        if self._loader is None:
            if collate_fn is None:
                raise ValueError("pass collate_fn (or call build_loader first)")
            self.build_loader(collate_fn)
        trainer = self.trainer
        trainer.resume_if_available()
        stats = {}
        for epoch in range(int(self.cfg.run_cfg.get("max_epoch", 1))):
            target = (epoch + 1) * self.iters_per_epoch
            logger.info("Start training epoch %d (to step %d)", epoch, target)
            stats = trainer.train(self._loader, target)
            if trainer.ckpt.latest_step() != int(trainer.state.step):
                trainer.ckpt.save(trainer.state)
        return stats
