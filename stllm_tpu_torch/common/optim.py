"""Learning-rate schedules as plain functions of the step
(stllm_tpu/common/optim.py): linear warmup into cosine or per-epoch step
decay, the HF Trainer ``cosine`` schedule of the QA config, and optax's
``warmup_cosine_decay_schedule`` that the train CLI builds. Each
``schedule(step)`` returns the rate of optimizer step ``step`` (0-based) as a
Python float; ``train.step.make_optimizer`` takes a schedule or a constant.
"""

from __future__ import annotations

import math
from typing import Callable

from stllm_tpu_torch.common.registry import registry

Schedule = Callable[[int], float]


def cosine_lr_schedule(init_lr: float, min_lr: float, warmup_steps: int,
                       total_steps: int, warmup_start_lr: float = 1e-6) -> Schedule:
    """Step-wise linear warmup followed by cosine decay to min_lr."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return warmup_start_lr + (init_lr - warmup_start_lr) * step / max(warmup_steps, 1)
        progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        progress = min(max(progress, 0.0), 1.0)
        return min_lr + 0.5 * (init_lr - min_lr) * (1.0 + math.cos(math.pi * progress))

    return schedule


def step_lr_schedule(init_lr: float, min_lr: float, decay_rate: float,
                     steps_per_epoch: int, warmup_steps: int = 0,
                     warmup_start_lr: float = 1e-6) -> Schedule:
    """Linear warmup then per-epoch exponential step decay, floored at min_lr."""

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return warmup_start_lr + (init_lr - warmup_start_lr) * step / max(warmup_steps, 1)
        epoch = step // max(steps_per_epoch, 1)
        return max(init_lr * (decay_rate ** epoch), min_lr)

    return schedule


def linear_warmup_cosine_hf(learning_rate: float, warmup_ratio: float,
                            total_steps: int) -> Schedule:
    """The HF Trainer ``cosine`` scheduler: linear warmup from 0 over
    ``warmup_ratio`` of the steps, cosine decay to 0 (the QA config's
    lr_scheduler_type and warmup_ratio)."""
    warmup_steps = int(round(total_steps * warmup_ratio))
    warm_len = max(warmup_steps, 1)
    decay_len = max(total_steps - warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return learning_rate * min(step, warm_len) / warm_len
        frac = min(step - warmup_steps, decay_len) / decay_len
        return learning_rate * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine decay to ``end_value``
    until ``decay_steps``, which counts the warmup (the cosine spans
    ``decay_steps - warmup_steps``). Like optax it refuses a cosine span
    that is not positive. Computed in float64; optax computes in float32."""
    span = decay_steps - warmup_steps
    if not span > 0:
        raise ValueError(f"warmup_cosine_decay needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        count = min(step - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / span))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


@registry.register_lr_scheduler("linear_warmup_cosine_lr")
class LinearWarmupCosineLRScheduler:
    def __init__(self, max_epoch: int, iters_per_epoch: int, init_lr: float,
                 min_lr: float, warmup_steps: int = 0, warmup_start_lr: float = -1, **_):
        self.schedule = cosine_lr_schedule(
            init_lr, min_lr, warmup_steps, max_epoch * iters_per_epoch,
            warmup_start_lr if warmup_start_lr >= 0 else init_lr)

    def __call__(self, step: int) -> float:
        return self.schedule(step)


@registry.register_lr_scheduler("linear_warmup_step_lr")
class LinearWarmupStepLRScheduler:
    def __init__(self, max_epoch: int, iters_per_epoch: int, init_lr: float,
                 min_lr: float, decay_rate: float = 1.0, warmup_steps: int = 0,
                 warmup_start_lr: float = -1, **_):
        self.schedule = step_lr_schedule(
            init_lr, min_lr, decay_rate, iters_per_epoch, warmup_steps,
            warmup_start_lr if warmup_start_lr >= 0 else init_lr)

    def __call__(self, step: int) -> float:
        return self.schedule(step)
