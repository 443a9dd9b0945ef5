"""Metric logging: windowed meters and a step logger with timing and ETA
(stllm_tpu/common/logging.py), single process. The memory column reports the
card's allocated bytes from ``torch.cuda.memory_allocated``.
"""

from __future__ import annotations

import datetime
import logging
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import numpy as np
import torch


class SmoothedValue:
    """Track a series of values; expose window-smoothed and global averages."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return float(max(self.deque)) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


def _device_mem_gb() -> Optional[float]:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.memory_allocated() / (1024 ** 3)
    return None


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr: str) -> SmoothedValue:
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def global_avg(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter.global_avg:.4f}" for name, meter in self.meters.items())

    def __str__(self) -> str:
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        total = len(iterable) if hasattr(iterable, "__len__") else None
        logger = logging.getLogger("stllm_tpu_torch")

        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                msg = [header, f"[{i}" + (f"/{total}]" if total else "]"), str(self)]
                if total is not None:
                    eta = iter_time.global_avg * (total - i)
                    msg.insert(2, f"eta: {datetime.timedelta(seconds=int(eta))}")
                msg += [f"time: {iter_time}", f"data: {data_time}"]
                mem = _device_mem_gb()
                if mem is not None:
                    msg.append(f"mem: {mem:.2f}GB")
                logger.info(self.delimiter.join(m for m in msg if m))
            i += 1
            end = time.time()

        total_time = time.time() - start_time
        logger.info("%s Total time: %s (%.4f s / it)", header,
                    datetime.timedelta(seconds=int(total_time)), total_time / max(i, 1))
