"""What the timing harnesses share: the device and output arguments and the
card line (both from ``evidence/_common.py``), the merge-preserving writer
rooted at ``--out-dir``, and the synchronized clock that keeps every
repeat's raw time beside the statistic each harness reports."""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Tuple

import torch

from stllm_tpu_torch.evidence._common import (
    add_device_args, device_line, pick_device, read_doc, stamp, write_doc)

__all__ = ["OUT_DIR", "add_device_args", "capture", "clock", "device_line", "merge_doc",
           "pick_device", "repeats", "replay_ms", "stamp", "sync"]

OUT_DIR = "timing_out"


def sync(device) -> None:
    """Wait for the card's queued work (a no-op on the CPU): every clock
    read of a harness comes after one."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clock(fn: Callable[[], Any], device) -> Tuple[Any, float]:
    """(fn(), its wall seconds), synchronized before both clock reads."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def repeats(fn: Callable[[], Any], n: int, device) -> Tuple[Any, List[float]]:
    """The last of ``n`` synchronized runs of ``fn`` and every run's seconds."""
    out, times = None, []
    for _ in range(n):
        out, dt = clock(fn, device)
        times.append(dt)
    return out, times


def capture(fn: Callable[[], Any]) -> Tuple[Any, Any]:
    """``fn()`` captured once in a CUDA graph, after one warm run on the
    same side stream the capture uses: (graph, its static output). The
    warm run and the capture each launch what ``fn`` launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def replay_ms(graph, n: int) -> List[float]:
    """Milliseconds of each of ``n`` replays of ``graph``, by CUDA events,
    after one untimed replay."""
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def merge_doc(out_dir: str, name: str, update: Callable[[Dict], None]) -> str:
    """Read ``out_dir/name`` (empty if missing or unreadable), apply
    ``update`` to it in place and write it back: sections other runs own
    survive, as in the JAX scripts. Returns the path."""
    path = os.path.join(out_dir, name)
    doc = read_doc(path)
    update(doc)
    write_doc(path, doc)
    return path
