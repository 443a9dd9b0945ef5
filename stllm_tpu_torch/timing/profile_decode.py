"""Trace one greedy decode on the Vicuna-7B stack and print where the
device time goes.

One warmed ``generate`` of 32 new tokens after a 512-token prompt, under
``torch.profiler`` (CPU and CUDA activities): the 40 CUDA kernels with the
most total duration, the total device-op time, the traced wall time, the
kernel launches and the device idle share (1 minus the union of the kernel
intervals over the traced wall time). Decode is the port's first
bottleneck; this is its chunk-level trace.

    python -m stllm_tpu_torch.timing.profile_decode [int4f|int4pc|int8] [--cpu]

Prints the table and, last, one JSON line of the summary; writes no file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from stllm_tpu_torch.models.generation import GenerationConfig, generate
from stllm_tpu_torch.models.llama import LlamaConfig
from stllm_tpu_torch.timing import _common
from stllm_tpu_torch.timing.bench_decode import build_decode, prompt

HARNESS = "stllm_tpu_torch.timing.profile_decode"
VARIANTS = ("int4f", "int4pc", "int8")
PROMPT = 512
NEW = 32
TOP = 40
SPAN = "profile_decode.generate"


def gen_cfg() -> GenerationConfig:
    return GenerationConfig(max_new_tokens=NEW, stop_sequences=(), eos_token_id=-1,
                            pad_to_multiple=64)


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """The length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def summarize(events, span: Tuple[float, float], wall_s: float) -> Dict:
    """The kernel table and totals of a trace's events. ``span`` is the
    traced call's (start, end) in the trace's microseconds, ``wall_s`` its
    host-clock seconds (used where the trace has no span). The span's own
    range, which the profiler also lays on the device timeline, is no
    kernel."""
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name != SPAN and e.time_range.end > e.time_range.start]
    by_name: Dict[str, List[float]] = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.end - e.time_range.start
        rec[1] += 1
    wall_us = span[1] - span[0] if span[1] > span[0] else wall_s * 1e6
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    if span[1] > span[0]:
        spans = [(max(s, span[0]), min(e, span[1])) for s, e in spans
                 if e > span[0] and s < span[1]]
    busy = union_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"traced_wall_ms": wall_us / 1e3,
            "device_op_ms": sum(v[0] for v in by_name.values()) / 1e3,
            "device_busy_ms": busy / 1e3,
            "kernel_launches": len(kernels),
            "device_idle_share": max(0.0, 1.0 - busy / wall_us) if wall_us > 0 else 1.0,
            "top": [{"kernel": name, "calls": n, "ms": us / 1e3} for name, (us, n) in top]}


@torch.no_grad()
def run_profile(params: Dict, cfg: LlamaConfig, variant: str) -> Dict:
    """One warm generate, then one traced: the summary, the tokens of the
    traced call and the card line."""
    device = params["embed_tokens"].device
    emb = prompt(cfg, 1, device, PROMPT)
    gen = gen_cfg()
    generate(params, emb, llama_cfg=cfg, gen=gen)                 # warm
    print("warmed; tracing one generate call", flush=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _common.sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function(SPAN):
            out = generate(params, emb, llama_cfg=cfg, gen=gen)
            _common.sync(device)
        wall_s = time.perf_counter() - t0
    events = prof.events()
    spans = [e for e in events if e.name == SPAN]
    span = ((spans[0].time_range.start, spans[0].time_range.end) if spans else (0.0, 0.0))
    summary = summarize(events, span, wall_s)
    assert len(out[0]) == NEW
    print(f"total device-op time: {summary['device_op_ms']:.2f} ms over the traced call "
          f"({summary['traced_wall_ms']:.2f} ms wall, {summary['kernel_launches']} kernel "
          f"launches, device idle share {summary['device_idle_share']:.3f})")
    for row in summary["top"]:
        print(f"{row['ms']:9.3f} ms {row['calls']:6d}x  {row['kernel'][:110]}")
    return {"variant": variant, "prompt": PROMPT, "new_tokens": NEW, **summary,
            "tokens": out[0], "device": _common.device_line(device), "harness": HARNESS}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="trace one 32-token greedy decode after a 512-token prompt on Vicuna-7B")
    parser.add_argument("variant", nargs="?", default="int4f", choices=VARIANTS,
                        help="weight format (default int4f: fused W4A16 + int8 head)")
    _common.add_device_args(parser, None)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    params, cfg = build_decode(args.variant, device)
    result = run_profile(params, cfg, args.variant)
    print(json.dumps({k: v for k, v in result.items() if k != "tokens"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
