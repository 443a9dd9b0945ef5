#!/usr/bin/env python3
"""Where the time goes in one video-QA request of the PyTorch port.

    python3 script/profile_torch_slice.py [--out profile.json]

Run from the repository root on a CUDA card. Builds the QA config
(config/instructblipbase_stllm_qa.yaml) at full width with random weights.
Three phases: the encode of one 16-frame video (ViT-g + BTAdapter,
Q-Former, llama_proj, splice), the prefill of its 576-token prompt, and one
16-step greedy decode chunk over 4 slots. Each is warmed up, then timed
(host clock, synchronized; all phases before any profiler session), then
profiled once (torch.profiler, CUDA activity). For each phase it prints the
wall time, the device time summed over kernels, the device idle share
(1 - device / wall), the time in the packed-qkv kernel, in GEMMs and in the
rest, and the top kernels; with --out it also writes them as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "matmul")


def _device_us(e) -> float:
    return float(getattr(e, "self_device_time_total", 0.0) or 0.0)


def wall_ms(fn, reps: int = 3) -> float:
    """Host wall time of ``fn``, synchronized, mean of ``reps`` runs after a
    warm-up (allocator, cuBLAS heuristics)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def profile_phase(name: str, fn, wall: float) -> dict:
    """Device time by kernel from one profiled run of ``fn``, against its
    unprofiled wall time."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    dev_ms = sum(_device_us(e) for e in kernels) / 1e3
    attn = sum(_device_us(e) for e in kernels if "packed_qkv_attention" in e.key) / 1e3
    gemm = sum(_device_us(e) for e in kernels
               if any(m in e.key.lower() for m in GEMM_MARKS)) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:10]
    row = {"phase": name, "wall_ms": wall, "device_ms": dev_ms,
           "device_idle_share": max(0.0, 1.0 - dev_ms / wall),
           "kernel_launches": sum(e.count for e in kernels),
           "packed_qkv_ms": attn, "gemm_ms": gemm, "other_ms": dev_ms - attn - gemm,
           "top": [{"kernel": e.key[:90], "calls": e.count, "ms": _device_us(e) / 1e3}
                   for e in top]}
    print(json.dumps(row))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the phases as JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1

    from stllm_tpu_torch.common.config import Config
    from stllm_tpu_torch.models.generation import _decode_chunk_greedy, _pad_prompt, _prefill
    from stllm_tpu_torch.models.llama import init_kv_cache
    from stllm_tpu_torch.models.zoo import STLLM
    from stllm_tpu_torch.ops import kernels
    from stllm_tpu_torch.pipeline_serving import _encode_assemble

    kernels.build()
    model = STLLM.from_config(
        Config(REPO / "config" / "instructblipbase_stllm_qa.yaml").model_cfg, seed=0)
    cfg, params = model.cfg, model.params
    rng = np.random.default_rng(1)
    size = cfg.vit.image_size
    frames = torch.from_numpy(rng.integers(0, 256, (1, 16, size, size, 3), dtype=np.uint8)).cuda()
    pre = torch.from_numpy(rng.integers(3, cfg.llama.vocab_size, (1, 40))).int().cuda()
    suf = torch.from_numpy(rng.integers(3, cfg.llama.vocab_size, (1, 20))).int().cuda()
    q = torch.from_numpy(rng.integers(0, cfg.qformer.vocab_size, (1, 12))).int().cuda()

    embeds = _encode_assemble(params, frames, pre, suf, q, torch.ones_like(q), cfg)
    emb, mask = _pad_prompt(embeds, torch.ones(embeds.shape[:2], dtype=torch.int32,
                                               device="cuda"), 64)
    cache = init_kv_cache(cfg.llama, 4, 1024, device="cuda")
    cache.length.fill_(emb.shape[1])
    cur = torch.zeros((4,), dtype=torch.int32, device="cuda")
    phases = [
        ("encode_16_frames", lambda: _encode_assemble(
            params, frames, pre, suf, q, torch.ones_like(q), cfg)),
        (f"prefill_{emb.shape[1]}_tokens", lambda: _prefill(
            params["llama"], emb, mask, cfg.llama, emb.shape[1])),
        ("decode_16_steps_4_slots", lambda: _decode_chunk_greedy(
            params["llama"], cur, cache, cfg.llama, 16)),
    ]
    # every wall time before the first profiler session: a session can
    # leave tracing hooks that slow later kernel launches
    walls = [wall_ms(fn) for _, fn in phases]
    rows = [profile_phase(name, fn, w) for (name, fn), w in zip(phases, walls)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "torch": torch.__version__, "phases": rows},
                                  indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
