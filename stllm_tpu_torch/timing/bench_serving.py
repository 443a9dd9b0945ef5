"""Continuous-batching server throughput on the Vicuna-7B fused-W4A16 stack
(int8 head).

Submits N requests (512-token prompts, 64 new tokens each) to the
slot-based server (``stllm_tpu_torch/serving.py``, chunk 16) and measures
sustained generated tokens/s, prefill interleave and slot refill included:
the best of 3 greedy drains, then the best of 3 drains of a half-sampled
mix (top-p 0.9, temperature 0.8). Every drain's seconds are kept beside
the best, and so are the blocking host reads a drain makes.

    python -m stllm_tpu_torch.timing.bench_serving [n_requests] [slots] [--cpu]
        [--out-dir DIR]

Merges its keys into DIR/BENCH_SERVING.json (``bench_spec_serving`` owns
the "speculative" section).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from stllm_tpu_torch.models.generation import GenerationConfig
from stllm_tpu_torch.models.llama import LlamaConfig
from stllm_tpu_torch.serving import ContinuousBatcher
from stllm_tpu_torch.timing import _common
from stllm_tpu_torch.timing.bench_decode import build_decode

HARNESS = "stllm_tpu_torch.timing.bench_serving"
DOC = "BENCH_SERVING.json"
PROMPT, NEW = 512, 64
CHUNK = 16
DRAINS = 3
SAMPLED = 0.5


def build_serving(device, seed: int = 0, base: Dict = None) -> Tuple[Dict, LlamaConfig]:
    """Fused W4A16 with an int8 head, from ``base`` or a fresh init."""
    return build_decode("int4f", device, seed, base)


def gen_cfgs() -> Tuple[GenerationConfig, GenerationConfig]:
    greedy = GenerationConfig(max_new_tokens=NEW, eos_token_id=-1, stop_sequences=(),
                              pad_to_multiple=64)
    sampled = GenerationConfig(max_new_tokens=NEW, eos_token_id=-1, stop_sequences=(),
                               pad_to_multiple=64, do_sample=True, top_p=0.9, temperature=0.8)
    return greedy, sampled


@torch.no_grad()
def run_serving(params: Dict, cfg: LlamaConfig, n: int = 24, slots: int = 8,
                drains: int = DRAINS) -> Dict:
    """The JAX script's protocol on one ``default_rng(0)`` stream: a warm
    drain of ``slots`` greedy requests, ``drains`` greedy drains of ``n``,
    a warm mixed drain of ``slots``, ``drains`` mixed drains of ``n``."""
    device = params["embed_tokens"].device
    rng = np.random.default_rng(0)
    gen, gen_s = gen_cfgs()

    def make_cb():
        return ContinuousBatcher(params, cfg, slots=slots, max_len=PROMPT + NEW + 16,
                                 chunk=CHUNK)

    def submit_all(cb, count, sampled_frac=0.0):
        for i in range(count):
            emb = torch.from_numpy(rng.normal(size=(1, PROMPT, cfg.hidden)) * 0.02).to(
                device=device, dtype=torch.bfloat16)
            if i < count * sampled_frac:
                cb.submit(i, emb, gen_s, seed=i)
            else:
                cb.submit(i, emb, gen)

    def drain(sampled_frac=0.0):
        cb = make_cb()
        submit_all(cb, n, sampled_frac)
        out, dt = _common.clock(cb.run, device)
        total = sum(len(v) for v in out.values())
        assert len(out) == n and total == n * NEW
        return total, dt, cb.host_pulls, out

    cb = make_cb()                      # warm: prefill, insert, decode chunk
    submit_all(cb, slots)
    cb.run()
    runs = [drain() for _ in range(drains)]
    total, dt, pulls, greedy_out = min(runs, key=lambda r: r[1])
    cb = make_cb()                      # warm the mixed chunk
    submit_all(cb, slots, sampled_frac=SAMPLED)
    cb.run()
    mixed = [drain(SAMPLED) for _ in range(drains)]
    total_s, dt_s, _, _ = min(mixed, key=lambda r: r[1])
    result = {
        "metric": "continuous-batching sustained decode throughput "
                  "(7B fused W4A16, 512-tok prompts, 64 new, incl. "
                  "prefill interleave + slot refill)",
        "n_requests": n,
        "slots": slots,
        "tokens_per_s": round(total / dt, 1),
        "wall_s": round(dt, 2),
        "host_pulls_per_drain": pulls,
        "sampled_mix_tokens_per_s": round(total_s / dt_s, 1),
        "sampled_mix": "half greedy / half on-device top-p (0.9, T=0.8)",
        "drain_s": [r[1] for r in runs],
        "sampled_mix_drain_s": [r[1] for r in mixed],
    }
    print(json.dumps(result), flush=True)
    return {**result, "tokens": greedy_out}


def write(result: Dict, out_dir: str, device) -> str:
    section = {k: v for k, v in result.items() if k != "tokens"}
    return _common.merge_doc(out_dir, DOC,
                             lambda doc: doc.update(_common.stamp(section, device, HARNESS)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="continuous-batching throughput on the Vicuna-7B fused-W4A16 stack")
    parser.add_argument("n_requests", nargs="?", type=int, default=24,
                        help="requests a drain (default 24)")
    parser.add_argument("slots", nargs="?", type=int, default=8, help="decode slots (default 8)")
    _common.add_device_args(parser, _common.OUT_DIR)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    params, cfg = build_serving(device)
    write(run_serving(params, cfg, args.n_requests, args.slots), args.out_dir, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
