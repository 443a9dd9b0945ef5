"""Beam-against-greedy decode latency on Vicuna-7B, one card.

QA-bench decodes with num_beams=5 (reference:
stllm/test/qabench/msvd_qa.py:111-115), so beam latency is a served path:
a 512-token prompt, 32 new tokens, int8 (W8A8) or int4 (fused W4A16 with an
int8 head) weights. Each path: two warm calls, then the p50 of 5, with all
5 kept. ``batched``: 8 videos x 5 beams in one ``beam_search_batched``
call against 8 solo beam searches (the eval-sweep form).

    python -m stllm_tpu_torch.timing.bench_beam [both|greedy|beam|batched] [int8|int4]
        [--cpu] [--out-dir DIR]

Prints one JSON line; ``batched`` also writes DIR/BENCH_BEAM.json.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from stllm_tpu_torch.models.generation import (
    GenerationConfig, beam_search, beam_search_batched, generate)
from stllm_tpu_torch.models.llama import VICUNA_7B, LlamaConfig
from stllm_tpu_torch.timing import _common
from stllm_tpu_torch.timing.bench_decode import build_decode

HARNESS = "stllm_tpu_torch.timing.bench_beam"
DOC = "BENCH_BEAM.json"
PROMPT = 512
NEW = 32
ITERS = 5
P_VIDEOS = 8
MODES = ("both", "greedy", "beam", "batched")
WEIGHTS = {"int8": "int8", "int4": "int4f"}


def build_beam(wmode: str, device, seed: int = 0, base: Dict = None
               ) -> Tuple[Dict, LlamaConfig]:
    """W8A8 (``int8``) or fused W4A16 + int8 head (``int4``) Vicuna-7B."""
    return build_decode(WEIGHTS[wmode], device, seed, base, VICUNA_7B)


def gen_cfgs() -> Tuple[GenerationConfig, GenerationConfig]:
    greedy = GenerationConfig(max_new_tokens=NEW, stop_sequences=(), eos_token_id=-1)
    beam = GenerationConfig(max_new_tokens=NEW, stop_sequences=(), eos_token_id=-1,
                            num_beams=5, length_penalty=1.0)
    return greedy, beam


def time_fn(fn: Callable, device, iters: int) -> Tuple[float, List[float], object]:
    """Two warm calls, then the p50 of ``iters`` (ms), every call's ms and
    the last result."""
    fn()
    fn()
    out, times = _common.repeats(fn, iters, device)
    times = [t * 1000 for t in times]
    return float(np.percentile(times, 50)), times, out


@torch.no_grad()
def run_beam(params: Dict, cfg: LlamaConfig, mode: str = "both", wmode: str = "int8",
             iters: int = ITERS) -> Dict:
    device = params["embed_tokens"].device
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(a).to(device=device, dtype=cfg.dtype)
    embeds = t(rng.normal(size=(1, PROMPT, cfg.hidden)) * 0.02)
    mask = torch.ones((1, PROMPT), dtype=torch.int32, device=device)
    greedy_gen, beam_gen = gen_cfgs()

    def run_greedy():
        out = generate(params, embeds, attention_mask=mask, llama_cfg=cfg, gen=greedy_gen)
        assert len(out[0]) == NEW
        return out

    def run_beam_solo():
        out = beam_search(params, embeds, mask, llama_cfg=cfg, gen=beam_gen)
        assert len(out) == NEW
        return out

    out = {"metric": f"7B decode ms/token ({wmode} weights, 512-token prompt, 32 new, one card)"}
    tokens = {}
    if mode in ("both", "greedy"):
        greedy_ms, out["greedy_call_ms"], tokens["greedy"] = time_fn(run_greedy, device, iters)
        out["greedy_ms_per_token"] = round(greedy_ms / NEW, 2)
        out["greedy_total_ms"] = round(greedy_ms, 1)
    if mode in ("both", "beam"):
        beam_ms, out["beam5_call_ms"], tokens["beam"] = time_fn(run_beam_solo, device, iters)
        out["beam5_ms_per_token"] = round(beam_ms / NEW, 2)
        out["beam5_total_ms"] = round(beam_ms, 1)
    if mode == "both":
        out["beam_over_greedy"] = round(beam_ms / greedy_ms, 2)
    if mode == "batched":
        prompts = [t(rng.normal(size=(1, PROMPT, cfg.hidden)) * 0.02) for _ in range(P_VIDEOS)]

        def run_batched():
            res = beam_search_batched(params, prompts, llama_cfg=cfg, gen=beam_gen)
            assert len(res) == P_VIDEOS and len(res[0]) == NEW
            return res

        batched_ms, batched_call, tokens["batched"] = time_fn(run_batched, device, iters)
        solo_ms, solo_call, tokens["beam"] = time_fn(run_beam_solo, device, iters)
        out = {"metric": f"batched beam-5 eval throughput ({wmode} weights, "
                         f"{P_VIDEOS} videos/program, 512-token prompts, {NEW} new, one card)",
               "videos": P_VIDEOS,
               "batched_total_ms": round(batched_ms, 1),
               "batched_ms_per_token_per_video": round(batched_ms / NEW / P_VIDEOS, 2),
               "solo_beam_total_ms": round(solo_ms, 1),
               "speedup_vs_solo_sweep": round(solo_ms * P_VIDEOS / batched_ms, 2),
               "videos_per_hour_per_chip": round(P_VIDEOS * 3600e3 / batched_ms, 0),
               "batched_call_ms": batched_call, "solo_beam_call_ms": solo_call}
    _common.stamp(out, device, HARNESS)
    print(json.dumps(out), flush=True)
    return {**out, "tokens": tokens}


def write(result: Dict, out_dir: str) -> str:
    doc = {k: v for k, v in result.items() if k != "tokens"}
    return _common.merge_doc(out_dir, DOC, lambda old: (old.clear(), old.update(doc)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="greedy against beam-5 decode latency on Vicuna-7B (512-token prompt, "
                    "32 new tokens)")
    parser.add_argument("mode", nargs="?", default="both", choices=MODES,
                        help="paths to time (default both)")
    parser.add_argument("weights", nargs="?", default="int8", choices=list(WEIGHTS),
                        help="int8 (W8A8) or int4 (fused W4A16 + int8 head); default int8")
    _common.add_device_args(parser, _common.OUT_DIR)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    params, cfg = build_beam(args.weights, device)
    result = run_beam(params, cfg, args.mode, args.weights)
    if args.mode == "batched":
        write(result, args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
