"""Vicuna-7B W4A16 speculative greedy decode: the worst case (a random
2-layer draft, acceptance about 0) and full acceptance (the draft is the
target), beside plain greedy decode on the same prompt, and the
tokens/s-against-acceptance model from the measured round cost:

  t_round(k) = (k+1) * t_draft_step + t_verify(k+1)
  ms/token   = t_round / (E[accepted]+1),  E = a(1-a^k)/(1-a) for acceptance a

Protocol: a 512-token prompt, 64 new tokens; each arm one warm call, then
3 timed, ms/token over their sum, with every call's seconds kept.

    python -m stllm_tpu_torch.timing.bench_spec_decode [k] [--cpu] [--out-dir DIR]

Merges its keys into DIR/BENCH_SPEC.json (``bench_spec_trained`` owns
"trained_demo").
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from stllm_tpu_torch.models.generation import GenerationConfig, generate
from stllm_tpu_torch.models.llama import VICUNA_7B, LlamaConfig
from stllm_tpu_torch.models.speculative import speculative_generate
from stllm_tpu_torch.timing import _common
from stllm_tpu_torch.timing.bench_decode import build_decode

HARNESS = "stllm_tpu_torch.timing.bench_spec_decode"
DOC = "BENCH_SPEC.json"
PREFIX, NEW = 512, 64
ITERS = 3
DRAFT_LAYERS = 2
ACCEPTANCE = (0.5, 0.7, 0.8, 0.9)


def build_spec(device, seed: int = 0, base: Dict = None, cfg: LlamaConfig = VICUNA_7B
               ) -> Tuple[Dict, Dict, LlamaConfig, LlamaConfig]:
    """The fused W4A16 target (from ``base`` or a fresh init on ``seed``)
    and a random 2-layer W4A16 draft on seed 1."""
    tgt, cfg = build_decode("int4f", device, seed, base, cfg)
    dcfg = dataclasses.replace(cfg, num_layers=DRAFT_LAYERS)
    dft, _ = build_decode("int4f", device, 1, None, dcfg)
    return tgt, dft, cfg, dcfg


def gen_cfg() -> GenerationConfig:
    return GenerationConfig(max_new_tokens=NEW, stop_sequences=(), eos_token_id=-1,
                            pad_to_multiple=64)


def _prompt(cfg: LlamaConfig, device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.normal(size=(1, PREFIX, cfg.hidden)) * 0.02).to(
        device=device, dtype=torch.bfloat16)


@torch.no_grad()
def run_arm(tgt: Dict, dft: Dict, cfg: LlamaConfig, dft_cfg: LlamaConfig, k: int, label: str,
            iters: int = ITERS) -> Dict:
    """ms/token of ``speculative_generate``; the last call's stats and
    tokens; every call's seconds."""
    device = tgt["embed_tokens"].device
    emb = _prompt(cfg, device)
    gen = gen_cfg()

    def call():
        return speculative_generate(tgt, dft, emb, tgt_cfg=cfg, dft_cfg=dft_cfg, gen=gen, k=k,
                                    return_stats=True)
    out, stats = call()                                   # warm
    assert len(out[0]) == NEW
    (out, stats), times = _common.repeats(call, iters, device)
    ms_tok = sum(times) * 1e3 / (iters * NEW)
    print(f"{label:34s} {ms_tok:7.2f} ms/token  (mean accepted {stats['mean_accepted']:.2f}/{k}, "
          f"{stats['rounds']} rounds)", flush=True)
    return {"ms_per_token": ms_tok, "stats": stats, "tokens": out[0], "call_s": times}


@torch.no_grad()
def run_greedy(tgt: Dict, cfg: LlamaConfig, iters: int = ITERS) -> Dict:
    """Plain greedy ``generate`` on the target, the same prompt and count."""
    device = tgt["embed_tokens"].device
    emb = _prompt(cfg, device)
    gen = gen_cfg()
    generate(tgt, emb, llama_cfg=cfg, gen=gen)           # warm
    out, times = _common.repeats(lambda: generate(tgt, emb, llama_cfg=cfg, gen=gen), iters,
                                 device)
    ms_tok = sum(times) * 1e3 / (iters * NEW)
    print(f"{'plain greedy':34s} {ms_tok:7.2f} ms/token", flush=True)
    return {"ms_per_token": ms_tok, "tokens": out[0], "call_s": times}


def run_spec_decode(tgt: Dict, dft: Dict, cfg: LlamaConfig, dft_cfg: LlamaConfig, k: int = 6,
                    iters: int = ITERS) -> Dict:
    best = run_arm(tgt, tgt, cfg, cfg, k, "draft=target (accept=1.0)", iters)
    worst = run_arm(tgt, dft, cfg, dft_cfg, k, "random 2-layer draft (accept~0)", iters)
    plain = run_greedy(tgt, cfg, iters)
    # worst ~= t_round (about 1 token a round): model the real-draft curve
    # from the worst case's round cost at acceptance a
    t_round = worst["ms_per_token"] * worst["stats"]["tokens_per_round"]
    curve = {str(a): round(t_round / (a * (1 - a ** k) / (1 - a) + 1.0), 2) for a in ACCEPTANCE}
    result = {
        "metric": "7B W4A16 speculative greedy decode (512-tok prefill, 64 new)",
        "k": k,
        "draft": "2-layer Vicuna-width tower, W4A16",
        "worst_case_ms_per_token": round(worst["ms_per_token"], 2),
        "round_cost_ms": round(t_round, 2),
        "projected_ms_per_token_at_acceptance": curve,
        "full_acceptance_ms_per_token_draft_eq_target": round(best["ms_per_token"], 2),
        "plain_greedy_baseline_ms": round(plain["ms_per_token"], 2),
        "call_s": {"draft_eq_target": best["call_s"], "random_draft": worst["call_s"],
                   "plain_greedy": plain["call_s"]},
    }
    print(json.dumps(result), flush=True)
    return {**result, "arms": {"draft_eq_target": best, "random_draft": worst,
                               "plain_greedy": plain}}


def write(result: Dict, out_dir: str, device) -> str:
    section = _common.stamp({k: v for k, v in result.items() if k != "arms"}, device, HARNESS)
    return _common.merge_doc(out_dir, DOC, lambda doc: doc.update(section))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="Vicuna-7B W4A16 speculative decode: random draft, draft = target, and "
                    "plain greedy")
    parser.add_argument("k", nargs="?", type=int, default=6, help="draft tokens a round")
    _common.add_device_args(parser, _common.OUT_DIR)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    tgt, dft, cfg, dcfg = build_spec(device)
    write(run_spec_decode(tgt, dft, cfg, dcfg, args.k), args.out_dir, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
