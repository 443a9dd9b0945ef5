"""Long-context Vicuna-7B decode: where the int8 KV cache and H2O-budgeted
decode pay.

At a 512-token context the KV cache read is small beside the W4A16 weight
stream; it grows with the context (a bf16 cache is 512 KB a token: 32
layers x 2 x 4096 x 2 B), so the int8 cache and H2O eviction
(``models/h2o.py``, a cache capped at 1024 heavy hitters + a 128-token
window) must win somewhere past 512. This measures where.

Protocol: decode-only ms/token = (T(new=80) - T(new=16)) / 64, each T the
best of ``ITERS`` full calls after a warm one; differencing removes the
prefill and the fixed cost of a call. Every call's seconds are kept.

    python -m stllm_tpu_torch.timing.bench_decode_longctx [contexts ...] [--cpu]
        [--out-dir DIR]

(default contexts 512 2048 4096). Writes a "long_ctx" section into
DIR/BENCH_DECODE.json, keeping the rest.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from stllm_tpu_torch.models.generation import GenerationConfig, generate
from stllm_tpu_torch.models.h2o import h2o_decode_chunk_greedy, h2o_prefill
from stllm_tpu_torch.models.llama import VICUNA_7B, LlamaConfig, lm_head
from stllm_tpu_torch.timing import _common
from stllm_tpu_torch.timing.bench_decode import DOC, build_decode

HARNESS = "stllm_tpu_torch.timing.bench_decode_longctx"
ITERS = 3
H2O_BUDGET, H2O_RECENT = 1152, 128   # 1024 heavy hitters + a 128-token window
SHORT, LONG = 16, 80


def build_longctx(device, seed: int = 0, base: Dict = None) -> Tuple[Dict, LlamaConfig]:
    return build_decode("int4f", device, seed, base, VICUNA_7B)


def _prompt(cfg: LlamaConfig, prefix: int, device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.normal(size=(1, prefix, cfg.hidden)) * 0.02).to(
        device=device, dtype=torch.bfloat16)


def _differenced(run, iters: int) -> Tuple[float, Dict[str, List[float]], Dict]:
    """(T(80) - T(16)) * 1e3 / 64 from ``run(new) -> (best s, all s, tokens)``."""
    hi, hi_s, hi_tok = run(LONG, iters)
    lo, lo_s, lo_tok = run(SHORT, iters)
    ms = (hi - lo) * 1e3 / (LONG - SHORT)
    return ms, {f"new{LONG}_s": hi_s, f"new{SHORT}_s": lo_s}, {LONG: hi_tok, SHORT: lo_tok}


@torch.no_grad()
def decode_ms(params: Dict, cfg: LlamaConfig, prefix: int, label: str, iters: int = ITERS
              ) -> Dict:
    device = params["embed_tokens"].device
    emb = _prompt(cfg, prefix, device)

    def run(new, iters):
        gen = GenerationConfig(max_new_tokens=new, stop_sequences=(), eos_token_id=-1,
                               pad_to_multiple=64)
        generate(params, emb, llama_cfg=cfg, gen=gen)                 # warm
        out, times = _common.repeats(lambda: generate(params, emb, llama_cfg=cfg, gen=gen),
                                     iters, device)
        return min(times), times, out[0]

    ms, raw, tokens = _differenced(run, iters)
    print(f"{label:44s} ctx={prefix:5d}  {ms:6.2f} ms/token", flush=True)
    return {"ms": round(ms, 2), "raw": raw, "tokens": tokens}


@torch.no_grad()
def h2o_ms(params: Dict, cfg: LlamaConfig, prefix: int, iters: int = ITERS) -> Dict:
    device = params["embed_tokens"].device
    emb = _prompt(cfg, prefix, device)
    hidden, cache = h2o_prefill(params, emb, None, cfg, budget=H2O_BUDGET, recent=H2O_RECENT)
    tok = torch.argmax(lm_head(params, hidden[:, -1:])[:, 0], -1).to(torch.int32)

    def fresh():
        # a decode step writes the cache in place: each call starts from a
        # copy of the prefilled one, made outside the clock
        return cache._replace(**{f: tuple(t.clone() for t in getattr(cache, f))
                                 for f in ("k", "v", "pos", "mass", "filled")})

    def run(new, iters):
        h2o_decode_chunk_greedy(params, tok, fresh(), cfg, n=new)     # warm
        times = []
        for _ in range(iters):
            c = fresh()
            (toks, _), dt = _common.clock(
                lambda: h2o_decode_chunk_greedy(params, tok, c, cfg, n=new), device)
            times.append(dt)
        return min(times), times, toks[0].tolist()

    ms, raw, tokens = _differenced(run, iters)
    print(f"{'int4f + H2O budget=' + str(H2O_BUDGET):44s} ctx={prefix:5d}  {ms:6.2f} ms/token",
          flush=True)
    return {"ms": round(ms, 2), "raw": raw, "tokens": tokens}


def run_longctx(params: Dict, cfg: LlamaConfig, contexts: List[int], iters: int = ITERS
                ) -> Dict:
    """The "long_ctx" section, each arm's raw seconds (``raw_s``) and
    tokens (``tokens``) beside it."""
    kv8 = dataclasses.replace(cfg, kv_int8=True)
    section = {"protocol": f"decode-only ms/token by differencing (new={LONG} minus "
                           f"new={SHORT})/{LONG - SHORT}, best of {iters}, 7B fused W4A16 + "
                           "int8 head, one CUDA card",
               "contexts": {}, "raw_s": {}}
    tokens = {}
    for ctx in contexts:
        arms = {"kv_bf16": decode_ms(params, cfg, ctx, "int4f, bf16 KV", iters),
                "kv_int8": decode_ms(params, kv8, ctx, "int4f, int8 KV", iters)}
        if ctx > H2O_BUDGET:
            arms[f"h2o_budget{H2O_BUDGET}"] = h2o_ms(params, cfg, ctx, iters)
        section["contexts"][str(ctx)] = {k: a["ms"] for k, a in arms.items()}
        section["raw_s"][str(ctx)] = {k: a["raw"] for k, a in arms.items()}
        tokens[str(ctx)] = {k: a["tokens"] for k, a in arms.items()}
    print(json.dumps(section), flush=True)
    return {"section": section, "tokens": tokens}


def write(section: Dict, out_dir: str, device) -> str:
    section = _common.stamp(dict(section), device, HARNESS)
    return _common.merge_doc(out_dir, DOC, lambda doc: doc.__setitem__("long_ctx", section))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="long-context Vicuna-7B decode ms/token: bf16 KV, int8 KV and H2O")
    parser.add_argument("contexts", nargs="*", type=int, default=[512, 2048, 4096],
                        help="prompt lengths (default 512 2048 4096)")
    _common.add_device_args(parser, _common.OUT_DIR)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    params, cfg = build_longctx(device)
    write(run_longctx(params, cfg, args.contexts)["section"], args.out_dir, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
