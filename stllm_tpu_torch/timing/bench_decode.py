"""Vicuna-7B greedy-decode latency on every weight format: bf16, int8 (W8A8)
and int4 (W4A16, per-channel or per-group, fused or not, with an int8 head
and an int8 KV cache).

Decode streams every decoder-layer weight once a token, so ms/token follows
the weight bytes. This times the real path: ``models.generation`` chunked
greedy over the layer-major KV cache after a 512-token prefill, 64 new
tokens, the mean over ``iters`` generate calls after one warm call. Each
call's own time is kept beside the mean.

    python -m stllm_tpu_torch.timing.bench_decode [variants ...] [--batch B]
        [--iters N] [--cpu] [--out-dir DIR]

Variants: bf16, int8, int4 (group 128), int4pc (per-channel), int4h8
(+ int8 head), int4kv8 (+ int8 KV cache), int4f (q|k|v and gate|up fused,
int8 head), int4g64, int4fg128 (default: int8 int4f). Per-channel int4
runs the W4A16 kernel (prefill and decode forms); per-group int4 runs plain
torch, as the reference leaves it to XLA; bf16 and int8 run no kernel of
the port in the LLaMA. At batch 1 the results merge into
DIR/BENCH_DECODE.json. Reference protocol: the HF KV-cache decode loop of
stllm/conversation/conversation.py:231-243.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from stllm_tpu_torch.models.generation import GenerationConfig, generate
from stllm_tpu_torch.models.llama import (
    VICUNA_7B, LlamaConfig, init_llama, quantize_llama_params, quantize_llama_params_int4)
from stllm_tpu_torch.timing import _common

HARNESS = "stllm_tpu_torch.timing.bench_decode"
DOC = "BENCH_DECODE.json"
PREFIX = 512
NEW = 64
ITERS = 3


def _int4(**kw) -> Callable[[Dict, bool], Dict]:
    return lambda p, free: quantize_llama_params_int4(p, free_dense=free, **kw)


# variant -> (dense tree, free_dense) -> converted tree; free_dense=True
# consumes the dense tree layer by layer
CONVERT: Dict[str, Callable[[Dict, bool], Dict]] = {
    "bf16": lambda p, free: p,
    "int8": lambda p, free: quantize_llama_params(p, free_dense=free),
    "int4": _int4(group=128),
    "int4pc": _int4(group=None),
    "int4h8": _int4(group=None, quant_head=True),
    "int4kv8": _int4(group=None, quant_head=True),
    "int4f": _int4(group=None, quant_head=True, fuse=True),
    "int4g64": _int4(group=64),
    "int4fg128": _int4(group=128, quant_head=True, fuse=True),
}
KV8 = ("int4kv8",)
LABEL = {"bf16": "bf16 dense", "int8": "int8 W8A8",
         "int4": "int4 W4A16 (group=128)", "int4pc": "int4 W4A16 (per-chan)",
         "int4h8": "int4 W4A16 + int8 lm_head",
         "int4kv8": "int4 W4A16 + int8 head + int8 KV",
         "int4f": "int4 W4A16 fused qkv/gateup + int8 head",
         "int4g64": "int4 W4A16 (group=64)",
         "int4fg128": "int4 W4A16 fused + int8 head (group=128)"}
GROUPED = ("int4pc", "int4", "int4g64", "int4f", "int4fg128")


def variant_cfg(variant: str, cfg: LlamaConfig = VICUNA_7B) -> LlamaConfig:
    return dataclasses.replace(cfg, kv_int8=True) if variant in KV8 else cfg


def build_decode(variant: str, device, seed: int = 0, base: Dict = None,
                 cfg: LlamaConfig = VICUNA_7B) -> Tuple[Dict, LlamaConfig]:
    """The ``variant`` tree and its config: converted from ``base`` (a dense
    tree, left intact and shared) or from a fresh init of ``cfg`` on
    ``seed`` (consumed by the conversion)."""
    if base is None:
        tree = init_llama(torch.Generator(device=device).manual_seed(seed), cfg)
        return CONVERT[variant](tree, True), variant_cfg(variant, cfg)
    return CONVERT[variant](base, False), variant_cfg(variant, cfg)


def prompt(cfg: LlamaConfig, batch: int, device, length: int = None) -> torch.Tensor:
    """(batch, length (default PREFIX), hidden) bf16 embeddings from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(batch, length or PREFIX, cfg.hidden)) * 0.02
    return torch.from_numpy(emb).to(device=device, dtype=torch.bfloat16)


def gen_cfg() -> GenerationConfig:
    return GenerationConfig(max_new_tokens=NEW, stop_sequences=(), eos_token_id=-1,
                            pad_to_multiple=64)


@torch.no_grad()
def run_decode(params: Dict, cfg: LlamaConfig, label: str, iters: int = ITERS,
               batch: int = 1) -> Dict:
    """One warm generate, then ``iters`` timed ones: ms a decode step (all
    streams advance together), tokens/s, every call's seconds and the
    tokens of the last call."""
    device = params["embed_tokens"].device
    emb = prompt(cfg, batch, device)
    gen = gen_cfg()
    out = generate(params, emb, llama_cfg=cfg, gen=gen)       # warm
    assert len(out) == batch and len(out[0]) == NEW
    out, times = _common.repeats(lambda: generate(params, emb, llama_cfg=cfg, gen=gen),
                                 iters, device)
    dt = sum(times) / iters
    ms_tok = dt * 1e3 / NEW
    tput = batch * NEW / dt
    print(f"{label:34s} {ms_tok:7.2f} ms/step  {tput:7.0f} tok/s "
          f"(B={batch}, prefill+decode avg over {NEW} steps)", flush=True)
    return {"ms_per_step": ms_tok, "tokens_per_s": tput, "call_s": times, "tokens": out}


def write(results: Dict[str, Dict], out_dir: str, device) -> str:
    """Merge batch-1 results into ``out_dir/BENCH_DECODE.json`` under the
    JAX script's keys, with every call's seconds and the card line."""
    ms = {v: round(r["ms_per_step"], 2) for v, r in results.items()}

    def update(doc):
        if "int4f" in ms:
            doc["decode_w4a16_ms_per_token"] = ms["int4f"]
            doc["protocol"] = ("512-token prefill + 64-token greedy, fused W4A16 + int8 head, "
                               "one CUDA card")
        if "int8" in ms:
            doc["int8_ms_per_token"] = ms["int8"]
        grp = {v: ms[v] for v in GROUPED if v in ms}
        if any(v in grp for v in ("int4", "int4g64", "int4fg128")):
            doc["w4a16_scale_granularity_ms_per_token"] = {
                "variants": {LABEL[v]: t for v, t in grp.items()},
                "note": "per-group (g=128/64) scales run plain torch: K-varying scales cannot "
                        "fold into the W4A16 kernel's epilogue or K-prepad (ops/quant.py)",
            }
        doc["call_s"] = {**doc.get("call_s", {}),
                         **{LABEL[v]: r["call_s"] for v, r in results.items()}}
        _common.stamp(doc, device, HARNESS)
    return _common.merge_doc(out_dir, DOC, update)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="Vicuna-7B greedy-decode latency by weight format (512-token prefill, "
                    "64 new tokens)")
    parser.add_argument("variants", nargs="*", metavar="VARIANT",
                        help=f"weight formats, of {' '.join(CONVERT)} (default: int8 int4f)")
    parser.add_argument("--batch", type=int, default=1, help="streams (default 1)")
    parser.add_argument("--iters", type=int, default=ITERS,
                        help=f"timed generate calls (default {ITERS})")
    _common.add_device_args(parser, _common.OUT_DIR)
    args = parser.parse_args(argv)
    unknown = [v for v in args.variants if v not in CONVERT]
    if unknown:
        parser.error(f"unknown variants {unknown}")
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    results = {}
    for v in args.variants or ["int8", "int4f"]:
        # a fresh init a variant: the in-place conversion consumes the dense tree
        params, cfg = build_decode(v, device)
        results[v] = run_decode(params, cfg, LABEL[v], args.iters, args.batch)
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({v: {k: r[k] for k in ("ms_per_step", "tokens_per_s", "call_s")}
                      for v, r in results.items()}), flush=True)
    if args.batch == 1:
        write(results, args.out_dir, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
