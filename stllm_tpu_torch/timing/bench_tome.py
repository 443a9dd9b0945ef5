"""Encode throughput at every token-merging level on the static-int8 plain
stack (EVA-ViT-g + Q-Former + llama_proj, a 64-frame video): "off", the
spatial levels (``merge_schedule``), and the temporal levels (cross-frame
folds that halve the frame rows, then a post-trunk re-merge so the
Q-Former cross-attends over about as many tokens as at the spatial
levels). Each level: two warm encodes, then ``iters`` timed, frames/s over
their sum; every encode's seconds are kept.

    python -m stllm_tpu_torch.timing.bench_tome [iters] [only] [--cpu] [--out-dir DIR]

``only`` keeps the levels whose name contains it. Prints one JSON line a
level and merges them into DIR/BENCH_TOME.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict

import torch

from stllm_tpu_torch.models.stllm import STLLMConfig, encode_img
from stllm_tpu_torch.ops.tome import MERGE_LEVELS
from stllm_tpu_torch.timing import _common
from stllm_tpu_torch.timing.bench_encode_static import FRAMES, build_encode_static

HARNESS = "stllm_tpu_torch.timing.bench_tome"
DOC = "BENCH_TOME.json"
LEVELS = {"off": (), **{k: v["merge_schedule"] for k, v in MERGE_LEVELS.items()
                        if "temporal_schedule" not in v and k != "off"}}
T_LEVELS = {k: (v["temporal_schedule"], v["merge_schedule"])
            for k, v in MERGE_LEVELS.items() if "temporal_schedule" in v}


@torch.no_grad()
def measure(cfg: STLLMConfig, params: Dict, inputs: Dict[str, torch.Tensor], iters: int):
    def encode():
        return encode_img(params, inputs["frames"], cfg, inputs["q_ids"], inputs["q_mask"])

    encode()
    encode()
    out, times = _common.repeats(encode, iters, inputs["frames"].device)
    return inputs["frames"].shape[1] * iters / sum(times), times, out


def run_tome(params: Dict, cfg: STLLMConfig, inputs: Dict[str, torch.Tensor], iters: int = 8,
             only: str = "") -> Dict:
    """frames/s by level, every encode's seconds by level, and each level's
    last encode."""
    fps, encode_s, outs = {}, {}, {}
    for name, sched in LEVELS.items():
        if only and only not in name:
            continue
        c = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, merge_schedule=sched))
        f, encode_s[name], outs[name] = measure(c, params, inputs, iters)
        fps[name] = round(f, 1)
        print(json.dumps({"level": name, "schedule": list(sched), "frames_per_s": fps[name]}),
              flush=True)
    for name, (tsched, msched) in T_LEVELS.items():
        if only and only not in name:
            continue
        c = dataclasses.replace(cfg, vit=dataclasses.replace(
            cfg.vit, temporal_schedule=tsched, merge_schedule=msched))
        f, encode_s[name], outs[name] = measure(c, params, inputs, iters)
        fps[name] = round(f, 1)
        print(json.dumps({"level": name, "temporal": list(tsched), "post_trunk": list(msched),
                          "frames_per_s": fps[name]}), flush=True)
    return {"fps": fps, "encode_s": encode_s, "outs": outs}


def write(result: Dict, out_dir: str, device) -> str:
    def update(doc):
        doc.update({"metric": "static-int8 encode fr/s at token-merge levels", "frames": FRAMES,
                    **result["fps"]})
        doc["encode_s"] = {**doc.get("encode_s", {}), **result["encode_s"]}
        _common.stamp(doc, device, HARNESS)
    return _common.merge_doc(out_dir, DOC, update)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="static-int8 encode throughput at every token-merge level "
                    "(64-frame video)")
    parser.add_argument("iters", nargs="?", type=int, default=8,
                        help="timed encodes a level (default 8)")
    parser.add_argument("only", nargs="?", default="",
                        help="run only the levels whose name contains this")
    _common.add_device_args(parser, _common.OUT_DIR)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    params, cfg, inputs = build_encode_static(device)
    write(run_tome(params, cfg, inputs, args.iters, args.only), args.out_dir, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
