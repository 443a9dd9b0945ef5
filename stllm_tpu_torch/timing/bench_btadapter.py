"""BTAdapter encoder throughput: the encoder of the reference's QA config
(config/instructblipbase_stllm_qa.yaml:3 -> stllm/models/eva_btadapter.py:
46-255), 64 frames as 4 videos x 16 frames, fully static int8 (trunk and
branch calibrated, ``calibrate_btadapter_scales``), then at every spatial
token-merge level (the trunk merged, the branch taps unmerged through the
origin map) and every temporal fold level (trunk folds only: the BTAdapter
output is per frame by construction). Each: two warm encodes, then 6 timed,
frames/s over their sum; every encode's seconds are kept.

    python -m stllm_tpu_torch.timing.bench_btadapter [--cpu] [--out-dir DIR]

Writes DIR/BENCH_BTADAPTER.json (replacing it, as the JAX script does)
and prints one JSON line a level, then the document.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from stllm_tpu_torch.models.btadapter import (
    btadapter_forward, calibrate_btadapter_scales, init_btadapter)
from stllm_tpu_torch.models.vit import EVA_VIT_G, ViTConfig, quantize_vit_params
from stllm_tpu_torch.ops.tome import MERGE_LEVELS, level_kwargs
from stllm_tpu_torch.timing import _common

HARNESS = "stllm_tpu_torch.timing.bench_btadapter"
DOC = "BENCH_BTADAPTER.json"
F, T = 64, 16
ITERS = 6


def make_cfg() -> ViTConfig:
    return dataclasses.replace(EVA_VIT_G, gelu_approx=True)


def build_btadapter(device, seed: int = 0, cfg: ViTConfig = None
                    ) -> Tuple[Dict, ViTConfig, torch.Tensor]:
    """The static-int8 BTAdapter (depth 3), calibrated on the first 16 of
    the 64 bf16 normal frames of ``default_rng(0)``, and those frames."""
    cfg = cfg or make_cfg()
    params = init_btadapter(torch.Generator(device=device).manual_seed(seed), cfg, depth=3)
    rng = np.random.default_rng(0)
    s = cfg.image_size
    frames = torch.from_numpy(rng.normal(size=(F, s, s, 3))).to(device=device,
                                                                dtype=torch.bfloat16)
    params = quantize_vit_params(params, free_dense=True)
    params = calibrate_btadapter_scales(params, frames[:16], cfg, num_frames=16)
    return params, cfg, frames


def levels() -> Dict[str, Dict]:
    """Level name -> ViTConfig overrides: the spatial levels' merge
    schedules, then the temporal levels' trunk folds."""
    out = {k: {"merge_schedule": v["merge_schedule"]} for k, v in MERGE_LEVELS.items()
           if "temporal_schedule" not in v and k != "off"}
    out.update({k: {"temporal_schedule": level_kwargs(k, post_trunk=False)["temporal_schedule"]}
                for k in MERGE_LEVELS if "temporal_schedule" in MERGE_LEVELS[k]})
    return out


@torch.no_grad()
def measure(params: Dict, cfg: ViTConfig, frames: torch.Tensor, iters: int = ITERS
            ) -> Tuple[float, List[float], torch.Tensor]:
    def enc():
        return btadapter_forward(params, frames, cfg, num_frames=T)

    enc()
    enc()
    out, times = _common.repeats(enc, iters, frames.device)
    return frames.shape[0] * iters / sum(times), times, out


def run_btadapter(params: Dict, cfg: ViTConfig, frames: torch.Tensor, iters: int = ITERS
                  ) -> Dict:
    """The unmerged encoder, then each level."""
    fps, times, out = measure(params, cfg, frames, iters)
    result = {"btadapter_static_fps": round(fps, 1),
              "config": "64 frames as 4x16, fully-static int8 trunk+branch",
              "encode_s": {"static": times}, "tome_fps": {}, "outs": {"static": out}}
    for name, kw in levels().items():
        f, times, out = measure(params, dataclasses.replace(cfg, **kw), frames, iters)
        result["tome_fps"][name] = round(f, 1)
        result["encode_s"][name] = times
        result["outs"][name] = out
        print(json.dumps({"level": name, "frames_per_s": round(f, 1)}), flush=True)
    return result


def write(result: Dict, out_dir: str, device) -> str:
    doc = _common.stamp({k: v for k, v in result.items() if k != "outs"}, device, HARNESS)
    return _common.merge_doc(out_dir, DOC, lambda old: (old.clear(), old.update(doc)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="BTAdapter static-int8 encoder throughput, unmerged and at every "
                    "token-merge level (64 frames as 4 x 16)")
    _common.add_device_args(parser, _common.OUT_DIR)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    params, cfg, frames = build_btadapter(device)
    result = run_btadapter(params, cfg, frames)
    write(result, args.out_dir, device)
    print(json.dumps({k: v for k, v in result.items() if k != "outs"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
