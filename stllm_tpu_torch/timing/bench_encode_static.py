"""Static-int8 encode throughput of the plain EVA-ViT-g stack (ViT-g +
Q-Former + llama_proj) on a 64-frame video, under each ``STLLM_FUSED_LN``
setting: 0 (off), proj, fc2, 1 (both). Fused sites run the s8 matmul,
residual, LayerNorm and requantization kernel (#11); every block runs the
static-int8 packed attention (#3). Each setting: two warm encodes, then 8
timed ones, frames/s over their sum; every encode's seconds are kept.

    python -m stllm_tpu_torch.timing.bench_encode_static [--fused-ln 0 proj fc2 1]
        [--iters N] [--cpu]

Without ``--fused-ln`` it runs the setting of the ``STLLM_FUSED_LN``
variable. Prints one JSON line a setting and, last, one of them all;
writes no file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from stllm_tpu_torch.models import vit
from stllm_tpu_torch.models.stllm import STLLMConfig, encode_img, init_stllm
from stllm_tpu_torch.models.vit import EVA_VIT_G, calibrate_vit_scales, quantize_vit_params
from stllm_tpu_torch.timing import _common

HARNESS = "stllm_tpu_torch.timing.bench_encode_static"
FRAMES = 64
ITERS = 8
SETTINGS = {"0": False, "proj": "proj", "fc2": "fc2", "1": "both"}


def make_cfg() -> STLLMConfig:
    return STLLMConfig(vit=dataclasses.replace(EVA_VIT_G, gelu_approx=True))


def build_encode_static(device, seed: int = 0, cfg: STLLMConfig = None
                        ) -> Tuple[Dict, STLLMConfig, Dict[str, torch.Tensor]]:
    """The static-int8 encoder (no LLaMA), calibrated on the first 16 of
    the 64 bf16 frames of ``default_rng(0)``, and its inputs."""
    cfg = cfg or make_cfg()
    params = init_stllm(torch.Generator(device=device).manual_seed(seed), cfg,
                        init_llama_params=False)
    params.pop("llama")
    rng = np.random.default_rng(0)
    s = cfg.vit.image_size
    frames = torch.from_numpy(rng.normal(size=(1, FRAMES, s, s, 3))).to(
        device=device, dtype=torch.bfloat16)
    q_ids = torch.from_numpy(rng.integers(0, cfg.qformer.vocab_size, (1, 16))).to(
        device=device, dtype=torch.int32)
    inputs = {"frames": frames, "q_ids": q_ids,
              "q_mask": torch.ones((1, 16), dtype=torch.int32, device=device)}
    params["vit"] = quantize_vit_params(params["vit"], free_dense=True)
    params["vit"] = calibrate_vit_scales(params["vit"], frames.reshape(FRAMES, s, s, 3)[:16],
                                         cfg.vit)
    return params, cfg, inputs


@torch.no_grad()
def run_encode_static(params: Dict, cfg: STLLMConfig, inputs: Dict[str, torch.Tensor],
                      settings: List[str], iters: int = ITERS) -> Dict[str, Dict]:
    """frames/s a setting, with ``vit.FUSED_LN`` set for its run and
    restored after, every encode's seconds and the last encode."""
    device = inputs["frames"].device
    frames = inputs["frames"].shape[1]

    def encode():
        return encode_img(params, inputs["frames"], cfg, inputs["q_ids"], inputs["q_mask"])

    results = {}
    saved = vit.FUSED_LN
    try:
        for name in settings:
            vit.FUSED_LN = SETTINGS[name]
            encode()
            encode()
            out, times = _common.repeats(encode, iters, device)
            fps = frames * iters / sum(times)
            results[name] = {"fused_ln": vit.FUSED_LN, "frames_per_s": fps, "encode_s": times,
                             "out": out}
            print(f"FUSED_LN={vit.FUSED_LN!r}: static int8 encode {fps:.1f} fr/s", flush=True)
    finally:
        vit.FUSED_LN = saved
    return results


def _env_setting() -> str:
    return next(k for k, v in SETTINGS.items() if v == vit.FUSED_LN)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="static-int8 64-frame encode throughput under each STLLM_FUSED_LN setting")
    parser.add_argument("--fused-ln", nargs="+", choices=list(SETTINGS), default=None,
                        help="settings to run (default: the STLLM_FUSED_LN variable's)")
    parser.add_argument("--iters", type=int, default=ITERS,
                        help=f"timed encodes a setting (default {ITERS})")
    _common.add_device_args(parser, None)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    params, cfg, inputs = build_encode_static(device)
    results = run_encode_static(params, cfg, inputs, args.fused_ln or [_env_setting()],
                                args.iters)
    print(json.dumps({"frames": FRAMES, "iters": args.iters,
                      "device": _common.device_line(device), "harness": HARNESS,
                      "settings": {k: {m: v for m, v in r.items() if m != "out"}
                                   for k, r in results.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
