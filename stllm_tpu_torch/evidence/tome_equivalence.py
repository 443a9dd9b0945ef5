"""Token-merging answer-equivalence envelope on the full-size pipeline.

Quantifies what staged token merging (ops/tome.py) does to MVBench-style
greedy answers. The protocol is int8_equivalence's: N samples of 16-frame
video -> static-int8 encode -> 608-token prompt -> 16-token greedy answer
(reference: stllm/test/mvbench/mv_bench.py:229-283, do_sample=False). The
baseline is the unmerged static-int8 stack; each merge level re-encodes the
same videos and compares answers. Every arm shares one quantized model
(merging is a config change, ``cfg.vit.merge_schedule``), so every flip is
merging's alone.

Frames are synthetic video (smooth per-frame motion over a random base),
not iid noise: merging exploits temporal and spatial redundancy, which iid
noise lacks. Noise is the adversarial arm (``noise_frames``), where merging
should perturb most. The "auto" arm picks a level per video
(``ops.tome.select_merge_level``).

    python -m stllm_tpu_torch.evidence.tome_equivalence [N] [LEVEL_FILTER] [--cpu] [--out-dir DIR]

LEVEL_FILTER keeps the levels whose name contains it. Writes
DIR/TOME_EQUIV.json, merge-preserving: per-level entries update in place
and the trained-model section (int8_equivalence_trained) stays.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from stllm_tpu_torch.evidence import _common
from stllm_tpu_torch.evidence._common import run_samples
from stllm_tpu_torch.models.llama import quantize_llama_params
from stllm_tpu_torch.models.stllm import STLLMConfig, init_stllm, resolve_auto_merge
from stllm_tpu_torch.models.vit import EVA_VIT_G, calibrate_vit_scales, quantize_vit_params
from stllm_tpu_torch.ops.tome import MERGE_LEVELS, scale_level_to_depth, select_merge_level

HARNESS = "stllm_tpu_torch.evidence.tome_equivalence"

# The named schedules of ops/tome.py MERGE_LEVELS, the table every merging
# benchmark runs. Spatial levels: (block_idx, tokens_after) staged in-trunk
# merges. Temporal levels: cross-frame folds (which exploit adjacent-frame
# redundancy, present in the drifting video, absent in the iid-noise arm)
# plus a post-trunk re-merge.
LEVELS = {k: v["merge_schedule"] for k, v in MERGE_LEVELS.items()
          if "temporal_schedule" not in v and k != "off"}
T_LEVELS = {k: (v["temporal_schedule"], v["merge_schedule"])
            for k, v in MERGE_LEVELS.items() if "temporal_schedule" in v}


def make_cfg() -> STLLMConfig:
    return STLLMConfig(vit=dataclasses.replace(EVA_VIT_G, gelu_approx=True))


def make_samples(n: int, cfg: STLLMConfig, video: bool = True) -> List[Dict[str, np.ndarray]]:
    return _common.qa_samples(n, cfg, video)


def level_cfg(cfg: STLLMConfig, name: str) -> STLLMConfig:
    """``cfg`` under the named level, its schedules scaled to the trunk's
    depth (``scale_level_to_depth``: the table's own at EVA-ViT-g's 39)."""
    sched = scale_level_to_depth(name, cfg.vit.depth)
    return dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, **sched))


def build_stack(params: Dict, cfg: STLLMConfig, samples: List[Dict]) -> STLLMConfig:
    """The static-int8 stack of int8_equivalence, in place: every arm's
    baseline and model. Returns its config (the int8 KV cache)."""
    dev = params["llama"]["embed_tokens"].device
    params["vit"] = quantize_vit_params(params["vit"], free_dense=True)
    calib = np.concatenate([s["frames"][0] for s in samples[:4]], axis=0)
    params["vit"] = calibrate_vit_scales(params["vit"], torch.from_numpy(calib).to(dev),
                                         cfg.vit)
    params["llama"] = quantize_llama_params(params["llama"], free_dense=True)
    return dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, kv_int8=True))


def grade(base_out: List[List[int]], base_margins: List[float],
          got_out: List[List[int]]) -> Dict:
    n = len(base_out)
    first = sum(a[0] == b[0] for a, b in zip(base_out, got_out))
    exact = sum(a == b for a, b in zip(base_out, got_out))
    margins = np.asarray(base_margins)
    flips = np.asarray([a[0] != b[0] for a, b in zip(base_out, got_out)])
    med = float(np.median(margins))
    above = margins > med
    return {
        "first_token_match": first / n,
        "exact_16_match": exact / n,
        "max_margin_flipped": (round(float(margins[flips].max()), 4)
                               if flips.any() else 0.0),
        "first_token_match_above_median_margin":
            (float((~flips[above]).mean()) if above.any() else 1.0),
    }


def run(params: Dict, cfg: STLLMConfig, samples: List[Dict], noise: List[Dict],
        only: str = "") -> Dict:
    """The unmerged baseline on ``params`` / ``cfg`` (the static-int8 stack
    in ``main``), then every level whose name contains ``only`` and the
    auto arm, each graded against the baseline on both sample sets."""
    base_out, base_margins = run_samples(params, cfg, samples, "unmerged")
    base_noise, noise_margins = run_samples(params, cfg, noise, "unmerged-noise")
    doc = {
        "metric": "token-merging vs unmerged greedy answer equivalence "
                  "(16-frame MVBench-shaped QA, static-int8 stack, random "
                  "full-size weights)",
        "harness": HARNESS,
        "n": len(samples),
        "baseline_stack": "W8A8 static-scale ViT incl. static-s8 qkv "
                          "attention + W8A8 LLaMA + int8 KV (headline)",
        "median_top2_margin_bf16_arm": round(float(np.median(base_margins)), 4),
        "levels": {},
    }
    for name in (*LEVELS, *T_LEVELS):
        if only and only not in name:
            continue
        cfg_m = level_cfg(cfg, name)
        out, _ = run_samples(params, cfg_m, samples, f"tome-{name}")
        entry = grade(base_out, base_margins, out)
        if name in LEVELS:
            entry["merge_schedule"] = [list(x) for x in cfg_m.vit.merge_schedule]
        else:
            entry["temporal_schedule"] = [list(x) for x in cfg_m.vit.temporal_schedule]
            entry["post_trunk_merge"] = [list(x) for x in cfg_m.vit.merge_schedule]
        nout, _ = run_samples(params, cfg_m, noise, f"tome-{name}-noise")
        entry["noise_frames"] = grade(base_noise, noise_margins, nout)
        doc["levels"][name] = entry
        print(json.dumps({name: entry}), flush=True)

    # the auto arm: the redundancy-adaptive selector picks a level per video.
    # On mixed smooth / noise traffic it should keep the smooth videos' gains
    # and back off to no merging on irredundant input (the noise subset
    # grading about like the unmerged baseline)
    if not only or only in "auto":
        cfg_auto = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, merge_level="auto"))
        chosen = {"smooth": {}, "noise": {}}
        for kind, arm in (("smooth", samples), ("noise", noise)):
            for s in arm:
                lvl = select_merge_level(s["frames"])
                chosen[kind][lvl] = chosen[kind].get(lvl, 0) + 1
        cfg_fn = lambda s: resolve_auto_merge(cfg_auto, s["frames"])
        out, _ = run_samples(params, cfg_fn, samples, "tome-auto")
        entry = grade(base_out, base_margins, out)
        nout, _ = run_samples(params, cfg_fn, noise, "tome-auto-noise")
        entry["noise_frames"] = grade(base_noise, noise_margins, nout)
        entry["levels_chosen"] = chosen
        doc["levels"]["auto"] = entry
        print(json.dumps({"auto": entry}), flush=True)
    return doc


def write(doc: Dict, out_dir: str) -> str:
    """Merge-preserving: the trained-model section is written by its own
    harness; per-level entries update in place."""
    path = os.path.join(out_dir, _common.TOME_EQUIV)
    old = _common.read_doc(path)
    old_levels = old.get("levels", {})
    old_levels.update(doc["levels"])
    old.update(doc)
    old["levels"] = old_levels
    _common.write_doc(path, old)
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="token-merging vs unmerged greedy answer equivalence on the static-int8 "
                    "stack, random full-size weights")
    parser.add_argument("n", nargs="?", type=int, default=60, help="smooth-video samples "
                        "(default 60; the noise arm has max(n // 3, 8))")
    parser.add_argument("only", nargs="?", default="",
                        help="run only the levels whose name contains this")
    _common.add_device_args(parser)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    cfg = make_cfg()
    params = init_stllm(torch.Generator(device=device).manual_seed(0), cfg,
                        init_llama_params=True)
    samples = make_samples(args.n, cfg, video=True)
    noise = make_samples(max(args.n // 3, 8), cfg, video=False)
    cfg_q = build_stack(params, cfg, samples)
    doc = _common.stamp(run(params, cfg_q, samples, noise, args.only), device, HARNESS)
    write(doc, args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
