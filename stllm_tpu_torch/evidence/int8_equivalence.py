"""int8-vs-bf16 greedy answer equivalence on the full-size pipeline.

Runs the same N MVBench-shaped QA samples (16-frame video -> encode ->
608-token prompt -> 16-token greedy answer, the reference protocol of
stllm/test/mvbench/mv_bench.py:229-283 with do_sample=False :274-277)
through the bf16 stack and a quantized stack and compares the generated
token ids:

  - first_token_match: the MVBench answer letter is decided by the first
    generated token ("Best option:(" + letter), so this is the proxy for
    check_ans equality (reference: mv_bench.py:285-300);
  - exact_16_match / mean_prefix: stricter whole-answer agreement.

The stack under test (second argument):
  int8  (default) - W8A8 static-scale ViT + W8A8 LLaMA + int8 KV cache;
  w4a16           - W8A8 static-scale ViT + fused W4A16 LLaMA + int8 head
                    + int8 KV cache.

Weights are random (no released checkpoint is in the repository), a hard
setting for argmax equivalence: random logits have far smaller top-1
margins than a trained model's peaked answers. The margin analysis reports
where the flips live.

    python -m stllm_tpu_torch.evidence.int8_equivalence [N] [int8|w4a16] [--cpu] [--out-dir DIR]

Writes DIR/EQUIV_INT8.json, merge-preserving: the int8 result at the
document's top level, the w4a16 result under "w4a16_random_weights".
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
from stllm_tpu_torch.models.llama import quantize_llama_params, quantize_llama_params_int4
from stllm_tpu_torch.models.stllm import STLLMConfig, init_stllm
from stllm_tpu_torch.models.vit import EVA_VIT_G, calibrate_vit_scales, quantize_vit_params

HARNESS = "stllm_tpu_torch.evidence.int8_equivalence"
STACKS = {
    "int8": "W8A8 static-scale ViT + W8A8 LLaMA + int8 KV cache",
    "w4a16": "W8A8 static-scale ViT + fused W4A16 LLaMA + int8 head + int8 KV",
}


def make_cfg() -> STLLMConfig:
    """EVA-ViT-g (no BTAdapter, tanh GELU), the InstructBLIP Q-Former and
    Vicuna-7B, bf16."""
    return STLLMConfig(vit=dataclasses.replace(EVA_VIT_G, gelu_approx=True))


def make_samples(n: int, cfg: STLLMConfig) -> List[Dict[str, np.ndarray]]:
    """iid uint8 frames; host-side, so only one sample at a time is on the
    device beside the model."""
    return _common.qa_samples(n, cfg, video=False)


def convert(params: Dict, cfg: STLLMConfig, samples: List[Dict], stack: str) -> STLLMConfig:
    """Convert ``params`` IN PLACE to the quantized serving stack (the dense
    7B and its quantized copy are never held together). The ViT takes the
    static activation scales, calibrated on the first 4 samples' frames, so
    most samples are out of calibration. Returns the config to serve with
    (the int8 KV cache)."""
    if stack not in STACKS:
        raise ValueError(f"stack {stack!r} not in {sorted(STACKS)}")
    dev = params["llama"]["embed_tokens"].device
    params["vit"] = quantize_vit_params(params["vit"], free_dense=True)
    calib = np.concatenate([s["frames"][0] for s in samples[:4]], axis=0)
    params["vit"] = calibrate_vit_scales(params["vit"], torch.from_numpy(calib).to(dev),
                                         cfg.vit)
    if stack == "w4a16":
        params["llama"] = quantize_llama_params_int4(params["llama"], group=None,
                                                     free_dense=True, quant_head=True, fuse=True)
    else:
        params["llama"] = quantize_llama_params(params["llama"], free_dense=True)
    return dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, kv_int8=True))


def matched_prefix(a: List[int], b: List[int]) -> int:
    m = 0
    for x, y in zip(a, b):
        if x != y:
            break
        m += 1
    return m


def grade(bf16_out: List[List[int]], bf16_margins: List[float], q_out: List[List[int]],
          stack: str) -> Dict:
    """The comparison and its margin analysis: a greedy flip is possible
    only where the bf16 top1 - top2 gap is below the quantization's
    perturbation."""
    n = len(bf16_out)
    first = sum(a[0] == b[0] for a, b in zip(bf16_out, q_out))
    exact = sum(a == b for a, b in zip(bf16_out, q_out))
    prefix_lens = [matched_prefix(a, b) for a, b in zip(bf16_out, q_out)]
    margins = np.asarray(bf16_margins)
    flips = np.asarray([a[0] != b[0] for a, b in zip(bf16_out, q_out)])
    max_flip_margin = float(margins[flips].max()) if flips.any() else 0.0
    med = float(np.median(margins))
    above_med = margins > med
    match_above_med = float((~flips[above_med]).mean()) if above_med.any() else 1.0
    return {
        "metric": f"{stack}-vs-bf16 greedy answer equivalence "
                  "(16-frame MVBench-shaped QA, random full-size weights)",
        "n": n,
        "first_token_match": first / n,
        "exact_16_match": exact / n,
        "mean_matched_prefix": float(np.mean(prefix_lens)),
        "median_top2_margin_bf16": round(med, 4),
        "max_margin_flipped": round(max_flip_margin, 4),
        "first_token_match_above_median_margin": match_above_med,
        "quant_stack": STACKS[stack],
    }


def run(params: Dict, cfg: STLLMConfig, samples: List[Dict], stack: str = "int8") -> Dict:
    """The bf16 arm, the in-place conversion, the quantized arm and the
    grade. ``params`` is the dense tree of ``cfg``; it is converted."""
    bf16_out, bf16_margins = run_samples(params, cfg, samples, "bf16")
    cfg_q = convert(params, cfg, samples, stack)
    q_out, _ = run_samples(params, cfg_q, samples, stack)
    return grade(bf16_out, bf16_margins, q_out, stack)


def write(result: Dict, stack: str, out_dir: str) -> str:
    path = os.path.join(out_dir, _common.EQUIV_INT8)
    doc = _common.read_doc(path)
    if stack == "w4a16":
        doc["w4a16_random_weights"] = result
    else:
        doc.update(result)
    _common.write_doc(path, doc)
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="int8 / W4A16 vs bf16 greedy answer equivalence on random full-size "
                    "weights")
    parser.add_argument("n", nargs="?", type=int, default=100, help="samples (default 100)")
    parser.add_argument("stack", nargs="?", default="int8", choices=sorted(STACKS),
                        help="the quantized stack under test (default int8)")
    _common.add_device_args(parser)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    cfg = make_cfg()
    params = init_stllm(torch.Generator(device=device).manual_seed(0), cfg,
                        init_llama_params=True)
    result = run(params, cfg, make_samples(args.n, cfg), args.stack)
    _common.stamp(result, device, HARNESS)
    print(json.dumps(result), flush=True)
    write(result, args.stack, args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
