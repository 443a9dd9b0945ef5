"""Quantization and token-merging equivalence on a TRAINED model.

The random-weight harnesses (int8_equivalence, tome_equivalence) argue from
margins: flips happen only below tiny top-1 / top-2 gaps. This grounds the
claim by training a mid-size model (the full 4096-wide LLaMA and 1408-wide
ViT at reduced depths) to emit fixed QA answers, then running the same
greedy comparison on its peaked margins: the int8 stack, W4A16 with
per-channel and per-group (g=128, g=64) scales, and every ToMe level on
both smooth-video and iid-noise subsets.

Protocol: n synthetic videos (the first half smooth drifting video, the
redundancy temporal merging exploits; the second half iid noise, the
adversarial arm) with fixed 16-token answers; train everything (the ViT
too) with the production train step; quantize to the serving stacks;
compare greedy outputs. The quantized arms grade against the trained bf16
answers; the merge arms against the trained int8 answers (merging rides
the int8 stack, so its flips are merging's alone).

    python -m stllm_tpu_torch.evidence.int8_equivalence_trained [steps] [n] [vit_blocks] [llama_layers] [--cpu] [--out-dir DIR]

Writes the trained sections of DIR/EQUIV_INT8.json (before the merge arms
run) and DIR/TOME_EQUIV.json, and prints one JSON line for each completed
level (harvest_trained_levels reads them from a log).
Reference protocol anchor: stllm/test/mvbench/mv_bench.py:229-283
(greedy), stllm/models/eva_vit.py:416-428 (trunk shape).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from stllm_tpu_torch.data.packing import pack_training_batch
from stllm_tpu_torch.data.synth import synth_video
from stllm_tpu_torch.evidence import _common
from stllm_tpu_torch.models.generation import GenerationConfig, generate
from stllm_tpu_torch.models.llama import (
    LlamaConfig, quantize_llama_params, quantize_llama_params_int4)
from stllm_tpu_torch.models.qformer import QFormerConfig
from stllm_tpu_torch.models.stllm import STLLMConfig, apply_video_input, encode_img, init_stllm
from stllm_tpu_torch.models.vit import ViTConfig, calibrate_vit_scales, quantize_vit_params
from stllm_tpu_torch.ops.layers import gather_rows
from stllm_tpu_torch.ops.tome import MERGE_LEVELS, scale_level_to_depth
from stllm_tpu_torch.train.step import (
    create_train_state, make_probe_optimizer, make_train_step, tree_paths)

HARNESS = "stllm_tpu_torch.evidence.int8_equivalence_trained"
T_FRAMES = 8          # supports the 3 chained folds of t_aggressive
ANSWER_TOKENS = 16
BATCH = 4             # samples a train step
SEQ_LEN = 96
LR = 2e-4
W4_VARIANTS = {"w4a16": None, "w4a16_g128": 128, "w4a16_g64": 64}   # name -> group


def build_cfg(vit_blocks: int, llama_layers: int) -> STLLMConfig:
    """Full widths, reduced depths: the quantization error statistics of the
    full model (the same matmul shapes) at a size that trains in minutes."""
    return STLLMConfig(
        vit=ViTConfig(image_size=224, patch_size=14, width=1408, depth=vit_blocks, heads=16,
                      mlp_hidden=6144, dtype=torch.bfloat16, gelu_approx=True, remat=True),
        qformer=QFormerConfig(num_layers=4, dtype=torch.bfloat16),
        llama=LlamaConfig(vocab_size=32000, hidden=4096, num_layers=llama_layers, heads=32,
                          intermediate=11008, max_positions=512, remat=True),
        use_mask=False,
        video_input="mean",   # 32 video tokens: short sequences
    )


def build_dataset(rng, n: int, cfg: STLLMConfig, device) -> List[Dict]:
    """``n`` fixed (video, question, answer) triples, packed to 96 slots; the
    first half smooth video, the second half iid noise."""
    data = []
    v = cfg.num_video_tokens(T_FRAMES)
    size = cfg.vit.image_size
    for i in range(n):
        if i < n // 2:
            frames = synth_video(rng, T_FRAMES, size).astype(np.float32)
            frames = (frames - 128.0) / 64.0   # roughly unit-scale
            kind = "smooth"
        else:
            frames = rng.normal(size=(1, T_FRAMES, size, size, 3)).astype(np.float32)
            kind = "noise"
        before = [list(rng.integers(10, 30000, 12))]
        after = [list(rng.integers(10, 30000, 8))]
        answer = [list(rng.integers(10, 30000, ANSWER_TOKENS))]
        packed = pack_training_batch(before, after, answer, num_video=v, seq_len=SEQ_LEN,
                                     pad_id=0)
        batch = {k: torch.from_numpy(np.asarray(val)).to(device) for k, val in packed.items()}
        batch["frames"] = torch.from_numpy(frames).to(device=device, dtype=torch.bfloat16)
        batch["qformer_input_ids"] = torch.as_tensor(
            rng.integers(0, 30000, (1, 8)), dtype=torch.int32, device=device)
        batch["qformer_attention_mask"] = torch.ones((1, 8), dtype=torch.int32, device=device)
        data.append({"before": before[0], "after": after[0], "answer": answer[0],
                     "batch": batch, "kind": kind})
    return data


def stack_batches(items: List[Dict]) -> Dict[str, torch.Tensor]:
    """Concatenate single-sample batches along the batch axis."""
    return {k: torch.cat([it["batch"][k] for it in items], dim=0)
            for k in items[0]["batch"]}


def train(params: Dict, cfg: STLLMConfig, data: List[Dict], steps: int, rng) -> List[float]:
    """Every leaf trains (``make_probe_optimizer(lr=2e-4)``), in batches of
    4 over a reshuffled order each epoch; in place on ``params``. Returns
    the losses."""
    n = len(data)
    opt = make_probe_optimizer(params, lr=LR)
    state = create_train_state(params, opt, trainable_fn=lambda path: True)
    step_fn = make_train_step(cfg, opt)
    print("training ...", flush=True)
    t0 = time.perf_counter()
    order = np.arange(n)
    # ceil, so a tail short of a batch is sampled too; at least 1, so n < 4 runs
    spe = max(1, -(-n // BATCH))
    losses = []
    for it in range(steps):
        if it % spe == 0:
            rng.shuffle(order)
        sel = order[(it % spe) * BATCH:][:BATCH]
        state, metrics = step_fn(state, stack_batches([data[i] for i in sel]))
        losses.append(metrics["loss"].detach())
        if (it + 1) % 50 == 0:
            print(f"  step {it + 1}: loss {float(losses[-1]):.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    for _, p in tree_paths(params):
        p.requires_grad_(False)
    return [float(x) for x in losses]


def answer_gen() -> GenerationConfig:
    return GenerationConfig(max_new_tokens=ANSWER_TOKENS, stop_sequences=(), eos_token_id=-1,
                            pad_to_multiple=32)


@torch.no_grad()
def greedy_answer(params: Dict, sample: Dict, cfg: STLLMConfig) -> Tuple[List[int], torch.Tensor]:
    """Encode and assemble the prompt without the answer, then greedy-decode.
    Returns (tokens, prompt embeddings)."""
    b = sample["batch"]
    vid = encode_img(params, b["frames"], cfg, b["qformer_input_ids"],
                     b["qformer_attention_mask"])
    video = apply_video_input(params, vid, cfg)           # (1, V, D)
    emb = params["llama"]["embed_tokens"]
    dev, dtype = emb.device, cfg.llama.dtype
    before = gather_rows(emb, torch.as_tensor([sample["before"]], device=dev)).to(dtype)
    after = gather_rows(emb, torch.as_tensor([sample["after"]], device=dev)).to(dtype)
    embeds = torch.cat([before, video.to(dtype), after], dim=1)
    return generate(params["llama"], embeds, llama_cfg=cfg.llama, gen=answer_gen())[0], embeds


def first_token_margin(llama_params: Dict, embeds: torch.Tensor, cfg: STLLMConfig) -> float:
    return _common.first_token_margin(llama_params, embeds, cfg.llama, 32, ANSWER_TOKENS)


def grade(base: List[List[int]], got: List[List[int]], margins=None) -> Dict:
    n = len(base)
    flips = np.asarray([a[0] != b[0] for a, b in zip(base, got)])
    out = {
        "n": n,
        "first_token_match": sum(a[0] == b[0] for a, b in zip(base, got)) / n,
        "exact_16_match": sum(a == b for a, b in zip(base, got)) / n,
    }
    if margins is not None:
        m = np.asarray(margins)
        out["max_margin_flipped"] = (round(float(m[flips].max()), 4)
                                     if flips.any() else 0.0)
    return out


def model_text(cfg: STLLMConfig) -> str:
    return (f"{cfg.llama.hidden}-width {cfg.llama.num_layers}-layer LLaMA + "
            f"{cfg.vit.width}-width {cfg.vit.depth}-block ViT (full matmul shapes, reduced "
            "depth), trained to emit fixed 16-token answers; half the "
            "videos smooth, half iid noise")


def bf16_arm(params: Dict, cfg: STLLMConfig, data: List[Dict]) -> Tuple[List, List[float]]:
    """The trained answers and their margins (the flip-severity scale)."""
    answers, margins = [], []
    for s in data:
        ans, embeds = greedy_answer(params, s, cfg)
        answers.append(ans)
        margins.append(first_token_margin(params["llama"], embeds, cfg))
    return answers, margins


def quant_arms(params: Dict, cfg: STLLMConfig, data: List[Dict], bf16_answers: List,
               margins: List[float], steps: int, trained_ok: int):
    """The serving-stack conversions and their grades against the trained
    bf16 answers. The dense LLaMA is kept (``free_dense=False``) until all
    four quantized forms are made from it; the ViT converts in place.
    Returns (int8 result, {w4 name: result}, int8 answers, int8 LLaMA tree,
    the static-int8 config)."""
    n = len(data)
    cfg_q = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, kv_int8=True))
    w4 = {name: quantize_llama_params_int4(params["llama"], group=g)
          for name, g in W4_VARIANTS.items()}
    params["vit"] = quantize_vit_params(params["vit"], free_dense=True)
    calib = torch.cat([s["batch"]["frames"][0] for s in data[:2]], 0)
    params["vit"] = calibrate_vit_scales(params["vit"], calib, cfg.vit)
    llama_int8 = quantize_llama_params(params["llama"], free_dense=True)
    params["llama"] = llama_int8

    int8_answers = [greedy_answer(params, s, cfg_q)[0] for s in data]
    result_int8 = grade(bf16_answers, int8_answers, margins)
    result_int8.update({
        "train_steps": steps,
        "bf16_answers_match_train_targets": trained_ok / n,
        "model": model_text(cfg),
        "int8_stack": "W8A8 static-scale ViT incl. static-s8 qkv attention "
                      "+ W8A8 LLaMA + int8 KV cache",
    })
    print(json.dumps({"trained_model": result_int8}), flush=True)

    w4_results = {}
    for name, llama_q in w4.items():
        params["llama"] = llama_q
        answers = [greedy_answer(params, s, cfg_q)[0] for s in data]
        r = grade(bf16_answers, answers, margins)
        r["w4_stack"] = ("W8A8 static-scale ViT + W4A16 "
                         + ("per-channel LLaMA (the W4A16 kernel)" if W4_VARIANTS[name] is None
                            else f"per-group g={W4_VARIANTS[name]} LLaMA (plain torch)")
                         + " + int8 KV cache")
        w4_results[name] = r
        print(json.dumps({name: r}), flush=True)
    params["llama"] = llama_int8
    return result_int8, w4_results, int8_answers, cfg_q


def merge_arms(params: Dict, cfg_q: STLLMConfig, data: List[Dict], int8_answers: List,
               margins: List[float]) -> Dict:
    """Every named ToMe level (scaled to the trunk's depth) on the trained
    int8 stack, graded against its unmerged answers on each subset."""
    smooth_idx = [i for i, s in enumerate(data) if s["kind"] == "smooth"]
    noise_idx = [i for i, s in enumerate(data) if s["kind"] == "noise"]
    levels = {}
    for level in MERGE_LEVELS:
        if level == "off":
            continue
        sched = scale_level_to_depth(level, cfg_q.vit.depth)
        cfg_m = dataclasses.replace(cfg_q, vit=dataclasses.replace(cfg_q.vit, **sched))
        answers = [greedy_answer(params, s, cfg_m)[0] for s in data]
        pick = lambda xs, idx: [xs[i] for i in idx]
        entry = {
            "smooth_video": grade(pick(int8_answers, smooth_idx), pick(answers, smooth_idx),
                                  pick(margins, smooth_idx)),
            "iid_noise": grade(pick(int8_answers, noise_idx), pick(answers, noise_idx),
                               pick(margins, noise_idx)),
            "schedule_at_depth": {k: [list(x) for x in v] for k, v in sched.items()},
            "baseline": "trained int8 answers (merging rides the int8 "
                        "headline stack)",
        }
        levels[level] = entry
        print(json.dumps({level: entry}), flush=True)
    return levels


def run(params: Dict, cfg: STLLMConfig, data: List[Dict], steps: int, rng, out_dir: str,
        device) -> Dict:
    """Train, then every arm. The quantized arms' sections are written into
    ``out_dir`` before the merge arms run (a failure there must not lose
    them), the merge arms' after. Returns {"losses", "bf16_answers",
    "margins", "trained_model", "w4": {...}, "trained_levels"}."""
    n = len(data)
    losses = train(params, cfg, data, steps, rng)
    bf16_answers, margins = bf16_arm(params, cfg, data)
    trained_ok = sum(a == s["answer"] for a, s in zip(bf16_answers, data))
    print(f"bf16 answers matching training targets: {trained_ok}/{n}; "
          f"median margin {float(np.median(margins)):.3f}", flush=True)
    result_int8, w4_results, int8_answers, cfg_q = quant_arms(
        params, cfg, data, bf16_answers, margins, steps, trained_ok)
    write_equiv(result_int8, w4_results, out_dir, device)
    levels = merge_arms(params, cfg_q, data, int8_answers, margins)
    trained_levels = {"model": result_int8["model"], "n_per_subset": n // 2, "levels": levels}
    write_tome(trained_levels, out_dir, device)
    return {"losses": losses, "bf16_answers": bf16_answers, "margins": margins,
            "trained_model": result_int8, "w4": w4_results, "trained_levels": trained_levels}


def write_equiv(result_int8: Dict, w4_results: Dict, out_dir: str, device) -> str:
    path = os.path.join(out_dir, _common.EQUIV_INT8)
    doc = _common.read_doc(path)
    doc["trained_model"] = _common.stamp(dict(result_int8), device, HARNESS)
    for name in W4_VARIANTS:
        doc["trained_model_" + name] = _common.stamp(dict(w4_results[name]), device, HARNESS)
    _common.write_doc(path, doc)
    return path


def write_tome(trained_levels: Dict, out_dir: str, device) -> str:
    path = os.path.join(out_dir, _common.TOME_EQUIV)
    doc = _common.read_doc(path)
    # supersedes the older 8-block n=8 arms: every level, both input regimes
    doc.pop("trained_model_medium", None)
    doc.pop("trained_model_t_medium", None)
    doc["trained_levels"] = _common.stamp(dict(trained_levels), device, HARNESS)
    _common.write_doc(path, doc)
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="int8, W4A16 and token-merging equivalence on a trained full-width, "
                    "reduced-depth proxy")
    parser.add_argument("steps", nargs="?", type=int, default=400,
                        help="training steps (default 400)")
    parser.add_argument("n", nargs="?", type=int, default=32, help="samples (default 32)")
    parser.add_argument("vit_blocks", nargs="?", type=int, default=16,
                        help="ViT blocks (default 16)")
    parser.add_argument("llama_layers", nargs="?", type=int, default=8,
                        help="LLaMA layers (default 8)")
    _common.add_device_args(parser)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    # the first JSON line names the device: harvest_trained_levels reads it
    print(json.dumps({"device": _common.device_line(device), "harness": HARNESS}), flush=True)
    cfg = build_cfg(args.vit_blocks, args.llama_layers)
    rng = np.random.default_rng(3)
    params = init_stllm(torch.Generator(device=device).manual_seed(0), cfg)
    data = build_dataset(rng, args.n, cfg, device)
    run(params, cfg, data, args.steps, rng, args.out_dir, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
