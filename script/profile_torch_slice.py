#!/usr/bin/env python3
"""Where the time goes in one video-QA request, or one training step, of the
PyTorch port.

    python3 script/profile_torch_slice.py [--mode bf16|w4a16|train|encode-static]
                                          [--out profile.json]

Run from the repository root on a CUDA card. Builds the QA config
(config/instructblipbase_stllm_qa.yaml) at full width with random weights:
in bf16 (the default), or as the W4A16 serving stack (``--mode w4a16``:
the int8 KV cache, the ViT converted to int8 and calibrated on one clip,
Vicuna-7B converted to per-channel int4 with q|k|v and gate|up fused and an
int8 lm_head). Three phases: the encode of one 16-frame video (ViT-g +
BTAdapter, Q-Former, llama_proj, splice), the prefill of its 576-token
prompt, and one 16-step greedy decode chunk over 4 slots. Each is warmed
up, then timed (host clock, synchronized; all phases before any profiler
session), then profiled once (torch.profiler, CUDA activity). For each
phase it prints the wall time, the device time summed over kernels, the
device idle share (1 - device / wall), the time in the packed-qkv
attention kernels, in the W4A16 kernel, in library GEMMs and in the rest,
and the top kernels; with --out it also writes them as JSON.

``--mode train`` profiles the training step of the same config as the config
sets it (all of Vicuna-7B trainable, use_mask, mvm_decode, per-layer
recompute; AdamW at 2e-5, micro-batch 1) on one collated batch at each
sequence tier: 768 packed slots (the fused short attention) and 1024 (the
flash forward and its two backward kernels). Per tier it prints the step's
wall time split into forward (student and teacher), backward and optimizer,
then the whole step's device time, idle share, launches, and the time in the
forward attention kernel, the two flash backward kernels, the packed-qkv
kernel, library GEMMs and the rest, and the peak memory.

``--mode encode-static`` times the 64-frame static-int8 encode of
script/bench_encode_static.py (plain EVA-ViT-g, tanh GELU, 16 question ids)
under each STLLM_FUSED_LN setting (off, "proj", "fc2", "both"): frames per
second, device time by kernel (#11 on its own), the idle share and the
launches; then, on 16 frames, how far each fused trunk lands from the
unfused one at depths 1 to 39, beside the unfused trunk's own gaps under
INT8_QKT "0" and under an input moved by one bf16 step.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

GEMM_MARKS = ("gemm", "nvjet", "cutlass", "xmma", "matmul")
ATTN_MARKS = ("packed::packed_kernel", "packed::packed_s8_kernel", "packed_any_kernel")
W4_MARKS = ("weight_stream_kernel", "splitk_reduce_kernel", "w4_prefill_kernel",
            "w4_decode_kernel")
# kernels reported on their own: the training attention (the forward kernel is
# #7 at the short tier, #4 at the long) and #11, the int8 matmul with the
# epilogue-carried LayerNorm (its 16-row, wide-row and cluster kernels)
KERNEL_MARKS = {"attention_fwd_ms": "flash_fwd_kernel", "flash_bwd_dq_ms": "flash_bwd_dq_kernel",
                "flash_bwd_dkv_ms": "flash_bwd_dkv_kernel", "qmm_res_ln_ms": "qmm_res_ln_"}
SETTINGS = (False, "proj", "fc2", "both")     # STLLM_FUSED_LN off, and its three sites


def _device_us(e) -> float:
    return float(getattr(e, "self_device_time_total", 0.0) or 0.0)


def wall_ms(fn, reps: int = 3) -> float:
    """Host wall time of ``fn``, synchronized, mean of ``reps`` runs after a
    warm-up (allocator, cuBLAS heuristics)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def profile_phase(name: str, fn, wall: float) -> dict:
    """Device time by kernel from one profiled run of ``fn``, against its
    unprofiled wall time."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0]
    dev_ms = sum(_device_us(e) for e in kernels) / 1e3
    attn = sum(_device_us(e) for e in kernels if any(m in e.key for m in ATTN_MARKS)) / 1e3
    w4 = sum(_device_us(e) for e in kernels if any(m in e.key for m in W4_MARKS)) / 1e3
    gemm = sum(_device_us(e) for e in kernels
               if any(m in e.key.lower() for m in GEMM_MARKS)
               and not any(m in e.key for m in W4_MARKS)) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:10]
    own = {k: sum(_device_us(e) for e in kernels if m in e.key) / 1e3
           for k, m in KERNEL_MARKS.items()}
    row = {"phase": name, "wall_ms": wall, "device_ms": dev_ms,
           "device_idle_share": max(0.0, 1.0 - dev_ms / wall),
           "kernel_launches": sum(e.count for e in kernels),
           "packed_qkv_ms": attn, "w4a16_ms": w4, "gemm_ms": gemm, **own,
           "other_ms": dev_ms - attn - w4 - gemm - sum(own.values()),
           "top": [{"kernel": e.key[:90], "calls": e.count, "ms": _device_us(e) / 1e3}
                   for e in top]}
    print(json.dumps(row))
    return row


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def _write(path, smi: str, mode: str, rows: list) -> None:
    if path:
        out = Path(path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": smi, "torch": torch.__version__, "mode": mode,
                                   "phases": rows}, indent=1))


def profile_train(out_path) -> int:
    """One training step of the QA config at each sequence tier."""
    from stllm_tpu_torch.common.config import Config
    from stllm_tpu_torch.data.collate import TrainCollator
    from stllm_tpu_torch.models.stllm import stllm_forward
    from stllm_tpu_torch.models.zoo import STLLM, ToyHashTokenizer
    from stllm_tpu_torch.ops import kernels
    from stllm_tpu_torch.train.step import (
        create_train_state, global_norm, make_optimizer, make_train_step)

    kernels.build()
    model_cfg = dict(Config(REPO / "config" / "instructblipbase_stllm_qa.yaml").model_cfg)
    model = STLLM.from_config(model_cfg, seed=0)
    cfg = model.cfg
    opt = make_optimizer(2e-5, weight_decay=0.0)
    state = create_train_state(model.params, opt, model.trainable_fn())
    step = make_train_step(cfg, opt)
    col = TrainCollator(cfg, ToyHashTokenizer(cfg.llama.vocab_size),
                        ToyHashTokenizer(cfg.qformer.vocab_size, reserve=2), seed=8)
    rng = np.random.default_rng(7)
    size = cfg.vit.image_size

    def words(n):
        return " ".join(f"w{int(i)}" for i in rng.integers(0, 5000, n))

    rows = []
    for prompt_words, answer_words in ((40, 100), (200, 250)):
        sample = {"image": rng.integers(0, 256, (16, size, size, 3), dtype=np.uint8),
                  "instruction_input": f"###Human: <Video><ImageHere></Video> "
                                       f"{words(prompt_words)} ###Assistant:",
                  "answer": words(answer_words)}
        batch = {k: torch.as_tensor(v).cuda() for k, v in col([sample]).items()}
        seq = int(batch["token_ids"].shape[1])

        def run_step():
            step(state, batch)

        def split_step():
            """forward, backward and optimizer of one step, each synchronized."""
            marks = []

            def mark():
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

            mark()
            loss = stllm_forward(state.tree, batch, cfg)["loss"]
            mark()
            loss.backward()
            mark()
            grads = {path: p.grad for path, p in state.params.items()}
            for p in state.params.values():
                p.grad = None
            opt.update(grads, state.opt_state, state.params,
                       grad_norm=global_norm(list(grads.values())))
            mark()
            return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]

        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        wall = wall_ms(run_step)
        launches = {k: v // 4 for k, v in kernels.LAUNCHES.items() if v}   # warm-up + 3 runs
        parts = np.mean([split_step() for _ in range(3)], axis=0)
        row = profile_phase(f"train_step_S{seq}", run_step, wall)
        row.update({"seq_len": seq, "forward_ms": float(parts[0]), "backward_ms": float(parts[1]),
                    "optimizer_ms": float(parts[2]), "samples_per_s": 1e3 / wall,
                    "launches_per_step": launches,
                    "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30})
        print(json.dumps({k: v for k, v in row.items() if k != "top"}))
        rows.append(row)
    smi = _smi()
    print(smi)
    _write(out_path, smi, "train", rows)
    return 0


def _mean_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().mean() / b.float().abs().mean())


@torch.no_grad()
def profile_encode_static(out_path) -> int:
    """The 64-frame static-int8 encode of script/bench_encode_static.py
    (plain EVA-ViT-g with tanh GELU, converted to int8 and calibrated on the
    first 16 frames, then ln_vision, the Q-Former with 16 question ids and
    llama_proj) under each STLLM_FUSED_LN setting: frames per second, device
    time by kernel and the idle share. Then how far each fused trunk lands
    from the unfused one on 16 of the frames, by depth, beside two other
    gaps of the unfused trunk: INT8_QKT "0" against "1", and an input moved
    by one bf16 step."""
    import dataclasses

    from stllm_tpu_torch.models import vit as vit_mod
    from stllm_tpu_torch.models.stllm import STLLMConfig, encode_img, init_stllm
    from stllm_tpu_torch.models.vit import (
        EVA_VIT_G, calibrate_vit_scales, quantize_vit_params, vit_forward)
    from stllm_tpu_torch.ops import kernels

    kernels.build()
    frames_n = 64
    cfg = STLLMConfig(vit=dataclasses.replace(EVA_VIT_G, gelu_approx=True))
    params = init_stllm(torch.Generator(device="cuda").manual_seed(0), cfg,
                        init_llama_params=False)
    params.pop("llama")
    rng = np.random.default_rng(0)
    size = cfg.vit.image_size
    frames = torch.from_numpy(rng.standard_normal((1, frames_n, size, size, 3),
                                                  dtype=np.float32)).to("cuda", torch.bfloat16)
    q_ids = torch.from_numpy(rng.integers(0, cfg.qformer.vocab_size, (1, 16))).int().cuda()
    q_mask = torch.ones_like(q_ids)
    params["vit"] = quantize_vit_params(params["vit"], free_dense=True)
    params["vit"] = calibrate_vit_scales(params["vit"], frames[0, :16], cfg.vit)

    def encode():
        return encode_img(params, frames, cfg, q_ids, q_mask)

    walls, launches = {}, {}
    for setting in SETTINGS:
        vit_mod.FUSED_LN = setting
        walls[setting] = wall_ms(encode)
        kernels.reset_launches()
        encode()
        torch.cuda.synchronize()
        launches[setting] = {k: v for k, v in kernels.LAUNCHES.items() if v}
    rows = []
    for setting in SETTINGS:
        vit_mod.FUSED_LN = setting
        row = profile_phase(f"encode_{frames_n}_frames_fused_ln_{setting}", encode, walls[setting])
        row.update({"fused_ln": str(setting), "frames_per_s": frames_n / walls[setting] * 1e3,
                    "launches": launches[setting]})
        print(json.dumps({k: v for k, v in row.items() if k != "top"}))
        rows.append(row)

    clip = frames[0, :16]
    nudged = (clip.float() * (1 + 2.0 ** -8)).bfloat16()
    blocks = params["vit"]["blocks"]

    def trunk(setting, depth, qkt="1", x=clip):
        vit_mod.FUSED_LN, vit_mod.INT8_QKT = setting, qkt
        return vit_forward({**params["vit"], "blocks": blocks[:depth]}, x, cfg.vit)

    gaps = []
    for depth in (1, 2, 3, 4, 8, 16, len(blocks)):
        base = trunk(False, depth)
        gap = {"depth": depth, **{f"fused_{s}": _mean_rel(trunk(s, depth), base)
                                  for s in SETTINGS[1:]},
               "int8_qkt_0": _mean_rel(trunk(False, depth, "0"), base),
               "input_one_bf16_step": _mean_rel(trunk(False, depth, x=nudged), base)}
        print(json.dumps(gap))
        gaps.append(gap)
    vit_mod.FUSED_LN, vit_mod.INT8_QKT = False, "1"
    rows.append({"phase": "trunk_mean_rel_vs_unfused_16_frames", "by_depth": gaps})
    smi = _smi()
    print(smi)
    _write(out_path, smi, "encode-static", rows)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("bf16", "w4a16", "train", "encode-static"),
                    default="bf16",
                    help="the bf16 model, the W4A16 serving stack, the training step, or the "
                         "64-frame static-int8 encode under each STLLM_FUSED_LN setting")
    ap.add_argument("--out", help="also write the phases as JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    if args.mode == "train":
        return profile_train(args.out)
    if args.mode == "encode-static":
        return profile_encode_static(args.out)

    from stllm_tpu_torch.common.config import Config
    from stllm_tpu_torch.models.btadapter import calibrate_btadapter_scales
    from stllm_tpu_torch.models.generation import _decode_chunk_greedy, _pad_prompt, _prefill
    from stllm_tpu_torch.models.llama import init_kv_cache, quantize_llama_params_int4
    from stllm_tpu_torch.models.vit import quantize_vit_params
    from stllm_tpu_torch.models.zoo import STLLM
    from stllm_tpu_torch.ops import kernels
    from stllm_tpu_torch.pipeline_serving import _encode_assemble

    kernels.build()
    model_cfg = dict(Config(REPO / "config" / "instructblipbase_stllm_qa.yaml").model_cfg)
    if args.mode == "w4a16":
        model_cfg["llama"] = {**(model_cfg.get("llama") or {}), "kv_int8": True}
    model = STLLM.from_config(model_cfg, seed=0)
    cfg, params = model.cfg, model.params
    rng = np.random.default_rng(1)
    size = cfg.vit.image_size
    if args.mode == "w4a16":
        params["vit"] = quantize_vit_params(params["vit"], free_dense=True)
        clip = torch.from_numpy(np.random.default_rng(2).integers(
            0, 256, (16, size, size, 3), dtype=np.uint8)).cuda()
        params["vit"] = calibrate_btadapter_scales(params["vit"], clip, cfg.vit, 16)
        params["llama"] = quantize_llama_params_int4(params["llama"], group=None,
                                                     free_dense=True, quant_head=True, fuse=True)
    frames = torch.from_numpy(rng.integers(0, 256, (1, 16, size, size, 3), dtype=np.uint8)).cuda()
    pre = torch.from_numpy(rng.integers(3, cfg.llama.vocab_size, (1, 40))).int().cuda()
    suf = torch.from_numpy(rng.integers(3, cfg.llama.vocab_size, (1, 20))).int().cuda()
    q = torch.from_numpy(rng.integers(0, cfg.qformer.vocab_size, (1, 12))).int().cuda()

    embeds = _encode_assemble(params, frames, pre, suf, q, torch.ones_like(q), cfg)
    emb, mask = _pad_prompt(embeds, torch.ones(embeds.shape[:2], dtype=torch.int32,
                                               device="cuda"), 64)
    cache = init_kv_cache(cfg.llama, 4, 1024, device="cuda")
    cache.length.fill_(emb.shape[1])
    cur = torch.zeros((4,), dtype=torch.int32, device="cuda")
    phases = [
        ("encode_16_frames", lambda: _encode_assemble(
            params, frames, pre, suf, q, torch.ones_like(q), cfg)),
        (f"prefill_{emb.shape[1]}_tokens", lambda: _prefill(
            params["llama"], emb, mask, cfg.llama, emb.shape[1])),
        ("decode_16_steps_4_slots", lambda: _decode_chunk_greedy(
            params["llama"], cur, cache, cfg.llama, 16)),
    ]
    # every wall time before the first profiler session: a session can
    # leave tracing hooks that slow later kernel launches
    walls = [wall_ms(fn) for _, fn in phases]
    rows = [profile_phase(name, fn, w) for (name, fn), w in zip(phases, walls)]
    smi = _smi()
    print(smi)
    _write(args.out, smi, args.mode, rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
