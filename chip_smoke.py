#!/usr/bin/env python3
"""Drive the PyTorch port (stllm_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. Phases, each fatal on failure:

1. build  - compile every CUDA kernel of the port from stllm_tpu_torch/csrc/
   (one nvcc per source, all at once) and print the card's name and power
   limit;
2. kernels - each kernel against its plain PyTorch version on the card at the
   shapes the video-QA paths give it, with its time, the plain version's, one
   PyTorch library call's where one computes the same function (a yardstick
   the port never calls) and the bound; for the two int8 GEMMs (#11 at the
   ViT-g proj and fc2 sites, #8 at its fc1 and fc2 shapes) the time of the
   port's own unfused chain that each replaces stands beside a null library
   time; #8 is also timed beside the design its TMA-fed wgmma GEMM replaced
   (script/replaced_kernels/, parent, new, new, parent), with its quant pass
   alone, its route's own floor and torch._int_mm on the same codes beside
   it, prints its registers and blocks per SM, and is held (not timed) at
   widths that are no multiple of 16 (K) or 8 (N) in bf16 and fp32; #12's
   decode form (M = 4, with the 32-layer totals) and wgmma
   prefill form (M = 576 and 640) and #11's cluster form are timed beside
   the design each replaced (the tile loop, the 16-row kernel; both kept in
   the same libraries), in the order parent, new, new, parent; the decode
   form is also held at 1, 3, 8 and 16 rows; #12's timed copies together
   exceed the 50 MB L2 at every shape;
   #1, #2 and #3 are held (not timed) at head_dim 120 and 128 and at
   H*D = 12288 and 12544, and their "any" form at head_dim 13, 20, 36, 136
   and 200 (#1 in bf16 and fp32); #3 is timed beside its design before the ring loop
   (script/replaced_kernels/, built here for that alone) in the order
   parent, new, new, parent, and its row-quant pass alone at the trunk's
   4112 rows of 1408; #9 (LayerNorm -> int8) and #10 (GELU -> int8, erf and
   tanh) run their register form at the trunk's rows (1408 and 6144 wide)
   and a ragged shape in bf16 and at the trunk's rows in fp32 (#9 with fp32
   and with bf16 gamma and beta), and are timed beside their designs before
   the register form (script/replaced_kernels/, parent, new, new, parent)
   and beside their "any" form forced at the same shape, with the codes
   each design puts one step from the plain version's; the "any" form is
   held at widths 13, 1412, 12255, 12285, 12287, 12296 and 16384 in bf16
   and fp32; the register form's divide is held to __fdiv_rn at every code
   boundary (script/row_divide_check.cu, built beside the replaced designs);
   the flash backward pair (#5, #6) is also held to the plain
   backward at the edges of its walked tiles (lengths that are no multiple
   of 64, whole masked tiles, more or fewer keys than queries), prints its
   blocks per SM, and stands beside SDPA's whole backward timed on the
   device alone (queued behind a device-side sleep) and with the host;
   #4-#7 are also held at head_dim 20 (zero-padded to 24 on the tile
   loops) and 176 and 256 (their "any" form), in bf16 and at 176 in fp32,
   the form asserted from the form counters, their times printed as
   context; the probe #15's five variants run #12's decode form at its 16
   rows, timed on w4_copies copies beside the tile loop they ran before
   (parent, new, new, parent), beside #12's decode form on the same codes
   and a dense bf16 matmul, and are held at 1, 4 and 16 rows, at widths
   that are no multiple of 8, and at 17 rows on the tile loop;
3. slice  - the QA config (config/instructblipbase_stllm_qa.yaml: EVA-ViT-g +
   BTAdapter, InstructBLIP Q-Former, Vicuna-7B, bf16, 16 frames, video_input
   all) at full width with random weights from a seed, served by
   VideoQAServer(slots=4, max_len=1024) for 6 requests; every request must
   get tokens and the kernel counters must show the kernels ran (45
   packed-qkv launches per video); a tiny bf16 model must encode the same
   video on the card and on the CPU to within the bf16 tolerance;
4. int8   - the same config with quant_int8 (dynamic W8A8) serves the same
   6 requests (per video: 78 LayerNorm-quant, 39 GELU-quant, 39 quant-epilogue
   attention and 6 bf16 attention launches), calibrate_btadapter_scales runs
   on one 16-frame clip (78, 39, 39 and 39 static-int8 attention launches),
   and the static-int8 model serves them again (42 static-int8 attention
   launches per video, nothing else); every launch of #9 and #10 in the
   serving and calibration runs is on their register form; a tiny bf16 int8
   model, dynamic and static, must encode one video on the card and on the
   CPU alike, and a tiny fp32 dynamic-int8 model must encode and calibrate
   on the card (#9 and #10 on fp32 rows) as on the CPU;
5. w4a16  - the W4A16 serving stack: the same config with llama.kv_int8,
   the ViT converted to int8 and calibrated on one clip (static int8), the
   Q-Former bf16, and Vicuna-7B converted by quantize_llama_params_int4
   (per-channel int4, q|k|v and gate|up fused, int8 lm_head), serves the
   same 6 requests from an int8 KV cache: 42 static-int8 attention launches
   per video and exactly 128 W4A16 launches per LLaMA forward (prefill on
   the wgmma form, decode on the decode form, none on the tile loop); a
   tiny bf16
   W4A16 + int8-KV LLaMA must give the same prefill logits on the card and
   on the CPU;
6. pipeline - the stack of script/bench_pipeline_serving.py under
   STLLM_FUSED_LN="both": a tiny fp32 plain-ViT static model must encode one
   video on the card (5 launches of #11) and on the CPU alike; then the plain
   EVA-ViT-g (no BTAdapter, tanh GELU) converted to int8 and calibrated by
   calibrate_vit_scales on one clip (78 LayerNorm-quant, 39 GELU-quant, 39
   quant-epilogue attention launches), with the W4A16 phase's Q-Former and
   fused int4 Vicuna-7B, serves 6 requests (64 prefix, 32 suffix and 16
   question ids, 16 greedy tokens, no stop; slots 4, chunk 8, max_len 768):
   per video exactly 77 launches of #11 (all on its cluster form) and 39
   static-int8 attentions and
   nothing dynamic, 128 W4A16 launches per LLaMA forward; then one clip's
   trunk under STLLM_FUSED_LN off, "proj", "fc2" and "both" (0, 39, 38 and 77
   launches of #11), each fused trunk no farther from the unfused one than
   1.5 times the unfused trunk moves under a one-bf16-step change of its
   input;
7. train  - the training step. A tiny bf16 model takes four optimizer steps
   on the card and on the CPU from the same weights and batches (losses and
   the first gradient must agree within the stated tolerances, and the loss
   on a fixed batch must fall). Then the QA config at full width and depth,
   as the config sets it (freeze_LLM false: all of Vicuna-7B trains, with the
   BTAdapter branch, llama_proj and the MVM decoder; use_mask, mvm_decode,
   per-layer recompute), goes through Trainer.train on batches from
   TrainCollator, micro-batch 1: three steps at a packed length of 768 (the
   fused short attention) and two at 1024 (the flash forward and its two
   backward kernels), with exact launch counts per step, finite losses, and
   frozen leaves untouched while trainable ones move.

Then it prints a ``{"kernels": [...]}`` line, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``. Without a CUDA card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import gc
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
L2_BYTES = 50 * 2 ** 20         # H100 SXM L2, published
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16, published
INT8_OP_PER_S = 1979e12        # H100 SXM dense int8, published
FP32_FLOP_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores, published
BF16_ATOL = BF16_RTOL = 3e-2   # bf16 attention tolerance of tests/test_ops.py
INT8_ATOL = INT8_RTOL = 3e-2   # dequantized int8 outputs; codes at most 1 step apart
INT8_TINY_REL = 5e-2           # tiny int8 encode, card vs CPU, relative L2
# #9's and #10's rows against their plain versions (tests/test_torch_quant.py's
# tolerance against JAX): codes one step apart in under 1e-3 of them, scales
# 1e-5 relative
ROW_CODES_DIFFER, ROW_SCALE_RTOL = 1e-3, 1e-5
# weight-streaming matmuls (#12-#15), compared in fp32: the products are exact,
# the fp32 sums run in another order and a bf16 output rounds once, so within
# atol = 1e-2 times the plain output's largest magnitude and rtol = 1e-2
WS_ATOL = WS_RTOL = 1e-2
# tiny W4A16 + int8-KV prefill logits, card vs CPU, relative L2: a bf16 linear
# output may round the other way after fp32 sums in another order, and an int8
# KV code then moves by one step
W4_TINY_REL = 5e-2
# fp32-pipe instructions an element of the row kernels' register forms (#9
# at K = 1408, #10 at K = 6144, erf and tanh; bf16 rows), the operations of
# their bound: one issues in each of an SM's 128 fp32 lanes a cycle, half
# the fp32 rate that counts a fused multiply-add as two operations. Counted
# in the SASS of their build by script/row_quant_sass.py, which also says
# whether these numbers still match the built kernels (NVIDIA H100 80GB HBM3)
LN_OPS_PER_ELEM, GELU_OPS_PER_ELEM = 15.27, {False: 28.38, True: 25.38}
FP32_INSTR_PER_S = FP32_FLOP_PER_S / 2
# and of #11's epilogue (scales, bias, residual, mean, variance, normalize,
# affine, quantize) and #8's activation quantization (amax, divide, round)
RES_LN_OPS_PER_ELEM, QUANT_OPS_PER_ELEM = 16, 3
RES_LN_OUT_SCALE = 0.05        # #11's static output scale in the kernels phase
NUM_REQUESTS, FRAMES, PREFIX_LEN, SUFFIX_LEN, Q_LEN, MAX_NEW = 6, 16, 40, 20, 12, 32
ROOT = Path(__file__).resolve().parent
TRUNK = (16, 257, 16, 88)      # the ViT-g trunk and BTAdapter spatial shape
# the training step: LLaMA attention (B, S, H, D) at the two sequence tiers
TRAIN_SHORT, TRAIN_LONG = (1, 768, 32, 128), (1, 1024, 32, 128)
TRAIN_STEPS = {"train-short": 3, "train-long": 2}
# launches per optimizer step at depth 32: the student's forward, its
# per-layer recompute in the backward, and the no-gradient teacher pass each
# launch one forward kernel a layer; only the student has a backward. The
# frozen ViT trunk (39 blocks) and the trainable branch (6 attentions) launch
# the packed kernel once each: nothing upstream of the trunk needs a
# gradient, so it is never recomputed, and the branch's backward recomputes
# through the plain reference.
TRAIN_LAUNCHES = {
    "train-short": {"fused_short_attention": 96, "flash_attention_fwd": 0,
                    "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                    "packed_qkv_attention": 45},
    "train-long": {"fused_short_attention": 0, "flash_attention_fwd": 96,
                   "flash_attention_bwd_dq": 32, "flash_attention_bwd_dkv": 32,
                   "packed_qkv_attention": 45},
}
# tiny bf16 training, card vs CPU: the two run the same bf16 model through
# different kernels (tensor-core sums, bf16 P), so per-step losses agree to
# TRAIN_TINY_LOSS_REL and the first step's gradient to TRAIN_TINY_GRAD_REL in
# relative L2 (the bf16 kernel tolerance); later steps drift as Adam turns
# small gradient differences into full-size updates
TRAIN_TINY_LOSS_REL, TRAIN_TINY_GRAD_REL = 1e-2, 3e-2
LSE_ATOL = 1e-3                # fp32 logsumexp of bf16 scores, summed in another order
# the fp32 instantiations of #1, #2 and #4-#7 against their fp32 plain
# versions: the same fp32 products summed in another order
F32_ATOL, F32_RTOL = 1e-5, 1e-4
# the tiny fp32 model, card (fp32 kernels) vs CPU (plain versions), relative L2
FP32_TINY_REL = 1e-4
TEMPORAL = (256, 16, 16, 88)   # the BTAdapter temporal shape: 16 frames, 16 x 16 patches

# per-video launches of each int8 path (39 trunk blocks, 3 branch layers)
DYNAMIC_PER_VIDEO = {"layer_norm_quant": 78, "gelu_quant": 39,
                     "packed_qkv_attention_quant": 39, "packed_qkv_attention": 6,
                     "packed_qkv_attention_s8": 0, "w4a16_matmul": 0}
CALIBRATION = {"layer_norm_quant": 78, "gelu_quant": 39, "packed_qkv_attention_quant": 39,
               "packed_qkv_attention_s8": 39, "packed_qkv_attention": 0, "w4a16_matmul": 0}
STATIC_PER_VIDEO = {"layer_norm_quant": 0, "gelu_quant": 0, "packed_qkv_attention_quant": 0,
                    "packed_qkv_attention": 0, "packed_qkv_attention_s8": 42}
PROBES = ("w4v3_matmul", "w8p_matmul", "w4_unpack_matmul")   # launched by their checks only
W4A16_LAUNCHES_PER_FORWARD = 4 * 32   # fused qkv, o, fused gate|up, down in 32 layers
W4_ROWS = (4, 576, 640)    # #12's rows: decode (4 slots), the QA and the pipeline prompts
W4_DECODE_HELD = (1, 3, 8, 16)   # other decode row counts the decode form is held at, untimed
# the packed kernels at the widths the reference's feasibility rule admits
# beyond the trunk's: head_dim 120 and 128 (#3), and H*D = 98 x 128 = 12544,
# wider than a row-quant block's shared memory (12256), short and long loops,
# and H*D = 96 x 128 = 12288, just past it
WIDE_PACKED = [(2, 37, 4, 120), (2, 37, 4, 128), (1, 16, 98, 128), (1, 40, 98, 128),
               (1, 16, 96, 128)]
# head_dim the tile loops do not take: the packed kernels' "any" form (H*D 39,
# 40, 108, 272 and 600)
ANY_PACKED = [(2, 37, 3, 13), (1, 40, 2, 20), (2, 19, 3, 36), (1, 33, 2, 136), (1, 16, 3, 200)]
# the designs that #3's ring loop and #9's and #10's register forms replaced,
# built only to be timed beside them, by the kernel's name
REPLACED = {name: ROOT / "script" / "replaced_kernels" / src for name, src in (
    ("packed_qkv_attention_s8", "packed_qkv_attention_s8_rows64.cu"),
    ("layer_norm_quant", "layer_norm_quant_row_block.cu"),
    ("gelu_quant", "gelu_quant_row_block.cu"),
    ("quant_matmul_blockwise", "quant_matmul_rows64.cu"))}
# #8 held (not timed) at widths the reference's tile rule takes whole that
# are no multiple of 16 (K) or 8 (N), at seventeen k-blocks of 128 (K 2176)
# and at row counts that are no multiple of a tile: (B, S, K, N), in bf16
# and fp32
ODD_BLOCKWISE = [(1, 5, 40, 20), (1, 5, 1000, 100), (1, 5, 13, 1536), (1, 5, 2048, 1500),
                 (1, 7, 40, 1535), (3, 37, 2176, 384)]
# #9 and #10 held (not timed) in their "any" form: (B, S, K) at bf16 widths
# that are no multiple of 8 (13, 1412; 12255, the widest row the form stages
# in shared memory, and 12285, 12287 just past it) and rows wider than 12288
# (12296, 16384), in bf16 and fp32 (fp32 at 1412 is whole 16-byte chunks:
# the register form)
ANY_ROWS = [(3, 5, 13), (2, 37, 1412), (2, 3, 12255), (2, 3, 12285), (2, 3, 12287),
            (2, 3, 12296), (2, 3, 16384)]
# the register form's divide held to __fdiv_rn at every code boundary, built
# beside the replaced designs (not part of the port)
DIVIDE_CHECK = ROOT / "script" / "row_divide_check.cu"
ROW_QUANT_ROWS = TRUNK[0] * TRUNK[1]   # #3's row-quant pass at the trunk: 4112 rows of 1408
# Vicuna-7B decoder shapes (K, N, packed rows of K-padding) of the W4A16 stack
W4_SHAPES = {"qkv": (4096, 12288, 0), "o": (4096, 4096, 0), "gateup": (4096, 22016, 0),
             "down": (11008, 4096, 128)}
# the decode-budget probe's matmul skeleton (script/probe_decode_budget.py), K
# padded as it pads it: to a multiple of 1024, else up to the next 512
PROBE_SHAPES = [("q", 4096, 4096), ("k", 4096, 4096), ("v", 4096, 4096), ("o", 4096, 4096),
                ("gate", 4096, 11008), ("up", 4096, 11008), ("down", 11264, 4096)]
UNPACK_SHAPE = (16, 4096, 11008)      # script/probe_w4_unpack.py
# (K, N) no multiple of 8 (or of 128) that the reference's kernels take: the
# probes #13, #14 held there on the decode form; #12 also at K/2 = 100 (with
# the 412 stored padding rows the reference's storage rule gives) and 4, on
# each of its forms
ODD_WS = [(512, 20), (512, 100), (512, 500), (1024, 12)]
# #15 held at these (K, N): the probe's, N no multiple of 8, K/2 odd; at
# these rows: its route's decode form up to 8 and tile loop above, and the
# decode form also at 9 and 16
ODD_UNPACK = [(4096, 11008), (512, 20), (202, 20), (2050, 500)]
UNPACK_HELD = (1, 4, 8, 9, 16, 17)
# #4-#7 at head_dims the tile loops do not take as they are, (B, S, H, D)
# and dtype: 20 zero-padded to 24 on the tile loops, 176 and 256 on the
# "any" form; #7 at S = 768 keys, #4-#6 at 1024, causal, a padded kv_mask
ANY_ATTN = [((1, 1024, 4, 20), torch.bfloat16), ((1, 1024, 4, 176), torch.bfloat16),
            ((1, 1024, 4, 256), torch.bfloat16), ((1, 1024, 2, 176), torch.float32)]
ODD_W4 = [(200, 20, 412), (8, 12, 0), (512, 100, 0), (512, 500, 0), (1024, 12, 0)]
# the pipeline-serving stack (script/bench_pipeline_serving.py): prefix,
# suffix and question ids per request, answer tokens
PIPE_PROMPT, PIPE_ANSWER = (64, 32, 16), 16
# per video under FUSED_LN="both": 39 proj and 38 fc2 sites (the last block's
# fc2 has no LayerNorm after it), 39 static-int8 attentions, nothing dynamic
PIPELINE_PER_VIDEO = {"qmm_res_ln": 77, "packed_qkv_attention_s8": 39, "layer_norm_quant": 0,
                      "gelu_quant": 0, "packed_qkv_attention_quant": 0,
                      "packed_qkv_attention": 0, "quant_matmul_blockwise": 0}
# calibrate_vit_scales runs the dynamic block only
PIPE_CALIBRATION = {"layer_norm_quant": 78, "gelu_quant": 39, "packed_qkv_attention_quant": 39,
                    "packed_qkv_attention_s8": 0, "qmm_res_ln": 0}
FUSED_SITES = {False: 0, "proj": 39, "fc2": 38, "both": 77}
# a fused trunk may land no farther from the unfused one than FUSED_GAP_FACTOR
# times the unfused trunk moves when its input moves by one bf16 step. The
# full-width trunk with random weights moves by 1.8% at one block and 5% at 39
# under such a step (script/profile_torch_slice.py --mode encode-static), so
# tests/test_ops.py's 1e-2 between fused and unfused holds on its tiny trunk
# (tests/test_torch_fused_ln.py), not here; the factor leaves room for the
# spread between clips
FUSED_GAP_FACTOR = 1.5


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


_SIDE = []   # one side stream for every capture: cuBLAS keeps a workspace per stream


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device time of fn() over ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times and timed by CUDA events: the host's
    per-call cost (argument checks, allocation, the launch) stays out, so a
    short kernel is timed and not the Python that launches it."""
    if not _SIDE:
        _SIDE.append(torch.cuda.Stream())
    side = _SIDE[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` calls that the host enqueues
    while the device sleeps (``torch.cuda._sleep``), timed by CUDA events
    from the end of the sleep: the calls then run back to back, so the
    host's time per call stays out even where fn cannot be captured in a
    CUDA graph (an autograd backward). Raises if the host fell behind."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    start.record()
    torch.cuda._sleep(10 ** 6)
    end.record()
    torch.cuda.synchronize()
    ms_per_mcycle = start.elapsed_time(end)
    torch.cuda._sleep(int((2 * wall_ms + 20) / ms_per_mcycle * 10 ** 6))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    behind = start.query()       # the sleep ended before the last call was enqueued
    torch.cuda.synchronize()
    if behind:
        raise RuntimeError("queued_ms: the host fell behind the device's sleep")
    return start.elapsed_time(end) / iters


def _start_nvcc(kernels, source: Path, lib_name: str):
    """Start nvcc on ``source`` (as ops/kernels.py builds a kernel, with the
    port's headers on the include path); returns (the process, its log, the
    library)."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = kernels.BUILD_DIR / f"lib{lib_name}.so"
    log = open(lib.with_suffix(".log"), "w+")
    cmd = kernels.nvcc_command(source, lib, f"-I{kernels.CSRC}")
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log, lib


def _finish_nvcc(source: Path, proc, log) -> str:
    """Wait for _start_nvcc's nvcc; returns its log."""
    rc = proc.wait()
    log.seek(0)
    text = log.read()
    log.close()
    if rc:
        raise RuntimeError(f"{source.name}: nvcc exit {rc}\n{text}")
    return text


def start_replaced_build(kernels, name: str):
    """_start_nvcc on REPLACED[name]."""
    return _start_nvcc(kernels, REPLACED[name], f"replaced_{name}")


def start_divide_check_build(kernels):
    """_start_nvcc on DIVIDE_CHECK."""
    return _start_nvcc(kernels, DIVIDE_CHECK, "row_divide_check")


def finish_divide_check_build(kernels, proc, log, lib):
    """Wait for start_divide_check_build's nvcc; returns ``check(window)``
    (script/row_divide_check.cu): the number of quotients and of codes of
    the register form's divide that differ from __fdiv_rn's within
    ``window`` fp32 values of every code boundary of every scale mantissa."""
    import ctypes

    _finish_nvcc(DIVIDE_CHECK, proc, log)
    fn = ctypes.CDLL(str(lib)).stllm_row_divide_ties
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]

    def check(window: int) -> tuple:
        count = torch.zeros(2, dtype=torch.int64, device="cuda")
        err = fn(window, count.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"row_divide_check: CUDA error {err}")
        return tuple(count.tolist())

    return check


def build_divide_check(kernels):
    """Build DIVIDE_CHECK and load it (finish_divide_check_build)."""
    return finish_divide_check_build(kernels, *start_divide_check_build(kernels))


# the replaced designs' C entry points: #3's is its ring loop's; #9's and #10's
# take bf16 only, without the type flags of today's entry points
_REPLACED_SYMBOLS = {"packed_qkv_attention_s8": "stllm_packed_qkv_attention_s8",
                     "layer_norm_quant": "stllm_layer_norm_quant_bf16",
                     "gelu_quant": "stllm_gelu_quant_bf16",
                     "quant_matmul_blockwise": "stllm_quant_matmul"}


def finish_replaced_build(kernels, name: str, proc, log, lib):
    """Wait for start_replaced_build's nvcc; returns the library's entry
    point wrapped like the kernel's wrapper in ops/kernels.py (uncounted: a
    yardstick)."""
    import ctypes

    text = _finish_nvcc(REPLACED[name], proc, log)
    for line in text.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] replaced {name}: {line.strip()}")
    fn = getattr(ctypes.CDLL(str(lib)), _REPLACED_SYMBOLS[name])
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = {"packed_qkv_attention_s8": kernels._ENTRY["packed_qkv_attention_s8"][1],
                   "layer_norm_quant": [P, P, P, P, P, LL, I, F, P],
                   "gelu_quant": [P, P, P, LL, I, I, P],
                   "quant_matmul_blockwise": [P, I, P, P, P, P, I, I, I, I, P]}[name]
    fn.restype = ctypes.c_int

    def check(err):
        if err:
            raise RuntimeError(f"replaced {name}: CUDA error {err}")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def rows(x):
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        return q, torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)

    def packed_s8(qkv_q, scales, h, d, scale):
        b, s, _ = qkv_q.shape
        out_q = torch.empty((b, s, h * d), dtype=torch.int8, device=qkv_q.device)
        out_s = torch.empty((b, s, 1), dtype=torch.float32, device=qkv_q.device)
        scratch = torch.empty((b, s, h * d), dtype=torch.float32, device=qkv_q.device)
        check(fn(qkv_q.data_ptr(), scales.data_ptr(), scale, scratch.data_ptr(),
                 out_q.data_ptr(), out_s.data_ptr(), b, s, h, d, stream()))
        return out_q, out_s

    def layer_norm(x, gamma, beta, eps):
        q, s = rows(x)
        check(fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), q.data_ptr(), s.data_ptr(),
                 x.numel() // x.shape[-1], x.shape[-1], eps, stream()))
        return q, s

    def gelu(x, approx):
        q, s = rows(x)
        check(fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), x.numel() // x.shape[-1],
                 x.shape[-1], int(approx), stream()))
        return q, s

    def blockwise(x, w_q, w_scale, bk):
        k, n = x.shape[-1], w_q.shape[-1]
        m = x.numel() // k
        out = torch.empty(x.shape[:-1] + (n,), dtype=x.dtype, device=x.device)
        scales = torch.empty((m, k // bk), dtype=torch.float32, device=x.device)
        check(fn(x.data_ptr(), int(x.dtype == torch.float32), w_q.t().contiguous().data_ptr(),
                 w_scale.float().contiguous().data_ptr(), scales.data_ptr(), out.data_ptr(),
                 m, k, n, bk, stream()))
        return out

    return {"packed_qkv_attention_s8": packed_s8, "layer_norm_quant": layer_norm,
            "gelu_quant": gelu, "quant_matmul_blockwise": blockwise}[name]


def phase_build(kernels):
    """Build every kernel, the replaced designs and the divide check (all
    nvcc at once); returns the replaced designs' wrappers by kernel name and
    the divide check (finish_divide_check_build)."""
    t0 = time.perf_counter()
    started = {name: start_replaced_build(kernels, name) for name in REPLACED}
    divide_job = start_divide_check_build(kernels)
    kernels.build()
    replaced = {name: finish_replaced_build(kernels, name, *job) for name, job in started.items()}
    divide_check = finish_divide_check_build(kernels, *divide_job)
    print(f"[build] kernels {sorted(kernels.SOURCES)} built in {time.perf_counter() - t0:.2f} s")
    for name, log in kernels.BUILD_LOG.items():
        lines = [line.strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line]
        if name in ("layer_norm_quant", "gelu_quant"):   # 60-130 instances: a summary
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
            spills = [line for line in lines
                      if "spill" in line and " 0 bytes spill stores" not in line]
            lines = [f"{len(regs)} instances, {min(regs)}-{max(regs)} registers, "
                     f"{len(spills)} with spills: {sorted(set(spills))}"]
        for line in lines:
            print(f"[build] {name}: {line}")
    print(f"[build] card: {smi_line()}")
    return replaced, divide_check


# ---------------------------------------------------------------------------
# kernels phase
# ---------------------------------------------------------------------------

def _bound(nbytes: float, ops_s: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _bf16_err(got, want) -> float:
    err = (got.float() - want.float()).abs()
    ok = bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
    if not ok or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"max abs err {float(err.max())} outside atol=rtol={BF16_ATOL}")
    return float(err.max())


def _f32_err(got, want) -> float:
    if got.dtype != torch.float32 or got.shape != want.shape:
        raise AssertionError(f"fp32 output {got.dtype} {tuple(got.shape)}")
    err = (got - want).abs()
    if not bool((err <= F32_ATOL + F32_RTOL * want.abs()).all()) \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"max abs err {float(err.max())} outside atol={F32_ATOL}, "
                             f"rtol={F32_RTOL}")
    return float(err.max())


def _attn_err(got, want) -> float:
    """An attention output against its plain version: fp32 to the fp32
    tolerance, bf16 to the bf16 one."""
    return (_f32_err if got.dtype == torch.float32 else _bf16_err)(got, want)


def _int8_err(got, want) -> float:
    """Codes at most one step apart, dequantized values within the int8
    tolerance; returns the max abs error of the dequantized outputs."""
    (gq, gs), (wq, ws) = got, want
    if gq.dtype != torch.int8 or gq.shape != wq.shape or gs.shape != ws.shape:
        raise AssertionError(f"int8 output {gq.dtype} {tuple(gq.shape)} {tuple(gs.shape)}")
    steps = int((gq.int() - wq.int()).abs().max())
    g, w = gq.float() * gs, wq.float() * ws
    err = (g - w).abs()
    ok = bool((err <= INT8_ATOL + INT8_RTOL * w.abs()).all()) and bool(torch.isfinite(gs).all())
    if steps > 1 or not ok:
        raise AssertionError(f"codes {steps} steps apart, max abs err {float(err.max())} "
                             f"outside atol=rtol={INT8_ATOL}")
    return float(err.max())


def _int8_step_err(got, want) -> float:
    """As _int8_err where a row's scale may exceed INT8_ATOL (the wide
    rows reach amax 8 and more): codes at most one step apart, scales
    within INT8_RTOL, and a value one code step away within one scale."""
    (gq, gs), (wq, ws) = got, want
    if gq.dtype != torch.int8 or gq.shape != wq.shape or gs.shape != ws.shape:
        raise AssertionError(f"int8 output {gq.dtype} {tuple(gq.shape)} {tuple(gs.shape)}")
    steps = int((gq.int() - wq.int()).abs().max())
    g, w = gq.float() * gs, wq.float() * ws
    err = (g - w).abs()
    ok = bool((err <= torch.clamp(ws, min=INT8_ATOL) + INT8_RTOL * w.abs()).all()) \
        and bool(((gs - ws).abs() <= INT8_RTOL * ws).all())
    if steps > 1 or not ok:
        raise AssertionError(f"codes {steps} steps apart, max abs err {float(err.max())} "
                             f"outside one step, atol={INT8_ATOL}, rtol={INT8_RTOL}")
    return float(err.max())


def _row_err(got, want) -> float:
    """#9's and #10's int8 rows against their plain version, codes and
    scales compared directly: codes at most one step apart in under
    ROW_CODES_DIFFER of the elements (the same fp32 math summed in another
    order may put a value on the other side of a rounding boundary), scales
    within ROW_SCALE_RTOL. Returns the max abs error of the dequantized
    outputs."""
    (gq, gs), (wq, ws) = got, want
    if gq.dtype != torch.int8 or gq.shape != wq.shape or gs.shape != ws.shape:
        raise AssertionError(f"int8 output {gq.dtype} {tuple(gq.shape)} {tuple(gs.shape)}")
    diff = (gq.int() - wq.int()).abs()
    steps, share = int(diff.max()), float((diff > 0).float().mean())
    scale_err = float(((gs - ws).abs() / ws).max())
    if steps > 1 or share >= ROW_CODES_DIFFER or scale_err > ROW_SCALE_RTOL \
            or not bool(torch.isfinite(gs).all()):
        raise AssertionError(f"codes {steps} steps apart in {share:.2e} of them, scales "
                             f"{scale_err:.2e} apart (limits 1, {ROW_CODES_DIFFER}, "
                             f"{ROW_SCALE_RTOL})")
    return float((gq.float() * gs - wq.float() * ws).abs().max())


def _ws_err(got, want) -> float:
    """Weight-streaming outputs in fp32 within WS_ATOL times the plain
    output's largest magnitude plus WS_RTOL relative."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    scale = float(w.abs().max())
    ok = bool((err <= WS_ATOL * scale + WS_RTOL * w.abs()).all())
    if got.dtype != want.dtype or got.shape != want.shape or not ok \
            or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{got.dtype} {tuple(got.shape)}: max abs err {float(err.max())} "
                             f"outside atol={WS_ATOL} x {scale}, rtol={WS_RTOL}")
    return float(err.max())


def _check_kernel(name: str, cases, kernel, plain, err_fn, library=None) -> list:
    """Each case: (label, [input tuples], bytes, ops time in s). The kernel
    is held to its plain version on the first inputs, then timed cycling the
    copies (four or more) so that each launch reads inputs the L2 does not hold:
    ``ms`` by CUDA-graph replay, ``ms_stream`` launched one by one from
    Python (where short kernels measure the host)."""
    rows = []
    for label, bufs, nbytes, ops_s in cases:
        got = kernel(*bufs[0])
        torch.cuda.synchronize()
        max_err = err_fn(got, plain(*bufs[0]))
        it = iter(range(1 << 30))

        def nxt():
            return bufs[next(it) % len(bufs)]

        row = {"shape": label, "max_abs_err": max_err,
               "ms": graph_ms(lambda: kernel(*nxt()), 40),
               "plain_ms": graph_ms(lambda: plain(*nxt()), 8),
               "library_ms": graph_ms(lambda: library(*nxt()), 40) if library else None,
               "ms_stream": cuda_ms(lambda: kernel(*nxt()), 40),
               **_bound(nbytes, ops_s)}
        rows.append(row)
        print(f"[kernels] {name} {row}")
    return rows


def _vs_parent(row: dict, kernel, parent, bufs, err_fn, plain, iters: int = 40,
               label: str = "parent") -> None:
    """Time the design a redesigned kernel replaced (``parent``, its form
    kept in the same library; or another form, named by ``label``) beside
    the kernel on the same input copies, in the order parent, kernel,
    kernel, parent: ``<label>_ms`` and ``ms_again`` are the means of each
    pair. The parent is held to the plain version too."""
    err_fn(parent(*bufs[0]), plain(*bufs[0]))
    it = iter(range(1 << 30))

    def timed(fn):
        return graph_ms(lambda: fn(*bufs[next(it) % len(bufs)]), iters)

    p1, n1, n2, p2 = timed(parent), timed(kernel), timed(kernel), timed(parent)
    row[f"{label}_ms"] = (p1 + p2) / 2
    row["ms_again"] = (n1 + n2) / 2
    what = "parent design" if label == "parent" else f"the {label} form"
    print(f"[kernels]   {row['shape']}: {what} {row[f'{label}_ms']:.4f} ms, this one "
          f"{row['ms_again']:.4f} ms ({label}, this, this, {label})")


def _entry(name, source, replaces, rows, atol, rtol) -> dict:
    head = rows[0]
    return {"name": name, "route": "cuda", "source": f"stllm_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": None,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "shape": head["shape"], "atol": atol, "rtol": rtol, "per_shape": rows}


def _qkv_bufs(gen, b, s, h, d, dtype=torch.bfloat16):
    """LN-normalized activations times 0.02-std weights, as the qkv
    projection makes them; four copies."""
    width = h * d
    out = []
    for _ in range(4):
        x = torch.randn(b, s, width, generator=gen, device="cuda")
        w = torch.randn(width, 3 * width, generator=gen, device="cuda") * 0.02
        out.append((x @ w).to(dtype).contiguous())
    return out


def _packed_case(gen, shape, dtype, out_bytes_per_row_elem: int, extra_out: int = 0):
    """One packed-attention timing case: (label, four input tuples, bytes,
    operations time), the products on the tensor cores in bf16 and on the
    CUDA cores in fp32."""
    b, s, h, d = shape
    size = torch.finfo(dtype).bits // 8
    bufs = [(q, h, d, d ** -0.5) for q in _qkv_bufs(gen, b, s, h, d, dtype)]
    rate = FP32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
    label = [b, s, 3 * h * d] + (["fp32"] if dtype == torch.float32 else [])
    return (label, bufs, b * s * 3 * h * d * size + b * s * h * d * out_bytes_per_row_elem
            + extra_out * b * s, 4 * b * h * s * s * d / rate)


def _static_int8(qkv: torch.Tensor):
    """qkv quantized to static int8 with per-third scales, as the
    calibrated block does."""
    b, s, f = qkv.shape
    thirds = qkv.float().reshape(b, s, 3, f // 3)
    scales = (thirds.abs().amax(dim=(0, 1, 3)) / 127.0).contiguous()
    q = torch.clamp(torch.round(thirds / scales[:, None]), -127, 127).to(torch.int8)
    return q.reshape(b, s, f), scales


def phase_kernels(kernels, replaced, divide_check) -> dict:
    """Every kernel against its plain version at the main-path shapes (the
    ViT trunk and spatial shape, the BTAdapter temporal shape for the bf16
    kernel), a ragged shape, and head_dim 24 and 64; #3, #9 and #10 also
    beside ``replaced``, the designs their redesigns replaced, and #9's and
    #10's divide through ``divide_check``."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    attn_shapes = [TRUNK, (3, 37, 4, 88), (2, 37, 4, 24), (2, 130, 3, 64)]
    out = {}

    # #1 packed attention, with SDPA as the library yardstick: bf16 at the
    # trunk, the temporal and a ragged shape, then the fp32 instantiation
    cases = [_packed_case(gen, shape, torch.bfloat16, 2)
             for shape in (TRUNK, TEMPORAL, (3, 37, 4, 88))]
    cases.append(_packed_case(gen, (2, 257, 16, 88), torch.float32, 4))

    def sdpa(qkv, h, d, scale):
        b, s, _ = qkv.shape
        q, k, v = qkv.view(b, s, 3, h, d).unbind(2)
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2))

    rows = _check_kernel("packed_qkv_attention", cases, kernels.packed_qkv_attention,
                         kernels.packed_qkv_attention_plain, _attn_err, library=sdpa)
    out["packed_qkv_attention"] = _entry(
        "packed_qkv_attention", "packed_qkv_attention.cu", "stllm_tpu/ops/attention.py:658",
        rows, BF16_ATOL, BF16_RTOL)
    blocks = {f"S={s}": kernels.occupancy("packed_qkv_attention", s, 88)
              for s in (TRUNK[1], TEMPORAL[1])}
    out["packed_qkv_attention"]["blocks_per_sm"] = blocks
    temporal = rows[1]
    print(f"[kernels] packed_qkv_attention: blocks per SM {blocks}; temporal shape "
          f"{TEMPORAL}: {temporal['ms']:.4f} ms against SDPA {temporal['library_ms']:.4f} ms")

    # #2 packed attention with the int8 epilogue; #3 on static-int8 qkv.
    # No single PyTorch call computes either function: library_ms is null.
    cases2, cases3 = [], []
    for b, s, h, d in attn_shapes:
        qkvs = _qkv_bufs(gen, b, s, h, d)
        out_bytes = b * s * h * d + b * s * 4
        flops = 4 * b * h * s * s * d
        cases2.append(([b, s, 3 * h * d], [(q, h, d, d ** -0.5) for q in qkvs],
                       b * s * 3 * h * d * 2 + out_bytes, flops / BF16_FLOP_PER_S))
        cases3.append(([b, s, 3 * h * d], [(*_static_int8(q), h, d, d ** -0.5) for q in qkvs],
                       b * s * 3 * h * d + 12 + out_bytes,
                       flops / 2 / INT8_OP_PER_S + flops / 2 / BF16_FLOP_PER_S))
    cases2.append(_packed_case(gen, (2, 257, 16, 88), torch.float32, 1, extra_out=4))
    rows = _check_kernel("packed_qkv_attention_quant", cases2,
                         kernels.packed_qkv_attention_quant,
                         kernels.packed_qkv_attention_quant_plain, _int8_err)
    out["packed_qkv_attention_quant"] = _entry(
        "packed_qkv_attention_quant", "packed_qkv_attention_quant.cu",
        "stllm_tpu/ops/attention.py:678", rows, INT8_ATOL, INT8_RTOL)
    rows = _check_kernel("packed_qkv_attention_s8", cases3, kernels.packed_qkv_attention_s8,
                         kernels.packed_qkv_attention_s8_plain, _int8_err)
    for row, (_, bufs, *_) in list(zip(rows, cases3))[:2]:     # the trunk and ragged shapes
        _vs_parent(row, kernels.packed_qkv_attention_s8, replaced["packed_qkv_attention_s8"],
                   bufs, _int8_err,
                   kernels.packed_qkv_attention_s8_plain)
    out["packed_qkv_attention_s8"] = _entry(
        "packed_qkv_attention_s8", "packed_qkv_attention_s8.cu",
        "stllm_tpu/ops/attention.py:830", rows, INT8_ATOL, INT8_RTOL)
    out["packed_qkv_attention_s8"]["parent_ms"] = rows[0]["parent_ms"]
    out["packed_qkv_attention_s8"]["parent_source"] = str(REPLACED["packed_qkv_attention_s8"].relative_to(ROOT))
    out["packed_qkv_attention_s8"]["row_quant_pass"] = _row_quant_pass(kernels, gen)
    blocks = {f"S={s}": kernels.occupancy("packed_qkv_attention_s8", s, 88)
              for s in (TRUNK[1], TEMPORAL[1])}
    out["packed_qkv_attention_s8"]["blocks_per_sm"] = blocks
    print(f"[kernels] packed_qkv_attention_s8: blocks per SM {blocks}")
    for name, held in _held_packed(kernels, gen).items():
        out[name].update(held)
        out[name]["forms"] = {"tiles": f"stllm_tpu_torch/csrc/{kernels.SOURCES[name]}",
                              "any": "stllm_tpu_torch/csrc/packed_qkv_any.cuh"}

    out.update(_row_kernels(kernels, gen, replaced, divide_check))
    out.update(_weight_stream_kernels(kernels, gen))
    out.update(_int8_gemm_kernels(kernels, gen, replaced["quant_matmul_blockwise"]))
    out.update(_train_attention_kernels(kernels, gen, out["packed_qkv_attention"]))
    return out


def _row_kernels(kernels, gen, replaced, divide_check) -> dict:
    """#9 (LayerNorm -> int8) and #10 (GELU -> int8, erf and tanh) over the
    trunk's rows and a ragged shape in bf16 (the models' rows), and over the
    trunk's rows in fp32 (#9 with fp32 and with bf16 gamma and beta), in the
    register form; the bf16 rows are timed beside the replaced design and
    the "any" form forced at the same shape (parent, new, new, parent; then
    the "any" form), with the codes each design puts one step from the
    plain version's (``codes_differ``); the "any" form is held at ANY_ROWS,
    and the register form's divide at every code boundary."""
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}
    specs = {"layer_norm_quant": [((16, 257), bf16, bf16), ((3, 37), bf16, bf16),
                                  ((16, 257), f32, f32), ((16, 257), f32, bf16)],
             "gelu_quant": [((16, 257), bf16, None), ((3, 37), bf16, None),
                            ((16, 257), f32, None)]}
    k_of = {"layer_norm_quant": 1408, "gelu_quant": 6144}
    for name, plain in (("layer_norm_quant", kernels.layer_norm_quant_plain),
                        ("gelu_quant", kernels.gelu_quant_plain)):
        k, kernel = k_of[name], getattr(kernels, name)
        cases, timed = [], []
        for (b, s), dt, pdt in specs[name]:
            n, size = b * s, torch.finfo(dt).bits // 8
            xs = [_row_input(gen, (b, s, k), dt, pdt) for _ in range(4)]
            label = [b, s, k] + ([] if dt == bf16 else ["fp32"] + (
                [f"{str(pdt)[6:]} params"] if pdt else []))
            nbytes = n * k * (size + 1) + n * 4
            if name == "layer_norm_quant":
                nbytes += 2 * k * (torch.finfo(pdt).bits // 8)
                variants = [(label, xs, LN_OPS_PER_ELEM)]
            else:
                variants = [(label + [f"approx={a}"], [(x[0], a) for x in xs],
                             GELU_OPS_PER_ELEM[a]) for a in (False, True)]
            for lab, bufs, ops in variants:
                cases.append((lab, bufs, nbytes, n * k * ops / FP32_INSTR_PER_S))
                timed.append(dt == bf16)
        rows = _check_kernel(name, cases, kernel, plain, _row_err)
        for row, (_, bufs, *_), is_bf16 in zip(rows, cases, timed):
            if is_bf16:
                _vs_parent(row, kernel, replaced[name], bufs, _row_err, plain)
                _any_form(row, getattr(kernels, "_" + name), bufs, plain)
                want = plain(*bufs[0])
                row["codes_differ"] = {"this": _flips(kernel(*bufs[0]), want),
                                       "parent": _flips(replaced[name](*bufs[0]), want)}
                print(f"[kernels]   {row['shape']}: codes one step from the plain "
                      f"version's {row['codes_differ']}")
        out[name] = _entry(name, f"{name}.cu", {"layer_norm_quant": "stllm_tpu/ops/quant.py:252",
                                                "gelu_quant": "stllm_tpu/ops/quant.py:261"}[name],
                           rows, None, ROW_SCALE_RTOL)
        out[name]["codes_differ_limit"] = ROW_CODES_DIFFER
        out[name]["parent_ms"] = rows[0]["parent_ms"]
        out[name]["parent_source"] = str(REPLACED[name].relative_to(ROOT))
        out[name]["forms"] = {
            "registers": f"stllm_tpu_torch/csrc/{name}.cu (stllm_tpu_torch/csrc/rowwise_quant.cuh)",
            "any": f"stllm_tpu_torch/csrc/{name}.cu"}
        out[name]["occupancy"] = {
            f"K={kk} {dt}": {"blocks_per_sm": kernels.occupancy(name, kk, f, 0),
                             "registers": kernels.occupancy(name, kk, f, 1)}
            for kk in (1408, 6144) for f, dt in ((0, "bf16"), (1, "fp32"))}
        out[name]["any_cases"] = _held_rows(kernels, gen, name)
        print(f"[kernels] {name}: register form {out[name]['occupancy']}")
    # the register form's divide (the row's reciprocal, one fused correction)
    # against __fdiv_rn: every scale mantissa, every code boundary, 16 fp32
    # values either side of it, both signs (script/row_divide_check.cu)
    t0 = time.perf_counter()
    bad = divide_check(16)
    if bad != (0, 0):
        raise AssertionError(f"[kernels] the register form's divide: {bad[0]} quotients and "
                             f"{bad[1]} codes differ from __fdiv_rn's at the code boundaries")
    pairs = (1 << 23) * 128 * 33 * 2
    out["layer_norm_quant"]["divide_check"] = {"pairs": pairs, "quotients_differ": bad[0],
                                               "codes_differ": bad[1]}
    print(f"[kernels] row divide held to __fdiv_rn at every code boundary ({pairs} pairs, "
          f"{time.perf_counter() - t0:.2f} s): {bad}")
    return out


def _flips(got, want) -> dict:
    """#9's or #10's codes one step from the plain version's: how many, and
    how many of those lie outside the dequantized int8 tolerance (atol =
    rtol = INT8_ATOL, the rows' check before the register form)."""
    (gq, gs), (wq, ws) = got, want
    w = wq.float() * ws
    outside = (gq.float() * gs - w).abs() > INT8_ATOL + INT8_RTOL * w.abs()
    return {"codes": int((gq != wq).sum()), "outside_int8_tol": int(outside.sum())}


def _row_input(gen, shape, dtype, params_dtype):
    """x ~ N(0.5, 2) in ``dtype``; for #9 (``params_dtype`` set) gamma
    around 1 and beta around 0, and eps."""
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    if params_dtype is None:
        return (x,)
    k = shape[-1]
    g = (1 + 0.1 * torch.randn(k, generator=gen, device="cuda")).to(params_dtype)
    be = (0.1 * torch.randn(k, generator=gen, device="cuda")).to(params_dtype)
    return x, g, be, 1e-6


def _any_form(row: dict, forced, bufs, plain, iters: int = 40) -> None:
    """The "any" form forced (``forced``: kernels._layer_norm_quant or
    _gelu_quant) at a shape the register form takes: held to the plain
    version and timed on the same copies (``any_form_ms``)."""
    _row_err(forced(*bufs[0], "any"), plain(*bufs[0]))
    it = iter(range(1 << 30))
    row["any_form_ms"] = graph_ms(lambda: forced(*bufs[next(it) % len(bufs)], "any"), iters)
    print(f"[kernels]   {row['shape']}: the \"any\" form forced {row['any_form_ms']:.4f} ms")


def _held_rows(kernels, gen, name: str) -> list:
    """#9 or #10 (erf and tanh) held to the plain version at ANY_ROWS in bf16
    and fp32: each call launches its kernel once, in the form
    row_quant_form names."""
    held = []
    for shape in ANY_ROWS:
        for dt in (torch.bfloat16, torch.float32):
            form = f"{name}/{kernels.row_quant_form(shape[-1], dt)}"
            args = _row_input(gen, shape, dt, dt if name == "layer_norm_quant" else None)
            calls = [args] if name == "layer_norm_quant" else [(args[0], a) for a in (False, True)]
            for call in calls:
                before, before_form = kernels.LAUNCHES[name], kernels.FORM_LAUNCHES[form]
                got = getattr(kernels, name)(*call)
                torch.cuda.synchronize()
                if (kernels.LAUNCHES[name] != before + 1
                        or kernels.FORM_LAUNCHES[form] != before_form + 1):
                    raise AssertionError(f"[kernels] {form} at {shape} did not launch once")
                err = _row_err(got, getattr(kernels, name + "_plain")(*call))
                held.append({"shape": list(shape), "dtype": str(dt), "form": form,
                             "max_abs_err": err, **({"approx": call[1]} if len(call) == 2
                                                    else {})})
    print(f"[kernels] {name} held at {ANY_ROWS} in bf16 and fp32: "
          + ", ".join(f"{h['shape'][-1]} {h['dtype'][6:]} {h['form'].split('/')[1]} "
                      f"{h['max_abs_err']:.3g}" for h in held))
    return held


def _held_packed(kernels, gen) -> dict:
    """#1, #2 and #3 held (not timed) to their plain versions at WIDE_PACKED
    ("wide_cases", the tile loops) and ANY_PACKED ("any_cases", the "any"
    form; #1 in bf16 and fp32): each call launches its kernel once, in the
    form packed_form names."""
    names = ("packed_qkv_attention", "packed_qkv_attention_quant", "packed_qkv_attention_s8")
    held = {n: {"wide_cases": [], "any_cases": []} for n in names}
    for key, shapes in (("wide_cases", WIDE_PACKED), ("any_cases", ANY_PACKED)):
        for b, s, h, d in shapes:
            qkv = _qkv_bufs(gen, b, s, h, d)[0]
            calls = [(n, (qkv, h, d, d ** -0.5)) for n in names[:2]]
            calls.append((names[2], (*_static_int8(qkv), h, d, d ** -0.5)))
            if key == "any_cases":
                calls.append((names[0], (qkv.float(), h, d, d ** -0.5)))
            for name, args in calls:
                err_fn = _attn_err if name == "packed_qkv_attention" else _int8_step_err
                form = f"{name}/{kernels.packed_form(d)}"
                before, before_form = kernels.LAUNCHES[name], kernels.FORM_LAUNCHES[form]
                got = getattr(kernels, name)(*args)
                torch.cuda.synchronize()
                if (kernels.LAUNCHES[name] != before + 1
                        or kernels.FORM_LAUNCHES[form] != before_form + 1):
                    raise AssertionError(f"[kernels] {form} at {(b, s, h, d)} did not launch "
                                         "once")
                err = err_fn(got, getattr(kernels, name + "_plain")(*args))
                held[name][key].append({"shape": [b, s, h, d], "dtype": str(args[0].dtype),
                                        "form": kernels.packed_form(d), "max_abs_err": err})
            print(f"[kernels] packed kernels at (B, S, H, D) = {(b, s, h, d)}, H*D = {h * d}, "
                  f"{kernels.packed_form(d)} form: "
                  + ", ".join(f"{n} {held[n][key][-1]['max_abs_err']:.4g}" for n in names))
    return held


def _row_quant_pass(kernels, gen) -> dict:
    """#3's second launch alone: the row-quant pass on fp32 attention rows at
    the trunk (4112 x 1408), held to rowwise_quant_plain and timed on four
    copies; its bound moves the fp32 rows in and the codes and scales out."""
    k = TRUNK[2] * TRUNK[3]
    ys = [torch.randn(ROW_QUANT_ROWS, k, generator=gen, device="cuda") * 0.05
          for _ in range(4)]
    err = _int8_err(kernels._rowwise_quant_pass(ys[0]), kernels.rowwise_quant_plain(ys[0]))
    it = iter(range(1 << 30))
    row = {"shape": [ROW_QUANT_ROWS, k], "max_abs_err": err,
           "ms": graph_ms(lambda: kernels._rowwise_quant_pass(ys[next(it) % 4]), 40),
           "plain_ms": graph_ms(lambda: kernels.rowwise_quant_plain(ys[next(it) % 4]), 8),
           **_bound(ROW_QUANT_ROWS * (k * 5 + 4), ROW_QUANT_ROWS * k * QUANT_OPS_PER_ELEM
                    / FP32_FLOP_PER_S)}
    print(f"[kernels] packed_qkv_attention_s8 row-quant pass alone {row}")
    return row


def _ws_bound(m: int, k: int, n: int, w_bytes: int, out_bytes: int, scaled: bool = True) -> tuple:
    """Bytes (x, weights, scale, out each moved once) and tensor-core time of
    an (m, k) x (k, n) weight-streaming product."""
    nbytes = m * k * 2 + w_bytes + (n * 4 if scaled else 0) + m * n * out_bytes
    return nbytes, 2 * m * k * n / BF16_FLOP_PER_S


def w4_copies(w_bytes: int) -> int:
    """Input copies that #12's timings cycle at a weight of ``w_bytes``:
    at least four, and together at least twice the L2, so that each launch
    streams its weight from device memory (o's 8.4 MB weight takes 13)."""
    return max(4, -(-2 * L2_BYTES // w_bytes))


def _ws_form_ran(kernels, name: str, form: str, fn):
    """fn(), which must make one launch of kernel ``name`` in ``form`` and
    none of any other form."""
    before = dict(kernels.FORM_LAUNCHES)
    got = fn()
    torch.cuda.synchronize()
    moved = {f: kernels.FORM_LAUNCHES[f] - before[f] for f in before
             if kernels.FORM_LAUNCHES[f] != before[f]}
    if moved != {f"{name}/{form}": 1}:
        raise AssertionError(f"[kernels] {name}: launches by form {moved}, want one {form}")
    return got


def _probe_kernels(kernels, gen, codes, scale) -> dict:
    """#13 and #14 at the decode-budget probe's seven shapes at M = 1, on
    the decode form (asserted from FORM_LAUNCHES), cycling w4_copies input
    copies, with the tile loop they ran before beside each (parent_ms, by
    _vs_parent), #12's decode form on the same codes in the nibble layout
    beside #13 (#12, #13, #13, #12: w4a16_same_codes_ms and ms_beside_w4a16),
    and torch.matmul on a dense bf16 weight of the same shape, also on
    w4_copies copies (context; library_ms stays null). Then the seven shapes
    x 32 layers: the probe's question on this card (does int4 beat int8
    streaming by the bytes, and what does the arithmetic unpack cost). Then
    both held at W4_DECODE_HELD rows at the probe's and ODD_WS's widths, in
    fp32, on every byte value, and on the tile loop at 17 rows."""
    forced = {"w4v3_matmul": kernels._w4v3_matmul, "w8p_matmul": kernels._w8p_matmul}
    plain = {"w4v3_matmul": kernels.w4v3_matmul_plain, "w8p_matmul": kernels.w8p_matmul_plain}
    public = {"w4v3_matmul": kernels.w4v3_matmul, "w8p_matmul": kernels.w8p_matmul}
    rows = {name: [] for name in forced}
    it = iter(range(1 << 30))

    def timed(fn, bufs):
        return graph_ms(lambda: fn(*bufs[next(it) % len(bufs)]), 40)

    def form(name, f):
        return lambda *a: forced[name](*a, f)

    def x_rows(m, k, dtype=torch.bfloat16):
        return torch.randn(m, k, generator=gen, device="cuda").to(dtype)

    def any_bytes(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    w4 = lambda *a: kernels._w4a16_matmul(*a, "decode")  # noqa: E731
    for label, k, n in PROBE_SHAPES:
        b12, b13 = [], []
        for _ in range(w4_copies(k // 2 * n)):
            x, top, bot, sc = x_rows(1, k), codes((k // 2, n)), codes((k // 2, n)), scale(n)
            b13.append((x, kernels.pack_int4_arith(top, bot), sc))
            b12.append((x, kernels.pack_int4_nibbles(top, bot), sc))
        b14 = [(x_rows(1, k), any_bytes(k, n), scale(n) * 7 / 127)
               for _ in range(w4_copies(k * n))]
        dense = [(x_rows(1, k), (torch.randn(k, n, generator=gen, device="cuda") * 0.02
                                 ).bfloat16()) for _ in range(w4_copies(2 * k * n))]
        dense_ms = timed(torch.matmul, dense)
        del dense
        for name, bufs, w_bytes in (("w4v3_matmul", b13, k // 2 * n), ("w8p_matmul", b14, k * n)):
            _ws_form_ran(kernels, name, "decode", lambda: public[name](*bufs[0]))
            row = _check_kernel(name, [([label, 1, k, n], bufs, *_ws_bound(1, k, n, w_bytes, 2))],
                                form(name, "decode"), plain[name], _ws_err)[0]
            row.update(form=kernels.probe_form(1), copies=len(bufs), dense_bf16_matmul_ms=dense_ms)
            _vs_parent(row, form(name, "decode"), form(name, "stream"), bufs, _ws_err, plain[name])
            rows[name].append(row)
        # #12's decode form on the same codes in the nibble layout, #13 beside it
        _ws_err(w4(*b12[0]), kernels.w4v3_matmul(*b13[0]))
        a1, n1, n2, a2 = (timed(w4, b12), timed(form("w4v3_matmul", "decode"), b13),
                          timed(form("w4v3_matmul", "decode"), b13), timed(w4, b12))
        rows["w4v3_matmul"][-1].update(w4a16_same_codes_ms=(a1 + a2) / 2,
                                       ms_beside_w4a16=(n1 + n2) / 2)
        print(f"[kernels]   {label}: #12 decode form on the same codes {(a1 + a2) / 2:.4f} ms, "
              f"#13 {(n1 + n2) / 2:.4f} ms (#12, #13, #13, #12)")
        del b12, b13, b14

    def total(name, key):
        return 32 * sum(r[key] for r in rows[name])

    totals = {"w4a16_matmul decode, same codes": total("w4v3_matmul", "w4a16_same_codes_ms"),
              "w4v3_matmul decode, beside it": total("w4v3_matmul", "ms_beside_w4a16"),
              "w4v3_matmul decode": total("w4v3_matmul", "ms"),
              "w4v3_matmul tile loop": total("w4v3_matmul", "parent_ms"),
              "w8p_matmul decode": total("w8p_matmul", "ms"),
              "w8p_matmul tile loop": total("w8p_matmul", "parent_ms"),
              "int4 bound": total("w4v3_matmul", "bound_ms"),
              "int8 bound": total("w8p_matmul", "bound_ms"),
              "dense bf16 matmul": total("w4v3_matmul", "dense_bf16_matmul_ms")}
    totals["w4v3 / w4a16"] = (totals["w4v3_matmul decode, beside it"]
                              / totals["w4a16_matmul decode, same codes"])
    totals["w8p / w4v3"] = totals["w8p_matmul decode"] / totals["w4v3_matmul decode"]
    print(f"[kernels] decode-budget probe, 7 shapes x 32 layers at M = 1, ms: "
          f"{json.dumps(totals)}")

    held = {}
    for name in forced:
        for m in W4_DECODE_HELD:
            for k, n in sorted({(k, n) for _, k, n in PROBE_SHAPES}) + ODD_WS:
                x, w = x_rows(m, k), any_bytes(k // 2 if name == "w4v3_matmul" else k, n)
                sc = scale(n)
                got = _ws_form_ran(kernels, name, "decode", lambda: public[name](x, w, sc))
                held[f"{name} M={m} K={k} N={n}"] = _ws_err(got, plain[name](x, w, sc))
        for k, n in ODD_WS + [(4096, 4096)]:
            x, w = x_rows(17, k), any_bytes(k // 2 if name == "w4v3_matmul" else k, n)
            sc = scale(n)
            got = _ws_form_ran(kernels, name, "stream", lambda: public[name](x, w, sc))
            held[f"{name} M=17 K={k} N={n} tile loop"] = _ws_err(got, plain[name](x, w, sc))
        x, w, sc = x_rows(3, 4096, torch.float32), any_bytes(2048 if name == "w4v3_matmul"
                                                             else 4096, 4096), scale(4096)
        got = _ws_form_ran(kernels, name, "decode", lambda: public[name](x, w, sc))
        held[f"{name} M=3 fp32"] = _ws_err(got, plain[name](x, w, sc))
    # every byte value, picked out by one-hot rows of x at unit scale: #13's
    # top and bottom codes and #14's codes exactly as the plain versions'
    every = ((torch.arange(256 * 16, device="cuda") % 256) - 128).to(torch.int8).reshape(256, 16)
    eye, one = torch.eye(512, device="cuda"), torch.ones(16, device="cuda")
    for name, rows_x in (("w4v3_matmul", 512), ("w8p_matmul", 256)):
        want = plain[name](eye[:rows_x, :rows_x], every, one)
        for r in range(0, rows_x, 16):
            got = _ws_form_ran(kernels, name, "decode",
                               lambda: public[name](eye[r:r + 16, :rows_x], every, one))
            if not torch.equal(got, want[r:r + 16]):
                raise AssertionError(f"[kernels] {name}: a byte value off at rows {r}")
    regs = {}
    for m in (8, 16):
        regs[f"kNibble M<={m}"] = {"blocks_per_sm": kernels.occupancy("w4a16_matmul", 2, m),
                                   "registers": kernels.occupancy("w4a16_matmul", 3, m)}
        for mode, name in (("kArith", "w4v3_matmul"), ("kInt8", "w8p_matmul")):
            regs[f"{mode} M<={m}"] = {"blocks_per_sm": kernels.occupancy(name, m, 0),
                                      "registers": kernels.occupancy(name, m, 1)}
    print(f"[kernels] probes #13, #14 on the decode form held at M {W4_DECODE_HELD}, at "
          f"{ODD_WS}, in fp32 and at 17 rows on the tile loop: max abs err "
          f"{max(held.values()):.4g}; every byte value exact; decode form by mode {regs}")
    out = {}
    for name, src, line in (("w4v3_matmul", "w4v3_matmul.cu", 58),
                            ("w8p_matmul", "w8p_matmul.cu", 116)):
        out[name] = _entry(name, src, f"script/probe_decode_budget.py:{line}", rows[name],
                           WS_ATOL, WS_RTOL)
        out[name].update(parent_ms=rows[name][0]["parent_ms"], held={k: v for k, v in held.items() if k.startswith(name)},
                         per_probe_32_layers=totals, decode_form_by_mode=regs,
                         forms={"decode": "stllm_tpu_torch/csrc/w4a16_decode.cuh",
                                "stream": "stllm_tpu_torch/csrc/weight_stream_matmul.cuh"})
    return out


def _held_w4_odd(kernels, gen) -> dict:
    """#12 at ODD_WS's widths and K/2 = 100 and 4 (ODD_W4) on each of its
    forms (decode at 4 rows, wgmma at 17, the tile loop at 4), held to the
    plain version, the form asserted from FORM_LAUNCHES."""
    held = {}
    for k, n, pad in ODD_W4:
        for f, m in (("decode", 4), ("wgmma", 17), ("stream", 4)):
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            packed = torch.randint(-128, 128, (k // 2 + pad, n), generator=gen, device="cuda",
                                   dtype=torch.int8)
            packed[k // 2:] = 0
            sc = torch.rand(n, generator=gen, device="cuda") * 0.01 + 0.005
            got = _ws_form_ran(kernels, "w4a16_matmul", f,
                               lambda: kernels._w4a16_matmul(x, packed, sc, f))
            held[f"K={k} N={n} pad={pad} {f}"] = _ws_err(
                got, kernels.w4a16_matmul_plain(x, packed, sc))
    print(f"[kernels] w4a16_matmul held at {ODD_W4} on every form: max abs err "
          f"{max(held.values()):.4g}")
    return held


def _weight_stream_kernels(kernels, gen) -> dict:
    """W4A16 (#12) at the stack's decode (M = 4 slots) and prefill (M = 576,
    the QA prompt; 640, the pipeline prompt) shapes, and the probes #13-#15
    at theirs (#13, #14 by _probe_kernels). No single PyTorch call computes
    these functions on this storage, so library_ms is null; #12's rows add
    the time of torch.matmul on the dense bf16 weight of the same shape, as
    context, and the time of the tile loop that the decode and wgmma forms
    replaced (parent_ms), on w4_copies input copies. The decode form is
    also held at W4_DECODE_HELD rows, and every form at ODD_W4's widths."""
    out = {}

    def codes(shape):
        return torch.randint(-7, 8, shape, generator=gen, device="cuda", dtype=torch.int8)

    def scale(n):
        return ((0.02 * 3 / 7) * (0.5 + torch.rand(n, generator=gen, device="cuda"))).contiguous()

    cases, dense = [], {}
    for m in W4_ROWS:
        for label, (k, n, pad) in W4_SHAPES.items():
            bufs = []
            for _ in range(w4_copies(k // 2 * n)):
                x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
                packed = torch.cat([kernels.pack_int4_nibbles(codes((k // 2, n)), codes((k // 2, n))),
                                    torch.zeros((pad, n), dtype=torch.int8, device="cuda")])
                bufs.append((x, packed, scale(n)))
            w = (torch.randn(k, n, generator=gen, device="cuda") * 0.02).bfloat16()
            dense[(label, m)] = graph_ms(lambda: torch.matmul(bufs[0][0], w), 40)
            del w
            cases.append(([label, m, k, n, pad], bufs, *_ws_bound(m, k, n, k // 2 * n, 2)))
    rows = _check_kernel("w4a16_matmul", cases, kernels.w4a16_matmul,
                         kernels.w4a16_matmul_plain, _ws_err)
    for row, (_, bufs, *_) in zip(rows, cases):
        m = row["shape"][1]
        row["dense_bf16_matmul_ms"] = dense[(row["shape"][0], m)]
        row["form"] = kernels.w4a16_form(m)
        _vs_parent(row, kernels.w4a16_matmul,
                   lambda x, p, s_: kernels._w4a16_matmul(x, p, s_, "stream"), bufs, _ws_err,
                   kernels.w4a16_matmul_plain)
        row["parent_splits"] = kernels.weight_stream_splits(m, row["shape"][3],
                                                            row["shape"][2] // 2)
    out["w4a16_matmul"] = _entry("w4a16_matmul", "w4a16_matmul.cu",
                                 "stllm_tpu/ops/quant.py:639", rows, WS_ATOL, WS_RTOL)
    out["w4a16_matmul"]["forms"] = {
        f: f"stllm_tpu_torch/csrc/{src}" for f, src in (
            ("decode", "w4a16_decode.cuh"), ("wgmma", "w4a16_prefill.cuh"),
            ("stream", "weight_stream_matmul.cuh"))}
    held = {}
    for m in W4_DECODE_HELD:
        for label, (k, n, pad) in W4_SHAPES.items():
            x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
            packed = torch.cat([
                kernels.pack_int4_nibbles(codes((k // 2, n)), codes((k // 2, n))),
                torch.zeros((pad, n), dtype=torch.int8, device="cuda")])
            sc = scale(n)
            if kernels.w4a16_form(m) != "decode":
                raise AssertionError(f"[kernels] w4a16_matmul M={m} is not on the decode form")
            held[f"{label} M={m}"] = _ws_err(kernels.w4a16_matmul(x, packed, sc),
                                            kernels.w4a16_matmul_plain(x, packed, sc))
    out["w4a16_matmul"]["decode_held"] = held
    blocks = {"decode M<=8": kernels.occupancy("w4a16_matmul", 2, 8),
              "decode M<=16": kernels.occupancy("w4a16_matmul", 2, 16),
              "tile loop BM=16": kernels.occupancy("w4a16_matmul", 0, 16)}
    out["w4a16_matmul"]["blocks_per_sm"] = blocks
    print(f"[kernels] w4a16_matmul decode form held at M {W4_DECODE_HELD}: max abs err "
          f"{max(held.values()):.4g}; blocks per SM {blocks}")
    totals = {}
    for m in W4_ROWS:
        sel = [r for r in rows if r["shape"][1] == m]
        totals[m] = {k: 32 * sum(r[k] for r in sel)
                     for k in ("ms", "bound_ms", "plain_ms", "dense_bf16_matmul_ms",
                               "parent_ms") if all(k in r for r in sel)}
        print(f"[kernels] w4a16_matmul M={m}, the four shapes x 32 layers: "
              f"{json.dumps(totals[m])}")
    out["w4a16_matmul"]["per_forward_32_layers"] = totals
    out["w4a16_matmul"]["parent_ms"] = rows[0]["parent_ms"]
    del cases

    out.update(_probe_kernels(kernels, gen, codes, scale))
    out["w4a16_matmul"]["odd_widths_held"] = _held_w4_odd(kernels, gen)

    out["w4_unpack_matmul"] = _unpack_kernels(kernels, gen, codes)
    return out


def _unpack_kernels(kernels, gen, codes) -> dict:
    """#15's five variants, each on its layout, cycling w4_copies input
    copies. At the probe's shape (16 rows) on the form ``unpack_form``
    routes them to (the tile loop; asserted from FORM_LAUNCHES), the decode
    form timed beside it (``decode_ms``, by _vs_parent); at 8 rows (one n8
    tile of x rows) on the decode form, the tile loop it replaced there
    beside it (``parent_ms``). #12's decode form on the same codes in the
    nibble layout at unit scale, at 16 rows, timed before and after them,
    and torch.matmul on a dense bf16 weight of the same shape (context;
    library_ms stays null). Every variant gives the same product. Then each
    held at ODD_UNPACK's widths at UNPACK_HELD rows on the routed form, and
    on the decode form up to 16 rows."""
    m, k, n = UNPACK_SHAPE
    few = kernels.UNPACK_DECODE_ROWS
    copies = w4_copies(k // 2 * n)
    x_of = [(torch.randn(m, k, generator=gen, device="cuda") * 0.1).bfloat16()
            for _ in range(copies)]
    tops = [codes((k // 2, n)) for _ in range(copies)]
    bots = [codes((k // 2, n)) for _ in range(copies)]

    def form(f):
        return lambda x, p, v: kernels._w4_unpack_matmul(x, p, v, f)

    it = iter(range(1 << 30))

    def timed(fn, bufs):
        return graph_ms(lambda: fn(*bufs[next(it) % len(bufs)]), 40)

    dense = [(torch.randn(m, k, generator=gen, device="cuda").bfloat16(),
              (torch.randn(k, n, generator=gen, device="cuda") * 0.02).bfloat16())
             for _ in range(w4_copies(2 * k * n))]
    dense_ms = timed(torch.matmul, dense)
    del dense
    one = torch.ones(n, device="cuda")
    b12 = [(x, kernels.pack_int4_nibbles(t, b), one) for x, t, b in zip(x_of, tops, bots)]
    w4 = lambda *a: kernels._w4a16_matmul(*a, "decode")  # noqa: E731
    w4_first = timed(w4, b12)
    rows, rows_few, products = [], [], []
    for variant in kernels.W4_UNPACK_VARIANTS:
        bufs = [(x, kernels.pack_int4_variant(variant, t, b), variant)
                for x, t, b in zip(x_of, tops, bots)]
        code = kernels.W4_UNPACK_VARIANTS.index(variant)
        for mm, out in ((m, rows), (few, rows_few)):
            rb = [(x[:mm], p, v) for x, p, v in bufs]
            routed = kernels.unpack_form(mm)
            other = "stream" if routed == "decode" else "decode"
            got = _ws_form_ran(kernels, "w4_unpack_matmul", routed,
                               lambda: kernels.w4_unpack_matmul(*rb[0]))
            if mm == m:
                products.append(got)
            row = _check_kernel("w4_unpack_matmul",
                                [([variant, mm, k, n], rb,
                                  *_ws_bound(mm, k, n, k // 2 * n, 4, scaled=False))],
                                form(routed), kernels.w4_unpack_matmul_plain, _ws_err)[0]
            row.update(form=routed, copies=copies, dense_bf16_matmul_ms=dense_ms,
                       decode_blocks_per_sm=kernels.occupancy("w4_unpack_matmul", code, mm, 0),
                       decode_registers=kernels.occupancy("w4_unpack_matmul", code, mm, 1))
            _vs_parent(row, form(routed), form(other), rb, _ws_err,
                       kernels.w4_unpack_matmul_plain,
                       label="parent" if routed == "decode" else "decode")
            out.append(row)
        del bufs
    w4_last = timed(w4, b12)
    del b12
    for prod in products[1:]:
        _ws_err(prod, products[0])       # every variant gives the same product
    same_codes = (w4_first + w4_last) / 2
    for row in rows:
        row["w4a16_decode_same_codes_ms"] = same_codes
    times = {r["shape"][0]: {f"{m} rows": {"tile loop (routed)": r["ms"],
                                           "decode": r["decode_ms"]},
                             f"{few} rows": {"decode (routed)": f["ms"],
                                             "tile loop": f["parent_ms"]}}
             for r, f in zip(rows, rows_few)}
    print(f"[kernels] w4_unpack_matmul at {list(UNPACK_SHAPE)} and at {few} rows on {copies} "
          f"copies, ms: {json.dumps(times)}"
          f"; #12's decode form on the same codes at {m} rows {same_codes:.4f} ({w4_first:.4f} "
          f"before, {w4_last:.4f} after); dense bf16 matmul {dense_ms:.4f}; decode form "
          f"registers and blocks per SM at {m} / {few} rows "
          f"{json.dumps({r['shape'][0]: [r['decode_registers'], r['decode_blocks_per_sm'], f['decode_registers'], f['decode_blocks_per_sm']] for r, f in zip(rows, rows_few)})}")
    held = {}
    for kk, nn in ODD_UNPACK:
        for mm in UNPACK_HELD:
            x = (torch.randn(mm, kk, generator=gen, device="cuda") * 0.1).bfloat16()
            top, bot = codes((kk // 2, nn)), codes((kk // 2, nn))
            first = None
            for variant in kernels.W4_UNPACK_VARIANTS:
                packed = kernels.pack_int4_variant(variant, top, bot)
                routed = kernels.unpack_form(mm)
                got = _ws_form_ran(kernels, "w4_unpack_matmul", routed,
                                   lambda: kernels.w4_unpack_matmul(x, packed, variant))
                plain = kernels.w4_unpack_matmul_plain(x, packed, variant)
                held[f"{variant} M={mm} K={kk} N={nn} {routed}"] = _ws_err(got, plain)
                if routed != "decode" and mm <= kernels.W4_DECODE_ROWS:
                    dec = form("decode")(x, packed, variant)
                    held[f"{variant} M={mm} K={kk} N={nn} decode"] = _ws_err(dec, plain)
                    _ws_err(dec, got)
                if first is None:
                    first = got
                else:
                    _ws_err(got, first)
    print(f"[kernels] w4_unpack_matmul held at {ODD_UNPACK} x M {list(UNPACK_HELD)} (routed: "
          f"decode up to {few}, the tile loop above; the decode form also up to "
          f"{kernels.W4_DECODE_ROWS}), every variant alike: max abs err {max(held.values()):.4g}")
    entry = _entry("w4_unpack_matmul", "w4_unpack_matmul.cu", "script/probe_w4_unpack.py:93",
                   rows + rows_few, WS_ATOL, WS_RTOL)
    entry.update(form=rows[0]["form"], decode_ms=rows[0]["decode_ms"], held=held,
                 forms={"decode": "stllm_tpu_torch/csrc/w4a16_decode.cuh",
                        "stream": "stllm_tpu_torch/csrc/weight_stream_matmul.cuh"})
    return entry


def _res_ln_err(got, want) -> float:
    """#11: x_new to the bf16 tolerance, codes at most one step apart;
    returns the larger of x_new's max abs error and the code steps times the
    output scale (the largest dequantized difference)."""
    (gx, gq), (wx, wq) = got, want
    if gq.dtype != torch.int8 or gq.shape != wq.shape or gx.dtype != wx.dtype:
        raise AssertionError(f"#11 outputs {gx.dtype} {gq.dtype} {tuple(gq.shape)}")
    steps = int((gq.int() - wq.int()).abs().max())
    if steps > 1:
        raise AssertionError(f"#11 codes {steps} steps apart")
    return max(_bf16_err(gx, wx), steps * RES_LN_OUT_SCALE)


def _int8_gemm_kernels(kernels, gen, replaced_blockwise) -> dict:
    """#11 at the ViT-g's two fused sites (proj with the attention's per-row
    scales, fc2 with the calibrated scalar) and #8 at the fc1 shape (one
    k-block) and the fc2 shape (three). No single PyTorch call computes
    either function, so library_ms is null; beside it stands the time of the
    port's own unfused chain that the kernel replaces (#11: quant_matmul_pre,
    the residual add and layer_norm_quant_static; #8: the per-row dynamic
    quant_matmul). #8 is also timed beside ``replaced_blockwise``, the
    design its TMA-fed wgmma GEMM replaced (parent, new, new, parent), with
    its quant pass alone and torch._int_mm on the same codes and weight as
    diagnostics, and held (not timed) at ODD_BLOCKWISE in bf16 and fp32."""
    from stllm_tpu_torch.ops import quant

    out = {}
    m = 16 * 257

    def vec(n, scale, shift=0.0):
        return (torch.randn(n, generator=gen, device="cuda") * scale + shift).contiguous()

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    def chain(hq, hs, w, ws, b, x, g, be, os_, eps):
        x_new = x + quant.quant_matmul_pre(hq, hs, {"w_q": w, "w_scale": ws, "b": b}, x.dtype)
        return x_new, quant.layer_norm_quant_static({"scale": g, "bias": be}, x_new, os_, eps)

    # the ViT-g sites, then the rows the dispatch rule passes beyond one pass
    # (N > 1536, staged in chunks) and a K that is not a multiple of 16; the
    # unfused chain is timed at the two sites
    cases, chains = [], {}
    for label, b, s, k, n, per_row in (("proj", 16, 257, 1408, 1408, True),
                                       ("fc2", 16, 257, 6144, 1408, False),
                                       ("wide", 16, 257, 1408, 2048, True),
                                       ("wide", 2, 257, 1408, 3968, False),
                                       ("wide", 2, 16, 1408, 8192, True),
                                       ("ragged-k", 3, 37, 1000, 1408, True)):
        rows_ = b * s
        bufs = []
        for _ in range(4):
            hs = (torch.rand(b, s, 1, generator=gen, device="cuda") * 0.01 + 1e-3
                  if per_row else torch.tensor(0.004, device="cuda"))
            w = codes(n, k).t()                          # (K, N) column-major
            bufs.append((codes(b, s, k), hs, w, vec(n, 0.0005, 0.001) * (384 / k) ** 0.5,
                         vec(n, 0.02), torch.randn(b, s, n, generator=gen,
                                                   device="cuda").bfloat16(),
                         vec(n, 0.1, 1.0), vec(n, 0.1),
                         torch.tensor(RES_LN_OUT_SCALE, device="cuda"), 1e-6))
        nbytes = (rows_ * k + (rows_ * 4 if per_row else 4) + k * n + 4 * n * 4 + 4
                  + rows_ * n * (2 + 2 + 1))
        cases.append(([label, b, s, k, n, "per-row hs" if per_row else "scalar hs"], bufs,
                      nbytes, 2 * rows_ * k * n / INT8_OP_PER_S
                      + rows_ * n * RES_LN_OPS_PER_ELEM / FP32_FLOP_PER_S))
        if label in ("proj", "fc2"):
            chains[label] = graph_ms(lambda: chain(*bufs[0]), 20)
    rows = _check_kernel("qmm_res_ln", cases, kernels.qmm_res_ln, kernels.qmm_res_ln_plain,
                         _res_ln_err)
    for row, (_, bufs, *_) in zip(rows, cases):
        row["unfused_chain_ms"] = chains.get(row["shape"][0])
        _, b, s, k, n, _ = row["shape"]
        row["form"] = kernels.qmm_res_ln_form(b * s, n, torch.bfloat16)
        if row["form"] == "cluster":
            _vs_parent(row, kernels.qmm_res_ln,
                       lambda *a: kernels._qmm_res_ln(*a, "rows"), bufs, _res_ln_err,
                       kernels.qmm_res_ln_plain, iters=20)
    out["qmm_res_ln"] = _entry("qmm_res_ln", "qmm_res_ln.cu", "stllm_tpu/ops/quant.py:423",
                               rows, BF16_ATOL, BF16_RTOL)
    out["qmm_res_ln"]["unfused_chain_ms"] = rows[0]["unfused_chain_ms"]
    out["qmm_res_ln"]["parent_ms"] = rows[0].get("parent_ms")
    del cases

    cases, chains = [], {}
    for label, k, n in (("fc1", 1408, 6144), ("fc2", 6144, 1408)):
        bk = quant._pick_tile(k, 2048)
        bufs = [(torch.randn(16, 257, k, generator=gen, device="cuda").bfloat16(),
                 codes(n, k).t(), torch.rand(n, generator=gen, device="cuda") * 0.002, bk)
                for _ in range(4)]
        cases.append(([label, 16, 257, k, n, f"k-blocks={k // bk}"], bufs,
                      m * k * 2 + k * n + n * 4 + m * n * 2,
                      2 * m * k * n / INT8_OP_PER_S + m * k * QUANT_OPS_PER_ELEM / FP32_FLOP_PER_S))
        chains[label] = graph_ms(lambda: quant.quant_matmul(*bufs[0][:3]), 20)
    rows = _check_kernel("quant_matmul_blockwise", cases, kernels.quant_matmul_blockwise,
                         kernels.quant_matmul_blockwise_plain, _ws_err)
    for row, (_, bufs, *_) in zip(rows, cases):
        row["unfused_chain_ms"] = chains[row["shape"][0]]
        _vs_parent(row, kernels.quant_matmul_blockwise, replaced_blockwise, bufs, _ws_err,
                   kernels.quant_matmul_blockwise_plain, iters=20)
        row.update(_blockwise_split(kernels, row["shape"][0], bufs))
    out["quant_matmul_blockwise"] = _entry(
        "quant_matmul_blockwise", "quant_matmul.cu", "stllm_tpu/ops/quant.py:145", rows,
        WS_ATOL, WS_RTOL)
    entry = out["quant_matmul_blockwise"]
    entry["unfused_chain_ms"] = rows[0]["unfused_chain_ms"]
    entry["parent_ms"] = rows[0]["parent_ms"]
    entry["parent_source"] = str(REPLACED["quant_matmul_blockwise"].relative_to(ROOT))
    entry["odd_widths_max_abs_err"] = _held_blockwise(kernels, gen)
    entry["occupancy"] = {
        label: {part: {what: kernels.occupancy("quant_matmul_blockwise", m, k, n, bk, 0, code)
                       for what, code in codes_}
                for part, codes_ in (("gemm", (("blocks_per_sm", 0), ("registers", 1),
                                               ("tile_columns", 2))),
                                     ("quant_pass", (("blocks_per_sm", 3), ("registers", 4))))}
        for label, k, n, bk in (("fc1", 1408, 6144, 1408), ("fc2", 6144, 1408, 2048))}
    print(f"[kernels] quant_matmul_blockwise: {entry['occupancy']}")
    for name, chain in (("qmm_res_ln", "quant_matmul_pre + residual add + "
                                       "layer_norm_quant_static"),
                        ("quant_matmul_blockwise", "quant_matmul (per-row dynamic W8A8)")):
        out[name]["unfused_chain_is"] = chain
    return out


def _blockwise_split(kernels, label, bufs) -> dict:
    """#8's diagnostics on the timed copies: its quant pass alone and
    torch._int_mm on the quant pass's codes and the same weight (the s8
    product alone, s32 out; a yardstick, not used by the port). Prints the
    route's own floor, worked out from the byte and operation counts (the
    quant pass's bytes, then the larger of the GEMM's operations and its
    bytes: the codes read again, the weight, the output)."""
    it = iter(range(1 << 30))

    def nxt():
        return bufs[next(it) % len(bufs)]

    x, w, _, bk = bufs[0]
    m, k, n = x.numel() // x.shape[-1], x.shape[-1], w.shape[-1]
    kp = -(-k // 16) * 16
    quant_bytes = m * k * x.element_size() + m * kp + m * (k // bk) * 4
    gemm_bytes = m * kp + n * kp + n * 4 + m * n * x.element_size()
    floor_ms = (quant_bytes / HBM_BYTES_PER_S
                + max(2 * m * kp * n / INT8_OP_PER_S, gemm_bytes / HBM_BYTES_PER_S)) * 1e3
    print(f"[kernels] quant_matmul_blockwise {label}: the two-launch route's floor "
          f"{floor_ms} ms")
    codes = [kernels._blockwise_quant_pass(b[0], b[3])[0] for b in bufs]
    cit = iter(range(1 << 30))
    return {"quant_pass_ms": graph_ms(lambda: kernels._blockwise_quant_pass(nxt()[0], bk), 20),
            "int_mm_ms": graph_ms(lambda: torch._int_mm(codes[next(cit) % len(codes)],
                                                        bufs[0][1]), 20)}


def _held_blockwise(kernels, gen) -> dict:
    """#8 against its plain version at ODD_BLOCKWISE, bf16 and fp32, the
    weight column-major and (bf16) row-major: max abs error by shape."""
    from stllm_tpu_torch.ops import quant

    out = {}
    for b, s, k, n in ODD_BLOCKWISE:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(b, s, k, generator=gen, device="cuda").to(dtype)
            w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
            if dtype == torch.float32:
                w = w.t().contiguous().t()
            ws = torch.rand(n, generator=gen, device="cuda") * 0.002
            bk = quant._pick_tile(k, 2048)
            got = kernels.quant_matmul_blockwise(x, w, ws, bk)
            label = f"{b}x{s}-k{k}-n{n}-{str(dtype).split('.')[-1]}"
            out[label] = _ws_err(got, kernels.quant_matmul_blockwise_plain(x, w, ws, bk))
    print(f"[kernels] quant_matmul_blockwise held at odd widths: {out}")
    return out


def _attn_case(gen, shape, causal: bool, masked: bool, dtype=torch.bfloat16):
    """Four copies of (q, k, v, kv_mask, causal, scale) at (B, S, H, D), the
    last batch row right-padded by a fifth when ``masked``, and the visible
    keys of each copy as the boolean mask SDPA takes."""
    b, s, h, d = shape
    bufs, sdpa_masks = [], {}
    for _ in range(4):
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        kv_mask = None
        if masked:
            kv_mask = torch.ones(b, s, dtype=torch.int32, device="cuda")
            kv_mask[-1, s - s // 5:] = 0
        bufs.append((q, k, v, kv_mask, causal, d ** -0.5))
        vis = None
        if masked:
            vis = (kv_mask > 0)[:, None, None, :].expand(b, 1, s, s)
            if causal:
                vis = vis & torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
        sdpa_masks[q.data_ptr()] = vis.contiguous() if vis is not None else None
    return bufs, sdpa_masks


def _attn_bound(shape, causal: bool, masked: bool, tensors: int, flop_factor: int,
                rows_f32: int, dtype=torch.bfloat16) -> tuple:
    """Bytes (``tensors`` (B, S, H, D) tensors of ``dtype``, ``rows_f32``
    fp32 (B, H, S) rows, the int32 mask) and the time of flop_factor *
    B * H * S^2 * D products, halved when causal: on the tensor cores in
    bf16, on the CUDA cores in fp32."""
    b, s, h, d = shape
    size = torch.finfo(dtype).bits // 8
    nbytes = (tensors * b * s * h * d * size + rows_f32 * b * h * s * 4
              + (b * s * 4 if masked else 0))
    flops = flop_factor * b * h * s * s * d / (2 if causal else 1)
    return nbytes, flops / (FP32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S)


def _attn_label(shape, causal, masked, dtype):
    return [*shape, f"causal={causal}", f"kv_mask={masked}"] + (
        ["fp32"] if dtype == torch.float32 else [])


def _train_attention_kernels(kernels, gen, packed_entry) -> dict:
    """The training path's attention: #7 and #4 against their plain versions
    at the LLaMA training shapes (causal, a padded kv_mask) and the ViT shape
    (non-causal), #5 and #6 against the plain backward at S = 1024, and the
    packed kernel's backward against autograd through the plain reference.
    Library yardstick: SDPA on the same inputs (forward; for #5 and #6 its
    backward through autograd, which computes dq, dk and dv together)."""
    import torch.nn.functional as F

    from stllm_tpu_torch.ops import attention

    out = {}
    masks = {}

    def sdpa(q, k, v, kv_mask, causal, scale):
        vis = masks[q.data_ptr()]
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=vis,
            is_causal=causal and vis is None, scale=scale)

    def fwd_err(got, want):
        lse_err = float((got[1] - want[1]).abs().max())
        if lse_err > LSE_ATOL:
            raise AssertionError(f"lse max abs err {lse_err} > {LSE_ATOL}")
        return _attn_err(got[0], want[0])

    def fwd_cases(specs, rows_f32):
        cases = []
        for shape, causal, masked, dtype in specs:
            bufs, m = _attn_case(gen, shape, causal, masked, dtype)
            masks.update(m)
            cases.append((_attn_label(shape, causal, masked, dtype), bufs,
                          *_attn_bound(shape, causal, masked, 4, 4, rows_f32, dtype)))
        return cases

    bf16, f32 = torch.bfloat16, torch.float32
    rows = _check_kernel("fused_short_attention",
                         fwd_cases([(TRAIN_SHORT, True, True, bf16), (TRUNK, False, False, bf16),
                                    ((2, 130, 3, 64), True, True, bf16),
                                    ((1, 768, 8, 128), True, True, f32)], 0),
                         kernels.fused_short_attention, kernels.fused_short_attention_plain,
                         _attn_err, library=sdpa)
    out["fused_short_attention"] = _entry(
        "fused_short_attention", "fused_short_attention.cu", "stllm_tpu/ops/attention.py:493",
        rows, BF16_ATOL, BF16_RTOL)
    long_specs = [(TRAIN_LONG, True, True, bf16), (TRUNK, False, False, bf16),
                  ((1, 1024, 8, 128), True, True, f32), ((2, 1100, 2, 88), False, True, bf16)]
    rows = _check_kernel("flash_attention_fwd", fwd_cases(long_specs, 1),
                         kernels.flash_attention_fwd, kernels.flash_attention_fwd_plain,
                         fwd_err, library=sdpa)
    out["flash_attention_fwd"] = _entry(
        "flash_attention_fwd", "flash_attention_fwd.cu", "stllm_tpu/ops/attention.py:103",
        rows, BF16_ATOL, BF16_RTOL)
    blocks = kernels.occupancy("flash_attention_fwd", TRAIN_LONG[3])
    out["flash_attention_fwd"]["blocks_per_sm"] = blocks
    print(f"[kernels] flash_attention_fwd: {blocks} blocks per SM at head_dim {TRAIN_LONG[3]}")

    # #5 dQ and #6 dK, dV from the forward kernel's out and lse
    def bwd_case(shape, causal, masked, sk=None, hidden=None):
        """bf16 backward inputs at (B, S, H, D) (keys: ``sk``, default S;
        ``hidden``: a key range masked in every batch row), lse and delta
        from the plain forward."""
        b, s_q, h, d = shape
        s_k = sk or s_q
        q = torch.randn(b, s_q, h, d, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(b, s_k, h, d, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        kv_mask = None
        if masked:
            kv_mask = torch.ones(b, s_k, dtype=torch.int32, device="cuda")
            kv_mask[-1, s_k - s_k // 5:] = 0
            if hidden:
                kv_mask[:, hidden[0]:hidden[1]] = 0
        o, lse = kernels.flash_attention_fwd_plain(q, k, v, kv_mask, causal, d ** -0.5)
        g = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
        delta = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        return q, k, v, kv_mask, g, lse, delta, causal, d ** -0.5

    cases5, cases6, sdpa_rows = [], [], []
    for shape, causal, masked, dtype in long_specs[:3]:
        bufs, m = _attn_case(gen, shape, causal, masked, dtype)
        masks.update(m)
        bwd, graphs = [], {}
        for q, k, v, kv_mask, _, scale in bufs:
            o, lse = kernels.flash_attention_fwd(q, k, v, kv_mask, causal, scale)
            g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            delta = (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
            bwd.append((q, k, v, kv_mask, g, lse, delta, causal, scale))
            # an SDPA graph on the same inputs, for the library's backward
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            masks[leaves[0].data_ptr()] = masks[q.data_ptr()]
            graphs[q.data_ptr()] = (sdpa(*leaves, kv_mask, causal, scale), leaves,
                                    g.transpose(1, 2))
        label = _attn_label(shape, causal, masked, dtype)
        cases5.append((label, bwd, *_attn_bound(shape, causal, masked, 5, 6, 2, dtype)))
        cases6.append((label, bwd, *_attn_bound(shape, causal, masked, 6, 8, 2, dtype)))
        # SDPA's whole backward (dq, dk and dv together) through autograd on
        # the same inputs: device time only (queued behind a sleep), and
        # launched one by one with the host's time inside, as earlier versions of
        # this script printed it
        it = iter(range(1 << 30))

        def sdpa_backward():
            ref, leaves, g = graphs[bwd[next(it) % 4][0].data_ptr()]
            return torch.autograd.grad(ref, leaves, g, retain_graph=True)

        sdpa_rows.append({"sdpa_whole_backward_ms": queued_ms(sdpa_backward, 40),
                          "sdpa_whole_backward_host_ms": cuda_ms(sdpa_backward, 40)})
        del graphs

    def plain_dq(*a):
        return kernels.flash_attention_bwd_plain(*a)[0]

    def plain_dkv(*a):
        return kernels.flash_attention_bwd_plain(*a)[1:]

    def pair_err(got, want):
        return max(_attn_err(g, w) for g, w in zip(got, want))

    rows = _check_kernel("flash_attention_bwd_dq", cases5, kernels.flash_attention_bwd_dq,
                         plain_dq, _attn_err)
    out["flash_attention_bwd_dq"] = _entry(
        "flash_attention_bwd_dq", "flash_attention_bwd_dq.cu", "stllm_tpu/ops/attention.py:214",
        rows, BF16_ATOL, BF16_RTOL)
    rows = _check_kernel("flash_attention_bwd_dkv", cases6, kernels.flash_attention_bwd_dkv,
                         plain_dkv, pair_err)
    out["flash_attention_bwd_dkv"] = _entry(
        "flash_attention_bwd_dkv", "flash_attention_bwd_dkv.cu",
        "stllm_tpu/ops/attention.py:257", rows, BF16_ATOL, BF16_RTOL)
    # the edges of the walked tiles, held to the plain backward (not timed):
    # lengths that are no multiple of the 64-row tile, a kv_mask that hides
    # two whole walked tiles (and a whole block's keys), more or fewer keys
    # than queries
    edges = [((1, 1000, 4, 128), True, True, None, None),
             ((2, 70, 2, 64), True, True, None, None),
             ((2, 70, 2, 64), False, True, None, None),
             ((2, 320, 2, 128), True, True, None, (64, 192)),
             ((2, 70, 2, 64), True, True, 130, None),
             ((1, 300, 2, 128), True, True, 200, None),
             ((1, 1000, 4, 128), False, True, 1100, None)]
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        out[name]["edge_shapes"] = []
    for shape, causal, masked, sk, hidden in edges:
        a = bwd_case(shape, causal, masked, sk, hidden)
        label = [*shape, f"sk={sk or shape[1]}", f"causal={causal}", f"kv_mask={masked}"] + (
            [f"hidden keys {hidden[0]}:{hidden[1]}"] if hidden else [])
        for name, plain, err_fn in (("flash_attention_bwd_dq", plain_dq, _attn_err),
                                    ("flash_attention_bwd_dkv", plain_dkv, pair_err)):
            kernel = getattr(kernels, name)
            err = err_fn(kernel(*a), plain(*a))
            out[name]["edge_shapes"].append({"shape": label, "max_abs_err": err})
            out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        if hidden:
            dk, dv = kernels.flash_attention_bwd_dkv(*a)
            if bool(dk[:, hidden[0]:hidden[1]].any()) or bool(dv[:, hidden[0]:hidden[1]].any()):
                raise AssertionError("dK, dV of hidden keys are not 0")
    print(f"[kernels] flash backward edge shapes: "
          f"{[r['shape'] for r in out['flash_attention_bwd_dq']['edge_shapes']]} held to the "
          f"plain backward")
    # no single PyTorch call computes dq alone or dk, dv alone: library_ms is
    # null for each, and SDPA's whole backward stands beside the pair
    pair = out["flash_attention_bwd_dq"]["ms"] + out["flash_attention_bwd_dkv"]["ms"]
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        entry = out[name]
        for row, sdpa_row in zip(entry["per_shape"], sdpa_rows):
            row.update(sdpa_row)
        entry.update(sdpa_rows[0])
        entry["sdpa_whole_backward_is"] = (
            "SDPA backward through autograd, dq, dk and dv together: sdpa_whole_backward_ms "
            "device time only (40 calls enqueued while the card sleeps, CUDA events from the "
            "sleep's end); sdpa_whole_backward_host_ms launched one by one with the host's "
            "time inside (what earlier versions of this script printed as sdpa_whole_backward_ms)")
        entry["pair_ms"] = pair
        entry["plain_is"] = "the whole plain backward: dq, dk and dv together"
        blocks = kernels.occupancy(name, TRAIN_LONG[3])
        entry["blocks_per_sm"] = blocks
        print(f"[kernels] {name}: {blocks} blocks per SM at head_dim {TRAIN_LONG[3]}")
    print(f"[kernels] flash backward pair {pair:.4f} ms against SDPA's whole backward "
          f"{sdpa_rows[0]['sdpa_whole_backward_ms']:.4f} ms device only "
          f"({sdpa_rows[0]['sdpa_whole_backward_host_ms']:.4f} ms with the host)")

    held = _held_attn_head_dims(kernels, gen)
    for name in ATTN_KERNELS:
        out[name]["head_dims_held"] = {label: {"form": r["form"], "max_abs_err": r["err"][name],
                                               "ms": r["ms"][name]}
                                       for label, r in held.items()}
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                       *(r["err"][name] for r in held.values()))
        out[name]["forms"] = {"tiles": "stllm_tpu_torch/csrc/flash_attention.cuh",
                              "any": "stllm_tpu_torch/csrc/flash_attention_any.cuh"}

    # the packed kernel's backward: the vjp of the plain-softmax reference
    b, s, h, d = TRUNK
    qkv = _qkv_bufs(gen, b, s, h, d)[0].requires_grad_()
    g = torch.randn(b, s, h * d, generator=gen, device="cuda").bfloat16()
    (got,) = torch.autograd.grad(attention.fused_qkv_attention(qkv, h, d), qkv, g)
    ref_in = qkv.detach().clone().requires_grad_()
    (want,) = torch.autograd.grad(attention._packed_reference(ref_in, h, d, d ** -0.5), ref_in, g)
    packed_entry["backward_max_abs_err"] = _bf16_err(got, want)
    packed_entry["backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
        attention.fused_qkv_attention(qkv, h, d), qkv, g), 10)
    print(f"[kernels] packed_qkv_attention backward (recompute through the plain reference): "
          f"max abs err {packed_entry['backward_max_abs_err']:.4f}, forward + backward "
          f"{packed_entry['backward_ms']:.3f} ms")
    return out


ATTN_KERNELS = ("fused_short_attention", "flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv")


def _held_attn_head_dims(kernels, gen) -> dict:
    """#4-#7 at ANY_ATTN's head_dims, each held to its plain version (the
    forward's lse too), its form asserted from FORM_LAUNCHES (the tile
    loops, zero-padded, up to 128; the "any" form above), and timed by CUDA
    events as context: no path runs these head_dims."""
    held = {}
    for (b, s, h, d), dtype in ANY_ATTN:
        form, scale = kernels.attn_form(d), d ** -0.5

        def mk(rows):
            return torch.randn(b, rows, h, d, generator=gen, device="cuda").to(dtype)

        def mask(keys):
            m = torch.ones(b, keys, dtype=torch.int32, device="cuda")
            m[-1, keys - keys // 5:] = 0
            return m

        short = (mk(768), mk(768), mk(768), mask(768), True, scale)
        q, k, v, kv_mask, g = mk(s), mk(s), mk(s), mask(s), mk(s)
        fwd = (q, k, v, kv_mask, True, scale)
        want_out, lse = kernels.flash_attention_fwd_plain(*fwd)
        delta = (g.float() * want_out.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = (q, k, v, kv_mask, g, lse, delta, True, scale)
        calls = {"fused_short_attention": (kernels.fused_short_attention, short,
                                           kernels.fused_short_attention_plain(*short)),
                 "flash_attention_fwd": (kernels.flash_attention_fwd, fwd, (want_out, lse)),
                 "flash_attention_bwd_dq": (kernels.flash_attention_bwd_dq, bwd,
                                            kernels.flash_attention_bwd_plain(*bwd)[0]),
                 "flash_attention_bwd_dkv": (kernels.flash_attention_bwd_dkv, bwd,
                                             kernels.flash_attention_bwd_plain(*bwd)[1:])}
        row = {"form": form, "err": {}, "ms": {}}
        for name, (fn, args, want) in calls.items():
            got = _ws_form_ran(kernels, name, form, lambda: fn(*args))
            if name == "flash_attention_fwd":
                lse_err = float((got[1] - want[1]).abs().max())
                if lse_err > LSE_ATOL:
                    raise AssertionError(f"[kernels] {name} D={d}: lse max abs err {lse_err}")
                got, want = got[0], want[0]
            pairs = zip(got, want) if name == "flash_attention_bwd_dkv" else [(got, want)]
            row["err"][name] = max(_attn_err(a, w) for a, w in pairs)
            row["ms"][name] = cuda_ms(lambda: fn(*args), 5)
        label = f"{[b, s, h, d]} {str(dtype).split('.')[-1]}"
        held[label] = row
        print(f"[kernels] training attention at head_dim {d} ({label}, the {form} form; "
              f"#7 at 768 keys): {json.dumps(row)}")
    return held


# ---------------------------------------------------------------------------
# tiny card-vs-CPU checks
# ---------------------------------------------------------------------------

def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return None if tree is None else tree.to(device)


TINY_MODEL_CFG = {
    "arch": "st_llm_hf", "model_type": "instructblip_vicuna0_btadapter", "dtype": "bf16",
    "video_input": "all", "btadapter_depth": 2,
    "vit": {"image_size": 56, "width": 176, "depth": 3, "heads": 2, "mlp_hidden": 352},
    "qformer": {"hidden": 64, "num_layers": 2, "heads": 2, "intermediate": 128,
                "encoder_width": 176, "num_query": 8, "vocab_size": 100},
    "llama": {"vocab_size": 100, "hidden": 64, "num_layers": 1, "heads": 2,
              "intermediate": 128},
}


def _tiny_inputs():
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.integers(0, 256, (1, 4, 56, 56, 3), dtype=np.uint8))
    return frames, torch.from_numpy(rng.integers(0, 100, (1, 5)))


def _card_vs_cpu(params, cfg, tol: float, card_params=None) -> float:
    """Relative L2 gap between one encode on the card (of ``card_params``,
    default ``params`` copied there) and on the CPU."""
    from stllm_tpu_torch.models.stllm import encode_img

    frames, q_ids = _tiny_inputs()
    want = encode_img(params, frames, cfg, q_ids).float()
    card_params = _tree_to(params, "cuda") if card_params is None else card_params
    got = encode_img(card_params, frames.cuda(), cfg, q_ids.cuda()).float().cpu()
    rel = float((got - want).norm() / want.norm())
    if not bool(torch.isfinite(got).all()) or rel > tol:
        raise AssertionError(f"tiny encode: card vs CPU relative L2 error {rel} > {tol}")
    return rel


def check_small_reference() -> float:
    """A tiny bf16 BTAdapter model encodes one video on the card (kernel)
    and on the CPU (plain version); the two must agree to bf16 tolerance."""
    from stllm_tpu_torch.models.zoo import STLLM

    model = STLLM.from_config(TINY_MODEL_CFG, seed=3, device="cpu")
    return _card_vs_cpu(model.params, model.cfg, BF16_RTOL)


def check_small_w4_reference(kernels) -> float:
    """A tiny bf16 LLaMA converted to W4A16 (per-channel int4, fused, int8
    head) with the int8 KV cache: prefill logits on the card (kernel #12)
    and on the CPU (its plain version) within W4_TINY_REL."""
    from stllm_tpu_torch.models.generation import _prefill
    from stllm_tpu_torch.models.llama import quantize_llama_params_int4
    from stllm_tpu_torch.models.zoo import STLLM

    cfg = {**TINY_MODEL_CFG, "llama": {**TINY_MODEL_CFG["llama"], "kv_int8": True}}
    model = STLLM.from_config(cfg, seed=3, device="cpu")
    lcfg = model.cfg.llama
    llama = quantize_llama_params_int4(model.params["llama"], group=None, fuse=True,
                                       quant_head=True)
    rng = np.random.default_rng(4)
    emb = torch.from_numpy(rng.standard_normal((2, 24, lcfg.hidden)) * 0.5).bfloat16()
    mask = torch.ones((2, 24), dtype=torch.int32)
    mask[1, 17:] = 0
    want, _ = _prefill(llama, emb, mask, lcfg, 32)
    before = kernels.LAUNCHES["w4a16_matmul"]
    got, cache = _prefill(_tree_to(llama, "cuda"), emb.cuda(), mask.cuda(), lcfg, 32)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["w4a16_matmul"] - before != 4 * lcfg.num_layers:
        raise AssertionError("tiny W4A16 prefill did not launch the kernel 4 times a layer")
    if cache.k[0].dtype != torch.int8 or cache.k_scale is None:
        raise AssertionError("tiny W4A16 prefill: the KV cache is not int8 with scales")
    got = got.cpu()
    rel = float((got - want).norm() / want.norm())
    if not bool(torch.isfinite(got).all()) or rel > W4_TINY_REL:
        raise AssertionError(f"tiny W4A16 prefill logits: card vs CPU relative L2 {rel} "
                             f"> {W4_TINY_REL}")
    return rel


def check_small_int8_reference() -> dict:
    """The tiny model with quant_int8, dynamic and then static: calibrated
    once on the CPU, the same scales copied to the card."""
    from stllm_tpu_torch.models.btadapter import calibrate_btadapter_scales
    from stllm_tpu_torch.models.zoo import STLLM

    model = STLLM.from_config({**TINY_MODEL_CFG, "quant_int8": True}, seed=3, device="cpu")
    out = {"dynamic": _card_vs_cpu(model.params, model.cfg, INT8_TINY_REL)}
    frames, _ = _tiny_inputs()
    model.params["vit"] = calibrate_btadapter_scales(model.params["vit"], frames[0],
                                                     model.cfg.vit, frames.shape[1])
    out["static"] = _card_vs_cpu(model.params, model.cfg, INT8_TINY_REL)
    return out


def check_small_fp32_int8(kernels) -> dict:
    """The tiny model in fp32 with quant_int8 (dynamic W8A8; #9 and #10 on
    fp32 rows with fp32 gamma and beta, in their register form): one encode
    and calibrate_btadapter_scales on the card and on the CPU from the same
    weights. The encode, the calibrated scales, and the static encode each
    device then runs with its own scales agree within INT8_TINY_REL."""
    from stllm_tpu_torch.models.btadapter import calibrate_btadapter_scales
    from stllm_tpu_torch.models.zoo import STLLM

    model = STLLM.from_config({**_fp32_tiny_cfg(), "quant_int8": True}, seed=3, device="cpu")
    cfg = model.cfg
    frames, _ = _tiny_inputs()
    before = dict(kernels.LAUNCHES), dict(kernels.FORM_LAUNCHES)
    out = {"encode_rel_l2": _card_vs_cpu(model.params, cfg, INT8_TINY_REL)}
    cpu_vit = calibrate_btadapter_scales(model.params["vit"], frames[0], cfg.vit, frames.shape[1])
    card_vit = calibrate_btadapter_scales(_tree_to(model.params["vit"], "cuda"), frames[0].cuda(),
                                          cfg.vit, frames.shape[1])
    torch.cuda.synchronize()
    names = ("layer_norm_quant", "gelu_quant")
    ran = {n: kernels.LAUNCHES[n] - before[0][n] for n in names}
    regs = {n: kernels.FORM_LAUNCHES[f"{n}/registers"] - before[1][f"{n}/registers"]
            for n in names}
    if not all(ran.values()) or ran != regs:
        raise AssertionError(f"tiny fp32 int8 model: row kernel launches {ran}, "
                             f"on the register form {regs}")

    def scales(tree):
        return torch.cat([torch.as_tensor(v, dtype=torch.float32).reshape(-1).cpu()
                          for v in _scale_leaves(tree)])

    want, got = scales(cpu_vit), scales(card_vit)
    rel = float((got - want).norm() / want.norm())
    if want.numel() == 0 or rel > INT8_TINY_REL:
        raise AssertionError(f"tiny fp32 int8 calibration: card vs CPU scales relative L2 "
                             f"{rel} > {INT8_TINY_REL}")
    out["calibration_scales_rel_l2"] = rel
    out["static_encode_rel_l2"] = _card_vs_cpu(
        dict(model.params, vit=cpu_vit), cfg, INT8_TINY_REL,
        card_params=dict(_tree_to(model.params, "cuda"), vit=card_vit))
    out["launches"] = ran
    return out


def _scale_leaves(tree, calibrated: bool = False):
    """Every calibrated scale (a leaf under an ``act_scales`` key) of a
    params tree, in the tree's order."""
    if isinstance(tree, dict):
        for key, v in tree.items():
            yield from _scale_leaves(v, calibrated or key == "act_scales")
    elif isinstance(tree, list):
        for v in tree:
            yield from _scale_leaves(v, calibrated)
    elif calibrated and tree is not None:
        yield tree


def _fp32_tiny_cfg(**llama) -> dict:
    """The tiny QA model in fp32, the ViT on its packed kernel
    (vit.use_flash None)."""
    return {**TINY_MODEL_CFG, "dtype": "fp32",
            "vit": {**TINY_MODEL_CFG["vit"], "use_flash": None},
            "llama": {**TINY_MODEL_CFG["llama"], **llama}}


def _rel(got, want, what: str) -> float:
    got, want = got.detach().float().cpu(), want.detach().float()
    rel = float((got - want).norm() / want.norm())
    if not bool(torch.isfinite(got).all()) or rel > FP32_TINY_REL:
        raise AssertionError(f"tiny fp32 {what}: card vs CPU relative L2 {rel} > {FP32_TINY_REL}")
    return rel


def _ran(kernels, before: dict, names) -> dict:
    ran = {n: kernels.LAUNCHES[n] - before[n] for n in names}
    if not all(ran.values()):
        raise AssertionError(f"tiny fp32 model: a kernel did not launch: {ran}")
    return ran


def check_small_fp32_serving(kernels) -> dict:
    """The tiny fp32 model serves on the card through the fp32 packed
    kernel (#1): the encode and the LLaMA prefill logits of one video, card
    against CPU within FP32_TINY_REL. TF32 is off: the reference keeps fp32
    products."""
    from stllm_tpu_torch.models.generation import _prefill
    from stllm_tpu_torch.models.stllm import encode_img
    from stllm_tpu_torch.models.zoo import STLLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = STLLM.from_config(_fp32_tiny_cfg(), seed=3, device="cpu")
    cfg, params = model.cfg, model.params
    frames, q_ids = _tiny_inputs()
    card = _tree_to(params, "cuda")
    before = dict(kernels.LAUNCHES)
    want = encode_img(params, frames, cfg, q_ids)
    got = encode_img(card, frames.cuda(), cfg, q_ids.cuda())
    torch.cuda.synchronize()
    out = {"encode_rel_l2": _rel(got, want, "encode"),
           "launches": _ran(kernels, before, ["packed_qkv_attention"])}
    rng = np.random.default_rng(4)
    emb = torch.from_numpy(rng.standard_normal((2, 24, cfg.llama.hidden)) * 0.5).float()
    mask = torch.ones((2, 24), dtype=torch.int32)
    mask[1, 17:] = 0
    want, _ = _prefill(params["llama"], emb, mask, cfg.llama, 32)
    got, _ = _prefill(card["llama"], emb.cuda(), mask.cuda(), cfg.llama, 32)
    out["prefill_rel_l2"] = _rel(got, want, "prefill logits")
    return out


def check_small_fp32_train(kernels) -> dict:
    """One train step of the tiny fp32 model (BTAdapter, use_mask,
    mvm_decode, all of the LLaMA trainable) on the card and on the CPU: the
    step's loss and its gradient within FP32_TINY_REL, once at the fused
    short tier (#1 and #7) and once with llama.use_flash True (#1, #4 and its
    backward #5, #6)."""
    from stllm_tpu_torch.models.stllm import stllm_forward
    from stllm_tpu_torch.models.zoo import STLLM
    from stllm_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for tier, llama, names in (
            ("fused", {"num_layers": 2}, ["packed_qkv_attention", "fused_short_attention"]),
            ("flash", {"num_layers": 2, "use_flash": True},
             ["packed_qkv_attention", "flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"])):
        model_cfg = {**_fp32_tiny_cfg(**llama), "use_mask": True, "mvm_decode": True,
                     "max_txt_len": 16, "use_grad_checkpoint": True, "freeze_LLM": False}
        res, cfg = {}, None
        for dev in ("cpu", "cuda"):
            model = STLLM.from_config(model_cfg, seed=3, device="cpu")
            cfg = model.cfg
            opt = make_optimizer(1e-3, weight_decay=0.0)
            state = create_train_state(_tree_to(model.params, dev), opt, model.trainable_fn())
            res[dev] = (state, make_train_step(cfg, opt))
        col = _collator(cfg, seed=6, seq_multiple=32)
        batch = col(_train_samples(np.random.default_rng(5), 4, 56, 6, 8, 2))
        grads, losses = {}, {}
        before = dict(kernels.LAUNCHES)
        for dev, (state, step) in res.items():
            put = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            loss = stllm_forward(state.tree, put, cfg)["loss"]
            g = torch.autograd.grad(loss, list(state.params.values()), allow_unused=True)
            grads[dev] = torch.cat([(torch.zeros_like(p) if x is None else x).flatten().cpu()
                                    for p, x in zip(state.params.values(), g)])
            _, metrics = step(state, put)
            losses[dev] = metrics["loss"].reshape(1)
        torch.cuda.synchronize()
        out[tier] = {"loss": float(losses["cpu"]),
                     "loss_rel": _rel(losses["cuda"], losses["cpu"], f"{tier} step loss"),
                     "grad_rel_l2": _rel(grads["cuda"], grads["cpu"], f"{tier} gradient"),
                     "seq_len": int(batch["token_ids"].shape[1]),
                     "launches": _ran(kernels, before, names)}
    return out


# ---------------------------------------------------------------------------
# the served paths at full width
# ---------------------------------------------------------------------------

def qa_model_cfg() -> dict:
    from stllm_tpu_torch.common.config import Config

    return dict(Config(ROOT / "config" / "instructblipbase_stllm_qa.yaml").model_cfg)


def make_requests(cfg, prefix_len: int = PREFIX_LEN, suffix_len: int = SUFFIX_LEN,
                  q_len: int = Q_LEN):
    rng = np.random.default_rng(1)
    size = cfg.vit.image_size
    return [(f"q{i}",
             rng.integers(0, 256, (1, FRAMES, size, size, 3), dtype=np.uint8),
             rng.integers(3, cfg.llama.vocab_size, (1, prefix_len)),
             rng.integers(3, cfg.llama.vocab_size, (1, suffix_len)),
             rng.integers(0, cfg.qformer.vocab_size, (1, q_len)))
            for i in range(NUM_REQUESTS)]


def serve(kernels, params, cfg, reqs, label: str, gen=None, **server) -> dict:
    """Serve ``reqs`` with VideoQAServer(slots=4, max_len=1024, or as
    ``server`` sets it), counting kernel launches over exactly that run, then
    time encode, prefill and decode on the first request's inputs."""
    from stllm_tpu_torch.models.generation import GenerationConfig, _pad_prompt, _prefill
    from stllm_tpu_torch.models.generation import _decode_chunk_greedy
    from stllm_tpu_torch.pipeline_serving import VideoQAServer, _encode_assemble

    gen = gen or GenerationConfig(max_new_tokens=MAX_NEW)
    srv = VideoQAServer(params, cfg, **{"slots": 4, "max_len": 1024, **server})
    for rid, frames, pre, suf, q in reqs:
        srv.submit(rid, frames, pre, suf, gen, qformer_text_ids=q)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launches()
    FORWARD_CALLS[0] = 0
    t0 = time.perf_counter()
    answers = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    form_launches = dict(kernels.FORM_LAUNCHES)
    forwards = FORWARD_CALLS[0]
    any_form = {k: v for k, v in form_launches.items() if k.endswith("/any") and v}
    if any_form:       # every model's head_dim (64, 88, 128) and row width (1408, 6144)
        raise AssertionError(f"[{label}] launches on an any form: {any_form}")
    _expect_register_rows(label, launches, form_launches)

    if set(answers) != {r[0] for r in reqs}:
        raise AssertionError(f"[{label}] answers for {sorted(answers)}, not all "
                             f"{NUM_REQUESTS} requests")
    for rid, toks in answers.items():
        if not toks or not all(0 <= t < cfg.llama.vocab_size for t in toks):
            raise AssertionError(f"[{label}] request {rid}: bad tokens {toks}")
    n_tok = sum(len(t) for t in answers.values())

    rid, frames, pre, suf, q = reqs[0]
    dev = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    fr, pre_t, suf_t = dev(frames), dev(pre).int(), dev(suf).int()
    q_t = dev(q).int()
    embeds = _encode_assemble(params, fr, pre_t, suf_t, q_t, torch.ones_like(q_t), cfg)
    want_shape = (1, pre.shape[1] + cfg.num_video_tokens(FRAMES) + suf.shape[1], cfg.llama.hidden)
    if tuple(embeds.shape) != want_shape or not bool(torch.isfinite(embeds).all()):
        raise AssertionError(f"[{label}] encode output {tuple(embeds.shape)} "
                             f"(want {want_shape}) not finite")
    encode_ms = cuda_ms(lambda: _encode_assemble(
        params, fr, pre_t, suf_t, q_t, torch.ones_like(q_t), cfg), 3, warmup=1)
    emb, mask = _pad_prompt(embeds, torch.ones(embeds.shape[:2], dtype=torch.int32,
                                               device="cuda"), gen.pad_to_multiple)
    logits, _ = _prefill(params["llama"], emb, mask, cfg.llama, emb.shape[1])
    if tuple(logits.shape) != (1, cfg.llama.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[{label}] prefill logits not finite")
    prefill_ms = cuda_ms(lambda: _prefill(params["llama"], emb, mask, cfg.llama,
                                          emb.shape[1]), 3, warmup=1)
    b = srv.batcher
    chunk = 16
    decode_ms_step = cuda_ms(lambda: _decode_chunk_greedy(
        b.params, b.cur, b.cache, cfg.llama, chunk), 2, warmup=1) / chunk
    out = {"mode": label, "requests": NUM_REQUESTS, "frames": FRAMES,
           "prompt_tokens": emb.shape[1], "tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "encode_ms_per_video": encode_ms,
           "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms_step,
           "decode_slots": b.slots,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "form_launches": form_launches, "llama_forwards": forwards,
           "launches_per_video": {k: v / NUM_REQUESTS for k, v in launches.items()},
           "kv_cache": {"dtype": str(b.cache.k[0].dtype).replace("torch.", ""),
                        "scales": b.cache.k_scale is not None},
           "tokens_per_request": {k: len(v) for k, v in sorted(answers.items())},
           "answers": {k: v[:8] for k, v in sorted(answers.items())}}
    print(f"[{label}] {json.dumps(out)}")
    return out


FORWARD_CALLS = [0]   # llama_forward calls of the serving path, counted by count_forwards


def count_forwards() -> None:
    """Count the serving path's llama_forward calls (generation's prefill
    and decode steps call it through the module's own name)."""
    from stllm_tpu_torch.models import generation

    real = generation.llama_forward

    def counted(*args, **kw):
        FORWARD_CALLS[0] += 1
        return real(*args, **kw)

    generation.llama_forward = counted


def _expect_w4_forms(label: str, out: dict) -> None:
    """Every prefill forward ran #12's wgmma form and every decode step its
    decode form, 4 x 32 launches a forward each, and nothing ran the tile
    loop (so no split-K launch)."""
    forms = out["form_launches"]
    wgmma, decode = forms["w4a16_matmul/wgmma"], forms["w4a16_matmul/decode"]
    if not wgmma or not decode or wgmma % W4A16_LAUNCHES_PER_FORWARD \
            or decode % W4A16_LAUNCHES_PER_FORWARD or forms["w4a16_matmul/stream"] \
            or wgmma + decode != out["launches"]["w4a16_matmul"]:
        raise AssertionError(f"[{label}] W4A16 launches by form {forms}")


def _expect_register_rows(label: str, launches: dict, form_launches: dict) -> None:
    """Every launch of #9 and #10 since the counters were reset ran the
    register form (every model's rows: 1408 and 6144 wide)."""
    for name in ("layer_norm_quant", "gelu_quant"):
        if form_launches[f"{name}/registers"] != launches[name]:
            raise AssertionError(f"[{label}] {name}: {launches[name]} launches, "
                                 f"{form_launches[f'{name}/registers']} on the register form")


def _expect(label: str, launches: dict, want: dict, per: int) -> None:
    got = {k: launches[k] for k in want}
    if got != {k: v * per for k, v in want.items()}:
        raise AssertionError(f"[{label}] kernel launches {got}, want {want} x {per}")


def phase_slice(kernels) -> dict:
    from stllm_tpu_torch.models.zoo import STLLM

    rel = check_small_reference()
    print(f"[slice] tiny bf16 encode, card vs CPU: relative L2 error {rel:.3e}")
    fp32 = check_small_fp32_serving(kernels)
    print(f"[slice] tiny fp32 model on the fp32 kernels, card vs CPU: {json.dumps(fp32)}")

    t0 = time.perf_counter()
    model = STLLM.from_config(qa_model_cfg(), seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    print(f"[slice] model built in {time.perf_counter() - t0:.1f} s: vit {cfg.vit.width}x"
          f"{cfg.vit.depth} ({cfg.vit_model}, branch {cfg.btadapter_depth}), qformer "
          f"{cfg.qformer.hidden}x{cfg.qformer.num_layers}, llama {cfg.llama.hidden}x"
          f"{cfg.llama.num_layers}, {cfg.llama.dtype}, video_input {cfg.video_input}")
    out = serve(kernels, model.params, cfg, make_requests(cfg), "slice")
    _expect("slice", out["launches"], {"packed_qkv_attention": 45, "layer_norm_quant": 0,
                                       "gelu_quant": 0, "packed_qkv_attention_quant": 0,
                                       "packed_qkv_attention_s8": 0, "w4a16_matmul": 0},
            NUM_REQUESTS)
    out["tiny_encode_rel_err"] = rel
    out["tiny_fp32"] = fp32
    return out


def _check_act_scales(vit_params) -> int:
    layers = (vit_params["blocks"] + vit_params["btadapter"]["temp"]
              + vit_params["btadapter"]["spatial"])
    for i, layer in enumerate(layers):
        sc = layer.get("act_scales")
        if not sc or not all(bool(torch.isfinite(v).all() and (v > 0).all())
                             for v in sc.values()):
            raise AssertionError(f"layer {i}: act_scales missing, not finite or not positive")
    return len(layers)


def phase_int8(kernels) -> dict:
    """quant_int8 at full width: dynamic serving, calibration, static serving."""
    from stllm_tpu_torch.models.btadapter import calibrate_btadapter_scales
    from stllm_tpu_torch.models.zoo import STLLM

    rels = check_small_int8_reference()
    print(f"[int8] tiny int8 encode, card vs CPU: relative L2 error {rels}")
    rels_f32 = check_small_fp32_int8(kernels)
    print(f"[int8] tiny fp32 dynamic-int8 model, card vs CPU: {rels_f32}")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = STLLM.from_config({**qa_model_cfg(), "quant_int8": True}, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[int8] W8A8 model built in {build_s:.1f} s, peak {build_gib:.2f} GiB, "
          f"now {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    cfg, params = model.cfg, model.params
    reqs = make_requests(cfg)
    dynamic = serve(kernels, params, cfg, reqs, "int8-dynamic")
    _expect("int8-dynamic", dynamic["launches"], DYNAMIC_PER_VIDEO, NUM_REQUESTS)

    clip = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (FRAMES, cfg.vit.image_size, cfg.vit.image_size, 3), dtype=np.uint8)).cuda()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    params["vit"] = calibrate_btadapter_scales(params["vit"], clip, cfg.vit, FRAMES)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    calib_launches = dict(kernels.LAUNCHES)
    _expect("int8-calibration", calib_launches, CALIBRATION, 1)
    _expect_register_rows("int8-calibration", calib_launches, kernels.FORM_LAUNCHES)
    n_layers = _check_act_scales(params["vit"])
    print(f"[int8] calibrated {n_layers} layers in {calib_s:.2f} s, launches {calib_launches}")

    static = serve(kernels, params, cfg, reqs, "int8-static")
    _expect("int8-static", static["launches"], {**STATIC_PER_VIDEO, "w4a16_matmul": 0},
            NUM_REQUESTS)
    for mode in (dynamic, static):
        print(f"[int8] {mode['mode']}: encode {mode['encode_ms_per_video']:.2f} ms/video, "
              f"prefill {mode['prefill_ms']:.2f} ms, decode {mode['decode_ms_per_token']:.2f} "
              f"ms/step, {mode['tokens_per_s']:.2f} tokens/s, peak "
              f"{mode['max_memory_allocated_gib']:.2f} GiB")
    return {"dynamic": dynamic, "static": static, "calibration_launches": calib_launches,
            "calibration_s": calib_s, "build_s": build_s, "build_peak_gib": build_gib,
            "tiny_encode_rel_err": rels, "tiny_fp32_int8": rels_f32}


def _time_heads(llama_params, lcfg) -> dict:
    """One decode step's head (4 slots) on the int8 w_q16 head, which
    upcasts the 131 MB of codes to a bf16 copy on every call, and on a
    dense bf16 head of the same shape."""
    from stllm_tpu_torch.models.llama import lm_head

    gen = torch.Generator(device="cuda").manual_seed(5)
    hidden = torch.randn(4, 1, lcfg.hidden, generator=gen, device="cuda").bfloat16()
    dense = {"lm_head": {"w": (torch.randn(lcfg.hidden, lcfg.vocab_size, generator=gen,
                                           device="cuda") * 0.02).bfloat16()}}
    out = {"w_q16": cuda_ms(lambda: lm_head(llama_params, hidden), 20),
           "dense_bf16": cuda_ms(lambda: lm_head(dense, hidden), 20)}
    print(f"[w4a16] lm_head, 4 slots: w_q16 {out['w_q16']:.4f} ms, dense bf16 "
          f"{out['dense_bf16']:.4f} ms")
    return out


def phase_w4a16(kernels) -> dict:
    """The W4A16 serving stack at full width: static-int8 ViT, bf16
    Q-Former, per-channel int4 Vicuna-7B with q|k|v and gate|up fused, the
    int8 lm_head, and the int8 KV cache."""
    from stllm_tpu_torch.models.btadapter import calibrate_btadapter_scales
    from stllm_tpu_torch.models.llama import quantize_llama_params_int4
    from stllm_tpu_torch.models.vit import quantize_vit_params
    from stllm_tpu_torch.models.zoo import STLLM

    rel = check_small_w4_reference(kernels)
    print(f"[w4a16] tiny W4A16 + int8-KV prefill logits, card vs CPU: relative L2 {rel:.3e}")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base = qa_model_cfg()
    model = STLLM.from_config({**base, "llama": {**(base.get("llama") or {}), "kv_int8": True}},
                              seed=0)
    cfg, params = model.cfg, model.params
    dense_bytes = sum(t.numel() * t.element_size() for layer in params["llama"]["layers"]
                      for p in layer.values() for t in p.values())
    params["vit"] = quantize_vit_params(params["vit"], free_dense=True)
    clip = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (FRAMES, cfg.vit.image_size, cfg.vit.image_size, 3), dtype=np.uint8)).cuda()
    params["vit"] = calibrate_btadapter_scales(params["vit"], clip, cfg.vit, FRAMES)
    params["llama"] = quantize_llama_params_int4(params["llama"], group=None, free_dense=True,
                                                 quant_head=True, fuse=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_gib = torch.cuda.max_memory_allocated() / 2**30
    w4_bytes = sum(t.numel() * t.element_size() for layer in params["llama"]["layers"]
                   for p in layer.values() for t in p.values())
    print(f"[w4a16] model built, calibrated and converted in {build_s:.1f} s, peak "
          f"{build_gib:.2f} GiB, now {torch.cuda.memory_allocated() / 2**30:.2f} GiB; decoder "
          f"weights {dense_bytes / 1e9:.2f} GB bf16 -> {w4_bytes / 1e9:.2f} GB W4A16; layer "
          f"keys {sorted(params['llama']['layers'][0])}, head {sorted(params['llama']['lm_head'])}")
    out = serve(kernels, params, cfg, make_requests(cfg), "w4a16")
    out["lm_head_ms"] = _time_heads(params["llama"], cfg.llama)
    _expect("w4a16", out["launches"], {**STATIC_PER_VIDEO, **{p: 0 for p in PROBES}},
            NUM_REQUESTS)
    forwards, w4 = out["llama_forwards"], out["launches"]["w4a16_matmul"]
    if not forwards or w4 != W4A16_LAUNCHES_PER_FORWARD * forwards:
        raise AssertionError(f"[w4a16] {w4} W4A16 launches over {forwards} LLaMA forwards, "
                             f"want {W4A16_LAUNCHES_PER_FORWARD} each")
    _expect_w4_forms("w4a16", out)
    if out["kv_cache"] != {"dtype": "int8", "scales": True}:
        raise AssertionError(f"[w4a16] KV cache {out['kv_cache']}, want int8 with scales")
    print(f"[w4a16] encode {out['encode_ms_per_video']:.2f} ms/video, prefill "
          f"{out['prefill_ms']:.2f} ms, decode {out['decode_ms_per_token']:.2f} ms/step, "
          f"{out['tokens_per_s']:.2f} tokens/s, build peak {build_gib:.2f} GiB, serving peak "
          f"{out['max_memory_allocated_gib']:.2f} GiB, {forwards} forwards x "
          f"{W4A16_LAUNCHES_PER_FORWARD} W4A16 launches")
    out.update({"build_s": build_s, "build_peak_gib": build_gib, "tiny_prefill_rel_err": rel,
                "decoder_weight_bytes": {"bf16": dense_bytes, "w4a16": w4_bytes}})
    return out, params, cfg


# ---------------------------------------------------------------------------
# the pipeline-serving stack: plain static-int8 ViT-g with the fused LayerNorm
# ---------------------------------------------------------------------------

TINY_PIPELINE_CFG = {
    "arch": "st_llm_hf", "model_type": "instructblip_vicuna0", "dtype": "fp32",
    "video_input": "all", "quant_int8": True,
    "vit": {"image_size": 56, "width": 256, "depth": 3, "heads": 4, "mlp_hidden": 512,
            "gelu_approx": True},
    "qformer": {**TINY_MODEL_CFG["qformer"], "encoder_width": 256},
    "llama": TINY_MODEL_CFG["llama"],
}


def check_small_pipeline_reference(kernels) -> float:
    """A tiny fp32 plain-ViT model with quant_int8, calibrated on the CPU,
    encodes one video under FUSED_LN="both" on the card (5 launches of #11
    for 3 blocks) and on the CPU (its plain version) within INT8_TINY_REL."""
    from stllm_tpu_torch.models.vit import calibrate_vit_scales
    from stllm_tpu_torch.models.zoo import STLLM

    model = STLLM.from_config(TINY_PIPELINE_CFG, seed=3, device="cpu")
    frames, _ = _tiny_inputs()
    model.params["vit"] = calibrate_vit_scales(model.params["vit"], frames[0], model.cfg.vit)
    before = kernels.LAUNCHES["qmm_res_ln"]
    rel = _card_vs_cpu(model.params, model.cfg, INT8_TINY_REL)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["qmm_res_ln"] - before != 2 * model.cfg.vit.depth - 1:
        raise AssertionError(f"tiny fused-LN encode launched #11 "
                             f"{kernels.LAUNCHES['qmm_res_ln'] - before} times, want "
                             f"{2 * model.cfg.vit.depth - 1}")
    return rel


def _pipeline_cfg(w4_cfg):
    """script/bench_pipeline_serving.py's build(): EVA-ViT-g (no BTAdapter)
    with tanh GELU, video_input all, the InstructBLIP Q-Former and Vicuna-7B
    as STLLMConfig's defaults set them. The W4A16 phase's Q-Former and
    decoder are the same modules, so their weights are reused."""
    import dataclasses

    from stllm_tpu_torch.models.stllm import STLLMConfig
    from stllm_tpu_torch.models.vit import EVA_VIT_G

    cfg = STLLMConfig(vit=dataclasses.replace(EVA_VIT_G, gelu_approx=True), video_input="all")
    if cfg.qformer != w4_cfg.qformer or dataclasses.replace(
            w4_cfg.llama, kv_int8=False, remat=False) != cfg.llama:
        raise AssertionError("[pipeline] the W4A16 phase's Q-Former or LLaMA differs from the "
                             "pipeline stack's")
    return cfg


def phase_pipeline(kernels, w4_params, w4_cfg) -> dict:
    """The stack of script/bench_pipeline_serving.py at full width and depth
    under FUSED_LN="both": the plain EVA-ViT-g converted to int8 and
    calibrated on one clip (calibrate_vit_scales), the dense Q-Former, the
    fused int4 Vicuna-7B with the int8 head; VideoQAServer(slots=4, chunk=8,
    max_len=768), 64 prefix and 32 suffix ids, 16 question ids, 16 greedy
    tokens with no stop. Then one clip's trunk under each FUSED_LN setting."""
    from stllm_tpu_torch.models import vit as vit_mod
    from stllm_tpu_torch.models.generation import GenerationConfig
    from stllm_tpu_torch.models.vit import (
        calibrate_vit_scales, init_vit, normalize_uint8, quantize_vit_params, vit_forward)

    fused_before = vit_mod.FUSED_LN
    vit_mod.FUSED_LN = "both"
    try:
        rel = check_small_pipeline_reference(kernels)
        print(f"[pipeline] tiny fp32 fused-LN encode, card vs CPU: relative L2 {rel:.3e}")
        cfg = _pipeline_cfg(w4_cfg)
        t0 = time.perf_counter()
        params = {k: w4_params[k] for k in ("ln_vision", "qformer", "llama_proj", "llama")}
        w4_params.clear()
        gc.collect()
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(0)
        params["vit"] = quantize_vit_params(init_vit(gen, cfg.vit), free_dense=True)
        clip = torch.from_numpy(np.random.default_rng(2).integers(
            0, 256, (FRAMES, cfg.vit.image_size, cfg.vit.image_size, 3), dtype=np.uint8)).cuda()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t1 = time.perf_counter()
        params["vit"] = calibrate_vit_scales(params["vit"], clip, cfg.vit)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t1
        calib = dict(kernels.LAUNCHES)
        _expect("pipeline-calibration", calib, PIPE_CALIBRATION, 1)
        _expect_register_rows("pipeline-calibration", calib, kernels.FORM_LAUNCHES)
        build_s = time.perf_counter() - t0
        print(f"[pipeline] plain ViT-g built, converted and calibrated in {build_s:.1f} s "
              f"(calibration {calib_s:.2f} s, launches {calib}), held "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

        answer = GenerationConfig(max_new_tokens=PIPE_ANSWER, stop_sequences=(),
                                  eos_token_id=-1, pad_to_multiple=64)
        out = serve(kernels, params, cfg, make_requests(cfg, *PIPE_PROMPT), "pipeline",
                    gen=answer, slots=4, max_len=768, chunk=8)
        _expect("pipeline", out["launches"], {**PIPELINE_PER_VIDEO, **{p: 0 for p in PROBES}},
                NUM_REQUESTS)
        forwards, w4 = out["llama_forwards"], out["launches"]["w4a16_matmul"]
        if not forwards or w4 != W4A16_LAUNCHES_PER_FORWARD * forwards:
            raise AssertionError(f"[pipeline] {w4} W4A16 launches over {forwards} LLaMA "
                                 f"forwards, want {W4A16_LAUNCHES_PER_FORWARD} each")
        _expect_w4_forms("pipeline", out)
        if out["form_launches"]["qmm_res_ln/cluster"] != out["launches"]["qmm_res_ln"]:
            raise AssertionError(f"[pipeline] #11 launches by form {out['form_launches']}: the "
                                 "ViT-g sites must take the cluster form")
        if set(out["tokens_per_request"].values()) != {PIPE_ANSWER}:
            raise AssertionError(f"[pipeline] tokens per request {out['tokens_per_request']}, "
                                 f"want {PIPE_ANSWER} each")

        # one clip's trunk under each setting: the #11 launches, the time, and
        # the gap to the unfused trunk, against the unfused trunk's own gap
        # under an input moved by one bf16 step
        images = normalize_uint8(clip, cfg.vit.dtype)
        vit_mod.FUSED_LN = False
        with torch.no_grad():
            nudged = vit_forward(params["vit"], (images.float() * (1 + 2.0 ** -8)).to(images.dtype),
                                 cfg.vit).float()
        trunk = {}
        for setting in (False, "proj", "fc2", "both"):
            vit_mod.FUSED_LN = setting
            torch.cuda.synchronize()
            kernels.reset_launches()
            with torch.no_grad():
                y = vit_forward(params["vit"], images, cfg.vit)
            torch.cuda.synchronize()
            n11 = kernels.LAUNCHES["qmm_res_ln"]
            with torch.no_grad():
                ms = cuda_ms(lambda: vit_forward(params["vit"], images, cfg.vit), 3, warmup=1)
            trunk[str(setting)] = {"qmm_res_ln_launches": n11, "trunk_ms": ms,
                                   "frames_per_s": FRAMES / ms * 1e3, "out": y.float()}
            if n11 != FUSED_SITES[setting] or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"[pipeline] FUSED_LN={setting!r}: {n11} #11 launches "
                                     f"(want {FUSED_SITES[setting]}), finite "
                                     f"{bool(torch.isfinite(y).all())}")
        base = trunk["False"]["out"]
        for row in trunk.values():
            row["mean_rel_vs_unfused"] = float((row.pop("out") - base).abs().mean()
                                               / base.abs().mean())
        floor = float((nudged - base).abs().mean() / base.abs().mean())
        worst = max(r["mean_rel_vs_unfused"] for r in trunk.values())
        print(f"[pipeline] 16-frame trunk by FUSED_LN: {json.dumps(trunk)}; the unfused trunk "
              f"under a one-bf16-step input: {floor:.4e}")
        if worst > FUSED_GAP_FACTOR * floor:
            raise AssertionError(f"[pipeline] a fused trunk is {worst} from the unfused one, "
                                 f"more than {FUSED_GAP_FACTOR} x {floor}")
    finally:
        vit_mod.FUSED_LN = fused_before
    print(f"[pipeline] encode {out['encode_ms_per_video']:.2f} ms/video, prefill "
          f"{out['prefill_ms']:.2f} ms, decode {out['decode_ms_per_token']:.2f} ms/step, "
          f"{out['tokens_per_s']:.2f} tokens/s, {NUM_REQUESTS / out['wall_s']:.3f} QA/s, serving "
          f"peak {out['max_memory_allocated_gib']:.2f} GiB")
    out.update({"qa_per_s": NUM_REQUESTS / out["wall_s"], "calibration_launches": calib,
                "calibration_s": calib_s, "build_s": build_s, "tiny_encode_rel_err": rel,
                "trunk_by_fused_ln": trunk, "trunk_one_bf16_step_gap": floor})
    return out


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

def _words(rng, n: int) -> str:
    return " ".join(f"w{int(i)}" for i in rng.integers(0, 5000, n))


def _train_samples(rng, frames: int, size: int, prompt_words: int, answer_words: int, rows: int):
    """Instruction-tuning samples as the datasets emit them: uint8 frames,
    an instruction around the video placeholder, an answer."""
    return [{"image": rng.integers(0, 256, (frames, size, size, 3), dtype=np.uint8),
             "instruction_input": "###Human: <Video><ImageHere></Video> "
                                  f"{_words(rng, prompt_words)} ###Assistant:",
             "answer": _words(rng, answer_words)} for _ in range(rows)]


def _collator(cfg, seed: int, **kw):
    from stllm_tpu_torch.data.collate import TrainCollator
    from stllm_tpu_torch.models.zoo import ToyHashTokenizer

    return TrainCollator(cfg, ToyHashTokenizer(cfg.llama.vocab_size),
                         ToyHashTokenizer(cfg.qformer.vocab_size, reserve=2), seed=seed, **kw)


def check_small_train() -> dict:
    """A tiny bf16 model (BTAdapter, use_mask, mvm_decode, per-layer
    recompute, all of the LLaMA trainable) takes four AdamW steps on the
    card, through the kernels, and on the CPU, through their plain
    versions, from the same weights and batches."""
    from stllm_tpu_torch.models.stllm import stllm_forward
    from stllm_tpu_torch.models.zoo import STLLM
    from stllm_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    model_cfg = {**TINY_MODEL_CFG, "use_mask": True, "mvm_decode": True, "max_txt_len": 16,
                 "use_grad_checkpoint": True, "freeze_LLM": False,
                 "llama": {**TINY_MODEL_CFG["llama"], "num_layers": 2}}
    rng = np.random.default_rng(5)
    states, cfg = {}, None
    for dev in ("cpu", "cuda"):
        model = STLLM.from_config(model_cfg, seed=3, device="cpu")
        cfg = model.cfg
        opt = make_optimizer(1e-3, weight_decay=0.0)
        state = create_train_state(_tree_to(model.params, dev), opt, model.trainable_fn())
        states[dev] = (state, make_train_step(cfg, opt))
    col = _collator(cfg, seed=6, seq_multiple=32)
    batches = [col(_train_samples(rng, 4, 56, 6, 8, 2)) for _ in range(4)]

    def put(batch, dev):
        return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    # the first step's gradient, before any update
    grads = {}
    for dev, (state, _) in states.items():
        loss = stllm_forward(state.tree, put(batches[0], dev), cfg)["loss"]
        g = torch.autograd.grad(loss, list(state.params.values()), allow_unused=True)
        grads[dev] = torch.cat([(torch.zeros_like(p) if x is None else x).float().flatten().cpu()
                                for p, x in zip(state.params.values(), g)])
    grad_rel = float((grads["cuda"] - grads["cpu"]).norm() / grads["cpu"].norm())

    fixed = {}
    for dev, (state, _) in states.items():
        with torch.no_grad():
            fixed[dev] = [float(stllm_forward(state.tree, put(batches[0], dev), cfg)["loss"])]
    losses = {"cpu": [], "cuda": []}
    for batch in batches:
        for dev, (state, step) in states.items():
            _, metrics = step(state, put(batch, dev))
            losses[dev].append({k: float(v) for k, v in metrics.items()})
    for dev, (state, _) in states.items():
        with torch.no_grad():
            fixed[dev].append(float(stllm_forward(state.tree, put(batches[0], dev), cfg)["loss"]))
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(losses["cuda"], losses["cpu"]))
    out = {"grad_rel_l2": grad_rel, "loss_rel_max": loss_rel, "losses": losses,
           "fixed_batch_loss": fixed, "seq_len": int(batches[0]["token_ids"].shape[1])}
    print(f"[train] tiny bf16 model, card vs CPU: {json.dumps(out)}")
    finite = all(np.isfinite(v) for dev in losses for m in losses[dev] for v in m.values())
    if not finite or grad_rel > TRAIN_TINY_GRAD_REL or loss_rel > TRAIN_TINY_LOSS_REL:
        raise AssertionError(f"tiny training: gradient relative L2 {grad_rel} (limit "
                             f"{TRAIN_TINY_GRAD_REL}), loss relative gap {loss_rel} (limit "
                             f"{TRAIN_TINY_LOSS_REL}), finite {finite}")
    for dev, (before, after) in fixed.items():
        if not after < before:
            raise AssertionError(f"tiny training on {dev}: the fixed batch's loss went "
                                 f"{before} -> {after}")
    return out


def _leaf_sums(leaves: dict) -> dict:
    return {path: float(p.detach().double().sum()) for path, p in leaves.items()}


def phase_train(kernels) -> dict:
    """The QA config's training step at full width and depth through
    Trainer.train, at both sequence tiers."""
    from stllm_tpu_torch.common.optim import linear_warmup_cosine_hf
    from stllm_tpu_torch.models.zoo import STLLM
    from stllm_tpu_torch.train.trainer import Trainer

    tiny = check_small_train()
    fp32 = check_small_fp32_train(kernels)
    print(f"[train] tiny fp32 model, one step on the fp32 kernels, card vs CPU: "
          f"{json.dumps(fp32)}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model_cfg = qa_model_cfg()
    model = STLLM.from_config(model_cfg, seed=0)
    cfg = model.cfg
    total_steps = sum(TRAIN_STEPS.values())
    out_dir = tempfile.mkdtemp(prefix="stllm_train_smoke_")
    # the QA config's run section: AdamW, lr 2e-5 on the HF cosine schedule with
    # 3 % warmup (none within this few steps), no weight decay, bf16
    trainer = Trainer(cfg, model.params, output_dir=out_dir,
                      trainable_fn=model.trainable_fn(),
                      learning_rate=linear_warmup_cosine_hf(2e-5, 0.03, total_steps),
                      weight_decay=0.0, max_grad_norm=1.0, log_freq=1)
    torch.cuda.synchronize()
    state = trainer.state
    n_train = sum(p.numel() for p in state.params.values())
    n_frozen = sum(p.numel() for p in state.frozen.values())
    build = {"build_s": time.perf_counter() - t0,
             "trainable_params": n_train, "frozen_params": n_frozen,
             "freeze_LLM": bool(model_cfg.get("freeze_LLM", True)),
             "remat": {"vit": cfg.vit.remat, "llama": cfg.llama.remat},
             "held_gib_before_steps": torch.cuda.memory_allocated() / 2**30}
    print(f"[train] full-width trainer built: {json.dumps(build)}")
    if not any(p.startswith("llama/layers/") for p in state.params) or not cfg.llama.remat \
            or not cfg.use_mask or not cfg.mvm_decode:
        raise AssertionError("[train] the QA config should train the LLaMA with masking, the "
                             "MVM decoder and per-layer recompute")
    before = {"train": _leaf_sums(state.params), "frozen": _leaf_sums(state.frozen)}

    step_ms = []
    real_step = trainer._step_fn

    def timed_step(st, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real_step(st, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return res

    trainer._step_fn = timed_step
    rng = np.random.default_rng(7)
    col = _collator(cfg, seed=8)
    size = cfg.vit.image_size
    # prompt and answer lengths that pack to 768 and to 1024 slots around the
    # 512 video tokens (max_txt_len caps the answer at 256)
    tier_words = {"train-short": (40, 100), "train-long": (200, 250)}
    tiers = {}
    done = 0
    for label, steps in TRAIN_STEPS.items():
        batches = [col(_train_samples(rng, FRAMES, size, *tier_words[label], 1))
                   for _ in range(steps)]
        seq = {int(b["token_ids"].shape[1]) for b in batches}
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        kernels.reset_launches()
        del step_ms[:]
        t1 = time.perf_counter()
        trainer.train(iter(batches), done + steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = dict(kernels.LAUNCHES)
        form_launches = dict(kernels.FORM_LAUNCHES)
        done += steps
        tiers[label] = {
            "mode": label, "steps": steps, "seq_len": sorted(seq), "micro_batch": 1,
            "kept_video_tokens": [int(b["mvm_weight"].sum()) for b in batches],
            "wall_s": wall, "step_ms": list(step_ms),
            "ms_per_step": float(np.mean(step_ms[1:])) if steps > 1 else step_ms[0],
            "samples_per_s": (steps - 1) / (sum(step_ms[1:]) / 1e3) if steps > 1 else None,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "form_launches": form_launches,
            "launches_per_step": {k: v / steps for k, v in launches.items() if v}}
        print(f"[{label}] {json.dumps(tiers[label])}")
        want_len = TRAIN_SHORT[1] if label == "train-short" else TRAIN_LONG[1]
        if seq != {want_len}:
            raise AssertionError(f"[{label}] packed lengths {sorted(seq)}, want {want_len}")
        _expect(label, launches, TRAIN_LAUNCHES[label], steps)
        others = {k: v for k, v in launches.items() if k not in TRAIN_LAUNCHES[label] and v}
        if others:
            raise AssertionError(f"[{label}] unexpected kernel launches {others}")
        off_tiles = {k: v for k, v in form_launches.items() if k.endswith("/any") and v}
        if off_tiles:      # head_dim 128: the tile loops, no padding
            raise AssertionError(f"[{label}] launches on an any form: {off_tiles}")

    log = [json.loads(line) for line in (Path(out_dir) / "log.txt").read_text().splitlines()]
    shutil.rmtree(out_dir, ignore_errors=True)
    keys = ("loss", "loss_ce", "loss_mvm", "grad_norm")
    if [r["step"] for r in log] != list(range(1, total_steps + 1)) or not all(
            np.isfinite(r[k]) and r[k] > 0 for r in log for k in keys):
        raise AssertionError(f"[train] log.txt: {log}")
    after = {"train": _leaf_sums(state.params), "frozen": _leaf_sums(state.frozen)}
    moved = [p for p in before["frozen"] if after["frozen"][p] != before["frozen"][p]]
    # a bf16 norm scale of 1.0 cannot take a 2e-5 step; every other leaf moves
    stuck = [p for p in before["train"] if after["train"][p] == before["train"][p]
             and not p.endswith("scale")]
    if moved or stuck:
        raise AssertionError(f"[train] frozen leaves that changed: {moved[:5]}; trainable "
                             f"leaves that did not: {stuck[:5]}")
    print(f"[train] {len(before['train'])} trainable leaves, {len(before['frozen'])} frozen "
          f"leaves unchanged; log {json.dumps(log)}")
    for t in tiers.values():
        print(f"[train] {t['mode']}: S = {t['seq_len'][0]}, {t['ms_per_step']:.1f} ms/step after "
              f"the first ({t['step_ms'][0]:.1f} ms), {t['samples_per_s']:.3f} samples/s, peak "
              f"{t['max_memory_allocated_gib']:.2f} GiB")
    return {"tiny": tiny, "tiny_fp32": fp32, "build": build, "log": log, **tiers}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from stllm_tpu_torch.ops import kernels

    replaced, divide_check = phase_build(kernels)
    entries = phase_kernels(kernels, replaced, divide_check)
    gc.collect()
    print(f"[kernels] held after the phase: {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    count_forwards()
    bf16 = phase_slice(kernels)
    gc.collect()
    int8 = phase_int8(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    w4a16, w4_params, w4_cfg = phase_w4a16(kernels)
    pipeline = phase_pipeline(kernels, w4_params, w4_cfg)
    del w4_params
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(kernels)
    short, long_ = train["train-short"], train["train-long"]
    # each kernel's launches from the path that runs it; the probes run on no
    # path (0 launches on every one)
    path_of = {"packed_qkv_attention": bf16, "layer_norm_quant": int8["dynamic"],
               "gelu_quant": int8["dynamic"], "packed_qkv_attention_quant": int8["dynamic"],
               "packed_qkv_attention_s8": int8["static"], "w4a16_matmul": w4a16,
               **{p: w4a16 for p in PROBES}, "fused_short_attention": short,
               "flash_attention_fwd": long_, "flash_attention_bwd_dq": long_,
               "flash_attention_bwd_dkv": long_, "qmm_res_ln": pipeline,
               "quant_matmul_blockwise": pipeline}
    for name, entry in entries.items():
        entry["launches"] = path_of[name]["launches"][name]
        entry["launches_by_path"] = {p["mode"]: p["launches"][name]
                                     for p in (bf16, int8["dynamic"], int8["static"], w4a16,
                                               pipeline, short, long_)}
        entry["launches_by_path"]["int8-calibration"] = int8["calibration_launches"][name]
        entry["launches_by_path"]["pipeline-calibration"] = pipeline["calibration_launches"][name]
        entry["launches_per_train_step"] = {t["mode"]: t["launches"][name] / t["steps"]
                                            for t in (short, long_)}
        if name in kernels.FORMS:
            entry["form_launches"] = {k: v for k, v in path_of[name]["form_launches"].items()
                                      if k.startswith(name + "/")}
    print(json.dumps({"kernels": list(entries.values())}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
