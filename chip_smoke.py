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
   #1 is also timed beside SDPA at the merged trunk's shapes (16 x 192,
   16 x 144, 8 x 320 tokens) and #3 at a folded one (8 x 288);
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
4. mvbench - the MVBench harness (stllm_tpu_torch/evalharness/mvbench.py)
   over six synthetic samples in two tasks (one with [start, end] bounds),
   read from uint8 clips held in memory (the card's machine may have no
   FFmpeg): a tiny fp32 model (#1's fp32 form) processes the clips on the
   card and on the CPU (frames within one uint8 step) and answers through
   the sequential, batched (3) and served (4 slots) routes on both devices
   with identical predictions; then the slice phase's full-width model with
   toy tokenizers (STLLM.chat) answers six samples from 480x640 and 360x480
   clips through the same three routes (max_len 1024 for the server, 100
   greedy tokens): every sample scored, the result JSON written, no
   over-long fallback, exactly 45 launches of #1 per video on every route
   and no call of its plain version; it prints each route's wall time and
   answered QA/s, the transform's ms per video on the card, peak memory and
   the share of predictions on which the routes agree;
5. qabench - beam search and the open-ended QA harness: a tiny fp32 model
   (#1's fp32 form encodes the video) gives identical tokens on the card
   and on the CPU through beam_search's device form, its penalized form and
   its host loop (a 3-token stop), beam_search_batched over 3 prompts and
   three PrefixSession turns, greedy and penalized; then the slice phase's
   full-width model answers run_videoqa over 4 in-memory 224x224 clips (16
   frames of 48), beam 5, the simple prompt (repetition_penalty 1.5), 64
   new tokens (the protocol's 300 cut for time), one video at a time and
   all four in one beam program (batch_videos=4, 20 decode rows), then
   run_vcgbench_general over the same clips and gpt_eval.evaluate with an
   offline fake judge over both prediction files: exactly 45 launches of #1
   per video and no plain #1 call on every route; it prints each route's
   wall time, answered QA/s, beam decode steps and peak memory, and the
   share of predictions on which the two videoqa routes agree;
6. prefix - the same model in a three-turn Chat over one clip with a
   PrefixSession (greedy, 32 new tokens a turn), beside solo generate on
   each turn's prompt: every turn is served by the session (no fallback to
   solo generate), turn 1 with one fresh prefill, turns 2 and 3 with one
   delta prefill each, reusing at least the system text and the video
   block; it prints each turn's prefill and total ms for both, the
   session's cache width and whether their tokens agree;
7. breadth - serving breadth. The tiny fp32 model on the card and on the CPU:
   a merged and folded ViT encode (origin maps equal) and a merged
   BTAdapter encode within FP32_TINY_REL; greedy tokens of the batcher with
   a shared prefix (the stored prefix unchanged), of the batcher in
   speculative mode and of H2O with eviction, identical on both devices;
   on each device every sampled stream served busy equals the same request
   alone and solo generate (generators differ between devices). Then the
   full-width model: the "mild" merge level serves the 6 requests (45 #1
   launches a video, 16 at 257 tokens, 13 at 192, 13 at 144, 3 temporal,
   no plain #1 call; the merged encode timed beside the unmerged one);
   VideoQAServer with prefix_key, three clips and eight questions with
   prefix_cache_size 2 (one encode a key, the repeated question answered
   alike; a prefix-hit prefill timed beside a full one); and AnswerService,
   four threads, two greedy and two sampled, each answer equal to the
   request served alone by a batcher of the same shape;
8. load   - the QA config at full width and depth (EVA-ViT-g with BTAdapter
   depth 3, the InstructBLIP Q-Former, Vicuna-7B, bf16) written from seeded
   weights into the reference's fp16 files in a temporary directory
   (eva_vit_g.pth in LAVIS names with the BTAdapter_* keys, an
   instruct_blip_vicuna7b_trimmed.pth-style file under "model" that is also
   the ckpt, and vicuna-7b-v1.1's two pytorch_model-0000k-of-00002.bin
   shards), loaded by STLLM.from_config on the card from another random
   init: every leaf a file holds bit for bit the written tensor in the dtype
   the loader gives it, then one 16-frame question answered greedily
   through STLLM.chat (exactly 45 #1 launches), its tokens equal to those
   of the same weights built in memory; it prints the bytes, write and load
   seconds and GB/s per family, host RSS and the device peak;
9. int8   - the same config with quant_int8 (dynamic W8A8) serves the same
   6 requests (per video: 78 LayerNorm-quant, 39 GELU-quant, 39 quant-epilogue
   attention and 6 bf16 attention launches), calibrate_btadapter_scales runs
   on one 16-frame clip (78, 39, 39 and 39 static-int8 attention launches),
   and the static-int8 model serves them again (42 static-int8 attention
   launches per video, nothing else); every launch of #9 and #10 in the
   serving and calibration runs is on their register form; a tiny bf16 int8
   model, dynamic and static, must encode one video on the card and on the
   CPU alike, and a tiny fp32 dynamic-int8 model must encode and calibrate
   on the card (#9 and #10 on fp32 rows) as on the CPU;
10. w4a16  - the W4A16 serving stack: the same config with llama.kv_int8,
   the ViT converted to int8 and calibrated on one clip (static int8), the
   Q-Former bf16, and Vicuna-7B converted by quantize_llama_params_int4
   (per-channel int4, q|k|v and gate|up fused, int8 lm_head), serves the
   same 6 requests from an int8 KV cache: 42 static-int8 attention launches
   per video and exactly 128 W4A16 launches per LLaMA forward (prefill on
   the wgmma form, decode on the decode form, none on the tile loop); a
   tiny bf16
   W4A16 + int8-KV LLaMA must give the same prefill logits on the card and
   on the CPU; then, on the same stack, one beam-5 answer alone (every
   decoder matmul #12 at M = 5, its decode form), one answer_batched group
   of 4 (M = 20, its wgmma form) and a two-turn PrefixSession: exactly 128
   #12 launches per LLaMA forward (llama_forward or llama_decode_prefix),
   42 static-int8 attention launches per video, beams over int8 caches with
   scales, the session's cache int8 with its scale planes; then speculative
   serving with a draft of the target's first 4 layers (slots 4, spec_k 4):
   exactly 128 #12 launches a target forward (verify at M = 20 on its wgmma
   form) and 16 a draft step (M = 4, its decode form), with the mean
   accepted tokens a round, ms a round and the share of tokens that agree
   with plain greedy serving;
11. pipeline - the stack of script/bench_pipeline_serving.py under
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
   input; and vit.merge_level "auto": a static clip resolves to
   "t_aggressive" and encodes with no #11 launch and #3 at the folded
   lengths (8 x 288, 4 x 288, 2 x 320), an iid-noise clip to no merging with
   77 #11 launches;
12. train - the training step. A tiny bf16 model takes four optimizer steps
   on the card and on the CPU from the same weights and batches (losses and
   the first gradient must agree within the stated tolerances, and the loss
   on a fixed batch must fall). Then the QA config at full width and depth,
   as the config sets it (freeze_LLM false: all of Vicuna-7B trains, with the
   BTAdapter branch, llama_proj and the MVM decoder; use_mask, mvm_decode,
   per-layer recompute), goes through Trainer.train on batches from
   TrainCollator, micro-batch 1: three steps at a packed length of 768 (the
   fused short attention) and two at 1024 (the flash forward and its two
   backward kernels), with exact launch counts per step, finite losses, and
   frozen leaves untouched while trainable ones move; the trainer's saves
   (one at each train() call's last step) are counted, not written: a full
   fine-tune's checkpoint is about 40 GB;
13. distill - (run right after w4a16's speculative serving, on its target)
   tiny fp32 distill_draft, two steps on the card and on the CPU within
   FP32_TINY_REL; then a dense bf16 4-layer draft at Vicuna-7B width
   distilled for 10 steps against the W4A16 target on 2 fixed batches of 2
   rows (992 prompt positions and the target's own 32-token greedy
   continuation: the flash tier), with exactly 128 #12 launches (wgmma
   form) and 40 / 4 / 4 flash forward / dQ / dK-dV launches a step (the
   draft keeps the QA config's per-layer recompute) and the
   last batch's loss below its first value; the distilled draft then serves
   the speculative requests, its accepted tokens a round beside the cut
   draft's;
14. demo - the demos' default model, the conversation config
   (config/instructblipbase_stllm_conversation.yaml: EVA-ViT-g without the
   BTAdapter, video_input residual, residual_size 16, Vicuna-7B, bf16) at
   full width, built by demo_core.build_chat, reading in-memory 240x320
   clips: one question at 64 frames through gradio_ask with 5 beams (the
   demo's 300 new tokens cut to 8), exactly 39 #1 launches at (64, 257) and
   nothing else, 512 video tokens as STLLMConfig reckons, the answer equal
   to the Chat's own, the encode, prefill and decode ms and the peak; then
   the web demo's handler on 127.0.0.1 (port 0), plain, with an
   AnswerService (4 slots) and with 2 PrefixSessions: two sessions, two
   greedy turns each, every answer equal to the Chat's own through the same
   route, 39 #1 launches an upload; the demos' simple-prompt template forces
   the repetition penalty 1.5, so every AnswerService ask falls back to solo
   generate (counted, as the reference does) and the sessions serve theirs;
15. train-lora - the train CLI's run() on the QA config with
   model.freeze_LLM=True model.lora_r=8 and micro-batch 1 over in-memory
   16-frame clips that pack to 1024 (a tiny fp32 LoRA step over a dense and
   a w_q16 base, and greedy generate through adapters over int4 trees,
   split and fused, on the card against the CPU first): two steps, then a
   second run into the same output_dir resumes at step 2 and takes one;
   per step the launches of a full fine-tune step at 1024, every frozen
   leaf bit for bit at its init, the checkpoint restored into a fresh
   model bit for bit, the A factors moved by the resumed step, no dataset
   retry; it prints the checkpoint's bytes and save and restore times.

16. runner - the reference's config-driven path,
   Config(cfg_dict=..., options=...) -> setup_task -> build_model (on the
   card) -> build_datasets (one registered corpus entry over in-memory
   clips) -> the registry's runner_base -> Trainer, on the QA config with
   LoRA r 8 under the frozen LLM, packed to 1024 (the runner on a tiny fp32
   config and the tiny Q-Former LM on the card against the CPU first): one
   epoch of two steps, then a runner with max_epoch 2 over the same
   output_dir resumes at step 2 and stops at 4; per step a LoRA step's
   launches, each step's checkpoint written once, every frozen leaf bit for
   bit at its init, the A factors moved by the resumed steps; then the
   Q-Former LM at its published width (fp32) generates 8 tokens on two
   sequences, its first logits held to the CPU's.

17. mesh - the multi-device layer at world size 1 (one card): an
   in-process NCCL group of one rank and a (1, 1) mesh; the QA config's
   full-width train step (the train phase's trainable set, packed to 1024)
   through Trainer(mesh=) for two steps against Trainer without a mesh
   from the same init and batches (losses within MESH_LOSS_REL, every
   updated trainable leaf's sum and norm equal bit for bit), exactly the
   train-long launches a step and nothing else, ms a step and the peak;
   then bf16 greedy generate on the (1, 1) mesh against no mesh (first
   logits' relative L2, tokens equal). Two ranks sharing the card over gloo
   are not run: gloo aborts on CUDA tensors (script/gloo_cuda_check.py).

``python3 chip_smoke.py --phases load demo train_breadth distill runner mesh``
builds the kernels and runs only the phases named (a partial run: no
result line).

Then it prints a ``{"kernels": [...]}`` line, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``. Without a CUDA card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import itertools
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
# the trunk's shapes under token merging (ops/tome.py MERGE_LEVELS): #1 at the
# "mild" level's 192 and 144 tokens (breadth-mild), and at the "t_mild" level's
# first fold on a bf16 plain ViT, 8 rows of 320 (held here only: no phase
# serves a bf16 plain ViT); #3 at the three folds of the "t_aggressive" level
# that pipeline-auto encodes (FOLDED_S8): 8 and 4 rows of 288, 2 rows of 320
MERGED = [(16, 192, 16, 88), (16, 144, 16, 88), (8, 320, 16, 88)]
MERGED_S8 = [(8, 288, 16, 88), (4, 288, 16, 88), (2, 320, 16, 88)]

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
    cases += [_packed_case(gen, shape, torch.bfloat16, 2) for shape in MERGED]

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
    for b, s, h, d in attn_shapes + MERGED_S8:
        qkvs = _qkv_bufs(gen, b, s, h, d)
        out_bytes = b * s * h * d + b * s * 4
        flops = 4 * b * h * s * s * d
        if (b, s, h, d) not in MERGED_S8:
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
    PACKED_CALLS.clear()
    FORWARD_CALLS[0] = 0
    t0 = time.perf_counter()
    answers = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    packed_lengths = {n: _lengths(n) for n in ("packed_qkv_attention", "packed_qkv_attention_s8")}
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
           "packed_lengths": packed_lengths,
           "launches_per_video": {k: v / NUM_REQUESTS for k, v in launches.items()},
           "kv_cache": {"dtype": str(b.cache.k[0].dtype).replace("torch.", ""),
                        "scales": b.cache.k_scale is not None},
           "tokens_per_request": {k: len(v) for k, v in sorted(answers.items())},
           "answers": {k: v[:8] for k, v in sorted(answers.items())}}
    print(f"[{label}] {json.dumps(out)}")
    return out


FORWARD_CALLS = [0]   # llama_forward calls of the serving path, counted by count_forwards
PREFIX_DECODES = [0]  # llama_decode_prefix calls (one a beam step, for every prompt of it)
PREFIX_CACHES = set()  # (prefix dtype, generated-cache dtype, scales) of those calls


def count_forwards() -> None:
    """Count the serving path's llama_forward calls and beam search's
    llama_decode_prefix calls (generation's prefill, decode and beam steps
    call them through the module's own names), and note the dtypes of the
    caches each beam step reads."""
    from stllm_tpu_torch.models import generation

    real, real_prefix = generation.llama_forward, generation.llama_decode_prefix

    def counted(*args, **kw):
        FORWARD_CALLS[0] += 1
        return real(*args, **kw)

    def counted_prefix(params, embeds, prefix, gen, cfg):
        PREFIX_DECODES[0] += 1
        PREFIX_CACHES.add((str(prefix.k[0].dtype).replace("torch.", ""),
                           str(gen.k[0].dtype).replace("torch.", ""),
                           prefix.k_scale is not None and gen.k_scale is not None))
        return real_prefix(params, embeds, prefix, gen, cfg)

    generation.llama_forward = counted
    generation.llama_decode_prefix = counted_prefix


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


def phase_slice(kernels):
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
    return out, model


# ---------------------------------------------------------------------------
# the MVBench harness through the port
# ---------------------------------------------------------------------------

MVBENCH_ROUTES = {"sequential": {"batch_size": 1}, "batched": {"batch_size": 3},
                  "serving": {"serving_slots": 4, "serving_max_len": 1024}}
MVBENCH_SOURCES = [(480, 640), (360, 480)]   # the full-width clips' frames, H x W
MVBENCH_TINY_SOURCES = [(96, 128), (40, 48)]  # the tiny model's: down- and upscaled to 56


def _mvbench_set(root: Path, sources, seed: int, frames: int = 48, fps: float = 8.0):
    """Six synthetic MVBench samples in two tasks (one with [start, end]
    bounds) over uint8 clips held in memory, one clip per sample, the
    sources' sizes taken in turn. Every answer string is unique, so
    predictions can be matched across routes by their ground truth.
    Returns (annotation dir, clips, data_list)."""
    rng = np.random.default_rng(seed)
    anno = root / "json"
    anno.mkdir(parents=True, exist_ok=True)
    clips, tasks = {}, {"bounded": [], "whole": []}
    for i in range(6):
        h, w = sources[i % len(sources)]
        name = f"clip{i}.mp4"
        clips[name] = (rng.integers(0, 256, (frames, h, w, 3), dtype=np.uint8), fps)
        cands = [f"option{i}{c}" for c in "abcd"[: 2 + i % 3]]
        item = {"video": name, "question": f"what happens in clip {i} ?",
                "candidates": cands, "answer": cands[i % len(cands)]}
        if i % 2 == 0:
            item.update(start=0.5 + 0.25 * i, end=4.0 + 0.25 * i)
        tasks["bounded" if i % 2 == 0 else "whole"].append(item)
    for task, items in tasks.items():
        (anno / f"{task}.json").write_text(json.dumps(items))
    data_list = {"Bounded Task": ("bounded.json", "", "video", True),
                 "Whole Task": ("whole.json", "", "video", False)}
    return str(anno), clips, data_list


def _clip_bench(anno: str, clips: dict, data_list: dict, **kw):
    """The port's MVBenchDataset reading from in-memory clips: read_video
    gathers frames with the harness's own mvbench_frame_indices call (the
    card's machine may have no FFmpeg to decode a file with)."""
    import os

    from stllm_tpu_torch.data.samplers import mvbench_frame_indices
    from stllm_tpu_torch.evalharness.mvbench import MVBenchDataset

    class ClipBench(MVBenchDataset):
        def read_video(self, path, bound=None):
            clip, fps = clips[os.path.basename(path)]
            idx = mvbench_frame_indices(bound, fps, len(clip) - 1, first_idx=0,
                                        num_segments=self.num_segments)
            return clip[idx]

    return ClipBench(anno, "", data_list, **kw)


def _preds(result: dict) -> dict:
    return {r["gt"]: r["pred"] for r in result["res_list"]}


def _prime_tokenizer(tokenizer, items) -> None:
    """Encode every sample's prompt segments as the harness does. The toy
    tokenizer decodes only the words it has encoded before (others become
    <unk>), so without this the first route to answer would decode with a
    smaller vocabulary than the later ones."""
    from stllm_tpu_torch.evalharness import mvbench

    for item in items:
        question = mvbench.SYSTEM + item["question"] + mvbench.QUESTION_PROMPT
        prompt = mvbench.mvbench_prompt(mvbench.SYSTEM, question, mvbench.ANSWER_PROMPT)
        for i, seg in enumerate(prompt.split("<VideoHere>")):
            tokenizer.encode(seg, add_special_tokens=(i == 0))


def check_small_mvbench(kernels) -> dict:
    """The tiny fp32 model (#1's fp32 form) through the MVBench harness on
    the card and on the CPU: the eval transform's frames within one uint8
    step of each other, then every route on both devices over the same
    frames, every prediction string identical."""
    from stllm_tpu_torch.conversation import Chat
    from stllm_tpu_torch.evalharness.mvbench import run_mvbench
    from stllm_tpu_torch.models.zoo import STLLM, ensure_tokenizers

    torch.backends.cuda.matmul.allow_tf32 = False
    model = ensure_tokenizers(STLLM.from_config(_fp32_tiny_cfg(), seed=3, device="cpu"),
                              warn=False)
    size = model.cfg.vit.image_size
    with tempfile.TemporaryDirectory() as tmp:
        anno, clips, data_list = _mvbench_set(Path(tmp), MVBENCH_TINY_SOURCES, seed=7)
        sets = {dev: _clip_bench(anno, clips, data_list, num_segments=8, resolution=size,
                                 device=dev) for dev in ("cpu", "cuda")}
        items = {dev: [ds[i] for i in range(len(ds))] for dev, ds in sets.items()}
    steps = max(int(np.abs(a["video"].astype(np.int16) - b["video"].astype(np.int16)).max())
                for a, b in zip(items["cpu"], items["cuda"]))
    if steps > 1:
        raise AssertionError(f"[mvbench] tiny: card and CPU frames {steps} uint8 steps apart")
    _prime_tokenizer(model.llama_tokenizer, items["cuda"])
    chats = {"cpu": model.chat(image_size=size),
             "cuda": Chat(_tree_to(model.params, "cuda"), model.cfg, model.llama_tokenizer,
                          qformer_tokenizer=model.qformer_tokenizer, image_size=size)}
    preds, launches = {}, {}
    for route, kw in MVBENCH_ROUTES.items():
        for dev, chat in chats.items():
            before = dict(kernels.LAUNCHES)
            res = run_mvbench(chat, items["cuda"], verbose=False, **kw)
            preds[(dev, route)] = _preds(res)
            launches[(dev, route)] = kernels.LAUNCHES["packed_qkv_attention"] - before[
                "packed_qkv_attention"]
    want = preds[("cpu", "sequential")]
    bad = {f"{d}/{r}": p for (d, r), p in preds.items() if p != want}
    if len(want) != 6 or bad:
        raise AssertionError(f"[mvbench] tiny: predictions differ from the CPU's sequential "
                             f"route {want}: {bad}")
    if any(launches[("cuda", r)] == 0 for r in MVBENCH_ROUTES) or any(
            launches[("cpu", r)] for r in MVBENCH_ROUTES):
        raise AssertionError(f"[mvbench] tiny: #1 launches by route {launches}")
    return {"frame_steps_apart": steps, "predictions": len(want) * len(preds),
            "card_launches": {r: launches[("cuda", r)] for r in MVBENCH_ROUTES}}


def _count_plain_attention(counts: dict):
    """Count calls of #1's plain versions (the packed reference and the
    kernel's plain math) from here on; returns an undo function."""
    from stllm_tpu_torch.ops import attention, kernels

    real = {(attention, "_packed_reference"): attention._packed_reference,
            (kernels, "packed_qkv_attention_plain"): kernels.packed_qkv_attention_plain}

    def counted(fn, name):
        def wrap(*args, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kw)
        return wrap

    for (mod, name), fn in real.items():
        setattr(mod, name, counted(fn, name))
    return lambda: [setattr(mod, name, fn) for (mod, name), fn in real.items()]


def phase_mvbench(kernels, model) -> dict:
    """The MVBench harness on the full-width QA model (bf16, random weights
    from seed 0, toy tokenizers): six samples from raw 480x640 and 360x480
    clips, processed on the card, through the sequential, batched (3) and
    served (4 slots, max_len 1024) routes at max_new_tokens 100."""
    from stllm_tpu_torch.data.processors import ChatVideoEvalProcessor
    from stllm_tpu_torch.evalharness.mvbench import run_mvbench
    from stllm_tpu_torch.models.zoo import ensure_tokenizers

    tiny = check_small_mvbench(kernels)
    print(f"[mvbench] tiny fp32 model, card vs CPU, every route: {json.dumps(tiny)}")

    chat = ensure_tokenizers(model, warn=False).chat(image_size=model.cfg.vit.image_size)
    out = {"tiny": tiny, "routes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        anno, clips, data_list = _mvbench_set(Path(tmp), MVBENCH_SOURCES, seed=11)
        ds = _clip_bench(anno, clips, data_list, num_segments=FRAMES,
                         resolution=model.cfg.vit.image_size, device="cuda")
        _prime_tokenizer(chat.llama_tokenizer, (ds.data_list[i]["data"] for i in range(len(ds))))
        raw = ds.read_video("clip0.mp4")
        proc = ChatVideoEvalProcessor(model.cfg.vit.image_size, normalize=False, device="cuda")
        proc(raw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            proc(raw)      # returns host NumPy: the device work is done on return
        out["processor_ms_per_video"] = (time.perf_counter() - t0) / 5 * 1e3
        print(f"[mvbench] eval transform on the card, {raw.shape[0]} frames of "
              f"{raw.shape[1]}x{raw.shape[2]} -> {model.cfg.vit.image_size}: "
              f"{out['processor_ms_per_video']:.2f} ms per video")
        preds = {}
        for route, kw in MVBENCH_ROUTES.items():
            stats, plain = {}, {}
            undo = _count_plain_attention(plain)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            try:
                res = run_mvbench(chat, ds, output_dir=str(Path(tmp) / route),
                                  output_name="mvbench", verbose=False, stats=stats, **kw)
                torch.cuda.synchronize()
            finally:
                undo()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            form_launches = dict(kernels.FORM_LAUNCHES)
            written = json.loads((Path(tmp) / route / "mvbench.json").read_text())
            preds[route] = _preds(res)
            scored = sum(v[1] for k, v in res["acc_dict"].items() if k != "Total Acc")
            if scored != 6 or len(preds[route]) != 6 or "Total Acc" not in written["acc_dict"]:
                raise AssertionError(f"[mvbench] {route}: {scored} samples scored, result "
                                     f"{written['acc_dict']}")
            if stats.get("overlong", 0):
                raise AssertionError(f"[mvbench] {route}: {stats['overlong']} samples took the "
                                     "per-sample path for an over-long prompt")
            _expect(f"mvbench-{route}", launches,
                    {"packed_qkv_attention": 45, "layer_norm_quant": 0, "gelu_quant": 0,
                     "packed_qkv_attention_quant": 0, "packed_qkv_attention_s8": 0,
                     "w4a16_matmul": 0}, 6)
            if plain or form_launches["packed_qkv_attention/any"]:
                raise AssertionError(f"[mvbench] {route}: plain #1 calls {plain}, any-form "
                                     f"launches {form_launches['packed_qkv_attention/any']}")
            row = {"mode": f"mvbench-{route}", "wall_s": wall, "qa_per_s": 6 / wall,
                   "total_acc": res["acc_dict"]["Total Acc"],
                   "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "launches": launches, "launches_per_video": {
                       k: v / 6 for k, v in launches.items() if v}}
            out["routes"][route] = row
            print(f"[mvbench] {route}: {wall:.2f} s wall, {6 / wall:.3f} answered QA/s")
            print(f"[mvbench] {route}: peak memory {row['max_memory_allocated_gib']:.2f} GiB, "
                  f"launches per video {json.dumps(row['launches_per_video'])}")
    agree = {f"{a}={b}": sum(preds[a][g] == preds[b][g] for g in preds[a]) / 6
             for a, b in (("sequential", "batched"), ("sequential", "serving"),
                          ("batched", "serving"))}
    out["route_agreement"] = agree
    print(f"[mvbench] share of predictions on which the routes agree (bf16, random weights): "
          f"{json.dumps(agree)}")
    return out


# ---------------------------------------------------------------------------
# beam search, the QA harness and the prefix session through the port
# ---------------------------------------------------------------------------

QA_CLIPS, QA_BEAMS = 4, 5
QA_MAX_NEW = 64        # the protocol's 300 new tokens an answer, cut for time
QA_ROUTES = {"sequential": 1, "batched": QA_CLIPS}   # run_videoqa's batch_videos
PREFIX_TURNS, PREFIX_MAX_NEW = 3, 32
W4_BEAM_MAX_NEW = 32


def _beam_runs(params, cfg, frames, q_ids, text, stop3) -> dict:
    """The tiny model's beam and session routes on one device (the one
    ``params`` and the inputs are on): prompts built around one encoded
    video, tokens of every route."""
    from stllm_tpu_torch.models import generation as G
    from stllm_tpu_torch.models.stllm import encode_video_for_inference

    lp, lc = params["llama"], cfg.llama
    dev = frames.device
    video = encode_video_for_inference(params, frames, cfg, q_ids)      # (1, V, D)
    text = [t.to(dev) for t in text]
    prompts = [torch.cat([text[0], video, text[1]], dim=1), torch.cat([video, text[2]], dim=1),
               torch.cat([text[0], video, text[2], text[1]], dim=1)]
    beam = G.GenerationConfig(max_new_tokens=12, num_beams=3, stop_sequences=(), eos_token_id=2,
                              pad_to_multiple=8)
    out = {"device": G.beam_search(lp, prompts[0], None, llama_cfg=lc, gen=beam),
           "penalized": G.beam_search(lp, prompts[0], None, llama_cfg=lc, gen=dataclasses.replace(
               beam, repetition_penalty=1.5)),
           "batched": G.beam_search_batched(lp, prompts, llama_cfg=lc, gen=beam, chunk=5)}
    if stop3 is not None:
        out["host_stop3"] = G.beam_search(lp, prompts[0], None, llama_cfg=lc,
                                          gen=dataclasses.replace(beam, stop_sequences=(stop3,)))
    for name, kw in (("session_greedy", {}),
                     ("session_penalized", {"repetition_penalty": 1.5, "min_length": 2})):
        gen = G.GenerationConfig(max_new_tokens=10, stop_sequences=(), eos_token_id=2,
                                 pad_to_multiple=8, **kw)
        sess = G.PrefixSession(lp, lc, max_len=512)
        embs = prompts[0]
        items = G.PrefixSession.items_for([[5] * text[0].shape[1], [6] * text[1].shape[1]],
                                          [video])
        turns = []
        for turn in range(3):
            toks = sess.generate(embs, items, gen)
            turns.append((toks, sess.last_reused))
            ans = lp["embed_tokens"][torch.as_tensor(toks, device=dev)][None].float()
            embs = torch.cat([embs, ans, text[turn % 3]], dim=1)
            items = items + [("t", t) for t in toks] + [("t", 50 + turn)] * text[turn % 3].shape[1]
        out[name] = turns
    return out


def check_small_beams(kernels) -> dict:
    """The tiny fp32 model (#1's fp32 form encodes the video) on the card
    and on the CPU gives identical tokens through beam_search's device form,
    its penalized form and its host loop (a 3-token stop), beam_search_batched
    over 3 prompts, and a three-turn PrefixSession greedy and penalized (with
    the same reuse counts)."""
    from stllm_tpu_torch.models.zoo import STLLM

    torch.backends.cuda.matmul.allow_tf32 = False
    model = STLLM.from_config(_fp32_tiny_cfg(), seed=3, device="cpu")
    frames, q_ids = _tiny_inputs()
    rng = np.random.default_rng(5)
    text = [torch.from_numpy(rng.standard_normal((1, n, model.cfg.llama.hidden)) * 0.5).float()
            for n in (7, 12, 4)]
    free = _beam_runs(model.params, model.cfg, frames, q_ids, text, None)["device"]
    stop3 = tuple(free[1:4])
    want = _beam_runs(model.params, model.cfg, frames, q_ids, text, stop3)
    before = dict(kernels.LAUNCHES)
    got = _beam_runs(_tree_to(model.params, "cuda"), model.cfg, frames.cuda(), q_ids.cuda(),
                     text, stop3)
    torch.cuda.synchronize()
    launches = _ran(kernels, before, ["packed_qkv_attention"])
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    host = want["host_stop3"]
    if bad or not (host[-3:] == list(stop3) or host[-1] == 2):
        raise AssertionError(f"[qabench] tiny beams and sessions, card vs CPU: {bad}; host "
                             f"loop {host} ends in neither the stop {stop3} nor eos")
    return {"routes": sorted(want), "tokens": {k: want[k] for k in ("device", "penalized",
                                                                    "host_stop3")},
            "session_reused": [r for _, r in want["session_greedy"]], "launches": launches}


def _qa_set(root: Path, size: int, seed: int, frames: int = 48):
    """QA_CLIPS uint8 clips held in memory, an empty file of each clip's
    name (the harness looks for the file; the chat reads the clip), and the
    VideoQA and VCG-Bench general annotation files."""
    rng = np.random.default_rng(seed)
    vdir = root / "videos"
    vdir.mkdir(parents=True, exist_ok=True)
    clips = {}
    for i in range(QA_CLIPS):
        clips[f"clip{i}.mp4"] = rng.integers(0, 256, (frames, size, size, 3), dtype=np.uint8)
        (vdir / f"clip{i}.mp4").touch()
    qa = [{"video_name": f"clip{i}", "question_id": f"q{i}",
           "question": f"what happens in clip {i} ?", "answer": f"answer{i}"}
          for i in range(QA_CLIPS)]
    vcg = [{"video_name": f"clip{i}.mp4", "Q": f"describe clip {i} in detail .", "A": f"a{i}"}
           for i in range(QA_CLIPS)]
    (root / "videoqa.json").write_text(json.dumps(qa))
    (root / "vcg_general.json").write_text(json.dumps(vcg))
    return vdir, clips


def _clip_chat(params, cfg, llama_tokenizer, qformer_tokenizer, clips, max_new_tokens=None):
    """A Chat whose upload_video reads the in-memory clip of a path's file
    name, sampling its frames as a file read does (get_seq_frames; the
    card's machine may have no FFmpeg); with ``max_new_tokens``, every
    answer is cut to that many new tokens (the QA harnesses take no
    budget)."""
    import os

    from stllm_tpu_torch.conversation import Chat
    from stllm_tpu_torch.data.samplers import get_seq_frames

    class ClipChat(Chat):
        def upload_video(self, video, conv, img_list, num_frame=64, text=None):
            clip = clips[os.path.basename(video)]
            return super().upload_video(clip[get_seq_frames(len(clip), num_frame)], conv,
                                        img_list, num_frame, text)

        def answer(self, *args, **kw):
            cap = {} if max_new_tokens is None else {"max_new_tokens": max_new_tokens}
            return super().answer(*args, **{**kw, **cap})

        def answer_batched(self, *args, **kw):
            cap = {} if max_new_tokens is None else {"max_new_tokens": max_new_tokens}
            return super().answer_batched(*args, **{**kw, **cap})

    return ClipChat(params, cfg, llama_tokenizer, qformer_tokenizer=qformer_tokenizer,
                    image_size=cfg.vit.image_size)


def _name_every_token(tokenizer) -> None:
    """Give every id the toy tokenizer has not encoded a word of its own, so
    a decoded answer names each of its tokens and answers compare token for
    token."""
    tokenizer.rev.update({i: f"w{i}" for i in range(tokenizer.vocab_size)
                          if i not in tokenizer.rev})


def _route_run(kernels, label: str, fn, per_video: dict, videos: int) -> dict:
    """Run ``fn`` with every launch count at 0 and #1's plain versions
    counted; check the per-video launches and that no plain #1 ran."""
    plain = {}
    undo = _count_plain_attention(plain)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launches()
    FORWARD_CALLS[0] = PREFIX_DECODES[0] = 0
    t0 = time.perf_counter()
    try:
        result = fn()
        torch.cuda.synchronize()
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches, form_launches = dict(kernels.LAUNCHES), dict(kernels.FORM_LAUNCHES)
    _expect(label, launches, per_video, videos)
    any_form = {k: v for k, v in form_launches.items() if k.endswith("/any") and v}
    if plain or any_form:
        raise AssertionError(f"[{label}] plain #1 calls {plain}, any-form launches {any_form}")
    return {"mode": label, "result": result, "wall_s": wall, "qa_per_s": videos / wall,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "llama_forwards": FORWARD_CALLS[0], "beam_decode_steps": PREFIX_DECODES[0],
            "launches": launches, "form_launches": form_launches,
            "launches_per_video": {k: v / videos for k, v in launches.items() if v}}


def _row(run: dict) -> dict:
    return {k: v for k, v in run.items() if k != "result"}


BF16_PER_VIDEO = {"packed_qkv_attention": 45, "layer_norm_quant": 0, "gelu_quant": 0,
                  "packed_qkv_attention_quant": 0, "packed_qkv_attention_s8": 0,
                  "w4a16_matmul": 0}


def phase_qabench(kernels, model) -> dict:
    """The open-ended VideoQA harness on the full-width QA model (bf16,
    random weights from seed 0, toy tokenizers): run_videoqa over
    QA_CLIPS in-memory 224x224 clips (16 frames of 48), beam 5, the simple
    prompt (repetition_penalty 1.5), QA_MAX_NEW new tokens, one video at a
    time and all four in one beam program (P * k = 20 decode rows); then
    run_vcgbench_general over the same clips and gpt_eval.evaluate with an
    offline fake judge over both prediction files."""
    from stllm_tpu_torch.conversation import CONV_instructblip_Vicuna0
    from stllm_tpu_torch.evalharness import gpt_eval
    from stllm_tpu_torch.evalharness.qabench import run_vcgbench_general, run_videoqa

    tiny = check_small_beams(kernels)
    print(f"[qabench] tiny fp32 beams and sessions, card vs CPU, identical tokens: "
          f"{json.dumps(tiny)}")
    cfg = model.cfg
    _name_every_token(model.llama_tokenizer)
    out = {"tiny": tiny, "routes": {}, "max_new_tokens": QA_MAX_NEW, "protocol_max_new": 300}
    print(f"[qabench] beam {QA_BEAMS}, repetition_penalty 1.5 (simple prompt), "
          f"{QA_MAX_NEW} new tokens an answer: the protocol's 300 cut for time")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        vdir, clips = _qa_set(root, cfg.vit.image_size, seed=13)
        chat = _clip_chat(model.params, cfg, model.llama_tokenizer, model.qformer_tokenizer,
                          clips, max_new_tokens=QA_MAX_NEW)
        preds = {}
        for route, batch in QA_ROUTES.items():
            run = _route_run(kernels, f"qabench-{route}", lambda: run_videoqa(
                chat, CONV_instructblip_Vicuna0, str(root / "videoqa.json"), str(vdir),
                str(root / route), "videoqa", num_frames=FRAMES, num_beams=QA_BEAMS,
                verbose=False, batch_videos=batch),
                BF16_PER_VIDEO, QA_CLIPS)
            written = json.loads((root / route / "videoqa.json").read_text())
            if written != run["result"] or [r["id"] for r in written] != [
                    f"q{i}" for i in range(QA_CLIPS)]:
                raise AssertionError(f"[qabench] {route}: written predictions {written}")
            preds[route] = [r["pred"] for r in written]
            if not all(p.strip() for p in preds[route]):
                raise AssertionError(f"[qabench] {route}: an empty answer {preds[route]}")
            out["routes"][route] = _row(run)
            print(f"[qabench] {route}: {run['wall_s']:.2f} s wall, {run['qa_per_s']:.3f} answered "
                  f"QA/s, {run['beam_decode_steps']} beam decode steps, peak memory "
                  f"{run['max_memory_allocated_gib']:.2f} GiB, launches per video "
                  f"{json.dumps(run['launches_per_video'])}")
        agree = sum(a == b for a, b in zip(preds["sequential"], preds["batched"])) / QA_CLIPS
        out["route_agreement"] = agree
        print(f"[qabench] share of predictions on which sequential and batched agree "
              f"(bf16, random weights): {agree}")

        run = _route_run(kernels, "vcgbench-general", lambda: run_vcgbench_general(
            chat, CONV_instructblip_Vicuna0, str(root / "vcg_general.json"), str(vdir),
            str(root / "vcg"), "general", num_frames=FRAMES, num_beams=QA_BEAMS,
            verbose=False), BF16_PER_VIDEO, QA_CLIPS)
        if [r["video_name"] for r in run["result"]] != list(clips):
            raise AssertionError(f"[qabench] vcgbench general answered {run['result']}")
        out["routes"]["vcgbench-general"] = _row(run)
        print(f"[qabench] vcgbench general: {run['wall_s']:.2f} s wall, "
              f"{run['qa_per_s']:.3f} answered QA/s, {run['beam_decode_steps']} beam decode "
              f"steps, peak memory {run['max_memory_allocated_gib']:.2f} GiB")

        def judge(messages):
            score = len(messages[1]["content"]) % 6
            return f"{{'pred': '{'yes' if score > 2 else 'no'}', 'score': {score}}}"

        scores = {name: gpt_eval.evaluate(rubric, str(pred), str(root / f"judge-{name}"), judge,
                                          workers=2)
                  for name, rubric, pred in (
                      ("videoqa", "activitynet_qa", root / "sequential" / "videoqa.json"),
                      ("vcg-general", "correctness", root / "vcg" / "general.json"))}
        if any(r["count"] != QA_CLIPS for r in scores.values()):
            raise AssertionError(f"[qabench] fake-judge scores {scores}")
        out["fake_judge"] = scores
        print(f"[qabench] gpt_eval with an offline fake judge: {json.dumps(scores)}")
    return out


def _time_prefills(times: dict):
    """Record the device time of every _prefill and _prefill_delta call
    (synchronized on both sides) from here on, each under its own name in
    ``times``; returns an undo function."""
    from stllm_tpu_torch.models import generation

    real = {n: getattr(generation, n) for n in ("_prefill", "_prefill_delta")}

    def timed(name, fn):
        def wrap(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, **kw)
            torch.cuda.synchronize()
            times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            return result
        return wrap

    for name, fn in real.items():
        setattr(generation, name, timed(name, fn))
    return lambda: [setattr(generation, n, fn) for n, fn in real.items()]


def _session_turns(kernels, chat, clip_name: str, label: str, turns: int, max_new: int,
                   max_len: int = 2048) -> dict:
    """A chat of ``turns`` turns over one clip (CONV_VIDEO_Vicuna0: the
    prompt holds the whole history) with kv_session=PrefixSession, greedy,
    ``max_new`` new tokens a turn; beside each turn, solo generate on the
    same prompt (a copy of the conversation). Every session turn must be
    served by the session (it sets ``last_reused`` and keeps a cache: Chat
    falls back to solo generate on UnsupportedRequest), turn 1 with one
    fresh _prefill, later turns with one _prefill_delta and no _prefill,
    reusing at least the system text and the video block."""
    from stllm_tpu_torch.conversation import CONV_VIDEO_Vicuna0
    from stllm_tpu_torch.models.generation import PrefixSession

    sess = PrefixSession(chat.params["llama"], chat.cfg.llama, max_len=max_len)
    conv, imgs = CONV_VIDEO_Vicuna0.copy(), []
    chat.upload_video(clip_name, conv, imgs, FRAMES, "what is in the video ?")
    video_end = len(chat._context_segment_ids(conv, imgs)[0]) + imgs[0].shape[1]
    rows = []
    for turn in range(turns):
        chat.ask(f"question {turn} : what happens next ?", conv)
        solo_conv = conv.copy()
        probe = conv.copy()
        probe.append_message(probe.roles[1], None)
        row = {"turn": turn + 1, "prompt": sum(map(len, chat._context_segment_ids(probe, imgs)))
               + imgs[0].shape[1]}
        for route, kw in (("session", {"kv_session": sess}), ("solo", {})):
            times = {"_prefill": [], "_prefill_delta": []}
            sess.last_reused = -1
            undo = _time_prefills(times)
            torch.cuda.synchronize()
            kernels.reset_launches()
            FORWARD_CALLS[0] = 0
            t0 = time.perf_counter()
            try:
                _, tokens = chat.answer(conv if route == "session" else solo_conv, imgs,
                                        max_new_tokens=max_new, do_sample=False, **kw)
                torch.cuda.synchronize()
            finally:
                undo()
            row[f"{route}_total_ms"] = (time.perf_counter() - t0) * 1e3
            calls = {n: len(v) for n, v in times.items()}
            want = ({"_prefill": 0, "_prefill_delta": 1} if route == "session" and turn
                    else {"_prefill": 1, "_prefill_delta": 0})
            if calls != want:
                raise AssertionError(f"[{label}] turn {turn + 1}, {route}: prefill calls "
                                     f"{calls}, want {want}")
            row[f"{route}_prefill_ms"] = sum(times["_prefill"] + times["_prefill_delta"])
            row[f"{route}_prefill_calls"] = calls
            row[f"{route}_tokens"] = [int(t) for t in tokens]
            row[f"{route}_llama_forwards"] = FORWARD_CALLS[0]
            if route == "session":
                if sess.last_reused < 0 or sess.cache is None:
                    raise AssertionError(f"[{label}] turn {turn + 1} fell back to solo generate "
                                         f"(last_reused {sess.last_reused})")
                row.update(reused=sess.last_reused, launches=dict(kernels.LAUNCHES),
                           form_launches=dict(kernels.FORM_LAUNCHES),
                           session_cache_width=sess.cache.k[0].shape[1])
        row["tokens_agree"] = row["session_tokens"] == row["solo_tokens"]
        if turn and row["reused"] < video_end:
            raise AssertionError(f"[{label}] turn {turn + 1} reused {row['reused']} positions, "
                                 f"fewer than the {video_end} up to the video block's end")
        rows.append(row)
        print(f"[{label}] turn {turn + 1}: prompt {row['prompt']} tokens, reused "
              f"{row['reused']}; session (cache width {row['session_cache_width']}) prefill "
              f"{row['session_prefill_ms']:.2f} ms, total "
              f"{row['session_total_ms']:.2f} ms; solo generate prefill "
              f"{row['solo_prefill_ms']:.2f} ms, total {row['solo_total_ms']:.2f} ms; tokens "
              f"agree: {row['tokens_agree']}")
    cache = sess.cache
    return {"mode": label, "turns": rows, "video_block_end": video_end,
            "kv_cache": {"dtype": str(cache.k[0].dtype).replace("torch.", ""),
                         "scales": cache.k_scale is not None, "width": cache.k[0].shape[1]},
            "launches": rows[-1]["launches"], "form_launches": rows[-1]["form_launches"]}


def phase_prefix(kernels, model) -> dict:
    """A three-turn chat over one clip on the full-width QA model with a
    PrefixSession, greedy, PREFIX_MAX_NEW new tokens a turn, beside solo
    generate on each turn's prompt."""
    with tempfile.TemporaryDirectory() as tmp:
        _, clips = _qa_set(Path(tmp), model.cfg.vit.image_size, seed=17)
    chat = _clip_chat(model.params, model.cfg, model.llama_tokenizer, model.qformer_tokenizer,
                      clips)
    out = _session_turns(kernels, chat, "clip0.mp4", "prefix", PREFIX_TURNS, PREFIX_MAX_NEW)
    if any(t["launches"]["packed_qkv_attention"] for t in out["turns"]):
        raise AssertionError("[prefix] a turn re-encoded the video")
    return out


# ---------------------------------------------------------------------------
# serving breadth: merged encodes, sampled streams, shared prefixes,
# AnswerService, speculative serving and H2O
# ---------------------------------------------------------------------------

PACKED_CALLS = collections.Counter()   # (kernel, rows, sequence length) of #1 and #3 calls
# #1 launches per video by sequence length under the "mild" level: 13 trunk
# blocks at each of 257, 192 and 144 tokens, the branch's 3 spatial layers at
# 257 and its 3 temporal ones over the 16 frames
MILD_LENGTHS = {16: 3, 144: 13, 192: 13, 257: 16}
PREFIX_KEY_PLAN = [("A0", "A", 0), ("A1", "A", 1), ("A2", "A", 2), ("B0", "B", 0),
                   ("B1", "B", 1), ("B2", "B", 2), ("A0-again", "A", 0), ("C0", "C", 0)]
SERVICE_PROMPTS = (300, 280, 320, 260)   # AnswerService prompts; the odd ones sampled
SPEC_K, SPEC_ROUNDS, SPEC_DRAFT_LAYERS = 4, 4, 4
# the t_aggressive level on the plain ViT-g (16 frames): #3 launches by
# (rows, sequence length), blocks 0-5, 6-15, 16-27 and 28-38
FOLDED_S8 = {(16, 257): 6, (8, 288): 10, (4, 288): 12, (2, 320): 11}


def record_packed_shapes(kernels) -> None:
    """Count every call of #1's and #3's wrappers (the attention dispatch
    calls them through the kernels module's names) by (kernel, rows,
    sequence length) in PACKED_CALLS from here on. The launch counters
    stay the wrappers' own; this only sorts the calls by shape."""
    for name in ("packed_qkv_attention", "packed_qkv_attention_s8"):
        def wrap(qkv, *args, _real=getattr(kernels, name), _name=name):
            PACKED_CALLS[(_name, qkv.shape[0], qkv.shape[1])] += 1
            return _real(qkv, *args)
        setattr(kernels, name, wrap)


def _lengths(name: str) -> dict:
    """{sequence length: calls} of kernel ``name`` in PACKED_CALLS."""
    out = collections.Counter()
    for (n, _, s), c in PACKED_CALLS.items():
        if n == name:
            out[s] += c
    return dict(sorted(out.items()))


def _encode_calls(counts: dict):
    """Count pipeline_serving's encode_img calls from here on; returns an
    undo function."""
    from stllm_tpu_torch import pipeline_serving

    real = pipeline_serving.encode_img

    def wrap(*args, **kw):
        counts["encode_img"] = counts.get("encode_img", 0) + 1
        return real(*args, **kw)

    pipeline_serving.encode_img = wrap
    return lambda: setattr(pipeline_serving, "encode_img", real)


def _gen_cfg(n: int, **kw):
    """``n`` new tokens, no stop, prompts padded to 8 (greedy unless ``kw``
    asks for sampling)."""
    from stllm_tpu_torch.models.generation import GenerationConfig

    return GenerationConfig(max_new_tokens=n, stop_sequences=(), eos_token_id=-1,
                            pad_to_multiple=8, **kw)


def _tiny_decoding(llama, lcfg, draft, dcfg, device) -> dict:
    """The tiny fp32 LLaMA's breadth routes on one device: greedy tokens of
    the batcher with a shared prefix, of the batcher in speculative mode
    (a random draft, then the target as its own draft) and of H2O with
    eviction; and each sampled stream served busy (beside
    greedy and sampled co-tenants), alone, and by solo generate."""
    from stllm_tpu_torch.models.generation import _pad_prompt, _prefill, generate
    from stllm_tpu_torch import serving
    from stllm_tpu_torch.models.h2o import h2o_decode_chunk_greedy, h2o_prefill
    from stllm_tpu_torch.serving import ContinuousBatcher

    llama, draft = _tree_to(llama, device), _tree_to(draft, device)
    rng = np.random.default_rng(8)

    def emb(s):
        return torch.from_numpy(rng.standard_normal((1, s, lcfg.hidden)) * 0.3).float().to(device)

    out = {}
    # the stored prefix as wide as the admit pads it (13 + pad(3) = 21): the
    # pad is no wider than the buffers, and the admit must still copy them
    pre, sufs = emb(13), [emb(3), emb(6)]
    pemb, pmask = _pad_prompt(pre, torch.ones((1, 13), dtype=torch.int32, device=device), 8)
    _, pkv = _prefill(llama, pemb, pmask, lcfg, 21)
    kept = [t.clone() for t in pkv.k + pkv.v]
    cb = ContinuousBatcher(llama, lcfg, slots=2, max_len=64, chunk=4)
    for i, suf in enumerate(sufs):
        cb.submit(i, suf, _gen_cfg(9), prefix=pkv, prefix_len=13)
    got = cb.run()
    if not all(torch.equal(a, b) for a, b in zip(kept, pkv.k + pkv.v)):
        raise AssertionError(f"[breadth] tiny {device}: an admit wrote the stored prefix")
    out["prefix"] = [got[i] for i in range(len(sufs))]
    solo = [generate(llama, torch.cat([pre, suf], dim=1), llama_cfg=lcfg, gen=_gen_cfg(9))[0]
            for suf in sufs]
    if out["prefix"] != solo:
        raise AssertionError(f"[breadth] tiny {device}: prefix-shared tokens differ from "
                             "generate on the whole prompt")

    prompts = [emb(s) for s in (5, 11, 7)]
    cb = ContinuousBatcher(llama, lcfg, slots=2, max_len=64, chunk=4, draft_params=draft,
                           draft_cfg=dcfg, spec_k=3, spec_rounds=2)
    for i, p in enumerate(prompts):
        cb.submit(i, p, _gen_cfg(12))
    got = cb.run()
    out["speculative"] = [got[i] for i in range(len(prompts))]
    solo = [generate(llama, p, llama_cfg=lcfg, gen=_gen_cfg(12))[0] for p in prompts]
    if out["speculative"] != solo:
        raise AssertionError(f"[breadth] tiny {device}: speculative serving differs from greedy")
    # the draft equal to the target accepts every proposal (count k + 1 a
    # round): the commit of whole rounds and the stale draft tail the next
    # round covers, which the random draft above hardly reaches
    counts, real_rounds = [], serving._spec_rounds
    cb = ContinuousBatcher(llama, lcfg, slots=2, max_len=64, chunk=4, draft_params=llama,
                           draft_cfg=lcfg, spec_k=3, spec_rounds=2)

    def spec_rounds(*args, **kw):
        active = [r is not None for r in cb.active]
        result = real_rounds(*args, **kw)
        counts.append(result[4][:, active].flatten().cpu())
        return result

    for i, p in enumerate(prompts):
        cb.submit(i, p, _gen_cfg(12))
    serving._spec_rounds = spec_rounds
    try:
        got = cb.run()
    finally:
        serving._spec_rounds = real_rounds
    out["speculative_self"] = [got[i] for i in range(len(prompts))]
    accepted = float(torch.cat(counts).double().mean()) - 1
    if out["speculative_self"] != solo or accepted != 3:
        raise AssertionError(f"[breadth] tiny {device}: with the draft equal to the target, "
                             f"tokens {out['speculative_self']} (greedy {solo}), mean accepted "
                             f"{accepted} a round, want 3")

    x = torch.cat([emb(11), emb(11)])
    mask = torch.ones((2, 11), dtype=torch.int32, device=device)
    mask[1, 7:] = 0
    hidden, cache = h2o_prefill(llama, x, mask, lcfg, budget=8, recent=3)
    from stllm_tpu_torch.models.llama import lm_head

    last = hidden[torch.arange(2, device=device), (mask.sum(-1) - 1).long()][:, None]
    first = torch.argmax(lm_head(llama, last)[:, 0], dim=-1).to(torch.int32)
    toks, _ = h2o_decode_chunk_greedy(llama, first, cache, lcfg, 10)
    out["h2o"] = toks.cpu().tolist()

    sampled = _gen_cfg(10, do_sample=True, top_p=0.85, temperature=0.9)
    busy = ContinuousBatcher(llama, lcfg, slots=3, max_len=64, chunk=4)
    plan = [(0, prompts[0], sampled, 5), (1, prompts[1], _gen_cfg(8), 0),
            (2, prompts[2], sampled, 9)]
    for rid, p, g, seed in plan:
        busy.submit(rid, p, g, seed=seed)
    busy_out = busy.run()
    for rid, p, g, seed in plan[::2]:
        idle = ContinuousBatcher(llama, lcfg, slots=3, max_len=64, chunk=4)
        idle.submit(rid, p, g, seed=seed)
        alone = idle.run()[rid]
        solo = generate(llama, p, llama_cfg=lcfg, gen=g, seed=seed)[0]
        if not busy_out[rid] == alone == solo:
            raise AssertionError(f"[breadth] tiny {device}: sampled stream {rid}: busy "
                                 f"{busy_out[rid]}, alone {alone}, solo generate {solo}")
    out["sampled"] = [busy_out[0], busy_out[2]]
    return out


def check_small_breadth(kernels) -> dict:
    """The tiny fp32 model (#1's fp32 form), card against CPU: a merged and
    folded ViT encode (values within FP32_TINY_REL, origin maps equal), a
    merged BTAdapter encode, and greedy tokens through the batcher with a
    shared prefix, in speculative mode (a random 1-layer draft, and the
    target as its own draft, which accepts every proposal) and through H2O
    with eviction, identical on both devices. Sampled streams differ
    between devices (their generators do): on each device every sampled
    stream served busy equals the same request alone and solo generate."""
    from stllm_tpu_torch.models.btadapter import btadapter_forward
    from stllm_tpu_torch.models.llama import init_llama
    from stllm_tpu_torch.models.vit import normalize_uint8, vit_forward
    from stllm_tpu_torch.models.zoo import STLLM

    torch.backends.cuda.matmul.allow_tf32 = False
    model = STLLM.from_config(_fp32_tiny_cfg(num_layers=2), seed=3, device="cpu")
    cfg, params = model.cfg, model.params
    card = _tree_to(params, "cuda")
    frames, _ = _tiny_inputs()
    images = normalize_uint8(frames[0], cfg.vit.dtype)
    out = {}
    before = dict(kernels.LAUNCHES)
    vit_cfg = dataclasses.replace(cfg.vit, temporal_schedule=((1, 2, 24),),
                                  merge_schedule=((2, 16), (3, 10)))
    want, w_origin = vit_forward(params["vit"], images, vit_cfg, return_merge_origin=True,
                                 num_frames=frames.shape[1])
    got, g_origin = vit_forward(card["vit"], images.cuda(), vit_cfg, return_merge_origin=True,
                                num_frames=frames.shape[1])
    if not torch.equal(g_origin.cpu(), w_origin):
        raise AssertionError("[breadth] tiny merged ViT: the card's origin map differs")
    out["vit_merged_rel_l2"] = _rel(got, want, "merged and folded ViT encode")
    bt_cfg = dataclasses.replace(cfg.vit, merge_schedule=((1, 12), (2, 8)))
    out["btadapter_merged_rel_l2"] = _rel(
        btadapter_forward(card["vit"], images.cuda(), bt_cfg, frames.shape[1]),
        btadapter_forward(params["vit"], images, bt_cfg, frames.shape[1]),
        "merged BTAdapter encode")
    torch.cuda.synchronize()
    out["launches"] = _ran(kernels, before, ["packed_qkv_attention"])

    lcfg = cfg.llama
    dcfg = dataclasses.replace(lcfg, num_layers=1)
    draft = init_llama(torch.Generator().manual_seed(7), dcfg)
    routes = {dev: _tiny_decoding(params["llama"], lcfg, draft, dcfg, dev)
              for dev in ("cpu", "cuda")}
    greedy = ("prefix", "speculative", "speculative_self", "h2o")
    for route in greedy:
        if routes["cuda"][route] != routes["cpu"][route]:
            raise AssertionError(f"[breadth] tiny {route} tokens: card {routes['cuda'][route]}, "
                                 f"CPU {routes['cpu'][route]}")
    out["greedy_tokens"] = {r: routes["cuda"][r] for r in greedy}
    out["sampled_tokens"] = {dev: r["sampled"] for dev, r in routes.items()}
    return out


def _breadth_mild(kernels, model) -> dict:
    """The full-width QA model under the "mild" level serves the 6
    requests: 45 #1 launches a video, by sequence length MILD_LENGTHS, no
    plain #1 call; the merged and the unmerged encode timed in this call
    (unmerged, merged, merged, unmerged)."""
    from stllm_tpu_torch.ops.tome import level_kwargs
    from stllm_tpu_torch.pipeline_serving import _encode_assemble

    cfg = model.cfg
    mild = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, **level_kwargs("mild")))
    reqs = make_requests(cfg)
    plain = {}
    undo = _count_plain_attention(plain)
    try:
        out = serve(kernels, model.params, mild, reqs, "breadth-mild")
    finally:
        undo()
    _expect("breadth-mild", out["launches"], {"packed_qkv_attention": 45,
                                              "packed_qkv_attention_s8": 0}, NUM_REQUESTS)
    want = {s: n * NUM_REQUESTS for s, n in MILD_LENGTHS.items()}
    if out["packed_lengths"]["packed_qkv_attention"] != want or plain:
        raise AssertionError(f"[breadth-mild] #1 launches by length "
                             f"{out['packed_lengths']['packed_qkv_attention']}, want {want}; "
                             f"plain calls {plain}")
    _, frames, pre, suf, q = reqs[0]
    args = [torch.as_tensor(a, device="cuda") for a in (frames, pre, suf, q)]
    args[1:] = [a.int() for a in args[1:]]
    args.append(torch.ones_like(args[3]))
    with torch.no_grad():
        t = [cuda_ms(lambda c=c: _encode_assemble(model.params, *args, c), 3, warmup=1)
             for c in (cfg, mild, mild, cfg)]
    out["encode_ms_unmerged"], out["encode_ms_mild"] = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    print(f"[breadth-mild] encode a video: unmerged {out['encode_ms_unmerged']:.2f} ms, mild "
          f"{out['encode_ms_mild']:.2f} ms (unmerged, mild, mild, unmerged); #1 launches by "
          f"length {out['packed_lengths']['packed_qkv_attention']}")
    return out


def _breadth_prefix_key(kernels, model) -> dict:
    """VideoQAServer with prefix_key on the full-width model: three clips,
    PREFIX_KEY_PLAN's questions, prefix_cache_size=2 (the third key evicts
    one): one encode a key (45 #1 launches each), the repeated question of
    a key answers with the first one's tokens; then a prefix-hit prefill
    (the suffix delta-prefilled on a copy of the stored prefix) timed
    beside a full prefill of the same prompt."""
    from stllm_tpu_torch.models.generation import (
        GenerationConfig, _pad_kv_time, _pad_prompt, _prefill, _prefill_delta)
    from stllm_tpu_torch.pipeline_serving import VideoQAServer, _encode_assemble

    cfg, params = model.cfg, model.params
    rng = np.random.default_rng(23)
    size, vocab = cfg.vit.image_size, cfg.llama.vocab_size
    clips = {k: rng.integers(0, 256, (1, FRAMES, size, size, 3), dtype=np.uint8) for k in "ABC"}
    pre = rng.integers(3, vocab, (1, PREFIX_LEN))
    q = rng.integers(0, cfg.qformer.vocab_size, (1, Q_LEN))
    sufs = [rng.integers(3, vocab, (1, SUFFIX_LEN)) for _ in range(3)]
    gen = GenerationConfig(max_new_tokens=MAX_NEW)
    srv = VideoQAServer(params, cfg, slots=4, max_len=1024, prefix_cache_size=2)
    for rid, key, i in PREFIX_KEY_PLAN:
        srv.submit(rid, clips[key], pre, sufs[i], gen, qformer_text_ids=q, prefix_key=key)
    counts = {}
    undo = _encode_calls(counts)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        answers = srv.run()
        torch.cuda.synchronize()
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    keys = sorted({k for _, k, _ in PREFIX_KEY_PLAN})
    if counts.get("encode_img") != len(keys) \
            or launches["packed_qkv_attention"] != 45 * len(keys):
        raise AssertionError(f"[breadth-prefix-key] {counts} encodes and "
                             f"{launches['packed_qkv_attention']} #1 launches for {len(keys)} "
                             "keys, want one encode (45 launches) a key")
    if set(answers) != {r for r, _, _ in PREFIX_KEY_PLAN} or answers["A0"] != answers["A0-again"] \
            or not all(answers.values()) or len(srv._prefix_lru) != 2:
        raise AssertionError(f"[breadth-prefix-key] answers {answers}, prefix store "
                             f"{list(srv._prefix_lru)}")

    dev = lambda a: torch.as_tensor(a, device="cuda").int()  # noqa: E731
    with torch.no_grad():
        embeds = _encode_assemble(params, torch.as_tensor(clips["A"], device="cuda"), dev(pre),
                                  dev(sufs[0]), dev(q), torch.ones_like(dev(q)), cfg)
        plen = embeds.shape[1] - SUFFIX_LEN
        llama, lcfg = params["llama"], cfg.llama
        ones = lambda n: torch.ones((1, n), dtype=torch.int32, device="cuda")  # noqa: E731
        pemb, pmask = _pad_prompt(embeds[:, :plen], ones(plen), gen.pad_to_multiple)
        _, pkv = _prefill(llama, pemb, pmask, lcfg, pemb.shape[1])
        semb, smask = _pad_prompt(embeds[:, plen:], ones(SUFFIX_LEN), gen.pad_to_multiple)
        femb, fmask = _pad_prompt(embeds, ones(embeds.shape[1]), gen.pad_to_multiple)
        w = max(pkv.k[0].shape[1], plen + semb.shape[1])
        hit_ms = cuda_ms(lambda: _prefill_delta(llama, semb, smask, _pad_kv_time(pkv, w), lcfg),
                         5, warmup=1)
        full_ms = cuda_ms(lambda: _prefill(llama, femb, fmask, lcfg, femb.shape[1]), 5, warmup=1)
    out = {"mode": "breadth-prefix-key", "requests": len(PREFIX_KEY_PLAN), "keys": len(keys),
           "prefix_cache_size": 2, "encodes": counts["encode_img"], "wall_s": wall,
           "launches": launches, "prompt_tokens": embeds.shape[1], "prefix_tokens": plen,
           "prefix_hit_prefill_ms": hit_ms, "full_prefill_ms": full_ms,
           "tokens_per_request": {k: len(v) for k, v in answers.items()}}
    print(f"[breadth-prefix-key] {len(PREFIX_KEY_PLAN)} requests on {len(keys)} keys in "
          f"{wall:.2f} s, {counts['encode_img']} encodes; prefill of a {embeds.shape[1]}-token "
          f"prompt: prefix hit ({plen} shared) {hit_ms:.2f} ms, full {full_ms:.2f} ms")
    return out


def _breadth_service(kernels, model) -> dict:
    """AnswerService over the full-width batcher (slots 4, max_len 1024,
    chunk 16): four threads, two greedy and two sampled requests of
    SERVICE_PROMPTS token embeddings; each answer equals the same request
    served alone by a batcher of the same shape."""
    import threading

    from stllm_tpu_torch.models.generation import GenerationConfig
    from stllm_tpu_torch.ops.layers import gather_rows
    from stllm_tpu_torch.serving import AnswerService, ContinuousBatcher

    llama, lcfg = model.params["llama"], model.cfg.llama
    rng = np.random.default_rng(31)
    reqs = []
    for i, s in enumerate(SERVICE_PROMPTS):
        ids = torch.as_tensor(rng.integers(3, lcfg.vocab_size, (1, s)), device="cuda")
        gen = GenerationConfig(max_new_tokens=MAX_NEW, do_sample=bool(i % 2), top_p=0.9)
        reqs.append((gather_rows(llama["embed_tokens"], ids).to(lcfg.dtype), gen, 100 + i))

    def batcher():
        return ContinuousBatcher(llama, lcfg, slots=4, max_len=1024, chunk=16)

    alone = []
    for emb, gen, seed in reqs:
        cb = batcher()
        cb.submit(0, emb, gen, seed=seed)
        alone.append(cb.run()[0])
        del cb
    svc = AnswerService(batcher())
    got, errs = [None] * len(reqs), []

    def call(i):
        try:
            got[i] = svc.answer(reqs[i][0], reqs[i][1], seed=reqs[i][2])
        except Exception as e:  # reported below
            errs.append((i, repr(e)))

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    svc.close()
    if errs or got != alone:
        raise AssertionError(f"[breadth-service] errors {errs}; answers equal alone: "
                             f"{[g == a for g, a in zip(got, alone)]}")
    out = {"mode": "breadth-service", "threads": len(reqs), "wall_s": wall,
           "tokens": sum(map(len, got)), "sampled": [bool(i % 2) for i in range(len(reqs))]}
    print(f"[breadth-service] {len(reqs)} threads (2 greedy, 2 sampled) answered in "
          f"{wall:.2f} s, {out['tokens']} tokens, each equal to the request served alone")
    return out


def phase_breadth(kernels, model) -> dict:
    """The slice's serving breadth on the tiny model (card against CPU) and
    on the full-width QA model: the "mild" merge level, prefix_key
    sharing and AnswerService."""
    t0 = time.perf_counter()
    tiny = check_small_breadth(kernels)
    print(f"[breadth] tiny fp32 model, card vs CPU: {json.dumps(tiny)}")
    out = {"tiny": tiny, "mild": _breadth_mild(kernels, model),
           "prefix_key": _breadth_prefix_key(kernels, model),
           "service": _breadth_service(kernels, model), "phase_s": time.perf_counter() - t0}
    print(f"[breadth] phase took {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# weights in the reference's formats, loaded through STLLM.from_config
# ---------------------------------------------------------------------------

LOAD_SEED, LOAD_INIT_SEED = 7, 8   # the written weights; the loaded model's own random init
LOAD_SHARDS = 2                    # vicuna-7b-v1.1's pytorch_model-0000k-of-00002.bin layout
LOAD_NEW_TOKENS = 32
LOAD_WIDTHS = (1408, 4096, 32)     # ViT-g width, Vicuna-7B width and depth: nothing cut
LOAD_FAMILIES = ("vit", "qformer", "llama", "ckpt")
# the top-level from_torch calls of STLLM._load_weights, in order, per family
LOAD_CALLS = [("load_torch_file", "vit"), ("convert_btadapter", "vit"),
              ("load_torch_file", "qformer"), ("convert_qformer", "qformer"),
              ("load_sharded_hf", "llama"), ("convert_hf_llama", "llama"),
              ("load_torch_file", "ckpt"), ("overlay_stllm_checkpoint", "ckpt")]
FILE_DTYPE_LEAVES = ("ln_vision/", "llama_proj/")   # overlay_stllm_checkpoint keeps the file's dtype


def _rss_gib() -> float:
    """This process's resident set now (/proc/self/statm), GiB."""
    import os

    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2 ** 30


def _peak_rss_gib() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def _timed_calls(owner, names, log: list):
    """Wrap the functions ``names`` of a module or class so each top-level
    call (not the wrapped functions it calls in turn) appends (name,
    seconds, card synchronized); returns the undo."""
    real = {n: vars(owner)[n] for n in names}
    depth = [0]

    def wrap(name):
        fn = getattr(owner, name)

        def timed(*args, **kw):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                depth[0] -= 1
                if not depth[0]:
                    torch.cuda.synchronize()
                    log.append((name, time.perf_counter() - t0))
        return staticmethod(timed) if isinstance(real[name], staticmethod) else timed

    for n in names:
        setattr(owner, n, wrap(n))
    return lambda: [setattr(owner, n, f) for n, f in real.items()]


def _write_reference_files(params, root: Path) -> tuple:
    """``params`` in the reference's formats, fp16 as the released files
    are: eva_vit_g.pth (LAVIS names with the BTAdapter_* keys), an
    instruct_blip_vicuna7b_trimmed.pth-style file under "model" (Q-Former,
    query_tokens, ln_vision, llm_proj) and a vicuna-7b-v1.1-style directory
    of LOAD_SHARDS .bin shards. Returns the config's paths, and per family
    the bytes written and the seconds (export to the host and write)."""
    from stllm_tpu_torch.convert import to_reference as ref

    fp16 = torch.float16
    paths = {"vit_model_path": root / "eva_vit_g.pth",
             "q_former_model": root / "instruct_blip_vicuna7b_trimmed.pth",
             "llama_model": root / "vicuna-7b-v1.1"}
    write_s, nbytes = {}, {}
    t0 = time.perf_counter()
    torch.save(ref.eva_vit_state(params["vit"], fp16), str(paths["vit_model_path"]))
    write_s["vit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    blip = ref.stllm_state({k: params[k] for k in ("ln_vision", "qformer", "llama_proj")}, fp16)
    torch.save({"model": blip}, str(paths["q_former_model"]))
    write_s["qformer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    shards = ref.save_hf_shards(ref.hf_llama_state(params["llama"], fp16),
                                str(paths["llama_model"]), LOAD_SHARDS)
    write_s["llama"] = time.perf_counter() - t0
    nbytes["vit"] = paths["vit_model_path"].stat().st_size
    nbytes["qformer"] = paths["q_former_model"].stat().st_size
    nbytes["llama"] = sum(Path(p).stat().st_size for p in shards)
    paths = {k: str(v) for k, v in paths.items()}
    paths["ckpt"] = paths["q_former_model"]   # as the QA config names it
    return paths, nbytes, write_s


def _round_trip_fp16(params, written) -> None:
    """The in-memory model: each leaf the files hold replaced, in place, by
    its fp16 value in the leaf's own dtype."""
    def walk(node, path=""):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            p = f"{path}/{k}" if path else str(k)
            if isinstance(v, (dict, list)):
                walk(v, p)
            elif v is not None and written(p):
                node[k] = v.to(torch.float16).to(v.dtype)

    walk(params)


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def phase_load(kernels) -> dict:
    """The QA config at full width (EVA-ViT-g with BTAdapter depth 3, the
    InstructBLIP Q-Former, Vicuna-7B at full depth, bf16) written from
    seeded weights into the reference's files in a temporary directory,
    loaded by STLLM.from_config on the card from a different random init
    (so every leaf the files hold must be replaced), every such leaf bit
    for bit the written fp16 tensor in the dtype the loader gives it (the
    config's; the file's for ln_vision and llama_proj), then one 16-frame
    question answered greedily through STLLM.chat: exactly 45 #1 launches,
    the tokens equal to those of the same weights built in memory. Prints
    the bytes written, write and load seconds and GB/s per family, host
    RSS and the device peak."""
    from stllm_tpu_torch.conversation import CONV_instructblip_Vicuna0
    from stllm_tpu_torch.convert import from_torch as cvt
    from stllm_tpu_torch.models import zoo
    from stllm_tpu_torch.models.zoo import STLLM, ensure_tokenizers
    from stllm_tpu_torch.train.step import tree_paths

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rss0, peak0 = _rss_gib(), _peak_rss_gib()
    base = qa_model_cfg()
    mem = STLLM.from_config(base, seed=LOAD_SEED)
    cfg = mem.cfg
    if (cfg.vit.width, cfg.llama.hidden, cfg.llama.num_layers) != LOAD_WIDTHS:
        raise AssertionError(f"[load] not the full-width QA config: {cfg}")
    root = Path(tempfile.mkdtemp(prefix="stllm_load_"))
    try:
        need = sum(t.numel() * 2 for _, t in tree_paths(mem.params))
        free = shutil.disk_usage(root).free
        if free < 1.1 * need:
            raise AssertionError(f"[load] {free / 1e9:.1f} GB free under {root}, the files "
                                 f"need {need / 1e9:.1f} GB")
        paths, nbytes, write_s = _write_reference_files(mem.params, root)
        rss_written, peak_written = _rss_gib(), _peak_rss_gib()
        print(f"[load] wrote {sum(nbytes.values()) / 1e9:.2f} GB under {root} ({free / 1e9:.0f} "
              f"GB free): {json.dumps({'bytes': nbytes, 'write_s': write_s})}")

        written = lambda p: not p.startswith("mvm_decoder/")  # noqa: E731  (no file holds it)
        _round_trip_fp16(mem.params, written)
        log, steps = [], []
        undo = [_timed_calls(cvt, sorted({n for n, _ in LOAD_CALLS} | {"convert_eva_vit"}), log),
                _timed_calls(zoo, ["init_stllm"], steps),
                _timed_calls(STLLM, ["_load_llama_tokenizer", "_load_bert_tokenizer"], steps)]
        t0 = time.perf_counter()
        try:
            model = STLLM.from_config({**base, **paths}, seed=LOAD_INIT_SEED)
            torch.cuda.synchronize()
        finally:
            for u in undo:
                u()
        from_config_s = time.perf_counter() - t0
        load_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        rss_loaded, peak_loaded = _rss_gib(), _peak_rss_gib()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if [n for n, _ in log] != [n for n, _ in LOAD_CALLS]:
        raise AssertionError(f"[load] from_torch calls {[n for n, _ in log]}, "
                             f"want {[n for n, _ in LOAD_CALLS]}")
    load_s = dict.fromkeys(LOAD_FAMILIES, 0.0)
    for (_, family), (_, s) in zip(LOAD_CALLS, log):
        load_s[family] += s
    nbytes["ckpt"] = nbytes["qformer"]

    got, want = dict(tree_paths(model.params)), dict(tree_paths(mem.params))
    if got.keys() != want.keys():
        raise AssertionError(f"[load] tree paths differ: {sorted(set(got) ^ set(want))[:10]}")
    unwritten = sorted(p for p in got if not written(p))
    if unwritten != ["mvm_decoder/head/b", "mvm_decoder/head/w", "mvm_decoder/norm/bias",
                     "mvm_decoder/norm/scale"]:
        raise AssertionError(f"[load] leaves no file holds: {unwritten}")
    bad = []
    for p, leaf in got.items():
        if not written(p):
            continue
        dtype = torch.float16 if p.startswith(FILE_DTYPE_LEAVES) else cfg.llama.dtype
        if not _bit_equal(leaf, want[p].to(torch.float16).to(dtype)):
            bad.append((p, str(leaf.dtype), tuple(leaf.shape)))
    if bad:
        raise AssertionError(f"[load] {len(bad)} loaded leaves differ from the files: {bad[:10]}")
    n_leaves = len(got) - len(unwritten)
    print(f"[load] {n_leaves} loaded leaves bit for bit the written tensors "
          f"(fp16 files, {cfg.llama.dtype} tree; ln_vision and llama_proj fp16)")

    clip = np.random.default_rng(LOAD_SEED).integers(0, 256, (FRAMES, cfg.vit.image_size,
                                                              cfg.vit.image_size, 3), np.uint8)
    question = "What is happening in this video?"

    def answer(m):
        ensure_tokenizers(m, warn=False)
        chat, conv, img_list = m.chat(cfg.vit.image_size), CONV_instructblip_Vicuna0.copy(), []
        chat.upload_video(clip, conv, img_list, num_frame=FRAMES, text=question)
        chat.ask(question, conv)
        return chat.answer(conv, img_list, max_new_tokens=LOAD_NEW_TOKENS, do_sample=False)[1]

    run = _route_run(kernels, "load", lambda: answer(model), BF16_PER_VIDEO, 1)
    tokens = run["result"]
    want_tokens = answer(mem)
    if len(tokens) == 0 or not np.array_equal(tokens, want_tokens):
        raise AssertionError(f"[load] loaded model's tokens {tokens.tolist()} != in-memory "
                             f"{want_tokens.tolist()}")
    del model, mem
    gb_s = {f: nbytes[f] / load_s[f] / 1e9 for f in LOAD_FAMILIES}
    out = {"mode": "load", "launches": run["launches"], "form_launches": run["form_launches"],
           "vicuna_layers": cfg.llama.num_layers, "vicuna_depth_cut": None,
           "bytes": nbytes, "write_s": write_s, "load_s": load_s, "load_gb_per_s": gb_s,
           "from_config_s": from_config_s, "calls": log, "other_calls": steps,
           "leaves_bit_equal": n_leaves,
           "tokens": len(tokens), "answer_s": run["wall_s"],
           "host_rss_gib": {"start": rss0, "written": rss_written, "loaded": rss_loaded},
           "host_peak_rss_gib": {"start": peak0, "written": peak_written,
                                 "loaded": peak_loaded},
           "max_memory_allocated_gib": {"load": load_peak_gib,
                                        "answer": torch.cuda.max_memory_allocated() / 2 ** 30},
           "phase_s": time.perf_counter() - t_phase}
    print(f"[load] {json.dumps(out)}")
    print(f"[load] {sum(nbytes[f] for f in ('vit', 'qformer', 'llama')) / 1e9:.2f} GB in the "
          f"reference's fp16 files, full depth (no cut): from_config {from_config_s:.1f} s, "
          + ", ".join(f"{f} {load_s[f]:.2f} s ({gb_s[f]:.2f} GB/s)" for f in LOAD_FAMILIES)
          + f"; {len(tokens)} greedy tokens equal to the in-memory model's, 45 #1 launches; "
          f"host RSS {rss_loaded:.1f} GiB (peak {peak_loaded:.1f}), device peak "
          f"{load_peak_gib:.1f} GiB through the load; phase {out['phase_s']:.1f} s "
          f"({smi_line()})")
    return out


def phase_w4_spec(kernels, params, cfg, draft=None, label: str = "w4a16-spec") -> dict:
    """Speculative serving on the W4A16 stack (phase_w4a16's params): the
    draft is a same-width tower of the target's first SPEC_DRAFT_LAYERS
    layers with its embedding, norm and head, or ``draft`` (params, cfg);
    slots 4, spec_k SPEC_K, SPEC_ROUNDS rounds a step, four requests of 32
    new tokens. #12 launches exactly 128 times a target forward (a verify
    forward at M = slots x (spec_k + 1) = 20 on its wgmma form) and once a
    draft forward for each int4 linear of the draft (16 for the cut draft,
    none for a dense one: a proposal step at M = 4 on its decode form).
    Prints the mean accepted tokens a round, ms a round and the share of
    tokens that agree with plain greedy serving (bf16 is not held across
    program shapes)."""
    from stllm_tpu_torch import serving
    from stllm_tpu_torch.models import generation, speculative
    from stllm_tpu_torch.ops.layers import gather_rows

    llama, lcfg = params["llama"], cfg.llama
    if draft is None:
        draft = {k: llama[k] for k in ("embed_tokens", "norm", "lm_head")}
        draft["layers"] = llama["layers"][:SPEC_DRAFT_LAYERS]
        dcfg = dataclasses.replace(lcfg, num_layers=SPEC_DRAFT_LAYERS)
    else:
        draft, dcfg = draft
    per_draft = sum(isinstance(p, dict) and "w4" in p for layer in draft["layers"]
                    for p in layer.values())
    t_phase = time.perf_counter()
    rng = np.random.default_rng(37)
    prompts = [gather_rows(llama["embed_tokens"], torch.as_tensor(
        rng.integers(3, lcfg.vocab_size, (1, s)), device="cuda")).to(lcfg.dtype)
        for s in SERVICE_PROMPTS]
    gen = _gen_cfg(W4_BEAM_MAX_NEW)
    forwards, rounds = collections.Counter(), []
    real = {(speculative, "llama_forward"): speculative.llama_forward,
            (generation, "llama_forward"): generation.llama_forward,
            (serving, "_spec_rounds"): serving._spec_rounds}

    def forward(mod):
        def wrap(p, **kw):
            ids = kw.get("input_ids")
            x = ids if ids is not None else kw["inputs_embeds"]
            role = "target" if p is llama else "draft"
            forwards[(mod.__name__.rsplit(".", 1)[-1], role, x.shape[0] * x.shape[1])] += 1
            return real[(mod, "llama_forward")](p, **kw)
        return wrap

    cb = serving.ContinuousBatcher(llama, lcfg, slots=4, max_len=1024, chunk=16,
                                   draft_params=draft, draft_cfg=dcfg, spec_k=SPEC_K,
                                   spec_rounds=SPEC_ROUNDS)

    def spec_rounds(*args, **kw):
        active = [r is not None for r in cb.active]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = real[(serving, "_spec_rounds")](*args, **kw)
        torch.cuda.synchronize()
        rounds.append(((time.perf_counter() - t0) * 1e3, result[4].cpu(), active))
        return result

    for i, p in enumerate(prompts):
        cb.submit(i, p, gen)
    speculative.llama_forward = forward(speculative)
    generation.llama_forward = forward(generation)
    serving._spec_rounds = spec_rounds
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        got = cb.run()
        torch.cuda.synchronize()
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
    wall = time.perf_counter() - t0
    launches, forms = dict(kernels.LAUNCHES), dict(kernels.FORM_LAUNCHES)
    verify = forwards[("speculative", "target", 4 * (SPEC_K + 1))]
    steps = forwards[("speculative", "draft", 4)]
    prefills = {role: sum(n for (mod, r, _), n in forwards.items()
                          if mod == "generation" and r == role) for role in ("target", "draft")}
    want_wgmma = W4A16_LAUNCHES_PER_FORWARD * (verify + prefills["target"]) \
        + per_draft * prefills["draft"]
    if sum(n for (mod, _, _), n in forwards.items() if mod == "speculative") != verify + steps \
            or verify != len(rounds) * SPEC_ROUNDS or steps != verify * (SPEC_K + 1) \
            or prefills != {"target": len(prompts), "draft": len(prompts)} \
            or launches["w4a16_matmul"] != want_wgmma + per_draft * steps \
            or forms["w4a16_matmul/wgmma"] != want_wgmma \
            or forms["w4a16_matmul/decode"] != per_draft * steps \
            or forms["w4a16_matmul/stream"]:
        raise AssertionError(f"[{label}] forwards {dict(forwards)}, W4A16 launches "
                             f"{launches['w4a16_matmul']} by form "
                             f"{ {k: v for k, v in forms.items() if k.startswith('w4a16')} }")
    counts = [c[:, a] for _, c, a in rounds]
    accepted = torch.cat([c.flatten() for c in counts]).float() - 1
    plain = serving.ContinuousBatcher(llama, lcfg, slots=4, max_len=1024, chunk=16)
    for i, p in enumerate(prompts):
        plain.submit(i, p, gen)
    greedy = plain.run()
    same = sum(a == b for i in got for a, b in zip(got[i], greedy[i]))
    total = sum(len(v) for v in greedy.values())
    out = {"mode": label, "requests": len(prompts), "spec_k": SPEC_K,
           "spec_rounds": SPEC_ROUNDS, "draft_layers": dcfg.num_layers,
           "draft_w4_launches_per_forward": per_draft, "wall_s": wall,
           "target_verify_forwards": verify, "draft_steps": steps, "prefills": prefills,
           "launches": launches, "form_launches": forms,
           "mean_accepted_per_round": float(accepted.mean()),
           "ms_per_round": sum(r[0] for r in rounds) / (len(rounds) * SPEC_ROUNDS),
           "tokens_agree_with_greedy": same / total,
           "answers_equal_greedy": sum(got[i] == greedy[i] for i in got),
           "phase_s": time.perf_counter() - t_phase}
    print(f"[{label}] {len(prompts)} requests x {W4_BEAM_MAX_NEW} tokens in {wall:.2f} s: "
          f"{verify} verify forwards (M = {4 * (SPEC_K + 1)}), {steps} draft steps (M = 4), "
          f"{launches['w4a16_matmul']} W4A16 launches; mean accepted "
          f"{out['mean_accepted_per_round']:.3f} a round, {out['ms_per_round']:.2f} ms a round; "
          f"{out['tokens_agree_with_greedy']:.3f} of the tokens agree with plain greedy; phase "
          f"{out['phase_s']:.1f} s")
    return out


def _pipeline_auto(kernels, params, cfg) -> dict:
    """vit.merge_level "auto" on the pipeline stack under FUSED_LN="both":
    a static clip (one frame repeated) resolves to "t_aggressive" and
    encodes with no #11 launch and #3 at the folded lengths FOLDED_S8; an
    iid-noise clip resolves to no merging and encodes with the fused trunk's
    77 #11 launches, #3 at 257 tokens."""
    from stllm_tpu_torch.models.stllm import encode_img, resolve_auto_merge
    from stllm_tpu_torch.ops.tome import MERGE_LEVELS

    auto = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, merge_level="auto"))
    rng = np.random.default_rng(29)
    size = cfg.vit.image_size
    clips = {"static": np.repeat(rng.integers(0, 256, (1, 1, size, size, 3), dtype=np.uint8),
                                 FRAMES, axis=1),
             "noise": rng.integers(0, 256, (1, FRAMES, size, size, 3), dtype=np.uint8)}
    want = {"static": ("t_aggressive", 0, FOLDED_S8),
            "noise": ("off", FUSED_SITES["both"], {(FRAMES, 257): 39})}
    out = {}
    for name, clip in clips.items():
        level, n11, s8 = want[name]
        resolved = resolve_auto_merge(auto, clip)
        sched = {k: getattr(resolved.vit, k) for k in ("merge_schedule", "temporal_schedule")}
        if sched != {"merge_schedule": (), "temporal_schedule": (), **MERGE_LEVELS[level]}:
            raise AssertionError(f"[pipeline-auto] {name} clip resolved to {sched}, want {level}")
        frames = torch.from_numpy(clip).cuda()
        torch.cuda.synchronize()
        kernels.reset_launches()
        PACKED_CALLS.clear()
        with torch.no_grad():
            enc = encode_img(params, frames, resolved)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        by_shape = {(r, s): c for (k, r, s), c in PACKED_CALLS.items()
                    if k == "packed_qkv_attention_s8"}
        if launches["qmm_res_ln"] != n11 or by_shape != s8 \
                or launches["packed_qkv_attention_s8"] != 39 \
                or not bool(torch.isfinite(enc).all()):
            raise AssertionError(f"[pipeline-auto] {name} clip: {launches['qmm_res_ln']} #11 "
                                 f"launches (want {n11}), #3 by (rows, length) {by_shape} "
                                 f"(want {s8}), finite {bool(torch.isfinite(enc).all())}")
        with torch.no_grad():
            ms = cuda_ms(lambda: encode_img(params, frames, resolved), 3, warmup=1)
        out[name] = {"mode": f"pipeline-auto-{name}", "level": level, "launches": launches,
                     "s8_by_shape": {f"{r}x{s}": c for (r, s), c in by_shape.items()},
                     "encode_ms": ms}
        print(f"[pipeline-auto] {name} clip: level {level}, {launches['qmm_res_ln']} #11 "
              f"launches, #3 by (rows, length) {by_shape}, encode {ms:.2f} ms")
        if name == "static":
            out[name]["vs_plain_s8"] = _folded_vs_plain_s8(kernels, params, frames, resolved)
    return out


def _folded_vs_plain_s8(kernels, params, frames, cfg) -> dict:
    """The folded static-clip encode with #3 against the same encode with
    #3's plain version in its place (on the card), as a mean relative gap,
    held to FUSED_GAP_FACTOR times the plain encode's own gap under an input
    moved by one bf16 step (FUSED_GAP_FACTOR's rule for the fused trunk)."""
    from stllm_tpu_torch.models.stllm import encode_img
    from stllm_tpu_torch.models.vit import normalize_uint8

    images = normalize_uint8(frames, cfg.vit.dtype)
    nudged = (images.float() * (1 + 2.0 ** -8)).to(images.dtype)
    real = kernels.packed_qkv_attention_s8
    with torch.no_grad():
        got = encode_img(params, images, cfg).float()
        kernels.packed_qkv_attention_s8 = kernels.packed_qkv_attention_s8_plain
        try:
            want = encode_img(params, images, cfg).float()
            moved = encode_img(params, nudged, cfg).float()
        finally:
            kernels.packed_qkv_attention_s8 = real
    scale = want.abs().mean()
    gap = float((got - want).abs().mean() / scale)
    floor = float((moved - want).abs().mean() / scale)
    rel_l2 = float((got - want).norm() / want.norm())
    print(f"[pipeline-auto] folded static encode, #3 against its plain version: mean gap "
          f"{gap:.4e}, relative L2 {rel_l2:.4e}; the plain encode under a one-bf16-step "
          f"input: {floor:.4e}")
    if not bool(torch.isfinite(got).all()) or gap > FUSED_GAP_FACTOR * floor:
        raise AssertionError(f"[pipeline-auto] the folded encode with #3 is {gap} from the one "
                             f"with #3's plain version, more than {FUSED_GAP_FACTOR} x {floor}")
    return {"mean_rel_gap": gap, "rel_l2": rel_l2, "one_step_floor": floor}


def phase_w4_beams(kernels, params, cfg) -> dict:
    """The W4A16 stack's beam and session routes (phase_w4a16's params: the
    static-int8 ViT, int4 Vicuna-7B with q|k|v and gate|up fused, the int8
    KV cache): one beam-5 answer alone (every decoder matmul #12 at M = 5,
    its decode form), one answer_batched group of 4 (M = 20, its wgmma
    form), and a two-turn PrefixSession. #12 launches exactly 128 times a
    LLaMA forward (llama_forward or llama_decode_prefix), the beams read
    int8 caches with scales, and the session's cache stays int8 with its
    scale planes as it grows."""
    from stllm_tpu_torch.conversation import CONV_instructblip_Vicuna0
    from stllm_tpu_torch.models.zoo import ToyHashTokenizer

    with tempfile.TemporaryDirectory() as tmp:
        _, clips = _qa_set(Path(tmp), cfg.vit.image_size, seed=19)
    tok = ToyHashTokenizer(cfg.llama.vocab_size)
    _name_every_token(tok)
    chat = _clip_chat(params, cfg, tok, ToyHashTokenizer(cfg.qformer.vocab_size, reserve=2),
                      clips)
    per_video = {**STATIC_PER_VIDEO, **{p: 0 for p in PROBES}}
    out = {}

    def upload(i):
        conv, imgs = CONV_instructblip_Vicuna0.copy(), []
        chat.upload_video(f"clip{i}.mp4", conv, imgs, FRAMES, f"what is in clip {i} ?")
        chat.ask(f"what is in clip {i} ?", conv)
        return conv, imgs

    PREFIX_CACHES.clear()
    for label, videos, fn in (
            ("w4a16-beam", 1, lambda: chat.answer(
                *upload(0), num_beams=QA_BEAMS, do_sample=False, system=False,
                max_new_tokens=W4_BEAM_MAX_NEW)[0]),
            ("w4a16-beam-batched", QA_CLIPS, lambda: chat.answer_batched(
                *map(list, zip(*(upload(i) for i in range(QA_CLIPS)))), num_beams=QA_BEAMS,
                max_new_tokens=W4_BEAM_MAX_NEW, system=False))):
        run = _route_run(kernels, label, fn, per_video, videos)
        forms, steps, fwd = run["form_launches"], run["beam_decode_steps"], run["llama_forwards"]
        w4 = run["launches"]["w4a16_matmul"]
        decode_form = W4A16_LAUNCHES_PER_FORWARD * steps if videos == 1 else 0
        if not steps or w4 != W4A16_LAUNCHES_PER_FORWARD * (fwd + steps) \
                or forms["w4a16_matmul/decode"] != decode_form or forms["w4a16_matmul/stream"] \
                or forms["w4a16_matmul/wgmma"] != w4 - decode_form:
            raise AssertionError(f"[{label}] {w4} W4A16 launches by form "
                                 f"{ {k: v for k, v in forms.items() if k.startswith('w4a16')} } "
                                 f"over {fwd} forwards and {steps} beam steps")
        out[label] = _row(run)
        print(f"[{label}] {videos} video(s), beam {QA_BEAMS} x {W4_BEAM_MAX_NEW} new tokens: "
              f"{run['wall_s']:.2f} s wall, {steps} beam decode steps at M = "
              f"{QA_BEAMS * videos}, {w4} W4A16 launches ({fwd} + {steps} forwards x "
              f"{W4A16_LAUNCHES_PER_FORWARD}), peak memory "
              f"{run['max_memory_allocated_gib']:.2f} GiB")
    if PREFIX_CACHES != {("int8", "int8", True)}:
        raise AssertionError(f"[w4a16] beam caches {PREFIX_CACHES}, want int8 with scales")

    sess = _session_turns(kernels, chat, "clip1.mp4", "w4a16-session", 2, W4_BEAM_MAX_NEW)
    for t in sess["turns"]:
        fwd, forms = t["session_llama_forwards"], t["form_launches"]
        w4 = t["launches"]["w4a16_matmul"]
        if w4 != W4A16_LAUNCHES_PER_FORWARD * fwd or forms["w4a16_matmul/wgmma"] \
                != W4A16_LAUNCHES_PER_FORWARD or forms["w4a16_matmul/stream"]:
            raise AssertionError(f"[w4a16-session] turn {t['turn']}: {w4} W4A16 launches over "
                                 f"{fwd} forwards, by form {forms}")
    if sess["kv_cache"]["dtype"] != "int8" or not sess["kv_cache"]["scales"]:
        raise AssertionError(f"[w4a16-session] cache {sess['kv_cache']}, want int8 with scales")
    out["w4a16-session"] = sess
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
        auto = _pipeline_auto(kernels, params, cfg)

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
                "trunk_by_fused_ln": trunk, "trunk_one_bf16_step_gap": floor, "auto": auto})
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

    class NoWrite:
        """A full fine-tune's checkpoint is the 6.9 B trainable bf16 leaves
        and both moments, about 40 GB: more than a call may write. The
        train-lora phase saves and restores; here the saves are only
        counted."""

        def __init__(self):
            self.steps = []

        def save(self, state, extra=None):
            self.steps.append(state.step)

    trainer.ckpt = NoWrite()
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
    if trainer.ckpt.steps != list(itertools.accumulate(TRAIN_STEPS.values())):
        raise AssertionError(f"[train] saves at steps {trainer.ckpt.steps}: each train() call "
                             "saves at its last step")
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


# ---------------------------------------------------------------------------
# the demo entry points on the conversation config
# ---------------------------------------------------------------------------

CONV_YAML = ROOT / "config" / "instructblipbase_stllm_conversation.yaml"
# the reference demo's 64 frames and 5 beams; its 300 new tokens are cut to
# DEMO_MAX_NEW for time, and a web ask (greedy) to DEMO_WEB_MAX_NEW
DEMO_FRAMES, DEMO_BEAMS, DEMO_MAX_NEW, DEMO_WEB_MAX_NEW = 64, 5, 8, 16
DEMO_SOURCE = (96, 240, 320)   # the in-memory clips: frames, height, width
# per encode of the conversation config (EVA-ViT-g without the BTAdapter):
# #1 once a trunk block, all 64 frames in one call at 257 tokens
DEMO_PER_ENCODE = {"packed_qkv_attention": 39}
DEMO_SHAPES = {("packed_qkv_attention", DEMO_FRAMES, 257): 39}
DEMO_WEB_QUESTIONS = ("What happens in this video?", "Why is it funny?")


def _timed(fn, sink: list):
    """``fn`` with the device synchronised around each call, its ms
    appended to ``sink``."""
    def wrap(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        sink.append((time.perf_counter() - t) * 1e3)
        return out
    return wrap


def _demo_chat(chat, clips):
    """A Chat over ``chat``'s model whose upload_video reads the in-memory
    clip named in the file it is handed (the gradio state's path, the web
    upload's temporary file; the card's machine may have no FFmpeg to
    decode a real one), sampling its frames as a file read does."""
    from stllm_tpu_torch.conversation import Chat
    from stllm_tpu_torch.data.samplers import get_seq_frames

    class NamedClipChat(Chat):
        def upload_video(self, video, conv, img_list, num_frame=64, text=None):
            clip = clips[Path(video).read_text()]
            return super().upload_video(clip[get_seq_frames(len(clip), num_frame)], conv,
                                        img_list, num_frame, text)

    return NamedClipChat(chat.params, chat.cfg, chat.llama_tokenizer,
                         qformer_tokenizer=chat.qformer_tokenizer,
                         image_size=chat.transform.image_size)


def _only(label: str, launches: dict, want: dict, per: int) -> None:
    """The launches ``want`` x ``per`` and nothing else."""
    _expect(label, launches, want, per)
    others = {k: v for k, v in launches.items() if k not in want and v}
    if others:
        raise AssertionError(f"[{label}] unexpected kernel launches {others}")


def _post(port: int, path: str, data: bytes, headers: dict) -> dict:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, headers=headers)
    return json.loads(urllib.request.urlopen(req, timeout=600).read())


def _demo_web_route(kernels, chat, files, label: str, solo_asks: int, **handler) -> dict:
    """The web demo's handler served on 127.0.0.1 (port 0) in this process:
    two sessions upload their clip and ask DEMO_WEB_QUESTIONS in turn,
    greedy; then the Chat answers the same turns itself through the same
    route (solo generate, the same AnswerService, a PrefixSession a
    conversation). Every answer must equal the Chat's own; #1 launches 39
    times an upload and no other kernel runs; exactly ``solo_asks`` asks
    run solo generate."""
    import threading
    from http.server import ThreadingHTTPServer

    from stllm_tpu_torch import demo_web
    from stllm_tpu_torch.conversation import CONV_instructblip_Vicuna0
    from stllm_tpu_torch.conversation import conversation as conv_mod
    from stllm_tpu_torch.models.generation import PrefixSession

    solo = collections.Counter()
    real_generate = conv_mod.generate

    def counted(*args, **kw):
        solo["generate"] += 1
        return real_generate(*args, **kw)

    ask_ms = []
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), demo_web.make_handler(chat, **handler))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    port = httpd.server_address[1]
    conv_mod.generate = counted
    PACKED_CALLS.clear()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        sids = {n: _post(port, f"/api/upload?segments={DEMO_FRAMES}", n.encode(),
                         {"X-Filename": f"{n}.mp4"})["session"] for n in files}
        got = {n: [] for n in files}
        for q in DEMO_WEB_QUESTIONS:
            for n in files:
                body = {"session": sids[n], "question": q, "num_beams": 1, "temperature": 0.0,
                        "max_new_tokens": DEMO_WEB_MAX_NEW}
                t = time.perf_counter()
                got[n].append(_post(port, "/api/ask", json.dumps(body).encode(),
                                    {"Content-Type": "application/json"})["answer"])
                ask_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
    finally:
        conv_mod.generate = real_generate
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    wall = time.perf_counter() - t0
    launches, shapes = dict(kernels.LAUNCHES), dict(PACKED_CALLS)
    _only(label, launches, DEMO_PER_ENCODE, len(files))
    if shapes != {k: v * len(files) for k, v in DEMO_SHAPES.items()}:
        raise AssertionError(f"[{label}] #1 calls by (rows, length) {shapes}")
    if solo["generate"] != solo_asks:
        raise AssertionError(f"[{label}] {solo['generate']} asks ran solo generate, want "
                             f"{solo_asks}")
    want = {}
    for n, path in files.items():
        conv, imgs = CONV_instructblip_Vicuna0.copy(), []
        chat.upload_video(path, conv, imgs, num_frame=DEMO_FRAMES)
        kv = (PrefixSession(chat.params["llama"], chat.cfg.llama, max_len=2048)
              if handler.get("prefix_kv") else None)
        want[n] = []
        for q in DEMO_WEB_QUESTIONS:
            chat.ask(q, conv)
            want[n].append(chat.answer(conv=conv, img_list=imgs, num_beams=1, temperature=0.0,
                                       do_sample=False, max_new_tokens=DEMO_WEB_MAX_NEW,
                                       max_length=2000, service=handler.get("service"),
                                       kv_session=kv)[0])
        if kv is not None:
            kv.release()
    if got != want:
        raise AssertionError(f"[{label}] web answers {got} != the Chat's own {want}")
    return {"mode": label, "wall_s": wall, "ask_ms": ask_ms, "answers": got,
            "solo_generate_calls": solo["generate"], "launches": launches,
            "packed_calls": {f"{r}x{s}": c for (_, r, s), c in shapes.items()}}


def phase_demo(kernels) -> dict:
    """The demos' default model, the conversation config
    (config/instructblipbase_stllm_conversation.yaml: EVA-ViT-g without the
    BTAdapter, video_input residual with 16 local frames, Vicuna-7B, bf16)
    at full width with random weights from seed 0, built by
    demo_core.build_chat. One question at 64 frames through gradio_ask with
    5 beams, timed by stage (encode, prefill, decode); then the web demo's
    handler, plain, with an AnswerService and with PrefixSessions."""
    from stllm_tpu_torch import demo_core
    from stllm_tpu_torch.conversation import CONV_instructblip_Vicuna0
    from stllm_tpu_torch.models import generation
    from stllm_tpu_torch.serving import AnswerService, ContinuousBatcher

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    built = demo_core.build_chat(str(CONV_YAML), device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase
    cfg = built.cfg
    if (cfg.vit_model, cfg.video_input, cfg.residual_size, cfg.vit.depth, cfg.llama.num_layers,
            cfg.llama.dtype) != ("eva_clip_g", "residual", 16, 39, 32, torch.bfloat16):
        raise AssertionError(f"[demo] the conversation config built {cfg}")
    _name_every_token(built.llama_tokenizer)
    rng = np.random.default_rng(41)
    clips = {n: rng.integers(0, 256, DEMO_SOURCE + (3,), dtype=np.uint8)
             for n in ("clip_a", "clip_b")}
    tmp = Path(tempfile.mkdtemp(prefix="stllm_demo_smoke_"))
    files = {}
    for n in clips:
        (tmp / f"{n}.mp4").write_text(n)
        files[n] = str(tmp / f"{n}.mp4")
    chat = _demo_chat(built, clips)

    question = "Tell me why this video looks so funny?"
    # one untimed encode first: the 64-frame shapes are new to this process
    chat.upload_video(files["clip_b"], CONV_instructblip_Vicuna0.copy(), [], DEMO_FRAMES,
                      text=question)
    state, _ = demo_core.gradio_upload(files["clip_a"], DEMO_FRAMES)
    enc, pre = [], []
    real_prefill = generation._prefill
    chat.upload_video = _timed(chat.upload_video, enc)
    generation._prefill = _timed(real_prefill, pre)
    PACKED_CALLS.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        chatbot, state = demo_core.gradio_ask(chat, question, DEMO_BEAMS, 1.0, [], state,
                                              max_new_tokens=DEMO_MAX_NEW)
        torch.cuda.synchronize()
    finally:
        generation._prefill = real_prefill
        del chat.upload_video
    ask_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches, shapes = dict(kernels.LAUNCHES), dict(PACKED_CALLS)
    _only("demo-gradio", launches, DEMO_PER_ENCODE, 1)
    if shapes != DEMO_SHAPES:
        raise AssertionError(f"[demo-gradio] #1 calls by (rows, length) {shapes}")
    tokens = int(state["img_list"][0].shape[1])
    if tokens != cfg.num_video_tokens(DEMO_FRAMES) or tokens != 16 * cfg.num_query:
        raise AssertionError(f"[demo-gradio] {tokens} video tokens, STLLMConfig reckons "
                             f"{cfg.num_video_tokens(DEMO_FRAMES)}")
    conv, imgs = CONV_instructblip_Vicuna0.copy(), []
    chat.upload_video(files["clip_a"], conv, imgs, DEMO_FRAMES, text=question)
    chat.ask(question, conv)
    own, _ = chat.answer(conv=conv, img_list=imgs, num_beams=DEMO_BEAMS, do_sample=False,
                         temperature=1.0, max_new_tokens=DEMO_MAX_NEW, max_length=2000)
    if chatbot != [[question, own]]:
        raise AssertionError(f"[demo-gradio] {chatbot} != the Chat's own answer {own!r}")
    gradio = {"mode": "demo-gradio", "frames": DEMO_FRAMES, "beams": DEMO_BEAMS,
              "max_new_tokens": DEMO_MAX_NEW, "video_tokens": tokens, "answer": own,
              "encode_ms": enc[0], "prefill_ms": sum(pre), "prefill_calls": len(pre),
              "decode_ms": ask_ms - enc[0] - sum(pre), "ask_ms": ask_ms,
              "max_memory_allocated_gib": peak, "launches": launches,
              "packed_calls": {f"{r}x{s}": c for (_, r, s), c in shapes.items()}}
    print(f"[demo-gradio] {json.dumps(gradio)}")

    # the demos' template (CONV_instructblip_Vicuna0) is a simple prompt, so
    # Chat.answer forces the reference's repetition penalty 1.5, which the
    # batcher refuses: every ask through --serve-slots falls back to solo
    # generate, as in the reference; a PrefixSession serves penalized turns
    asks = len(files) * len(DEMO_WEB_QUESTIONS)
    if CONV_instructblip_Vicuna0.instruction:
        raise AssertionError("[demo] the demos' template is no longer a simple prompt")
    service = AnswerService(ContinuousBatcher(chat.params["llama"], cfg.llama, slots=4,
                                              max_len=1024))
    try:
        web = [_demo_web_route(kernels, chat, files, "demo-web-plain", asks),
               _demo_web_route(kernels, chat, files, "demo-web-service", asks, service=service),
               _demo_web_route(kernels, chat, files, "demo-web-prefix_kv", 0, prefix_kv=2)]
    finally:
        service.close()
    shutil.rmtree(tmp, ignore_errors=True)
    plain = web[0]["answers"]
    for route in web:
        route["turns_equal_plain"] = sum(a == b for n in plain for a, b in
                                         zip(route["answers"][n], plain[n]))
        print(f"[{route['mode']}] {json.dumps(route)}")
    out = {"build_s": build_s, "gradio": gradio, "web": {r["mode"]: r for r in web},
           "phase_s": time.perf_counter() - t_phase}
    print(f"[demo] conversation config at full width, 64 frames: encode {gradio['encode_ms']:.1f} "
          f"ms, prefill {gradio['prefill_ms']:.1f} ms ({len(pre)} calls), beam-5 decode of "
          f"{DEMO_MAX_NEW} tokens {gradio['decode_ms']:.1f} ms, peak {peak:.2f} GiB; web asks "
          + ", ".join(f"{r['mode']} {np.mean(r['ask_ms']):.1f} ms" for r in web)
          + f"; phase {out['phase_s']:.1f} s ({smi_line()})")
    return out


# ---------------------------------------------------------------------------
# training breadth: the train CLI with LoRA, checkpoints and resume
# ---------------------------------------------------------------------------

LORA_R, LORA_STEPS = 8, 2
# per LoRA step under the frozen LLM, at the 1024 tier: what a full
# fine-tune step launches there. The adapters sit in every layer, so every
# layer's backward runs (#5, #6 once a layer), the per-layer recompute
# (remat) and the MVM teacher pass run #4 besides the forward, and the
# frozen trunk and the trainable branch launch #1 as before
LORA_LAUNCHES = TRAIN_LAUNCHES["train-long"]
LORA_WORDS = (200, 250)        # prompt and answer words that pack to 1024 slots
LORA_CLIPS = 4


def _clip_corpus(size: int, tmp: Path, rng):
    """LORA_CLIPS in-memory 48-frame clips and an annotation file for them
    in ``tmp`` (prompts and answers that pack to 1024 slots); returns the
    annotation's path and a video reader that gives the clip named by the
    path with the frame indices the sampler draws (the card's machine may
    have no FFmpeg to write or decode an mp4)."""
    from stllm_tpu_torch.data.samplers import get_frame_indices

    clips = {f"c{i}.mp4": rng.integers(0, 256, (48, size, size, 3), dtype=np.uint8)
             for i in range(LORA_CLIPS)}
    anno = [{"video": n, "QA": [{"q": _words(rng, LORA_WORDS[0]), "a": _words(rng, LORA_WORDS[1])}]}
            for n in clips]
    (tmp / "anno.json").write_text(json.dumps(anno))

    def reader(path, num_frames, sample, max_num_frames=-1, clip=None, rng=None, **_):
        frames = clips[Path(path).name]
        idx = get_frame_indices(num_frames, len(frames), sample=sample, rng=rng)
        return frames[idx], list(idx), len(frames) / 8.0

    return tmp / "anno.json", reader


def _lora_datasets(cfg, tmp: Path, rng):
    """One ITVidTrainDataset over the clips of ``_clip_corpus``."""
    from stllm_tpu_torch.data.datasets import ITVidTrainDataset

    anno, reader = _clip_corpus(cfg.vit.image_size, tmp, rng)
    ds = ITVidTrainDataset([str(anno), str(tmp), "video"], num_frames=FRAMES, seed=42)
    ds.video_reader = reader
    return [ds]


def _lora_run(kernels, argv, datasets, label: str) -> dict:
    """train.run with ``argv`` over ``datasets``, every count at 0 before;
    each step timed with the packed length of its batch, each save timed."""
    from stllm_tpu_torch.common.config import Config
    from stllm_tpu_torch.train import checkpoint, train, trainer as trainer_mod

    args = train.parse_args(argv)
    cfg = Config(args.cfg_path, options=args.options)
    steps, saves = [], []
    real_make, real_save = trainer_mod.make_train_step, checkpoint.CheckpointManager.save

    def make(*a, **kw):
        fn = real_make(*a, **kw)

        def step(state, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(state, batch)
            torch.cuda.synchronize()
            steps.append({"ms": (time.perf_counter() - t) * 1e3,
                          "seq_len": int(batch["token_ids"].shape[1])})
            return out
        return step

    trainer_mod.make_train_step = make
    checkpoint.CheckpointManager.save = _timed(real_save, saves)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        model, trainer, stats = train.run(cfg, args, datasets=datasets)
        torch.cuda.synchronize()
    finally:
        trainer_mod.make_train_step = real_make
        checkpoint.CheckpointManager.save = real_save
    launches, forms = dict(kernels.LAUNCHES), dict(kernels.FORM_LAUNCHES)
    n = len(steps)
    _only(label, launches, LORA_LAUNCHES, n)
    any_form = {k: v for k, v in forms.items() if k.endswith("/any") and v}
    if any_form or {s["seq_len"] for s in steps} != {TRAIN_LONG[1]}:
        raise AssertionError(f"[{label}] steps {steps}, any-form launches {any_form}")
    return {"mode": label, "model": model, "trainer": trainer, "cfg": cfg, "stats": stats,
            "steps": n, "step_ms": [s["ms"] for s in steps],
            "seq_len": sorted({s["seq_len"] for s in steps}), "save_ms": saves,
            "wall_s": time.perf_counter() - t0,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "form_launches": forms}


def _row_of(run: dict) -> dict:
    return {k: v for k, v in run.items() if k not in ("model", "trainer", "cfg")}


def phase_train_breadth(kernels) -> dict:
    """The train CLI's run() on the QA config at full width with LoRA
    (freeze_LLM, lora_r 8, micro-batch 1) over in-memory clips whose
    prompts pack to 1024: two steps, then a second run into the same
    output_dir to three steps, which must resume at step 2 and take one.
    Exact launches a step, frozen leaves bit for bit at their init, the
    checkpoint restored bit for bit into a fresh model, the schedule
    continued (the resumed step moves the A factors, which only a nonzero B
    and a nonzero learning rate can), no dataset retry."""
    from stllm_tpu_torch.common.config import Config
    from stllm_tpu_torch.models.zoo import STLLM
    from stllm_tpu_torch.train.checkpoint import CheckpointManager
    from stllm_tpu_torch.train.step import tree_paths
    from stllm_tpu_torch.train.trainer import Trainer

    tiny = check_small_lora(kernels)
    print(f"[train-lora] tiny fp32 LoRA, card vs CPU: {json.dumps(tiny)}")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="stllm_lora_smoke_"))
    rng = np.random.default_rng(17)
    yaml = str(ROOT / "config" / "instructblipbase_stllm_qa.yaml")
    options = ["model.freeze_LLM=True", f"model.lora_r={LORA_R}",
               "run.per_device_train_batch_size=1", f"run.output_dir={out_dir}",
               "run.logging_steps=1"]
    argv = ["--cfg-path", yaml, "--options", *options]
    try:
        model_cfg = Config(yaml, options=options).model_cfg
        ref = STLLM.from_config(model_cfg, seed=0, device="cuda")   # what run() builds
        init = dict(tree_paths(ref.params))
        policy = ref.trainable_fn()
        init_train = {p: t.clone() for p, t in init.items()
                      if policy(p) and t.is_floating_point()}
        datasets = _lora_datasets(ref.cfg, out_dir, rng)
        first = _lora_run(kernels, argv + ["--max-steps", str(LORA_STEPS)], datasets, "train-lora")
        state = first["trainer"].state
        params = state.params
        lora = {p for p in params if "_lora/" in p}
        if len(lora) != 2 * 2 * ref.cfg.llama.num_layers or any(
                p.startswith("llama/") and "_lora/" not in p for p in params) or any(
                p.endswith("alpha") for p in params):
            raise AssertionError(f"[train-lora] trainable leaves {sorted(params)[:8]} ...")
        if set(params) != set(init_train):
            raise AssertionError("[train-lora] the trainer's leaves are not the policy's")
        changed = [p for p, t in tree_paths(state.tree) if p in state.frozen
                   and not torch.equal(t, init[p])]
        # step 0's learning rate is 0 (the warmup starts there), so one step
        # moves leaves: B (A's gradient is 0 while B is 0, so A first moves in
        # the resumed step), llama_proj, the MVM decoder and the branch leaves
        # not behind a zero-init layer
        direct = [p for p in params if p.endswith("_lora/b")
                  or p.startswith(("llama_proj/", "mvm_decoder/")) and not p.endswith("scale")]
        stuck = [p for p in direct if torch.equal(params[p], init_train[p])]
        if changed or stuck:
            raise AssertionError(f"[train-lora] frozen leaves changed {changed[:5]}, trainable "
                                 f"leaves stuck {stuck[:5]}")
        if datasets[0].retries:
            raise AssertionError(f"[train-lora] {datasets[0].retries} dataset retries")
        ckpt_file = out_dir / f"checkpoint_{LORA_STEPS}" / "state.pt"
        ckpt_bytes = ckpt_file.stat().st_size
        saved = {k: v.detach().clone() for k, v in params.items()}
        saved_mu = {k: v.clone() for k, v in state.opt_state["mu"].items()}
        first_model, first_trainer = first.pop("model"), first.pop("trainer")
        del state, params, first_model, first_trainer
        gc.collect()
        torch.cuda.empty_cache()

        restored = Trainer(ref.cfg, ref.params, output_dir=str(out_dir / "restore"),
                           trainable_fn=ref.trainable_fn())
        torch.cuda.synchronize()
        t = time.perf_counter()
        CheckpointManager(str(out_dir)).restore(restored.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        if restored.state.step != LORA_STEPS or restored.state.opt_state["count"] != LORA_STEPS \
                or any(not torch.equal(restored.state.params[k], v) for k, v in saved.items()) \
                or any(not torch.equal(restored.state.opt_state["mu"][k], v)
                       for k, v in saved_mu.items()):
            raise AssertionError("[train-lora] the restored checkpoint differs from the saved "
                                 "state")

        second = _lora_run(kernels, argv + ["--max-steps", str(LORA_STEPS + 1)], datasets,
                           "train-lora-resume")
        state2 = second["trainer"].state
        log = [json.loads(x) for x in (out_dir / "log.txt").read_text().splitlines()]
        a_moved = [p for p in lora if p.endswith("/a")
                   and not torch.equal(state2.params[p], saved[p])]
        changed2 = [p for p, t in tree_paths(state2.tree) if p in state2.frozen
                    and not torch.equal(t, init[p])]
        # after the resumed step: every leaf moved but bf16 norm scales of 1.0
        # (a 1e-5 step rounds away) and branch leaves behind two zero-init layers
        moved = {p for p in state2.params if not torch.equal(state2.params[p], init_train[p])}
        branch = [p for p in state2.params if p.startswith("vit/")]
        stuck2 = [p for p in state2.params if p not in moved and not p.endswith("scale")
                  and not p.startswith("vit/")]
        if second["steps"] != 1 or state2.step != LORA_STEPS + 1 \
                or state2.opt_state["count"] != LORA_STEPS + 1 \
                or [r["step"] for r in log] != list(range(1, LORA_STEPS + 2)) \
                or len(a_moved) != len(lora) // 2 or changed2 or stuck2 \
                or not moved & set(branch) or datasets[0].retries \
                or not all(np.isfinite(r["loss"]) for r in log):
            raise AssertionError(f"[train-lora-resume] steps {second['steps']}, state step "
                                 f"{state2.step}, log {log}, A factors moved {len(a_moved)}, "
                                 f"frozen changed {changed2[:5]}, stuck {stuck2[:5]}")
        branch_moved = (len(moved & set(branch)), len(branch))
        second.pop("model"), second.pop("trainer")
        del state2
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    n_train = sum(t.numel() for t in saved.values())
    out = {"tiny": tiny, "lora_r": LORA_R, "trainable_params": n_train,
           "trainable_leaves": len(saved), "lora_leaves": len(lora),
           "branch_leaves_moved": branch_moved,
           "checkpoint_bytes": ckpt_bytes, "save_ms": first["save_ms"] + second["save_ms"],
           "restore_s": restore_s, "log": log, "first": _row_of(first),
           "resume": _row_of(second), "phase_s": time.perf_counter() - t_phase}
    first_ms = first["step_ms"]
    print(f"[train-lora] {json.dumps(out)}")
    print(f"[train-lora] QA config, LoRA r={LORA_R} under the frozen LLM: {n_train} trainable "
          f"parameters in {len(saved)} leaves; steps at S = {TRAIN_LONG[1]}: {first_ms} ms "
          f"(resumed step {second['step_ms']} ms), peak "
          f"{first['max_memory_allocated_gib']:.2f} GiB; checkpoint {ckpt_bytes} bytes, saves "
          f"{out['save_ms']} ms, restore {restore_s:.3f} s; phase {out['phase_s']:.1f} s "
          f"({smi_line()})")
    return out


def _copy_to(tree, device):
    """A copy of ``tree`` on ``device`` whose leaves share nothing with it
    and take no gradient (a CPU step would otherwise train the tree the
    card's copy is taken from)."""
    if isinstance(tree, dict):
        return {k: _copy_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_to(v, device) for v in tree]
    return None if tree is None else tree.detach().to(device, copy=True)


def _lora_tree(llama, gen, r: int = 4):
    """add_lora over ``llama`` (a LLaMA tree) with every B drawn nonzero."""
    from stllm_tpu_torch.models.lora import add_lora

    out = add_lora({"llama": llama}, gen, r)["llama"]
    for layer in out["layers"]:
        for key in [k for k in layer if k.endswith("_lora")]:
            b = layer[key]["b"]
            layer[key]["b"] = (torch.randn(b.shape, generator=gen, device=b.device) * 0.05
                               ).to(b.dtype)
    return out


def check_small_lora(kernels) -> dict:
    """Tiny fp32 LoRA on the card against the CPU: one train step under the
    frozen LLM (the step's loss and its gradient) over the dense base
    within FP32_TINY_REL and over the weight-only int8 base (w_q16, whose
    activations are bf16) within the bf16 training tolerances; then prefill
    logits and greedy tokens through adapters over an int4 tree, split and
    fused (#12 multiplies as bf16: W4_TINY_REL)."""
    from stllm_tpu_torch.models.generation import _prefill, generate
    from stllm_tpu_torch.models.llama import (
        LlamaConfig, init_llama, quantize_llama_params, quantize_llama_params_int4)
    from stllm_tpu_torch.models.stllm import stllm_forward
    from stllm_tpu_torch.models.zoo import STLLM
    from stllm_tpu_torch.train.step import create_train_state, make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for base, (loss_tol, grad_tol) in (("dense", (FP32_TINY_REL, FP32_TINY_REL)),
                                       ("w_q16", (TRAIN_TINY_LOSS_REL, TRAIN_TINY_GRAD_REL))):
        model_cfg = {**_fp32_tiny_cfg(num_layers=2, use_flash=True), "use_mask": True,
                     "mvm_decode": True, "max_txt_len": 16, "use_grad_checkpoint": True,
                     "freeze_LLM": True}
        model = STLLM.from_config(model_cfg, seed=3, device="cpu")
        model.params["llama"] = _lora_tree(model.params["llama"], torch.Generator().manual_seed(5))
        if base == "w_q16":
            model.params["llama"] = quantize_llama_params(model.params["llama"], a16=True)
        cfg = model.cfg
        col = _collator(cfg, seed=6, seq_multiple=32)
        batch = col(_train_samples(np.random.default_rng(5), 4, 56, 6, 8, 2))
        res, before = {}, dict(kernels.LAUNCHES)
        for dev in ("cpu", "cuda"):
            opt = make_optimizer(1e-3, weight_decay=0.0)
            state = create_train_state(_copy_to(model.params, dev), opt, model.trainable_fn())
            put = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            loss = stllm_forward(state.tree, put, cfg)["loss"]
            g = torch.autograd.grad(loss, list(state.params.values()), allow_unused=True)
            _, metrics = make_train_step(cfg, opt)(state, put)
            res[dev] = (metrics["loss"].reshape(1), torch.cat(
                [(torch.zeros_like(p) if x is None else x).float().flatten().cpu()
                 for p, x in zip(state.params.values(), g)]), sorted(state.params))
        torch.cuda.synchronize()
        if res["cpu"][2] != res["cuda"][2] or not any("_lora/" in p for p in res["cpu"][2]):
            raise AssertionError(f"tiny LoRA {base}: trainable leaves {res['cpu'][2]}")
        loss_rel = float((res["cuda"][0].cpu() - res["cpu"][0]).abs() / res["cpu"][0].abs())
        grad_rel = float((res["cuda"][1] - res["cpu"][1]).norm() / res["cpu"][1].norm())
        if loss_rel > loss_tol or grad_rel > grad_tol:
            raise AssertionError(f"tiny LoRA {base}: loss rel {loss_rel} (limit {loss_tol}), "
                                 f"gradient rel L2 {grad_rel} (limit {grad_tol})")
        out[base] = {"loss_rel": loss_rel, "grad_rel_l2": grad_rel,
                     "launches": _ran(kernels, before, ["packed_qkv_attention",
                                                        "flash_attention_fwd",
                                                        "flash_attention_bwd_dq",
                                                        "flash_attention_bwd_dkv"])}
    lcfg = LlamaConfig(vocab_size=100, hidden=64, num_layers=2, heads=2, intermediate=128,
                       max_positions=64, dtype=torch.float32)
    dense = init_llama(torch.Generator().manual_seed(7), lcfg)
    emb = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 16, 64)) * 0.5).float()
    mask = torch.ones((2, 16), dtype=torch.int32)
    for fuse in (False, True):
        tree = _lora_tree(quantize_llama_params_int4(dense, group=None, fuse=fuse),
                          torch.Generator().manual_seed(9))
        want, _ = _prefill(tree, emb, mask, lcfg, 24)
        card = _tree_to(tree, "cuda")
        before = kernels.LAUNCHES["w4a16_matmul"]
        got, _ = _prefill(card, emb.cuda(), mask.cuda(), lcfg, 24)
        torch.cuda.synchronize()
        w4 = kernels.LAUNCHES["w4a16_matmul"] - before
        rel = float((got.float().cpu() - want).norm() / want.norm())
        if w4 != (4 if fuse else 7) * lcfg.num_layers or rel > W4_TINY_REL:
            raise AssertionError(f"tiny int4 LoRA fuse={fuse}: {w4} #12 launches, logits rel "
                                 f"L2 {rel} (limit {W4_TINY_REL})")
        gen = _gen_cfg(8)
        t_cpu = generate(tree, emb, llama_cfg=lcfg, gen=gen)
        t_card = generate(card, emb.cuda(), llama_cfg=lcfg, gen=gen)
        out["int4_fused" if fuse else "int4_split"] = {
            "prefill_rel_l2": rel, "w4a16_launches_per_prefill": w4,
            "tokens_agree": sum(a == b for r, s in zip(t_cpu, t_card) for a, b in zip(r, s)),
            "tokens": sum(len(r) for r in t_cpu)}
    return out


# ---------------------------------------------------------------------------
# draft distillation against the W4A16 target
# ---------------------------------------------------------------------------

DISTILL_STEPS, DISTILL_BATCHES, DISTILL_ROWS = 10, 2, 2
DISTILL_PROMPT, DISTILL_CONT = 992, 32    # 1024 positions a row: the flash tier
DISTILL_LR = 3e-4                         # the reference's default


def check_small_distill(kernels) -> dict:
    """Two distill_draft steps of a tiny fp32 draft against a tiny fp32
    target on the card (the flash kernels' fp32 forms, use_flash) and on the
    CPU from the same weights and batches: both losses and every draft leaf
    after them within FP32_TINY_REL."""
    from stllm_tpu_torch.models.distill import distill_draft
    from stllm_tpu_torch.models.llama import LlamaConfig, init_llama
    from stllm_tpu_torch.train.step import tree_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = LlamaConfig(vocab_size=100, hidden=64, num_layers=2, heads=2, intermediate=128,
                       max_positions=64, dtype=torch.float32, use_flash=True)
    dcfg = dataclasses.replace(tcfg, num_layers=1)
    target = init_llama(torch.Generator().manual_seed(11), tcfg)
    draft = init_llama(torch.Generator().manual_seed(12), dcfg)
    rng = np.random.default_rng(13)
    batches = [(torch.from_numpy(rng.standard_normal((2, 12, 64)) * 0.3).float(),
                torch.from_numpy(rng.integers(0, 100, (2, 8)))) for _ in range(2)]
    res, before = {}, dict(kernels.LAUNCHES)
    for dev in ("cpu", "cuda"):
        d, log = _copy_to(draft, dev), []
        distill_draft(_copy_to(target, dev), d, lambda i: tuple(t.to(dev) for t in batches[i]),
                      tgt_cfg=tcfg, dft_cfg=dcfg, steps=2, learning_rate=1e-3, metrics=log)
        res[dev] = (torch.tensor([m["loss"] for m in log]),
                    torch.cat([t.detach().float().flatten().cpu() for _, t in tree_paths(d)]))
    torch.cuda.synchronize()
    out = {"loss_rel": _rel(res["cuda"][0], res["cpu"][0], "distill losses"),
           "draft_rel_l2": _rel(res["cuda"][1], res["cpu"][1], "distilled draft"),
           "launches": _ran(kernels, before, ["flash_attention_fwd", "flash_attention_bwd_dq",
                                              "flash_attention_bwd_dkv"])}
    return out


def _w4_target():
    """The W4A16 Vicuna-7B of phase_w4a16 alone (random weights from a seed,
    per-channel int4 with q|k|v and gate|up fused, the int8 head, the int8
    KV cache), for a run without that phase."""
    from types import SimpleNamespace

    from stllm_tpu_torch.models.llama import VICUNA_7B, init_llama, quantize_llama_params_int4

    lcfg = dataclasses.replace(VICUNA_7B, kv_int8=True)
    llama = quantize_llama_params_int4(init_llama(torch.Generator(device="cuda").manual_seed(0),
                                                  lcfg),
                                       group=None, free_dense=True, quant_head=True, fuse=True)
    return {"llama": llama}, SimpleNamespace(llama=lcfg)


def phase_distill(kernels, params=None, cfg=None, cut=None) -> dict:
    """distill_draft of a dense bf16 4-layer draft at Vicuna-7B width
    (init_llama, seed 43) against the W4A16 target that phase_w4_spec
    serves: DISTILL_BATCHES fixed batches of DISTILL_ROWS rows, each a
    DISTILL_PROMPT-token prompt (embedded by the target's table) and the
    target's own DISTILL_CONT-token greedy continuation, DISTILL_STEPS steps
    in turn. Per step exactly 128 #12 launches (the teacher's forward, wgmma
    form) and 36 / 4 / 4 flash forward / dQ / dK-dV launches (the teacher's
    32 layers forward, the draft's 4 forward and backward; 40 forward
    launches where the config recomputes each layer in the backward, as the
    QA config's stack does); the loss on the
    last step's batch must fall below its first value there. Then
    phase_w4_spec's requests are served with the distilled draft, its
    accepted tokens a round beside the cut draft's (``cut``, phase_w4_spec's
    result); no threshold: the weights are random."""
    from stllm_tpu_torch.models.distill import distill_draft
    from stllm_tpu_torch.models.generation import generate
    from stllm_tpu_torch.models.llama import init_llama
    from stllm_tpu_torch.ops.layers import gather_rows

    tiny = check_small_distill(kernels)
    print(f"[distill] tiny fp32 distillation, card vs CPU: {json.dumps(tiny)}")
    t_phase = time.perf_counter()
    if params is None:
        params, cfg = _w4_target()
    llama, lcfg = params["llama"], cfg.llama
    dcfg = dataclasses.replace(lcfg, num_layers=SPEC_DRAFT_LAYERS)
    rng = np.random.default_rng(43)
    batches = []
    t0 = time.perf_counter()
    for _ in range(DISTILL_BATCHES):
        ids = torch.as_tensor(rng.integers(3, lcfg.vocab_size, (DISTILL_ROWS, DISTILL_PROMPT)),
                              device="cuda")
        emb = gather_rows(llama["embed_tokens"], ids).to(lcfg.dtype)
        cont = generate(llama, emb, llama_cfg=lcfg, gen=_gen_cfg(DISTILL_CONT))
        batches.append((emb, torch.as_tensor(cont, device="cuda")))
    torch.cuda.synchronize()
    cont_s = time.perf_counter() - t0
    draft = init_llama(torch.Generator(device="cuda").manual_seed(43), dcfg)
    log, marks = [], []

    def timed_batch(i):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return batches[i % DISTILL_BATCHES]

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    distill_draft(llama, draft, timed_batch, tgt_cfg=lcfg, dft_cfg=dcfg, steps=DISTILL_STEPS,
                  learning_rate=DISTILL_LR, metrics=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:] + [t0 + wall])]
    launches, forms = dict(kernels.LAUNCHES), dict(kernels.FORM_LAUNCHES)
    # the teacher's no-gradient forward runs each layer once; the draft's
    # forward runs again in its backward where the config recomputes (the QA
    # config's use_grad_checkpoint sets llama.remat)
    per_step = {"w4a16_matmul": W4A16_LAUNCHES_PER_FORWARD,
                "flash_attention_fwd": lcfg.num_layers + dcfg.num_layers * (1 + dcfg.remat),
                "flash_attention_bwd_dq": dcfg.num_layers,
                "flash_attention_bwd_dkv": dcfg.num_layers}
    _only("distill", launches, per_step, DISTILL_STEPS)
    if forms["w4a16_matmul/wgmma"] != launches["w4a16_matmul"]:
        raise AssertionError(f"[distill] #12 by form {forms}")
    last = DISTILL_STEPS - 1
    first_same = last % DISTILL_BATCHES
    if not log[last]["loss"] < log[first_same]["loss"] or not all(
            np.isfinite(m["loss"]) for m in log):
        raise AssertionError(f"[distill] losses {log}: the last batch's loss did not fall")
    distill = {"mode": "distill", "steps": DISTILL_STEPS, "rows": DISTILL_ROWS,
               "positions": DISTILL_PROMPT + DISTILL_CONT, "log": log, "step_ms": step_ms,
               "continuations_s": cont_s, "wall_s": wall,
               "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches": launches, "form_launches": forms}
    print(f"[distill] {json.dumps(distill)}")
    spec = phase_w4_spec(kernels, params, cfg, draft=(draft, dcfg), label="w4a16-spec-distilled")
    cut_acc = None if cut is None else cut["mean_accepted_per_round"]
    print(f"[distill] {DISTILL_STEPS} steps of {DISTILL_ROWS} x {DISTILL_PROMPT + DISTILL_CONT} "
          f"positions: {np.mean(step_ms[1:]):.1f} ms a step after the first ({step_ms[0]:.1f} ms), "
          f"loss {log[first_same]['loss']:.4f} -> {log[last]['loss']:.4f} on the last batch, "
          f"peak {distill['max_memory_allocated_gib']:.2f} GiB; accepted tokens a round "
          f"{spec['mean_accepted_per_round']:.3f} with the distilled draft, {cut_acc} with the "
          f"cut one; phase {time.perf_counter() - t_phase:.1f} s ({smi_line()})")
    return {"tiny": tiny, "distill": distill, "spec": spec, "cut_accepted_per_round": cut_acc}



# ---------------------------------------------------------------------------
# the config-driven runner path: Config -> setup_task -> build_model ->
# build_datasets -> RunnerBase.train -> Trainer
# ---------------------------------------------------------------------------

RUNNER_CORPUS = "smoke_runner_clips"
RUNNER_ITERS = 2                     # steps an epoch; the resumed runner takes epoch 2
RUNNER_ENC = (2, 257)                # the Q-Former LM's encoder states: two sequences of 257


class _Indices:
    """A dataset whose item i is i: the collate function picks the batch."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


def _scaled(tree, factor: float):
    """``tree`` with every linear weight, embedding and query token scaled:
    at the init's 0.02 every row of a tiny Q-Former LM decodes one token."""
    if isinstance(tree, dict):
        return {k: (v * factor if k in ("w", "word", "position", "query_tokens")
                    else _scaled(v, factor)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_scaled(v, factor) for v in tree]
    return tree


def check_small_runner(kernels) -> dict:
    """The runner path on a tiny fp32 LoRA config, card against CPU: two
    steps of RunnerBase.train from the same weights over the same batches
    (the learning rate nonzero from step 0), each step's loss within
    FP32_TINY_REL; then the tiny Q-Former LM's loss and logits within
    FP32_TINY_REL and its greedy tokens identical."""
    from stllm_tpu_torch.common.config import Config
    from stllm_tpu_torch.models.qformer import (
        QFormerConfig, init_qformer_lm, qformer_lm_forward, qformer_lm_generate)
    from stllm_tpu_torch.runners import RunnerBase
    from stllm_tpu_torch.tasks import setup_task

    model_cfg = {**_fp32_tiny_cfg(num_layers=2, use_flash=True), "use_mask": True,
                 "mvm_decode": True, "max_txt_len": 16, "use_grad_checkpoint": True,
                 "freeze_LLM": True, "lora_r": 4}
    losses, before = {}, dict(kernels.LAUNCHES)
    for dev in ("cpu", "cuda"):
        out = tempfile.mkdtemp(prefix="stllm_runner_tiny_")
        try:
            cfg = Config(cfg_dict={"model": model_cfg, "run": {
                "task": "video_text_it", "max_epoch": 1, "iters_per_epoch": RUNNER_ITERS,
                "batch_size_train": 1, "init_lr": 1e-3, "warmup_lr": 1e-3, "log_freq": 1,
                "num_workers": 1, "output_dir": out}})
            task = setup_task(cfg)
            model = task.build_model(cfg, device="cpu")
            col = _collator(model.cfg, seed=6, seq_multiple=32)
            batches = [col(_train_samples(np.random.default_rng(5 + i), 4, 56, 6, 8, 2))
                       for i in range(RUNNER_ITERS)]
            if dev == "cuda":
                model.params, model.device = _copy_to(model.params, dev), torch.device(dev)
            runner = RunnerBase(cfg, task, model, {"clips": {"train": _Indices(RUNNER_ITERS)}})
            runner.train(collate_fn=lambda s: batches[s[0]])
            log = [json.loads(x) for x in (Path(out) / "log.txt").read_text().splitlines()]
            losses[dev] = [r["loss"] for r in log]
        finally:
            shutil.rmtree(out, ignore_errors=True)
    torch.cuda.synchronize()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    if len(rel) != RUNNER_ITERS or max(rel) > FP32_TINY_REL or losses["cpu"][0] == losses["cpu"][1]:
        raise AssertionError(f"tiny runner: losses card {losses['cuda']}, CPU {losses['cpu']}")
    out = {"runner_losses": losses, "runner_loss_rel": rel,
           "runner_launches": _ran(kernels, before, ["packed_qkv_attention",
                                                     "flash_attention_fwd",
                                                     "flash_attention_bwd_dq",
                                                     "flash_attention_bwd_dkv"])}

    qcfg = QFormerConfig(hidden=64, num_layers=2, heads=2, intermediate=128, encoder_width=176,
                         num_query=8, vocab_size=100, max_positions=32, dtype=torch.float32)
    params = _scaled(init_qformer_lm(torch.Generator().manual_seed(11), qcfg), 15.0)
    params["cls"]["bias"] = torch.randn(qcfg.vocab_size, generator=torch.Generator().manual_seed(12))
    card = _copy_to(params, "cuda")
    rng = np.random.default_rng(13)
    enc = torch.from_numpy(rng.standard_normal((3, 20, qcfg.encoder_width))).float()
    ids = torch.from_numpy(rng.integers(0, qcfg.vocab_size, (3, 7)))
    labels = ids.clone()
    labels[0, :2] = -100
    loss, logits = qformer_lm_forward(params, input_ids=ids, encoder_hidden_states=enc,
                                      labels=labels, cfg=qcfg)
    c_loss, c_logits = qformer_lm_forward(card, input_ids=ids.cuda(), encoder_hidden_states=enc.cuda(),
                                          labels=labels.cuda(), cfg=qcfg)
    out["qformer_lm_logits_rel"] = _rel(c_logits, logits, "Q-Former LM logits")
    out["qformer_lm_loss_rel"] = _rel(c_loss.reshape(1), loss.reshape(1), "Q-Former LM loss")
    kw = dict(bos_token_id=1, eos_token_id=None, max_new_tokens=8, cfg=qcfg)
    want = qformer_lm_generate(params, enc, **kw)
    got = qformer_lm_generate(card, enc.cuda(), **kw)
    if got != want or len({tuple(r) for r in want}) < 2:
        raise AssertionError(f"tiny Q-Former LM greedy tokens: card {got}, CPU {want}")
    out["qformer_lm_tokens"] = got
    return out


def _runner_config(out_dir: Path, max_epoch: int):
    """The QA config through Config(cfg_dict=..., options=...): LoRA under
    the frozen LLM, the runner's epoch keys, micro-batch 1, and one corpus
    entry in place of the config's seven."""
    from stllm_tpu_torch.common.config import Config, load_yaml

    d = load_yaml(ROOT / "config" / "instructblipbase_stllm_qa.yaml")
    d["datasets"] = {RUNNER_CORPUS: {"num_frames": FRAMES}}
    return Config(cfg_dict=d, options=[
        "model.freeze_LLM=True", f"model.lora_r={LORA_R}", "run.runner=runner_base",
        f"run.max_epoch={max_epoch}", f"run.iters_per_epoch={RUNNER_ITERS}",
        "run.batch_size_train=1", f"run.output_dir={out_dir}", "run.log_freq=1",
        "run.num_workers=2"])


def _runner_run(kernels, cfg, reader, label: str, built=None) -> dict:
    """setup_task -> build_model (on the card; ``built(model)`` is called
    then) -> build_datasets (the clips' reader put in) -> the registry's
    runner; every count at 0 just before RunnerBase.train, each step timed
    with its packed length, each save timed."""
    from stllm_tpu_torch.common.registry import registry
    from stllm_tpu_torch.data.collate import TrainCollator
    from stllm_tpu_torch.models.zoo import ensure_tokenizers
    from stllm_tpu_torch.tasks import setup_task
    from stllm_tpu_torch.train import checkpoint, trainer as trainer_mod

    t0 = time.perf_counter()
    task = setup_task(cfg)
    model = task.build_model(cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if built is not None:
        built(model)
    datasets = task.build_datasets(cfg)
    for d in datasets.values():
        d["train"].video_reader = reader
    ensure_tokenizers(model)
    collate = TrainCollator(model.cfg, model.llama_tokenizer,
                            qformer_tokenizer=model.qformer_tokenizer, seed=42)
    runner = registry.get_runner_class(cfg.run_cfg.runner)(cfg, task, model, datasets)
    steps, saves = [], []
    real_make, real_save = trainer_mod.make_train_step, checkpoint.CheckpointManager.save

    def make(*a, **kw):
        fn = real_make(*a, **kw)

        def step(state, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(state, batch)
            torch.cuda.synchronize()
            steps.append({"ms": (time.perf_counter() - t) * 1e3,
                          "seq_len": int(batch["token_ids"].shape[1])})
            return out
        return step

    trainer_mod.make_train_step = make
    checkpoint.CheckpointManager.save = _timed(real_save, saves)
    try:
        runner.trainer
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t1 = time.perf_counter()
        stats = runner.train(collate_fn=collate)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
    finally:
        trainer_mod.make_train_step = real_make
        checkpoint.CheckpointManager.save = real_save
    launches, forms = dict(kernels.LAUNCHES), dict(kernels.FORM_LAUNCHES)
    n = len(steps)
    _only(label, launches, LORA_LAUNCHES, n)
    any_form = {k: v for k, v in forms.items() if k.endswith("/any") and v}
    if any_form or {s["seq_len"] for s in steps} != {TRAIN_LONG[1]} \
            or any(d["train"].retries for d in datasets.values()):
        raise AssertionError(f"[{label}] steps {steps}, any-form launches {any_form}")
    return {"mode": label, "model": model, "runner": runner, "stats": stats, "steps": n,
            "step_ms": [s["ms"] for s in steps], "save_ms": saves, "build_s": build_s,
            "train_s": train_s, "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": launches, "form_launches": forms}


def _qformer_lm_full(kernels) -> dict:
    """The InstructBLIP Q-Former with its LM head at the published width in
    fp32: greedy generate of 8 tokens on two sequences of encoder states on
    the card, its first step's logits within FP32_TINY_REL relative L2 of
    the CPU's; no attention kernel runs (the Q-Former is plain torch)."""
    import dataclasses as dc

    from stllm_tpu_torch.models.qformer import (
        INSTRUCT_BLIP_QFORMER, init_qformer_lm, qformer_lm_forward, qformer_lm_generate)

    qcfg = dc.replace(INSTRUCT_BLIP_QFORMER, dtype=torch.float32)
    params = init_qformer_lm(torch.Generator().manual_seed(21), qcfg)
    card = _copy_to(params, "cuda")
    enc = torch.from_numpy(np.random.default_rng(22).standard_normal(
        (*RUNNER_ENC, qcfg.encoder_width))).float()
    bos = torch.ones((RUNNER_ENC[0], 1), dtype=torch.int32)
    want = qformer_lm_forward(params, input_ids=bos, encoder_hidden_states=enc, cfg=qcfg)
    got = qformer_lm_forward(card, input_ids=bos.cuda(), encoder_hidden_states=enc.cuda(), cfg=qcfg)
    rel = _rel(got, want, "full-width Q-Former LM first-step logits")
    kernels.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    tokens = qformer_lm_generate(card, enc.cuda(), bos_token_id=1, max_new_tokens=8, cfg=qcfg)
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t) * 1e3
    cpu_tokens = qformer_lm_generate(params, enc, bos_token_id=1, max_new_tokens=8, cfg=qcfg)
    if any(kernels.LAUNCHES.values()) or [len(r) for r in tokens] != [8] * RUNNER_ENC[0]:
        raise AssertionError(f"[qformer-lm] tokens {tokens}, launches {dict(kernels.LAUNCHES)}")
    return {"first_logits_rel_l2": rel, "tokens": tokens,
            "tokens_agree_cpu": sum(a == b for r, s in zip(tokens, cpu_tokens)
                                    for a, b in zip(r, s)),
            "generate_ms": gen_ms}


def _same_init(params, init: dict) -> None:
    from stllm_tpu_torch.train.step import tree_paths

    differ = [p for p, t in tree_paths(params) if not torch.equal(t, init[p])]
    if differ:
        raise AssertionError(f"[runner-resume] a second build from the seed differs: {differ[:5]}")


def phase_runner(kernels) -> dict:
    """The reference's LAVIS-style path on the full-width QA config, LoRA r 8
    under the frozen LLM, micro-batch 1 over in-memory 16-frame clips that
    pack to 1024: Config(cfg_dict=..., options=...), setup_task,
    build_model on the card, build_datasets from one registered corpus
    entry, the registry's runner_base for one epoch of two steps; then a
    second runner with max_epoch 2 over the same output_dir resumes at step
    2 and stops at 4. Per step exactly a LoRA step's launches, finite
    losses, each step's checkpoint written once, every frozen leaf bit for
    bit at its init, the A factors moved by the resumed steps. Then the
    Q-Former LM at its published width."""
    from stllm_tpu_torch.data import instruction_data
    from stllm_tpu_torch.models.zoo import build_stllm_config
    from stllm_tpu_torch.train.step import tree_paths

    tiny = check_small_runner(kernels)
    print(f"[runner] tiny fp32, card vs CPU: {json.dumps(tiny)}")
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="stllm_runner_smoke_"))
    try:
        cfg = _runner_config(out_dir, max_epoch=1)
        _, reader = _clip_corpus(build_stllm_config(cfg.model_cfg).vit.image_size, out_dir,
                                 np.random.default_rng(19))
        instruction_data.available_corpus[RUNNER_CORPUS] = [str(out_dir / "anno.json"),
                                                            str(out_dir), "video"]
        init = {}
        first = _runner_run(kernels, cfg, reader, "runner", built=lambda m: init.update(
            (p, t.clone()) for p, t in tree_paths(m.params)))
        model, trainer = first.pop("model"), first.pop("runner").trainer
        log = [json.loads(x) for x in (out_dir / "log.txt").read_text().splitlines()]
        changed = [p for p, t in tree_paths(trainer.state.tree) if p in trainer.state.frozen
                   and not torch.equal(t, init[p])]
        if first["steps"] != RUNNER_ITERS or trainer.ckpt.latest_step() != RUNNER_ITERS \
                or len(first["save_ms"]) != 1 or [r["step"] for r in log] != [1, 2] or changed:
            raise AssertionError(f"[runner] steps {first['steps']}, newest checkpoint "
                                 f"{trainer.ckpt.latest_step()}, saves {first['save_ms']}, "
                                 f"log {log}, frozen changed {changed[:5]}")
        lora = {p for p in trainer.state.params if "_lora/" in p}
        saved_a = {p: trainer.state.params[p].clone() for p in lora if p.endswith("/a")}
        ckpt_bytes = (out_dir / f"checkpoint_{RUNNER_ITERS}" / "state.pt").stat().st_size
        frozen = set(trainer.state.frozen)
        del model, trainer
        gc.collect()
        torch.cuda.empty_cache()

        # a fresh model from the same seed: its init is the first model's
        second = _runner_run(kernels, _runner_config(out_dir, max_epoch=2), reader,
                             "runner-resume", built=lambda m: _same_init(m.params, init))
        model2, runner2 = second.pop("model"), second.pop("runner")
        state = runner2.trainer.state
        log = [json.loads(x) for x in (out_dir / "log.txt").read_text().splitlines()]
        changed = [p for p, t in tree_paths(state.tree) if p in frozen
                   and not torch.equal(t, init[p])]
        a_moved = [p for p, t in saved_a.items() if not torch.equal(state.params[p], t)]
        dirs = sorted(p.name for p in out_dir.iterdir() if p.name.startswith((".", "checkpoint")))
        if second["steps"] != RUNNER_ITERS or state.step != 2 * RUNNER_ITERS \
                or runner2.trainer.ckpt.latest_step() != 2 * RUNNER_ITERS \
                or len(second["save_ms"]) != 1 or [r["step"] for r in log] != [1, 2, 3, 4] \
                or not all(np.isfinite(r["loss"]) for r in log) or changed \
                or len(a_moved) != len(saved_a) or not saved_a \
                or dirs != [f"checkpoint_{RUNNER_ITERS}", f"checkpoint_{2 * RUNNER_ITERS}"]:
            raise AssertionError(f"[runner-resume] steps {second['steps']}, state step "
                                 f"{state.step}, saves {second['save_ms']}, log {log}, frozen "
                                 f"changed {changed[:5]}, A moved {len(a_moved)} of "
                                 f"{len(saved_a)}, checkpoint dirs {dirs}")
        del model2, runner2, state, init
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        instruction_data.available_corpus.pop(RUNNER_CORPUS, None)
        shutil.rmtree(out_dir, ignore_errors=True)
    qlm = _qformer_lm_full(kernels)
    out = {"tiny": tiny, "lora_r": LORA_R, "lora_leaves": len(lora),
           "checkpoint_bytes": ckpt_bytes, "log": log, "first": first, "resume": second,
           "qformer_lm": qlm, "phase_s": time.perf_counter() - t_phase}
    print(f"[runner] {json.dumps({k: v for k, v in out.items() if k not in ('first', 'resume')})}")
    print(f"[runner] QA config through setup_task / build_model / build_datasets / runner_base, "
          f"LoRA r={LORA_R}: steps at S = {TRAIN_LONG[1]}: {first['step_ms']} ms, resumed "
          f"{second['step_ms']} ms; peak {first['max_memory_allocated_gib']:.2f} / "
          f"{second['max_memory_allocated_gib']:.2f} GiB; build_model {first['build_s']:.2f} / "
          f"{second['build_s']:.2f} s; checkpoint {ckpt_bytes} bytes, saves "
          f"{first['save_ms'] + second['save_ms']} ms; Q-Former LM (published width, fp32) "
          f"8 tokens x {RUNNER_ENC[0]} in {qlm['generate_ms']:.1f} ms, first logits rel L2 "
          f"{qlm['first_logits_rel_l2']:.2e}; phase {out['phase_s']:.1f} s ({smi_line()})")
    return out


# ---------------------------------------------------------------------------
# the multi-device layer at world size 1
# ---------------------------------------------------------------------------

MESH_STEPS = 2
# the (1, 1)-mesh losses and greedy first logits against the meshless ones,
# relative: the same ops run in the same order, so they are equal (the updated
# weights are held bit for bit apart from this); the limit is fp32 rounding
MESH_LOSS_REL = 1e-6
MESH_PROMPT, MESH_NEW = 96, 16     # the greedy decode's prompt embeddings and new tokens


class _CountSaves:
    """A full fine-tune's checkpoint is about 40 GB: the saves are counted."""

    def __init__(self):
        self.steps = []

    def save(self, state, extra=None):
        self.steps.append(state.step)


def _digest(params) -> torch.Tensor:
    """(leaves, 2) fp64: each trainable leaf's sum and L2 norm, in path order."""
    return torch.stack([torch.stack([p.detach().sum(dtype=torch.float64),
                                     torch.linalg.vector_norm(p.detach(), dtype=torch.float64)])
                        for p in params.values()]).cpu()


def _mesh_train(kernels, batches, mesh, label: str):
    """MESH_STEPS full-width steps of the QA config from seed 0 through
    Trainer (on ``mesh``, or without one); returns the run's record, the
    trained model and the trainable leaves' paths and ``_digest``."""
    from stllm_tpu_torch.common.optim import linear_warmup_cosine_hf
    from stllm_tpu_torch.models.zoo import STLLM
    from stllm_tpu_torch.train.trainer import Trainer

    model = STLLM.from_config(qa_model_cfg(), seed=0)
    out_dir = tempfile.mkdtemp(prefix="stllm_mesh_smoke_")
    trainer = Trainer(model.cfg, model.params, output_dir=out_dir, mesh=mesh,
                      trainable_fn=model.trainable_fn(),
                      learning_rate=linear_warmup_cosine_hf(2e-5, 0.03, MESH_STEPS),
                      weight_decay=0.0, max_grad_norm=1.0, log_freq=1)
    trainer.ckpt = _CountSaves()
    step_ms, real_step = [], trainer._step_fn

    def timed_step(st, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real_step(st, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return res

    trainer._step_fn = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    trainer.train(iter(batches), MESH_STEPS)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    digest = (list(trainer.state.params), _digest(trainer.state.params))
    log = [json.loads(line) for line in (Path(out_dir) / "log.txt").read_text().splitlines()]
    shutil.rmtree(out_dir, ignore_errors=True)
    run = {"mode": label, "steps": MESH_STEPS, "mesh": None if mesh is None else mesh.shape,
           "seq_len": sorted({int(b["token_ids"].shape[1]) for b in batches}),
           "losses": [r["loss"] for r in log], "step_ms": step_ms,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches, "launches_per_step": {k: v / MESH_STEPS
                                                       for k, v in launches.items() if v}}
    print(f"[{label}] {json.dumps(run)}")
    if run["seq_len"] != [TRAIN_LONG[1]] or trainer.ckpt.steps != [MESH_STEPS]:
        raise AssertionError(f"[{label}] packed lengths {run['seq_len']}, saves at "
                             f"{trainer.ckpt.steps}")
    _expect(label, launches, TRAIN_LAUNCHES["train-long"], MESH_STEPS)
    others = {k: v for k, v in launches.items() if k not in TRAIN_LAUNCHES["train-long"] and v}
    if others:
        raise AssertionError(f"[{label}] unexpected kernel launches {others}")
    del trainer
    return run, model, digest


def phase_mesh(kernels) -> dict:
    """The (1, 1) mesh over an in-process NCCL group of one rank: the sharded
    Trainer and greedy generate against their meshless runs."""
    import datetime

    import torch.distributed as dist

    from stllm_tpu_torch.models import generation
    from stllm_tpu_torch.models.zoo import build_stllm_config
    from stllm_tpu_torch.parallel.mesh import make_mesh
    from stllm_tpu_torch.parallel.sharding import stllm_param_shardings

    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="stllm_mesh_store_")
    dist.init_process_group("nccl", store=dist.FileStore(str(Path(store) / "store"), 1),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(data=1, model=1)
        cfg = build_stllm_config(qa_model_cfg())
        rng = np.random.default_rng(11)
        col = _collator(cfg, seed=12)
        # prompt and answer lengths that pack to 1024 slots, as the train phase's long tier
        batches = [col(_train_samples(rng, FRAMES, cfg.vit.image_size, 200, 250, 1))
                   for _ in range(MESH_STEPS)]
        plain, model, plain_digest = _mesh_train(kernels, batches, None, "mesh-none")
        del model
        gc.collect()
        torch.cuda.empty_cache()
        sharded, model, sharded_digest = _mesh_train(kernels, batches, mesh, "mesh-1x1")
        rel = max(abs(a - b) / abs(b) for a, b in zip(sharded["losses"], plain["losses"]))
        # the updated weights: every trainable leaf's sum and norm, bit for bit
        same_paths = plain_digest[0] == sharded_digest[0]
        differ = ([] if not same_paths else
                  [p for p, a, b in zip(plain_digest[0], plain_digest[1], sharded_digest[1])
                   if not torch.equal(a, b)])

        # bf16 greedy decode, the (1, 1) mesh against none, on the trained weights
        llama, lcfg = model.params["llama"], model.cfg.llama
        emb = (torch.randn((1, MESH_PROMPT, lcfg.hidden), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(13))
               * 0.02).to(lcfg.dtype)
        gen_cfg = generation.GenerationConfig(max_new_tokens=MESH_NEW, eos_token_id=-1,
                                              stop_sequences=())
        first, real_prefill = [], generation._prefill

        def prefill(*args, **kw):
            logits, cache = real_prefill(*args, **kw)
            first.append(logits.float())
            return logits, cache

        generation._prefill = prefill
        try:
            toks = generation.generate(llama, emb, llama_cfg=lcfg, gen=gen_cfg)
            specs = stllm_param_shardings(mesh, {"llama": llama})["llama"]
            toks_mesh = generation.generate(llama, emb, llama_cfg=lcfg, gen=gen_cfg, mesh=mesh,
                                            specs=specs)
        finally:
            generation._prefill = real_prefill
        gen_rel = float((first[1] - first[0]).norm() / first[0].norm())
        del model, llama
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    out = {"mode": "mesh", "backend": "nccl", "world": 1, "mesh": mesh.shape,
           "loss_rel_max": rel, "plain": plain, "sharded": sharded,
           "trainable_leaves": len(plain_digest[0]), "leaves_differing": len(differ),
           "launches": sharded["launches"],
           "ms_per_step": {r["mode"]: r["step_ms"] for r in (plain, sharded)},
           "peak_gib": {r["mode"]: r["max_memory_allocated_gib"] for r in (plain, sharded)},
           "generate": {"first_logits_rel_l2": gen_rel, "tokens_equal": toks == toks_mesh,
                        "new_tokens": len(toks[0])},
           "phase_s": time.perf_counter() - t0}
    print(f"[mesh] (1, 1) mesh vs none: losses {sharded['losses']} vs {plain['losses']} "
          f"(max rel {rel:.2e}), {len(differ)} of {len(plain_digest[0])} trained leaves "
          f"differ, ms a step {sharded['step_ms']} vs {plain['step_ms']}, peak "
          f"{sharded['max_memory_allocated_gib']:.2f} vs {plain['max_memory_allocated_gib']:.2f}"
          f" GiB; greedy first logits rel L2 {gen_rel:.2e}, tokens equal "
          f"{toks == toks_mesh}; phase {out['phase_s']:.1f} s ({smi_line()})")
    if not same_paths or differ:
        raise AssertionError(f"[mesh] the updated weights differ from the meshless run's: "
                             f"same paths {same_paths}, leaves {differ[:5]} of {len(differ)}")
    if not rel <= MESH_LOSS_REL or not all(np.isfinite(sharded["losses"])):
        raise AssertionError(f"[mesh] losses {sharded['losses']} against {plain['losses']}: "
                             f"relative gap {rel} (limit {MESH_LOSS_REL})")
    if toks != toks_mesh or not gen_rel <= MESH_LOSS_REL:
        raise AssertionError(f"[mesh] greedy tokens {toks_mesh} against {toks}, first logits "
                             f"relative L2 {gen_rel}")
    return out


# phases --phases can run alone
PARTIAL = ("load", "demo", "train_breadth", "distill", "runner", "mesh")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", nargs="+", choices=PARTIAL,
                        help="build the kernels, then run only these phases (distill on a "
                             "W4A16 target of its own); a partial run prints no result line")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from stllm_tpu_torch.ops import kernels

    replaced, divide_check = phase_build(kernels)
    if args.phases:
        count_forwards()
        record_packed_shapes(kernels)
        for name in args.phases:
            {"load": phase_load, "demo": phase_demo, "train_breadth": phase_train_breadth,
             "distill": phase_distill, "runner": phase_runner, "mesh": phase_mesh}[name](kernels)
            gc.collect()
            torch.cuda.empty_cache()
        print(f"chip_smoke: phases {args.phases} passed (a partial run: no result line)")
        return 0
    entries = phase_kernels(kernels, replaced, divide_check)
    gc.collect()
    print(f"[kernels] held after the phase: {torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    count_forwards()
    record_packed_shapes(kernels)
    bf16, qa_model = phase_slice(kernels)
    mvbench = phase_mvbench(kernels, qa_model)
    qabench = phase_qabench(kernels, qa_model)
    prefix = phase_prefix(kernels, qa_model)
    breadth = phase_breadth(kernels, qa_model)
    del qa_model
    gc.collect()
    torch.cuda.empty_cache()
    load = phase_load(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    int8 = phase_int8(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    w4a16, w4_params, w4_cfg = phase_w4a16(kernels)
    w4_beams = phase_w4_beams(kernels, w4_params, w4_cfg)
    w4_spec = phase_w4_spec(kernels, w4_params, w4_cfg)
    # the distillation's target is the stack phase_w4_spec serves
    distill = phase_distill(kernels, w4_params, w4_cfg, cut=w4_spec)
    gc.collect()
    torch.cuda.empty_cache()
    pipeline = phase_pipeline(kernels, w4_params, w4_cfg)
    del w4_params
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(kernels)
    short, long_ = train["train-short"], train["train-long"]
    gc.collect()
    torch.cuda.empty_cache()
    demo = phase_demo(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    breadth_train = phase_train_breadth(kernels)
    lora, resume = breadth_train["first"], breadth_train["resume"]
    gc.collect()
    torch.cuda.empty_cache()
    runner = phase_runner(kernels)
    run_first, run_resume = runner["first"], runner["resume"]
    gc.collect()
    torch.cuda.empty_cache()
    mesh = phase_mesh(kernels)
    mesh_none, mesh_1x1 = mesh["plain"], mesh["sharded"]
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
        for route in (*mvbench["routes"].values(), *qabench["routes"].values(), prefix,
                      breadth["mild"], breadth["prefix_key"], load, *w4_beams.values(), w4_spec,
                      *pipeline["auto"].values(), demo["gradio"], *demo["web"].values(),
                      lora, resume, run_first, run_resume, distill["distill"],
                      distill["spec"], mesh_none, mesh_1x1):
            entry["launches_by_path"][route["mode"]] = route["launches"][name]
        entry["launches_by_path"]["pipeline-calibration"] = pipeline["calibration_launches"][name]
        entry["launches_per_train_step"] = {t["mode"]: t["launches"][name] / t["steps"]
                                            for t in (short, long_, lora, resume, run_first,
                                                      run_resume, distill["distill"], mesh_none,
                                                      mesh_1x1)}
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
