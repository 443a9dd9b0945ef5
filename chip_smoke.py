#!/usr/bin/env python3
"""Drive the PyTorch port (stllm_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit. Phases, each fatal on failure:

1. build  - compile every CUDA kernel of the port from stllm_tpu_torch/csrc/
   (one nvcc per source, all at once) and print the card's name and power
   limit;
2. kernels - each kernel against its plain PyTorch version on the card at the
   shapes the video-QA path gives it, with its time, the plain version's, one
   PyTorch library call's (a yardstick the port never calls) and the bound;
3. slice  - the QA config (config/instructblipbase_stllm_qa.yaml: EVA-ViT-g +
   BTAdapter, InstructBLIP Q-Former, Vicuna-7B, bf16, 16 frames, video_input
   all) at full width with random weights from a seed, served by
   VideoQAServer(slots=4, max_len=1024) for 6 requests; every request must
   get tokens and the kernel counters must show the kernels ran (45
   packed-qkv launches per video); a tiny bf16 model must encode the same
   video on the card and on the CPU to within the bf16 tolerance.

Then it prints a ``{"kernels": [...]}`` line, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``. Without a CUDA card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16, published
BF16_ATOL = BF16_RTOL = 3e-2   # bf16 attention tolerance of tests/test_ops.py
NUM_REQUESTS, FRAMES, PREFIX_LEN, SUFFIX_LEN, Q_LEN, MAX_NEW = 6, 16, 40, 20, 12, 32


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


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


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    kernels.build()
    print(f"[build] kernels {sorted(kernels.SOURCES)} built in {time.perf_counter() - t0:.2f} s")
    for name, log in kernels.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] card: {smi_line()}")


def phase_kernels(kernels) -> dict:
    """packed_qkv_attention against its plain version at the ViT trunk and
    spatial shape, the BTAdapter temporal shape and a ragged one."""
    import torch.nn.functional as F

    shapes = [(16, 257, 16, 88), (256, 16, 16, 88), (3, 37, 4, 88)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_shape = []
    for b, s, h, d in shapes:
        width = h * d
        # LN-normalized activations times 0.02-std weights, as the qkv
        # projection makes them; four copies cycle so each timed launch
        # reads an input the 50 MB L2 does not hold
        bufs = []
        for _ in range(4):
            x = torch.randn(b, s, width, generator=gen, device="cuda")
            w = torch.randn(width, 3 * width, generator=gen, device="cuda") * 0.02
            bufs.append((x @ w).to(torch.bfloat16).contiguous())
        qkv = bufs[0]
        scale = d ** -0.5
        got = kernels.packed_qkv_attention(qkv, h, d, scale)
        torch.cuda.synchronize()
        want = kernels.packed_qkv_attention_plain(qkv, h, d, scale)
        err = (got.float() - want.float()).abs()
        max_err = float(err.max())
        ok = bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
        if not ok or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"packed_qkv_attention {(b, s, h, d)}: max abs err "
                                 f"{max_err} outside atol=rtol={BF16_ATOL}")
        it = iter(range(1 << 30))

        def nxt():
            return bufs[next(it) % len(bufs)]

        ms = cuda_ms(lambda: kernels.packed_qkv_attention(nxt(), h, d, scale), 40)
        plain_ms = cuda_ms(lambda: kernels.packed_qkv_attention_plain(nxt(), h, d, scale), 5)

        def sdpa():
            q, k, v = nxt().view(b, s, 3, h, d).unbind(2)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))

        library_ms = cuda_ms(sdpa, 40)
        nbytes = b * s * 3 * width * 2 + b * s * width * 2
        flops = 4 * b * h * s * s * d
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
        row = {"shape": [b, s, 3 * width], "max_abs_err": max_err, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        per_shape.append(row)
        print(f"[kernels] packed_qkv_attention {row}")
    head = per_shape[0]
    return {"name": "packed_qkv_attention", "route": "cuda",
            "source": "stllm_tpu_torch/csrc/packed_qkv_attention.cu",
            "replaces": "stllm_tpu/ops/attention.py:658",
            "launches": None,
            "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "atol": BF16_ATOL, "rtol": BF16_RTOL,
            "per_shape": per_shape}


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return None if tree is None else tree.to(device)


def check_small_reference() -> float:
    """A tiny bf16 BTAdapter model encodes one video on the card (kernel)
    and on the CPU (plain version); the two must agree to bf16 tolerance."""
    from stllm_tpu_torch.models.llama import LlamaConfig
    from stllm_tpu_torch.models.qformer import QFormerConfig
    from stllm_tpu_torch.models.stllm import STLLMConfig, encode_img, init_stllm
    from stllm_tpu_torch.models.vit import ViTConfig

    cfg = STLLMConfig(
        vit=ViTConfig(image_size=56, width=176, depth=3, heads=2, mlp_hidden=352),
        qformer=QFormerConfig(hidden=64, num_layers=2, heads=2, intermediate=128,
                              encoder_width=176, num_query=8, vocab_size=100),
        llama=LlamaConfig(vocab_size=100, hidden=64, num_layers=1, heads=2,
                          intermediate=128),
        video_input="all", vit_model="eva_btadapter_g", btadapter_depth=2)
    params = init_stllm(torch.Generator().manual_seed(3), cfg)
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(rng.integers(0, 256, (1, 4, 56, 56, 3), dtype=np.uint8))
    q_ids = torch.from_numpy(rng.integers(0, 100, (1, 5)))
    want = encode_img(params, frames, cfg, q_ids).float()
    got = encode_img(_tree_to(params, "cuda"), frames.cuda(), cfg, q_ids.cuda()).float().cpu()
    rel = float((got - want).norm() / want.norm())
    if not bool(torch.isfinite(got).all()) or rel > BF16_RTOL:
        raise AssertionError(f"tiny bf16 encode: card vs CPU relative L2 error {rel}")
    return rel


def phase_slice(kernels) -> dict:
    from stllm_tpu_torch.common.config import Config
    from stllm_tpu_torch.models.generation import GenerationConfig, _pad_prompt, _prefill
    from stllm_tpu_torch.models.generation import _decode_chunk_greedy
    from stllm_tpu_torch.models.zoo import STLLM
    from stllm_tpu_torch.pipeline_serving import VideoQAServer, _encode_assemble

    rel = check_small_reference()
    print(f"[slice] tiny bf16 encode, card vs CPU: relative L2 error {rel:.3e}")

    cfg_path = Path(__file__).resolve().parent / "config" / "instructblipbase_stllm_qa.yaml"
    t0 = time.perf_counter()
    model = STLLM.from_config(Config(cfg_path).model_cfg, seed=0)
    torch.cuda.synchronize()
    cfg = model.cfg
    print(f"[slice] model built in {time.perf_counter() - t0:.1f} s: vit {cfg.vit.width}x"
          f"{cfg.vit.depth} ({cfg.vit_model}, branch {cfg.btadapter_depth}), qformer "
          f"{cfg.qformer.hidden}x{cfg.qformer.num_layers}, llama {cfg.llama.hidden}x"
          f"{cfg.llama.num_layers}, {cfg.llama.dtype}, video_input {cfg.video_input}")

    rng = np.random.default_rng(1)
    size = cfg.vit.image_size
    reqs = [(f"q{i}",
             rng.integers(0, 256, (1, FRAMES, size, size, 3), dtype=np.uint8),
             rng.integers(3, cfg.llama.vocab_size, (1, PREFIX_LEN)),
             rng.integers(3, cfg.llama.vocab_size, (1, SUFFIX_LEN)),
             rng.integers(0, cfg.qformer.vocab_size, (1, Q_LEN)))
            for i in range(NUM_REQUESTS)]
    gen = GenerationConfig(max_new_tokens=MAX_NEW)
    srv = VideoQAServer(model.params, cfg, slots=4, max_len=1024)
    for rid, frames, pre, suf, q in reqs:
        srv.submit(rid, frames, pre, suf, gen, qformer_text_ids=q)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answers = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    if set(answers) != {r[0] for r in reqs}:
        raise AssertionError(f"answers for {sorted(answers)}, not all {NUM_REQUESTS} requests")
    for rid, toks in answers.items():
        if not toks or not all(0 <= t < cfg.llama.vocab_size for t in toks):
            raise AssertionError(f"request {rid}: bad tokens {toks}")
    want = 45 * NUM_REQUESTS
    if launches["packed_qkv_attention"] != want:
        raise AssertionError(f"packed_qkv_attention launched {launches['packed_qkv_attention']} "
                             f"times, want 45 per video = {want}")
    n_tok = sum(len(t) for t in answers.values())

    # per-phase device times, measured after the served run on its inputs
    rid, frames, pre, suf, q = reqs[0]
    dev = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    fr, pre_t, suf_t = dev(frames), dev(pre).int(), dev(suf).int()
    q_t = dev(q).int()
    embeds = _encode_assemble(model.params, fr, pre_t, suf_t, q_t, torch.ones_like(q_t), cfg)
    want_shape = (1, PREFIX_LEN + cfg.num_video_tokens(FRAMES) + SUFFIX_LEN, cfg.llama.hidden)
    if tuple(embeds.shape) != want_shape or not bool(torch.isfinite(embeds).all()):
        raise AssertionError(f"encode output {tuple(embeds.shape)} (want {want_shape}) not finite")
    encode_ms = cuda_ms(lambda: _encode_assemble(
        model.params, fr, pre_t, suf_t, q_t, torch.ones_like(q_t), cfg), 3, warmup=1)
    emb, mask = _pad_prompt(embeds, torch.ones(embeds.shape[:2], dtype=torch.int32,
                                               device="cuda"), gen.pad_to_multiple)
    logits, _ = _prefill(model.params["llama"], emb, mask, cfg.llama, emb.shape[1])
    if tuple(logits.shape) != (1, cfg.llama.vocab_size) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits not finite")
    prefill_ms = cuda_ms(lambda: _prefill(model.params["llama"], emb, mask, cfg.llama,
                                          emb.shape[1]), 3, warmup=1)
    b = srv.batcher
    chunk = 16
    decode_ms_step = cuda_ms(lambda: _decode_chunk_greedy(
        b.params, b.cur, b.cache, cfg.llama, chunk), 2, warmup=1) / chunk
    out = {"requests": NUM_REQUESTS, "frames": FRAMES, "prompt_tokens": emb.shape[1],
           "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "encode_ms_per_video": encode_ms, "prefill_ms": prefill_ms,
           "decode_ms_per_token": decode_ms_step, "decode_slots": b.slots,
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": launches,
           "packed_qkv_launches_per_video": launches["packed_qkv_attention"] / NUM_REQUESTS,
           "tokens_per_request": {k: len(v) for k, v in sorted(answers.items())},
           "tiny_encode_rel_err": rel,
           "answers": {k: v[:8] for k, v in sorted(answers.items())}}
    print(f"[slice] {json.dumps(out)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from stllm_tpu_torch.ops import kernels

    phase_build(kernels)
    entry = phase_kernels(kernels)
    sl = phase_slice(kernels)
    entry["launches"] = sl["launches"]["packed_qkv_attention"]
    print(json.dumps({"kernels": [entry]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
