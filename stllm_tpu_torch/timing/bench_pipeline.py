"""Full-pipeline MVBench-style QA latency on one card (p50, ms).

One QA = 16-frame encode (EVA-ViT-g + Q-Former + llama_proj) -> prompt
assembly (64 prefix tokens, the 16 x 32 video tokens, 32 suffix tokens:
608) -> Vicuna-7B prefill -> 16-token greedy answer, the reference's
per-sample MVBench loop (stllm/test/mvbench/mv_bench.py:229-283: encode_img,
option prompt, do_sample=False generate) on random weights. Two warm QAs,
then the p50 over 9, with all 9 kept.

``--int8``: static-int8 ViT, W8A8 LLaMA and an int8 KV cache; ``--int4``:
static-int8 ViT, fused W4A16 LLaMA with an int8 head and an int8 KV cache;
``--tome=L``: a named token-merging level (``auto`` picks it from a smooth
synthetic video's own frames). ``--from-video``: decode included. It
writes synthetic mp4 clips (cv2), decodes 16 uniform frames a sample
through ``data/video_reader`` (the native reader where built, else cv2)
with GroupScale and CenterCrop, and feeds the QA one sample ahead from a
background thread; it reports the decode-only, QA-only and overlapped
rates and the overlap efficiency.

    python -m stllm_tpu_torch.timing.bench_pipeline [--int8 | --int4] [--tome=L]
        [--from-video] [--cpu] [--out-dir DIR]

Merges a section keyed by stack and level into DIR/BENCH_PIPELINE.json
and prints it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from stllm_tpu_torch.data.synth import synth_video
from stllm_tpu_torch.models.generation import GenerationConfig, generate
from stllm_tpu_torch.models.llama import quantize_llama_params, quantize_llama_params_int4
from stllm_tpu_torch.models.stllm import STLLMConfig, encode_img, init_stllm, resolve_auto_merge
from stllm_tpu_torch.models.vit import EVA_VIT_G, calibrate_vit_scales, quantize_vit_params
from stllm_tpu_torch.ops.tome import level_kwargs, select_merge_level
from stllm_tpu_torch.timing import _common

HARNESS = "stllm_tpu_torch.timing.bench_pipeline"
DOC = "BENCH_PIPELINE.json"
FRAMES = 16
PREFIX_TOKENS = 64   # system + question text before the video
SUFFIX_TOKENS = 32   # options + "Best option:(" after the video
ANSWER_TOKENS = 16
ITERS = 9


def stack_key(int8: bool, int4: bool, tome: Optional[str]) -> str:
    return ("int4" if int4 else "int8" if int8 else "bf16") + (f"+tome={tome}" if tome else "")


def make_cfg(int8: bool = False, tome: Optional[str] = None) -> STLLMConfig:
    cfg = STLLMConfig(vit=dataclasses.replace(EVA_VIT_G, gelu_approx=True))
    if tome == "auto":
        cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, merge_level="auto"))
    elif tome:
        cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, **level_kwargs(tome)))
    if int8:
        cfg = dataclasses.replace(cfg, llama=dataclasses.replace(cfg.llama, kv_int8=True))
    return cfg


def build_pipeline(device, int8: bool = False, int4: bool = False, tome: Optional[str] = None,
                   seed: int = 0, llama: Optional[Dict] = None, cfg: STLLMConfig = None
                   ) -> Tuple[Dict, STLLMConfig, np.random.Generator]:
    """The stack (``--int4`` implies the int8 ViT and KV cache; a given
    ``llama`` tree is used as it is) and the ``default_rng(0)`` stream after
    the calibration frames, from which ``qa_inputs`` draws."""
    int8 = int8 or int4
    cfg = cfg or make_cfg(int8, tome)
    params = init_stllm(torch.Generator(device=device).manual_seed(seed), cfg,
                        init_llama_params=llama is None)
    if llama is not None:
        params["llama"] = llama
    rng = np.random.default_rng(0)
    if int8:
        params["vit"] = quantize_vit_params(params["vit"], free_dense=True)
        if llama is None:
            params["llama"] = (quantize_llama_params_int4(params["llama"], group=None,
                                                          free_dense=True, quant_head=True,
                                                          fuse=True) if int4 else
                               quantize_llama_params(params["llama"], free_dense=True))
        s = cfg.vit.image_size
        calib = torch.from_numpy(rng.integers(0, 256, (16, s, s, 3)).astype(np.uint8))
        params["vit"] = calibrate_vit_scales(params["vit"], calib.to(device), cfg.vit)
    return params, cfg, rng


def qa_inputs(cfg: STLLMConfig, rng, device, tome: Optional[str] = None
              ) -> Tuple[STLLMConfig, Dict[str, torch.Tensor], Optional[str]]:
    """Noise frames, Q-Former ids and the prefix and suffix embeddings from
    ``rng``; under ``auto`` the frames are a smooth synthetic video of
    ``default_rng(0)`` and the config resolves its level from them."""
    s, d = cfg.vit.image_size, cfg.llama.hidden
    frames = rng.integers(0, 256, (1, FRAMES, s, s, 3)).astype(np.uint8)
    q_ids = rng.integers(0, cfg.qformer.vocab_size, (1, 16))
    prefix = rng.normal(size=(1, PREFIX_TOKENS, d)) * 0.02
    suffix = rng.normal(size=(1, SUFFIX_TOKENS, d)) * 0.02
    auto_level = None
    if tome == "auto":
        frames = synth_video(np.random.default_rng(0), FRAMES, s)
        auto_level = select_merge_level(frames)
        cfg = resolve_auto_merge(cfg, frames)
    t = lambda a, dtype: torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)
    return cfg, {"frames": t(frames, torch.uint8), "q_ids": t(q_ids, torch.int32),
                 "q_mask": torch.ones((1, 16), dtype=torch.int32, device=device),
                 "prefix": t(prefix, cfg.llama.dtype), "suffix": t(suffix, cfg.llama.dtype)}, \
        auto_level


def gen_cfg() -> GenerationConfig:
    return GenerationConfig(max_new_tokens=ANSWER_TOKENS, stop_sequences=(), eos_token_id=-1)


def qa_fn(params: Dict, cfg: STLLMConfig, inputs: Dict[str, torch.Tensor]
          ) -> Callable[[torch.Tensor], List[List[int]]]:
    """frames -> the greedy answer of one QA."""
    gen, d = gen_cfg(), cfg.llama.hidden

    @torch.no_grad()
    def one_qa(frames):
        vid = encode_img(params, frames, cfg, inputs["q_ids"], inputs["q_mask"]).reshape(1, -1, d)
        embeds = torch.cat([inputs["prefix"], vid, inputs["suffix"]], dim=1)   # (1, 608, d)
        return generate(params["llama"], embeds, llama_cfg=cfg.llama, gen=gen)
    return one_qa


def run_pipeline(params: Dict, cfg: STLLMConfig, inputs: Dict[str, torch.Tensor],
                 int8: bool = False, int4: bool = False, tome: Optional[str] = None,
                 auto_level: Optional[str] = None, iters: Optional[int] = None) -> Dict:
    """Two warm QAs, then the p50 of ``iters`` (default ITERS) timed ones."""
    iters = iters or ITERS
    device = inputs["frames"].device
    one_qa = qa_fn(params, cfg, inputs)
    frames = inputs["frames"]
    one_qa(frames)
    one_qa(frames)
    out, times = _common.repeats(lambda: one_qa(frames), iters, device)
    times = [t * 1000 for t in times]
    assert len(out[0]) == ANSWER_TOKENS
    int8 = int8 or int4
    line = {
        "metric": "p50 e2e latency per MVBench QA (16-frame encode + 608-token "
                  "prefill + 16-token greedy, one card)"
                  + (" [int4 W4A16 LLM + int8 ViT]" if int4 else " [int8 W8A8]" if int8 else ""),
        "value": round(float(np.percentile(times, 50)), 1),
        "unit": "ms",
        "all_ms": [round(t, 1) for t in times],
        "raw_ms": times,
    }
    if tome:
        line["tome_level"] = tome
        if auto_level:
            line["auto_selected"] = auto_level
            line["frames"] = "smooth synthetic video (selector input)"
    return {**line, "answer": out[0]}


def synth_videos(tmpdir: str, n: int, frames: int = 128, w: int = 320, h: int = 240
                 ) -> List[str]:
    """``n`` mp4 clips of a rolled noise image (cv2's writer)."""
    import cv2

    paths = []
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    for i in range(n):
        path = os.path.join(tmpdir, f"clip{i}.mp4")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (w, h))
        assert vw.isOpened()
        for f in range(frames):
            vw.write(np.roll(base, f * 3 + i, axis=1))
        vw.release()
        paths.append(path)
    return paths


def decode_sample(path: str, image_size: int = 224, device=None) -> np.ndarray:
    """16 uniform frames -> GroupScale + CenterCrop uint8 (1, 16, s, s, 3),
    resized on ``device`` (default: the card)."""
    from stllm_tpu_torch.data.processors import center_crop, scale_short_side
    from stllm_tpu_torch.data.video_reader import open_video

    vr = open_video(path)
    idx = np.linspace(0, len(vr) - 1, FRAMES).round().astype(int)
    frames = vr.get_batch(idx)
    return center_crop(scale_short_side(frames, image_size, device), image_size)[None]


def run_from_video(one_qa_frames: Callable[[torch.Tensor], object], device,
                   n_samples: int = 16, image_size: int = 224) -> Dict:
    """Decode-only, QA-only and overlapped rates over ``n_samples`` clips
    (8 distinct), with each phase's seconds."""
    from stllm_tpu_torch.data.video_reader import native_available

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    with tempfile.TemporaryDirectory() as td:
        clips = synth_videos(td, 8)
        paths = [clips[i % 8] for i in range(n_samples)]
        fr0 = decode_sample(paths[0], image_size, device)
        one_qa_frames(to_dev(fr0))
        one_qa_frames(to_dev(fr0))

        t0 = time.perf_counter()
        decoded = [decode_sample(p, image_size, device) for p in paths]
        t_decode = time.perf_counter() - t0

        _, t_qa = _common.clock(lambda: [one_qa_frames(to_dev(d)) for d in decoded], device)

        q: "queue.Queue" = queue.Queue(maxsize=2)

        def producer():
            for p in paths:
                q.put(to_dev(decode_sample(p, image_size, device)))
            q.put(None)

        def overlapped():
            th = threading.Thread(target=producer, daemon=True)
            th.start()
            while True:
                item = q.get()
                if item is None:
                    break
                one_qa_frames(item)
            th.join()
        _, t_overlap = _common.clock(overlapped, device)

    serial = t_decode + t_qa
    bound = max(t_decode, t_qa)
    eff = (serial - t_overlap) / (serial - bound) if serial > bound else 1.0
    return {
        "n_samples": n_samples,
        "decoder": "native/videodec" if native_available() else "cv2-fallback",
        "decode_only_samples_per_s": round(n_samples / t_decode, 2),
        "qa_only_samples_per_s": round(n_samples / t_qa, 2),
        "overlapped_samples_per_s": round(n_samples / t_overlap, 2),
        "overlap_efficiency": round(min(max(eff, 0.0), 1.0), 3),
        "phase_s": {"decode": t_decode, "qa": t_qa, "overlapped": t_overlap},
        "host_cpus": os.cpu_count(),
    }


def write(line: Dict, key: str, out_dir: str, device) -> str:
    section = _common.stamp({k: v for k, v in line.items() if k != "answer"}, device, HARNESS)
    return _common.merge_doc(out_dir, DOC, lambda doc: doc.__setitem__(key, section))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="p50 end-to-end latency of one MVBench-style QA (16-frame encode, "
                    "608-token prefill, 16-token greedy answer)")
    parser.add_argument("--int8", action="store_true",
                        help="static-int8 ViT, W8A8 LLaMA, int8 KV cache")
    parser.add_argument("--int4", action="store_true",
                        help="static-int8 ViT, fused W4A16 LLaMA + int8 head, int8 KV cache")
    parser.add_argument("--tome", default=None, help="a named token-merging level, or auto")
    parser.add_argument("--from-video", action="store_true",
                        help="include video decode (synthetic mp4 clips; needs cv2)")
    _common.add_device_args(parser, _common.OUT_DIR)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    params, cfg, rng = build_pipeline(device, args.int8, args.int4, args.tome)
    cfg, inputs, auto_level = qa_inputs(cfg, rng, device, args.tome)
    line = run_pipeline(params, cfg, inputs, args.int8, args.int4, args.tome, auto_level)
    if args.from_video:
        one_qa = qa_fn(params, cfg, inputs)
        line["from_video"] = run_from_video(one_qa, device, image_size=cfg.vit.image_size)
    print(json.dumps({k: v for k, v in line.items() if k != "answer"}), flush=True)
    write(line, stack_key(args.int8, args.int4, args.tome), args.out_dir, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
