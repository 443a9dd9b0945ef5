"""Sustained full-pipeline video-QA serving throughput on one card.

One QA = 16-frame encode (EVA-ViT-g static-int8 + Q-Former + llama_proj)
-> prompt assembly (64 prefix + 512 video + 32 suffix tokens = 608) ->
Vicuna-7B prefill -> 16-token greedy answer, the shape of ``bench_pipeline``
(reference per-sample loop: stllm/test/mvbench/mv_bench.py:229-283). Here
the QAs flow through ``pipeline_serving.VideoQAServer`` (chunk 8): encodes
admit lazily into free decode slots, and decode advances every slot a
chunk, so co-resident answers share the weight stream. The serial arm is
the same server at one slot over 4 requests, scaled to 16. Each arm is the
best of 3 drains after a warm one; every drain's seconds are kept.

Decode stack: fused W4A16 + int8 lm_head. ``--tome=L`` applies a named
token-merging level; under ``auto`` the traffic alternates smooth synthetic
video and iid noise and each request resolves its own level.

    python -m stllm_tpu_torch.timing.bench_pipeline_serving [--tome=LEVEL] [--slots=N]
        [--cpu] [--out-dir DIR]

Merges a section keyed by the level ("base" without one) into
DIR/BENCH_PIPELINE_SERVING.json and prints it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from stllm_tpu_torch.data.synth import noise_video, synth_video
from stllm_tpu_torch.models.generation import GenerationConfig
from stllm_tpu_torch.models.llama import quantize_llama_params_int4
from stllm_tpu_torch.models.stllm import STLLMConfig, init_stllm
from stllm_tpu_torch.models.vit import EVA_VIT_G, calibrate_vit_scales, quantize_vit_params
from stllm_tpu_torch.ops.tome import level_kwargs, select_merge_level
from stllm_tpu_torch.pipeline_serving import VideoQAServer
from stllm_tpu_torch.timing import _common

HARNESS = "stllm_tpu_torch.timing.bench_pipeline_serving"
DOC = "BENCH_PIPELINE_SERVING.json"
FRAMES = 16
PREFIX, SUFFIX, ANSWER = 64, 32, 16
N_REQUESTS = 16
SERIAL_REQUESTS = 4
CHUNK = 8
MAX_LEN = 768
DRAINS = 3


def make_cfg(tome: Optional[str] = None) -> STLLMConfig:
    cfg = STLLMConfig(vit=dataclasses.replace(EVA_VIT_G, gelu_approx=True), video_input="all")
    if tome == "auto":
        # the level resolves per request from its own frames, at submit
        return dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, merge_level="auto"))
    if tome:
        return dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, **level_kwargs(tome)))
    return cfg


def build_pipeline_serving(device, tome: Optional[str] = None, seed: int = 0,
                           llama: Optional[Dict] = None, cfg: STLLMConfig = None
                           ) -> Tuple[Dict, STLLMConfig]:
    """The static-int8 plain ViT-g (calibrated on 16 uint8 frames of
    ``default_rng(0)``) and the fused W4A16 LLaMA with an int8 head; a
    given ``llama`` tree (already in that form) is used as it is."""
    cfg = cfg or make_cfg(tome)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_stllm(gen, cfg, init_llama_params=llama is None)
    params["vit"] = quantize_vit_params(params["vit"], free_dense=True)
    params["llama"] = llama if llama is not None else quantize_llama_params_int4(
        params["llama"], group=None, free_dense=True, quant_head=True, fuse=True)
    rng = np.random.default_rng(0)
    s = cfg.vit.image_size
    calib = torch.from_numpy(rng.integers(0, 256, (16, s, s, 3)).astype(np.uint8)).to(device)
    params["vit"] = calibrate_vit_scales(params["vit"], calib, cfg.vit)
    return params, cfg


def gen_cfg() -> GenerationConfig:
    return GenerationConfig(max_new_tokens=ANSWER, stop_sequences=(), eos_token_id=-1,
                            pad_to_multiple=64)


@torch.no_grad()
def drain(params: Dict, cfg: STLLMConfig, slots: int, n: int, chunk: int = CHUNK,
          selected: Optional[Dict[str, int]] = None, drains: int = DRAINS
          ) -> Tuple[float, List[float], Dict]:
    """One fixed request set (``default_rng(1)``): all-noise frames, or
    under ``auto`` smooth and noise clips in turn (``selected`` counts the
    levels they resolve to). A warm drain, then ``drains`` timed ones, each
    submitting fresh token ids from the same stream. Returns the best
    seconds, every timed drain's seconds and the last drain's answers."""
    device = params["llama"]["embed_tokens"].device
    rng = np.random.default_rng(1)
    gen = gen_cfg()
    vocab = cfg.llama.vocab_size
    mixed = cfg.vit.merge_level == "auto"
    size = cfg.vit.image_size
    all_frames = []
    for i in range(n):
        if mixed and i % 2 == 0:
            f = synth_video(rng, FRAMES, size)
        elif mixed:
            f = noise_video(rng, FRAMES, size)
        else:
            f = rng.integers(0, 256, (1, FRAMES, size, size, 3))
        f = np.asarray(f, np.uint8)
        all_frames.append(torch.from_numpy(f).to(device))
        if mixed and selected is not None:
            lvl = select_merge_level(f)
            selected[lvl] = selected.get(lvl, 0) + 1

    def submit_all(srv):
        for i in range(n):
            srv.submit(i, all_frames[i], rng.integers(0, vocab, (1, PREFIX)),
                       rng.integers(0, vocab, (1, SUFFIX)), gen,
                       qformer_text_ids=rng.integers(0, cfg.qformer.vocab_size, (1, 16)))

    srv = VideoQAServer(params, cfg, slots=slots, max_len=MAX_LEN, chunk=chunk)
    submit_all(srv)
    out = srv.run()                          # warm
    assert len(out) == n and all(len(t) == ANSWER for t in out.values())
    times = []
    for _ in range(drains):
        srv = VideoQAServer(params, cfg, slots=slots, max_len=MAX_LEN, chunk=chunk)
        submit_all(srv)
        out, dt = _common.clock(srv.run, device)
        times.append(dt)
        assert len(out) == n and all(len(t) == ANSWER for t in out.values())
    return min(times), times, out


def run_pipeline_serving(params: Dict, cfg: STLLMConfig, tome: Optional[str] = None,
                         slots: int = 4, drains: int = DRAINS) -> Dict:
    """The serving arm (``slots`` slots, 16 requests) and the serial arm
    (1 slot, 4 requests, scaled to 16): the JAX script's document, every
    drain's seconds and both arms' answers."""
    selected: Dict[str, int] = {}
    t_serve, serve_s, answers = drain(params, cfg, slots, N_REQUESTS, selected=selected,
                                      drains=drains)
    t_one, serial_s, serial_answers = drain(params, cfg, 1, SERIAL_REQUESTS, drains=drains)
    t_serial = t_one * (N_REQUESTS / SERIAL_REQUESTS)
    doc = {
        "metric": "sustained video-QA serving on one card "
                  "(16-frame encode + 608-tok prefill + 16-tok greedy "
                  "answer per QA, encode interleaved with batched decode)",
        "stack": "static-int8 ViT + fused W4A16 LLaMA + int8 head"
                 + (f" + tome={tome}" if tome else ""),
        "slots": slots,
        "n_requests": N_REQUESTS,
        "qa_per_s": round(N_REQUESTS / t_serve, 2),
        "serial_qa_per_s": round(1.0 / (t_serial / N_REQUESTS), 2),
        "speedup_vs_serial": round(t_serial / t_serve, 2),
        "serve_drain_s": serve_s,
        "serial_drain_s": serial_s,
    }
    if tome == "auto":
        doc["traffic"] = ("mixed: alternating smooth synthetic video and "
                          "iid noise; level resolved per request at submit")
        doc["auto_selected"] = selected
    print(json.dumps(doc), flush=True)
    return {**doc, "answers": answers, "serial_answers": serial_answers}


def write(result: Dict, tome: Optional[str], out_dir: str, device) -> str:
    section = {k: v for k, v in result.items() if k not in ("answers", "serial_answers")}
    _common.stamp(section, device, HARNESS)
    return _common.merge_doc(out_dir, DOC, lambda doc: doc.__setitem__(tome or "base", section))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="sustained full-pipeline video-QA serving throughput (static-int8 ViT-g, "
                    "fused W4A16 Vicuna-7B)")
    parser.add_argument("--tome", default=None,
                        help="a named token-merging level, or auto (default: none)")
    parser.add_argument("--slots", type=int, default=4, help="decode slots (default 4)")
    _common.add_device_args(parser, _common.OUT_DIR)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    params, cfg = build_pipeline_serving(device, args.tome)
    write(run_pipeline_serving(params, cfg, args.tome, args.slots), args.tome, args.out_dir,
          device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
