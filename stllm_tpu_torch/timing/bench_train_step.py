"""A measured training step of the frozen-LLM instruction-tuning
configuration the reference ships (trainable: BTAdapter, llama_proj, the
residual module and LoRA; ViT trunk, Q-Former and LLaMA frozen; reference
st_llm.py:182-185, 257-296), with the frozen Vicuna-7B base in weight-only
int8 (``ops/quant.w8a16_matmul``, differentiable in the activations, so
the LoRA and projection gradients are exact for the quantized base). The
MVM teacher pass is on; ViT and LLaMA recompute in the backward.

Batch: 1 sample x 16 frames, sequence 768 (512 video tokens + 256 text).
One first step, then ``--steps`` timed ones: ms a step (their mean) and
samples/s, with every step's seconds.

    python -m stllm_tpu_torch.timing.bench_train_step [--bf16-base] [--steps N]
        [--lora-r R] [--layers L] [--no-mask] [--cpu]

``--bf16-base`` keeps the base in bf16: the outcome, a fit or an out-of-
memory error, is printed as the result. Prints one JSON line; writes no
file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from stllm_tpu_torch.data.packing import pack_training_batch, sample_video_mask
from stllm_tpu_torch.models.llama import VICUNA_7B, init_llama, quantize_llama_params
from stllm_tpu_torch.models.lora import add_lora
from stllm_tpu_torch.models.stllm import STLLMConfig, init_stllm
from stllm_tpu_torch.models.vit import EVA_VIT_G
from stllm_tpu_torch.timing import _common
from stllm_tpu_torch.train.step import (
    TrainState, create_train_state, default_trainable, make_optimizer, make_train_step)

HARNESS = "stllm_tpu_torch.timing.bench_train_step"
T_FRAMES = 16
SEQ = 768
IMAGE = 224


def make_cfg(layers: int = 32, no_mask: bool = False) -> STLLMConfig:
    return STLLMConfig(
        vit_model="eva_btadapter_g",
        vit=dataclasses.replace(EVA_VIT_G, gelu_approx=True, remat=True),
        llama=dataclasses.replace(VICUNA_7B, remat=True, num_layers=layers, max_positions=2048),
        use_mask=not no_mask,
    )


def build_batch(cfg: STLLMConfig, rng, device) -> Dict[str, torch.Tensor]:
    """One packed sample (40 + video + 60 text tokens, a 100-token answer)
    with the MVM keep mask, 16 normal frames and 32 Q-Former ids."""
    b = 1
    v = cfg.num_video_tokens(T_FRAMES)
    keep = sample_video_mask(rng, b, v)
    before = [list(rng.integers(10, 30000, 40))] * b
    after = [list(rng.integers(10, 30000, 60))] * b
    answer = [list(rng.integers(10, 30000, 100))] * b
    batch = pack_training_batch(before, after, answer, num_video=v, seq_len=SEQ, pad_id=0,
                                keep=keep)
    batch = {k: torch.from_numpy(np.asarray(val)).to(device) for k, val in batch.items()}
    batch["frames"] = torch.from_numpy(rng.normal(size=(b, T_FRAMES, IMAGE, IMAGE, 3))).to(
        device=device, dtype=torch.bfloat16)
    batch["qformer_input_ids"] = torch.from_numpy(rng.integers(0, 30000, (b, 32))).to(
        device=device, dtype=torch.int32)
    batch["qformer_attention_mask"] = torch.ones((b, 32), dtype=torch.int32, device=device)
    return batch


def build_params(cfg: STLLMConfig, device, bf16_base: bool = False, lora_r: int = 16) -> Dict:
    """The stack on the seeds of the JAX script (LLaMA 2, the rest 0, LoRA
    1): the LLaMA built and quantized alone first, then the vision tower."""
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)
    if bf16_base:
        params = init_stllm(gen(0), cfg)
    else:
        llama = quantize_llama_params(init_llama(gen(2), cfg.llama), free_dense=True, a16=True)
        params = init_stllm(gen(0), cfg, init_llama_params=False)
        params["llama"] = llama
    return add_lora(params, gen(1), r=lora_r)


def build_train_step(cfg: STLLMConfig, params: Dict) -> Tuple[TrainState, Callable]:
    optimizer = make_optimizer(learning_rate=1e-4)
    state = create_train_state(params, optimizer, default_trainable())
    return state, make_train_step(cfg, optimizer)


def run_train_step(state: TrainState, train_step: Callable, batch: Dict[str, torch.Tensor],
                   steps: int = 8) -> Dict:
    """The first step (timed on its own), then ``steps`` timed steps."""
    device = batch["token_ids"].device
    (state, metrics), first_s = _common.clock(lambda: train_step(state, batch), device)
    first_loss = float(metrics["loss"])
    print(f"first step: {first_s:.1f}s  loss={first_loss:.3f}", flush=True)
    step_s = []
    for _ in range(steps):
        (state, metrics), dt = _common.clock(lambda: train_step(state, batch), device)
        step_s.append(dt)
    dt = sum(step_s) / steps
    out = {"ms_per_step": dt * 1e3, "samples_per_s": 1.0 / dt, "step_s": step_s,
           "first_step_s": first_s, "first_loss": first_loss, "loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]), "frames": T_FRAMES, "seq": SEQ}
    print(f"train step: {out['ms_per_step']:.0f} ms/step  ({out['samples_per_s']:.2f} "
          f"samples/s, micro-batch 1 x {T_FRAMES} frames, seq {SEQ})")
    print(f"loss={out['loss']:.3f} grad_norm={out['grad_norm']:.3f}", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="measured BTAdapter QA training step (LoRA on a weight-only int8 "
                    "Vicuna-7B base, MVM teacher pass, remat)")
    parser.add_argument("--bf16-base", action="store_true",
                        help="keep the frozen LLaMA base in bf16 (prints a fit or an "
                             "out-of-memory error as the outcome)")
    parser.add_argument("--steps", type=int, default=8, help="timed steps (default 8)")
    parser.add_argument("--lora-r", type=int, default=16, help="LoRA rank (default 16)")
    parser.add_argument("--layers", type=int, default=32, help="LLaMA depth (bisection aid)")
    parser.add_argument("--no-mask", action="store_true",
                        help="disable the MVM teacher pass (bisection aid)")
    _common.add_device_args(parser, None)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    cfg = make_cfg(args.layers, args.no_mask)
    head = {"harness": HARNESS, "device": _common.device_line(device),
            "base": "bf16" if args.bf16_base else "int8 weight-only", "layers": args.layers,
            "lora_r": args.lora_r, "mvm": not args.no_mask}
    print("initializing full-size params ...", flush=True)
    try:
        state, step = build_train_step(cfg, build_params(cfg, device, args.bf16_base,
                                                         args.lora_r))
        result = run_train_step(state, step, build_batch(cfg, np.random.default_rng(0), device),
                                args.steps)
    except torch.cuda.OutOfMemoryError as e:
        if not args.bf16_base:
            raise
        print(json.dumps({**head, "outcome": "out of memory", "error": str(e)[:300]}),
              flush=True)
        return 0
    print(json.dumps({**head, "outcome": "fit", **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
