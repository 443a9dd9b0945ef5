"""Measured speculative-decode speedup on a trained model at full width.

Random weights give an acceptance near 0, and no released checkpoint is
at hand, so this trains the models it needs at full matmul widths:

  1. the target, a 4-layer 4096-wide LLaMA (vocab 4000), trained with
     teacher-forced CE to emit fixed 64-token answers to 8 fixed 16-token
     prompts (``optax.adamw(3e-4)``'s rule);
  2. a 1-layer draft distilled on the target's own outputs
     (``models/distill.py``, the production draft recipe);
  3. greedy ``generate`` against ``speculative_generate`` (k 6) on the same
     prompts: one warm pass over the 8 prompts, then 3 timed, ms/token over
     their sum, with every pass's seconds kept. The outputs must agree.

The draft/target depth ratio here (1/4) is worse than production's (a
2-layer draft for 32 layers, 1/16), so the speedup is a floor for the
mechanism. The vocabulary is 4000 so that the head keeps a production-like
share of the weight bytes.

    python -m stllm_tpu_torch.timing.bench_spec_trained [train_steps] [distill_steps]
        [--cpu] [--out-dir DIR]

Writes a "trained_demo" section into DIR/BENCH_SPEC.json, keeping the rest.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from stllm_tpu_torch.models.distill import distill_draft, distill_optimizer
from stllm_tpu_torch.models.generation import GenerationConfig, generate
from stllm_tpu_torch.models.llama import LlamaConfig, init_llama, llama_forward, lm_head
from stllm_tpu_torch.models.speculative import speculative_generate
from stllm_tpu_torch.ops.layers import gather_rows
from stllm_tpu_torch.timing import _common
from stllm_tpu_torch.train.step import create_train_state, make_train_step, tree_paths

HARNESS = "stllm_tpu_torch.timing.bench_spec_trained"
DOC = "BENCH_SPEC.json"
CFG_T = LlamaConfig(vocab_size=4000, hidden=4096, num_layers=4, heads=32, intermediate=11008,
                    max_positions=512)
CFG_D = dataclasses.replace(CFG_T, num_layers=1)
N_PROMPTS, PROMPT, ANSWER = 8, 16, 64
K = 6
ITERS = 3
TARGET_LR, DRAFT_LR = 3e-4, 1e-3


def build_data(rng, cfg: LlamaConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """prompts (8, 16, hidden) bf16 and answers (8, 64) from ``rng``."""
    prompts = torch.from_numpy(rng.normal(size=(N_PROMPTS, PROMPT, cfg.hidden)) * 0.02).to(
        device=device, dtype=torch.bfloat16)
    answers = torch.from_numpy(rng.integers(10, cfg.vocab_size - 100, (N_PROMPTS, ANSWER))).to(
        device=device, dtype=torch.int64)
    return prompts, answers


def answer_loss(cfg: LlamaConfig):
    """Mean CE of each answer token from the position before it, the
    prompt followed by the embedded answer minus its last token."""
    def loss_fn(tree: Dict, batch: Dict[str, torch.Tensor], _cfg) -> Dict:
        prompts, answers = batch["prompts"], batch["answers"]
        tok = gather_rows(tree["embed_tokens"], answers[:, :-1]).to(cfg.dtype)
        hidden, _ = llama_forward(tree, inputs_embeds=torch.cat([prompts.to(cfg.dtype), tok], 1),
                                  cfg=cfg)
        logits = lm_head(tree, hidden[:, PROMPT - 1:PROMPT + ANSWER - 1])
        logp = torch.log_softmax(logits.float(), dim=-1)
        return {"loss": -logp.gather(-1, answers[..., None]).mean()}
    return loss_fn


def train_target(tgt: Dict, cfg: LlamaConfig, prompts: torch.Tensor, answers: torch.Tensor,
                 steps: int) -> List[float]:
    """``steps`` full-batch steps on ``tgt`` in place; the losses."""
    opt = distill_optimizer(TARGET_LR)
    state = create_train_state(tgt, opt, trainable_fn=lambda path: True)
    step = make_train_step(cfg, opt, loss_fn=answer_loss(cfg))
    batch = {"prompts": prompts, "answers": answers}
    losses = []
    t0 = time.perf_counter()
    for it in range(steps):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].detach())
        if (it + 1) % 100 == 0:
            print(f"target step {it + 1}: loss {float(losses[-1]):.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    for _, p in tree_paths(tgt):
        p.requires_grad_(False)
    return [float(x) for x in losses]


def build_trained_pair(device, train_steps: int, distill_steps: int,
                       cfg_t: LlamaConfig = None, cfg_d: LlamaConfig = None) -> Dict:
    """The data (``default_rng(0)``), the target (seed 0) trained
    ``train_steps`` and the draft (seed 1) distilled ``distill_steps``."""
    cfg_t, cfg_d = cfg_t or CFG_T, cfg_d or CFG_D
    prompts, answers = build_data(np.random.default_rng(0), cfg_t, device)
    tgt = init_llama(torch.Generator(device=device).manual_seed(0), cfg_t)
    losses = train_target(tgt, cfg_t, prompts, answers, train_steps)
    dft = init_llama(torch.Generator(device=device).manual_seed(1), cfg_d)
    dft = distill_draft(tgt, dft, lambda i: (prompts[i % N_PROMPTS][None],
                                             answers[i % N_PROMPTS][None]),
                        tgt_cfg=cfg_t, dft_cfg=cfg_d, steps=distill_steps,
                        learning_rate=DRAFT_LR, log_every=100)
    return {"tgt": tgt, "dft": dft, "cfg_t": cfg_t, "cfg_d": cfg_d, "prompts": prompts,
            "answers": answers, "losses": losses}


def gen_cfg() -> GenerationConfig:
    return GenerationConfig(max_new_tokens=ANSWER, eos_token_id=-1, stop_sequences=(),
                            pad_to_multiple=16)


@torch.no_grad()
def run_spec_trained(pair: Dict, k: int = K, iters: int = ITERS) -> Dict:
    tgt, dft, cfg_t, cfg_d = pair["tgt"], pair["dft"], pair["cfg_t"], pair["cfg_d"]
    prompts, answers = pair["prompts"], pair["answers"]
    device = prompts.device
    gen = gen_cfg()
    greedy = [generate(tgt, prompts[i:i + 1], llama_cfg=cfg_t, gen=gen)[0]
              for i in range(N_PROMPTS)]
    trained_ok = sum(g == answers[i].tolist() for i, g in enumerate(greedy))
    print(f"greedy answers matching train targets: {trained_ok}/{N_PROMPTS}", flush=True)

    def time_loop(fn):
        fn()                                           # warm
        _, times = _common.repeats(fn, iters, device)
        return sum(times) * 1e3 / (iters * N_PROMPTS * ANSWER), times

    greedy_ms, greedy_s = time_loop(lambda: [
        generate(tgt, prompts[i:i + 1], llama_cfg=cfg_t, gen=gen) for i in range(N_PROMPTS)])
    stats_all = []

    def run_spec():
        outs = []
        for i in range(N_PROMPTS):
            out, st = speculative_generate(tgt, dft, prompts[i:i + 1], tgt_cfg=cfg_t,
                                           dft_cfg=cfg_d, gen=gen, k=k, return_stats=True)
            outs.append(out[0])
            stats_all.append(st)
        return outs

    spec_ms, spec_s = time_loop(run_spec)
    spec_out = run_spec()
    for i, (g, s) in enumerate(zip(greedy, spec_out)):
        assert g == s, f"spec output diverged from greedy on prompt {i}"
    result = {
        "target": "4-layer 4096-wide LLaMA (trained to emit fixed answers)",
        "draft": "1-layer distilled (models/distill.py) — depth ratio 1/4 "
                 "vs production's ~1/16: speedup here is a conservative floor",
        "k": k,
        "train_targets_matched": f"{trained_ok}/{N_PROMPTS}",
        "measured_acceptance": round(float(np.mean([s["mean_accepted"] for s in stats_all])), 2),
        "greedy_ms_per_token": round(greedy_ms, 3),
        "speculative_ms_per_token": round(spec_ms, 3),
        "speedup": round(greedy_ms / spec_ms, 2),
        "outputs_token_identical": True,
        "greedy_pass_s": greedy_s,
        "speculative_pass_s": spec_s,
    }
    print(json.dumps(result), flush=True)
    return {**result, "greedy": greedy, "stats": stats_all}


def write(result: Dict, out_dir: str, device) -> str:
    section = _common.stamp({k: v for k, v in result.items() if k not in ("greedy", "stats")},
                            device, HARNESS)
    return _common.merge_doc(out_dir, DOC, lambda doc: doc.__setitem__("trained_demo", section))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="speculative decoding on a trained 4-layer 4096-wide target with a "
                    "distilled 1-layer draft")
    parser.add_argument("train_steps", nargs="?", type=int, default=400,
                        help="target training steps (default 400)")
    parser.add_argument("distill_steps", nargs="?", type=int, default=300,
                        help="draft distillation steps (default 300)")
    _common.add_device_args(parser, _common.OUT_DIR)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    pair = build_trained_pair(device, args.train_steps, args.distill_steps)
    write(run_spec_trained(pair), args.out_dir, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
