"""W4A16 accuracy against decoder depth on trained proxies.

Per-matmul quantization error compounds with depth, and the production
decoder is 32 layers deep. This measures how the error grows with depth,
and whether per-group scales (g=128, g=64, which the int4 packing supports)
close the gap.

Protocol per depth d (default 4, 8, 16): train a full-width (4096 / 11008,
32 heads, vocab 32000) d-layer LLaMA to map n random 24-token prompt
embeddings to fixed 16-token answers (the production CE, batch 4, lr 2e-4,
``make_probe_optimizer``: AdamW, or Adafactor above 1.5e9 parameters); then
for each weight form (int8 W8A8, W4A16 per-channel, g=128, g=64) compare
greedy answers with the trained bf16 stack and record the first answer
position's logit error. Per-group int4 runs plain torch (the reference
leaves it to XLA); per-channel int4 runs the W4A16 kernel.

    python -m stllm_tpu_torch.evidence.w4a16_depth [steps] [n] [depths...] [--cpu] [--out-dir DIR]

Writes DIR/EQUIV_INT8.json["w4a16_depth_scaling"], merge-preserving.
Protocol anchor: beam-5 / greedy answers, reference
stllm/test/qabench/msvd_qa.py:108-115.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from stllm_tpu_torch.evidence import _common
from stllm_tpu_torch.models.generation import GenerationConfig, _pad_prompt, _prefill, generate
from stllm_tpu_torch.models.llama import (
    LlamaConfig, init_llama, llama_forward, lm_head, quantize_llama_params,
    quantize_llama_params_int4)
from stllm_tpu_torch.ops.layers import gather_rows
from stllm_tpu_torch.train.step import (
    Adafactor, create_train_state, make_probe_optimizer, make_train_step, tree_paths)

HARNESS = "stllm_tpu_torch.evidence.w4a16_depth"
PROMPT = 24
ANSWER = 16
WIDTH, INTER, HEADS, VOCAB = 4096, 11008, 32, 32000
BATCH = 4
LR = 2e-4


def make_cfg(depth: int, max_positions: int = 128) -> LlamaConfig:
    return LlamaConfig(vocab_size=VOCAB, hidden=WIDTH, num_layers=depth, heads=HEADS,
                       intermediate=INTER, max_positions=max_positions)


def build_data(rng, n: int, cfg: LlamaConfig, prompt: int = PROMPT) -> List[Dict]:
    """``n`` (prompt embeddings (1, prompt, hidden) fp32, 16 answer ids)."""
    data = []
    for _ in range(n):
        data.append({
            "prompt": (rng.normal(size=(1, prompt, cfg.hidden)) * 0.02).astype(np.float32),
            "answer": list(rng.integers(10, cfg.vocab_size - 10, ANSWER)),
        })
    return data


def stack(data: List[Dict], device) -> Dict[str, torch.Tensor]:
    """All of ``data`` as one batch: prompt (n, P, hidden), answer (n, 16)."""
    return {"prompt": torch.from_numpy(np.concatenate([d["prompt"] for d in data])).to(device),
            "answer": torch.as_tensor(np.asarray([d["answer"] for d in data], np.int64),
                                      device=device)}


def answer_loss(tree: Dict, batch: Dict[str, torch.Tensor], cfg: LlamaConfig) -> Dict:
    """The answers' embeddings after the prompt's; mean CE of each answer
    token from the position before it (positions P-1 .. P+A-2)."""
    prompt, ans = batch["prompt"], batch["answer"]
    p = prompt.shape[1]
    x = torch.cat([prompt.to(cfg.dtype), gather_rows(tree["embed_tokens"], ans).to(cfg.dtype)],
                  dim=1)
    hidden, _ = llama_forward(tree, inputs_embeds=x, cfg=cfg)
    logits = lm_head(tree, hidden[:, p - 1:p + ans.shape[1] - 1])
    return {"loss": -torch.log_softmax(logits.float(), -1).gather(-1, ans[..., None]).mean()}


def make_step(cfg: LlamaConfig, opt):
    return make_train_step(cfg, opt, loss_fn=answer_loss)


def train(params: Dict, cfg: LlamaConfig, data: List[Dict], steps: int) -> Dict:
    """``steps`` steps in place on ``params``, batch i taking samples
    4i .. 4i+3 (mod n). Returns the optimizer's name and the losses."""
    n = len(data)
    opt = make_probe_optimizer(params, LR)
    name = "adafactor" if isinstance(opt, Adafactor) else "adamw"
    n_params = sum(p.numel() for _, p in tree_paths(params))
    print(f"depth {cfg.num_layers}: {n_params / 1e9:.2f}B params, {name}, {steps} steps",
          flush=True)
    state = create_train_state(params, opt, trainable_fn=lambda path: True)
    step = make_step(cfg, opt)
    all_of = stack(data, params["embed_tokens"].device)
    losses = []
    t0 = time.perf_counter()
    for it in range(steps):
        sel = torch.as_tensor(np.arange(it * BATCH, (it + 1) * BATCH) % n,
                              device=all_of["prompt"].device)
        state, metrics = step(state, {k: v[sel] for k, v in all_of.items()})
        losses.append(metrics["loss"].detach())
        if (it + 1) % 100 == 0:
            print(f"  step {it + 1}: loss {float(losses[-1]):.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    for _, p in tree_paths(params):
        p.requires_grad_(False)
    return {"optimizer": name, "losses": [float(x) for x in losses]}


@torch.no_grad()
def greedy(params: Dict, cfg: LlamaConfig, prompt: np.ndarray) -> List[int]:
    gen = GenerationConfig(max_new_tokens=ANSWER, stop_sequences=(), eos_token_id=-1,
                           pad_to_multiple=8)
    x = torch.from_numpy(prompt).to(params["embed_tokens"].device)
    return generate(params, x, llama_cfg=cfg, gen=gen)[0]


@torch.no_grad()
def first_logits(params: Dict, cfg: LlamaConfig, prompt: np.ndarray) -> np.ndarray:
    """fp32 logits at the first answer position (the prefill's last), as
    float64."""
    x = torch.from_numpy(prompt).to(params["embed_tokens"].device)
    mask = torch.ones((1, x.shape[1]), dtype=torch.int32, device=x.device)
    e, m = _pad_prompt(x, mask, 8)
    logits, _ = _prefill(params, e, m, cfg, e.shape[1] + ANSWER)
    return logits[0].double().cpu().numpy()


VARIANTS: Dict[str, Callable[[Dict], Dict]] = {
    "int8": lambda p: quantize_llama_params(p),
    "w4a16_per_channel": lambda p: quantize_llama_params_int4(p, group=None),
    "w4a16_g128": lambda p: quantize_llama_params_int4(p, group=128),
    "w4a16_g64": lambda p: quantize_llama_params_int4(p, group=64),
}


def grade(bf16_ans: List[List[int]], q_ans: List[List[int]], margins: List[float],
          logit_errs: List[float]) -> Dict:
    flips = np.asarray([a[0] != b[0] for a, b in zip(q_ans, bf16_ans)])
    m = np.asarray(margins)
    return {
        "first_token_match": float((~flips).mean()),
        "exact_16_match": sum(a == b for a, b in zip(bf16_ans, q_ans)) / len(bf16_ans),
        "mean_abs_logit_err_first_pos": round(float(np.mean(logit_errs)), 4),
        "max_margin_flipped": (round(float(m[flips].max()), 4) if flips.any() else 0.0),
    }


@torch.no_grad()
def evaluate(params: Dict, cfg: LlamaConfig, data: List[Dict]) -> Dict:
    """The trained bf16 answers and margins, then each quantized form of
    ``params`` graded against them."""
    bf16_ans = [greedy(params, cfg, d["prompt"]) for d in data]
    bf16_lg = [first_logits(params, cfg, d["prompt"]) for d in data]
    target_ok = sum(a == d["answer"] for a, d in zip(bf16_ans, data))
    margins = [float(np.sort(lg)[-1] - np.sort(lg)[-2]) for lg in bf16_lg]
    print(f"  targets matched {target_ok}/{len(data)}; median margin "
          f"{np.median(margins):.3f}", flush=True)
    out = {"bf16_targets_matched": target_ok / len(data),
           "median_margin": round(float(np.median(margins)), 4), "variants": {}}
    for name, build in VARIANTS.items():
        qp = build(params)
        q_ans, errs = [], []
        for d, blg in zip(data, bf16_lg):
            q_ans.append(greedy(qp, cfg, d["prompt"]))
            errs.append(float(np.abs(first_logits(qp, cfg, d["prompt"]) - blg).mean()))
        del qp
        out["variants"][name] = grade(bf16_ans, q_ans, margins, errs)
        print(f"  {name}: {json.dumps(out['variants'][name])}", flush=True)
    return out


def run_depth(params: Dict, cfg: LlamaConfig, data: List[Dict], steps: int) -> Dict:
    """One row: train ``params`` in place, then grade every variant."""
    trained = train(params, cfg, data, steps)
    ev = evaluate(params, cfg, data)
    return {"depth": cfg.num_layers, "n": len(data), "train_steps": steps,
            "optimizer": trained["optimizer"],
            "bf16_targets_matched": ev["bf16_targets_matched"],
            "median_margin": ev["median_margin"], "variants": ev["variants"]}


def write(rows: List[Dict], out_dir: str, device) -> str:
    path = os.path.join(out_dir, _common.EQUIV_INT8)
    doc = _common.read_doc(path)
    doc["w4a16_depth_scaling"] = _common.stamp({
        "model": "full-width (4096/11008, 32 heads) LLaMA at varying depth, "
                 "trained to emit fixed 16-token answers from random "
                 "prompt embeddings",
        "rows": rows,
    }, device, HARNESS)
    _common.write_doc(path, doc)
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="int8 and W4A16 answer equivalence against decoder depth on trained "
                    "full-width LLaMA proxies")
    parser.add_argument("steps", nargs="?", type=int, default=400,
                        help="training steps a depth (default 400)")
    parser.add_argument("n", nargs="?", type=int, default=16, help="samples (default 16)")
    parser.add_argument("depths", nargs="*", type=int, default=[4, 8, 16],
                        help="decoder depths (default 4 8 16)")
    _common.add_device_args(parser)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    rng = np.random.default_rng(11)
    rows = []
    for depth in args.depths:
        cfg = make_cfg(depth)
        params = init_llama(torch.Generator(device=device).manual_seed(depth), cfg)
        rows.append(run_depth(params, cfg, build_data(rng, args.n, cfg), args.steps))
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
    write(rows, args.out_dir, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
