"""Probe: where, and why, does 7B random-weight speculative serving leave
plain greedy?

The verify step computes the target's logits through another program shape
(a (B, k+1)-token forward) than the plain 1-token decode step, so bf16
reduction orders differ between the two, and random weights have tiny
top-2 margins: a sub-margin argmax tie can flip (the flip class that
EQUIV_INT8.json quantifies for int8 against bf16).

This decodes one Vicuna-7B stream (W4A16, fused, int8 head) from 512 random
prompt embeddings both ways through one ContinuousBatcher each, plain and
speculative (a 2-layer W4A16 draft, spec_k 4, 4 rounds a step), finds the
first divergent position, replays the plain path to it, and prints the
bf16 top-2 margin there and the rank of the speculative token. A margin
near 0 and rank 1 (the speculative token was the runner-up within noise)
confirms the tie class; a large margin or a deeper rank is a logic fault,
unless the gap to the speculative token lies within ``cache_floor``: how
far the same replay's logits move on the speculative batcher's longer
cache alone (several near-tied tokens can then swap at rank 2).

    python -m stllm_tpu_torch.evidence.probe_spec_divergence [--cpu]

Prints its findings and, last, one JSON line with them; writes no file.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from stllm_tpu_torch.evidence import _common
from stllm_tpu_torch.models.generation import GenerationConfig, _decode_step_impl, _prefill
from stllm_tpu_torch.models.llama import (
    VICUNA_7B, LlamaConfig, init_llama, llama_forward, lm_head, quantize_llama_params_int4)
from stllm_tpu_torch.serving import ContinuousBatcher

HARNESS = "stllm_tpu_torch.evidence.probe_spec_divergence"
PROMPT, NEW = 512, 64
SPEC_K, SPEC_ROUNDS, DRAFT_LAYERS = 4, 4, 2
CHUNK = 16


def to_w4(params: Dict) -> Dict:
    """W4A16 per-channel, q|k|v and gate|up fused, the int8 head; in place."""
    return quantize_llama_params_int4(params, group=None, free_dense=True, quant_head=True,
                                      fuse=True)


def build(device) -> Tuple[Dict, Dict, LlamaConfig]:
    """Vicuna-7B (seed 0) and its ``DRAFT_LAYERS``-layer draft (seed 9),
    each ``to_w4``."""
    params = to_w4(init_llama(torch.Generator(device=device).manual_seed(0), VICUNA_7B))
    dcfg = dataclasses.replace(VICUNA_7B, num_layers=DRAFT_LAYERS)
    draft = to_w4(init_llama(torch.Generator(device=device).manual_seed(9), dcfg))
    return params, draft, dcfg


def prompt_embeds(cfg: LlamaConfig, device, prompt: int = PROMPT) -> torch.Tensor:
    """(1, prompt, hidden) bf16 from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(1, prompt, cfg.hidden)) * 0.02).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)


def gen_config(new: int = NEW) -> GenerationConfig:
    return GenerationConfig(max_new_tokens=new, eos_token_id=-1, stop_sequences=(),
                            pad_to_multiple=64)


def max_len(prompt: int, new: int) -> int:
    return prompt + new + 16


def drain(params: Dict, cfg: LlamaConfig, emb: torch.Tensor, gen: GenerationConfig,
          draft: Optional[Dict] = None, dcfg: Optional[LlamaConfig] = None) -> List[int]:
    """One stream through a one-slot ContinuousBatcher, speculative when a
    draft is given."""
    kw = dict(draft_params=draft, draft_cfg=dcfg, spec_k=SPEC_K,
              spec_rounds=SPEC_ROUNDS) if draft is not None else {}
    cb = ContinuousBatcher(params, cfg, slots=1,
                           max_len=max_len(emb.shape[1], gen.max_new_tokens), chunk=CHUNK, **kw)
    cb.submit(0, emb, gen)
    return cb.run()[0]


@torch.no_grad()
def replay_logits(params: Dict, cfg: LlamaConfig, emb: torch.Tensor, plain: List[int],
                  div: int, cache_len: int) -> np.ndarray:
    """The plain path replayed (prefill into a cache of ``cache_len``, then
    one decode step per plain token before ``div``): the fp32 logits that
    chose ``plain[div]``."""
    mask = torch.ones((1, emb.shape[1]), dtype=torch.int32, device=emb.device)
    logits, cache = _prefill(params, emb, mask, cfg, cache_len)
    for t in plain[:div]:
        logits, cache = _decode_step_impl(
            params, torch.tensor([t], dtype=torch.int32, device=emb.device), cache, cfg)
    return logits[0].float().cpu().numpy()


@torch.no_grad()
def verify_shape_logits(params: Dict, cfg: LlamaConfig, emb: torch.Tensor, plain: List[int],
                        div: int, cache_len: int) -> np.ndarray:
    """The logits that chose ``plain[div]`` from the verify step's shape: the
    plain path replayed to ``div - SPEC_K - 1`` tokens, then one forward of
    the ``SPEC_K + 1`` plain tokens before ``div``, its last row."""
    mask = torch.ones((1, emb.shape[1]), dtype=torch.int32, device=emb.device)
    _, cache = _prefill(params, emb, mask, cfg, cache_len)
    start = div - SPEC_K - 1
    for t in plain[:start]:
        _, cache = _decode_step_impl(
            params, torch.tensor([t], dtype=torch.int32, device=emb.device), cache, cfg)
    seq = torch.tensor([plain[start:div]], dtype=torch.int32, device=emb.device)
    h, _ = llama_forward(params, input_ids=seq, cache=cache, cfg=cfg)
    return lm_head(params, h[:, -1:])[0, 0].float().cpu().numpy()


def replay(params: Dict, cfg: LlamaConfig, emb: torch.Tensor, plain: List[int],
           spec_token: int, div: int, new: int) -> Dict:
    """The plain path's logits at ``div``: its top-1, the speculative
    token's rank there, the top1 - top2 margin and the top1 - spec gap.
    Also ``cache_floor``: the largest change of those logits when the same
    replay runs on the speculative batcher's cache, ``SPEC_K + 1`` slots
    longer (its verify slack): the attention's reductions over a longer
    buffer round otherwise, so this is the bf16 noise the two paths differ
    by before any logic does. And ``verify_shape_floor``: the same, for the
    verify step's (SPEC_K + 1)-row forward on the plain path's own cache
    (None where ``div`` leaves no room for it)."""
    s = emb.shape[1]
    lg = replay_logits(params, cfg, emb, plain, div, max_len(s, new))
    longer = replay_logits(params, cfg, emb, plain, div, max_len(s, new) + SPEC_K + 1)
    shaped = (verify_shape_logits(params, cfg, emb, plain, div, max_len(s, new))
              if div > SPEC_K else None)
    order = np.argsort(-lg, kind="stable")
    return {"top1": int(order[0]), "spec_token": int(spec_token),
            "spec_rank": int(np.where(order == spec_token)[0][0]),
            "top1_top2_margin": float(lg[order[0]] - lg[order[1]]),
            "top1_spec_gap": float(lg[order[0]] - lg[spec_token]),
            "cache_floor": float(np.abs(longer - lg).max()),
            "verify_shape_floor": None if shaped is None else float(np.abs(shaped - lg).max())}


def run(params: Dict, cfg: LlamaConfig, draft: Dict, dcfg: LlamaConfig, emb: torch.Tensor,
        new: int = NEW) -> Dict:
    """Both drains, the first divergence and, where there is one, the
    replay's margin and rank."""
    gen = gen_config(new)
    plain = drain(params, cfg, emb, gen)
    spec = drain(params, cfg, emb, gen, draft, dcfg)
    div = next((i for i, (a, b) in enumerate(zip(plain, spec)) if a != b), None)
    print(f"plain[:16]={plain[:16]}\nspec [:16]={spec[:16]}\n"
          f"first divergence at index: {div}", flush=True)
    out = {"prompt": emb.shape[1], "new_tokens": new, "spec_k": SPEC_K,
           "spec_rounds": SPEC_ROUNDS, "draft_layers": dcfg.num_layers,
           "plain": plain, "spec": spec, "first_divergence": div}
    if div is None:
        print("no divergence — cannot reproduce", flush=True)
        return out
    r = replay(params, cfg, emb, plain, spec[div], div, new)
    print(f"plain top1={r['top1']} (={plain[div]}), spec tok={spec[div]} "
          f"rank={r['spec_rank']}, top1-top2 margin={r['top1_top2_margin']:.5f}, "
          f"top1-spec gap={r['top1_spec_gap']:.5f}", flush=True)
    print(f"logits of the same replay on the speculative cache move by up to "
          f"{r['cache_floor']:.5f}; through the verify step's {SPEC_K + 1}-row forward "
          f"by up to {r['verify_shape_floor']}", flush=True)
    out.update(r)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="find where W4A16 Vicuna-7B speculative serving first leaves plain "
                    "greedy, and the margin and rank there")
    _common.add_device_args(parser, out_dir=None)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    params, draft, dcfg = build(device)
    out = run(params, VICUNA_7B, draft, dcfg, prompt_embeds(VICUNA_7B, device))
    print(json.dumps(_common.stamp(out, device, HARNESS)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
