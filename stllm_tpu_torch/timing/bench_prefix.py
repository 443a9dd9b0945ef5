"""Multi-turn chat latency: full re-prefill against PrefixSession KV reuse.

Every chat turn of the reference re-prefills the whole conversation
(stllm/conversation/conversation.py:222-243): system text, the video
tokens and every earlier turn. ``PrefixSession`` keeps the conversation's
KV cache across turns and prefills only the new tail, so a late turn's
latency stops growing with the history. Three arms on Vicuna-7B W4A16
(fused, int8 head), each turn-1 prompt 608 tokens (16 text + 576 video + 16
question), greedy:

- ``chat_608``: 4 turns, +48 tokens a turn, 32 new tokens a turn;
- ``long_2k``: 12 turns, +128 a turn (96-token answers), history about 2k;
- ``long_4k``: 14 turns, +256 a turn (192-token answers), history about
  3.9k (``max_positions`` 4352).

Each arm runs each conversation once to warm, then once timed, both ways,
then again with one new token a turn (the time to the first token, which
is what reuse removes). Every turn's milliseconds are kept.

    python -m stllm_tpu_torch.timing.bench_prefix [arms ...] [--cpu] [--out-dir DIR]

Merges each arm into DIR/BENCH_PREFIX.json["arms"] as it finishes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from stllm_tpu_torch.models.generation import GenerationConfig, PrefixSession, generate
from stllm_tpu_torch.models.llama import VICUNA_7B, LlamaConfig
from stllm_tpu_torch.ops.layers import gather_rows
from stllm_tpu_torch.timing import _common
from stllm_tpu_torch.timing.bench_decode import build_decode

HARNESS = "stllm_tpu_torch.timing.bench_prefix"
DOC = "BENCH_PREFIX.json"
PROMPT0 = 608          # system + 576 video tokens + first question
VIDEO = 576
TEXT = 16

ARMS = {
    #        turns, answer, question, max_len, max_positions
    "chat_608": (4, 32, 16, 2048, 2048),
    "long_2k": (12, 96, 32, 2304, 2304),
    "long_4k": (14, 192, 64, 4352, 4352),
}


def build_prefix(device, seed: int = 0, base: Dict = None) -> Tuple[Dict, LlamaConfig]:
    return build_decode("int4f", device, seed, base, VICUNA_7B)


def conversation_embs(params: Dict, rng, turns_n: int, answer: int, question: int,
                      cfg: LlamaConfig) -> List[Tuple[torch.Tensor, List]]:
    """Per-turn (embeddings, items): random text ids embedded through the
    real table, and one fixed random video slab that every turn holds by
    identity, as a held upload is."""
    device = params["embed_tokens"].device
    video = torch.from_numpy(rng.normal(size=(1, VIDEO, cfg.hidden)) * 0.02).to(
        device=device, dtype=torch.bfloat16)
    vref = PrefixSession._Ref(video)
    pre = list(rng.integers(10, 30000, TEXT))
    q0 = list(rng.integers(10, 30000, TEXT))

    def embed(ids):
        rows = torch.as_tensor([ids], dtype=torch.int64, device=device)
        return gather_rows(params["embed_tokens"], rows).to(torch.bfloat16)

    embs = torch.cat([embed(pre), video, embed(q0)], dim=1)
    items = ([("t", int(t)) for t in pre] + [("v", vref, j) for j in range(VIDEO)]
             + [("t", int(t)) for t in q0])
    assert embs.shape[1] == PROMPT0
    turns = [(embs, items)]
    for _ in range(1, turns_n):
        ans = list(rng.integers(10, 30000, answer))
        q = list(rng.integers(10, 30000, question))
        embs = torch.cat([embs, embed(ans), embed(q)], dim=1)
        items = items + [("t", int(i)) for i in ans] + [("t", int(i)) for i in q]
        turns.append((embs, items))
    return turns


@torch.no_grad()
def run_full(params, turns, gen, cfg, answer) -> Tuple[List[float], List[List[int]]]:
    device = params["embed_tokens"].device
    ms, outs = [], []
    for embs, _ in turns:
        out, dt = _common.clock(lambda: generate(params, embs, llama_cfg=cfg, gen=gen), device)
        assert len(out[0]) == answer
        ms.append(dt * 1e3)
        outs.append(out[0])
    return ms, outs


@torch.no_grad()
def run_session(params, turns, gen, cfg, answer, max_len
                ) -> Tuple[List[float], List[int], List[List[int]]]:
    device = params["embed_tokens"].device
    sess = PrefixSession(params, cfg, max_len=max_len)
    ms, reused, outs = [], [], []
    for embs, items in turns:
        out, dt = _common.clock(lambda: sess.generate(embs, items, gen), device)
        assert len(out) == answer
        ms.append(dt * 1e3)
        reused.append(sess.last_reused)
        outs.append(out)
    sess.release()
    return ms, reused, outs


def run_arm(params: Dict, name: str, cfg: LlamaConfig = VICUNA_7B) -> Dict:
    """One arm: its section of the document, with every turn's tokens."""
    turns_n, answer, question, max_len, max_pos = ARMS[name]
    cfg = dataclasses.replace(cfg, max_positions=max_pos)
    gen = GenerationConfig(max_new_tokens=answer, stop_sequences=(), eos_token_id=-1,
                           pad_to_multiple=64)
    rng = np.random.default_rng(0)
    turns = conversation_embs(params, rng, turns_n, answer, question, cfg)

    print(f"[{name}] warm pass ...", flush=True)
    run_full(params, turns, gen, cfg, answer)
    full, full_out = run_full(params, turns, gen, cfg, answer)
    print(f"[{name}] full re-prefill  per-turn ms: {[round(m, 1) for m in full]}", flush=True)
    run_session(params, turns, gen, cfg, answer, max_len)
    sess_ms, reused, sess_out = run_session(params, turns, gen, cfg, answer, max_len)
    print(f"[{name}] prefix session   per-turn ms: {[round(m, 1) for m in sess_ms]}  "
          f"reused: {reused}", flush=True)
    gen1 = dataclasses.replace(gen, max_new_tokens=1)
    run_full(params, turns, gen1, cfg, 1)
    ttft_full, _ = run_full(params, turns, gen1, cfg, 1)
    run_session(params, turns, gen1, cfg, 1, max_len)
    ttft_sess, _, _ = run_session(params, turns, gen1, cfg, 1, max_len)
    print(f"[{name}] TTFT full {[round(m, 1) for m in ttft_full]} "
          f"session {[round(m, 1) for m in ttft_sess]}", flush=True)

    later_full = sum(full[1:]) / (turns_n - 1)
    later_sess = sum(sess_ms[1:]) / (turns_n - 1)
    history = PROMPT0 + (turns_n - 1) * (answer + question)
    return {
        "protocol": f"{turns_n}-turn video chat: turn-1 prompt {PROMPT0} "
                    f"tokens (576 video), each turn +{answer}-token answer "
                    f"+{question}-token question, {answer} greedy "
                    f"tokens/turn, final history {history} tokens",
        "turn_ms_full_reprefill": [round(m, 1) for m in full],
        "turn_ms_prefix_session": [round(m, 1) for m in sess_ms],
        "tokens_reused_per_turn": reused,
        "turn1_ratio_session_over_full": round(sess_ms[0] / full[0], 3),
        "turn2plus_avg_ms_full": round(later_full, 1),
        "turn2plus_avg_ms_session": round(later_sess, 1),
        "turn2plus_speedup": round(later_full / later_sess, 2),
        "last_turn_speedup": round(full[-1] / sess_ms[-1], 2),
        "ttft_ms_full": [round(m, 1) for m in ttft_full],
        "ttft_ms_session": [round(m, 1) for m in ttft_sess],
        "ttft_turn2plus_speedup": round(sum(ttft_full[1:]) / max(sum(ttft_sess[1:]), 1e-9), 2),
        "ttft_last_turn_speedup": round(ttft_full[-1] / ttft_sess[-1], 2),
        "note": "whole-turn speedup is bounded by decode (answer tokens "
                "cost the same either way); TTFT is what prefix reuse "
                "removes",
        "raw_ms": {"full": full, "session": sess_ms, "ttft_full": ttft_full,
                   "ttft_session": ttft_sess},
        "tokens": {"full": full_out, "session": sess_out},
    }


def write_arm(name: str, arm: Dict, out_dir: str, device) -> str:
    def update(doc):
        doc["stack"] = "7B W4A16 fused + int8 head, one CUDA card"
        doc.setdefault("arms", {})[name] = {k: v for k, v in arm.items() if k != "tokens"}
        _common.stamp(doc, device, HARNESS)
    return _common.merge_doc(out_dir, DOC, update)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="multi-turn video-chat latency, full re-prefill against PrefixSession, "
                    "on Vicuna-7B W4A16")
    parser.add_argument("arms", nargs="*", metavar="ARM",
                        help=f"arms, of {' '.join(ARMS)} (default: all)")
    _common.add_device_args(parser, _common.OUT_DIR)
    args = parser.parse_args(argv)
    unknown = [a for a in args.arms if a not in ARMS]
    if unknown:
        parser.error(f"unknown arms {unknown}")
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    params, cfg = build_prefix(device)
    for name in args.arms or list(ARMS):
        arm = run_arm(params, name, cfg)
        path = write_arm(name, arm, args.out_dir, device)
        print(json.dumps({name: {k: v for k, v in arm.items() if k != "tokens"}}), flush=True)
    print(json.dumps({"written": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
