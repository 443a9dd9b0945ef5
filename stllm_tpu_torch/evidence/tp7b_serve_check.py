"""7B tensor-parallel serving in bf16 under TP 4, one rank on one card
(script/tp7b_serve_check.py).

The reference compiles, against a 4-chip v5e topology, the 512-token
prefill and the production 16-step greedy decode chunk with the LLaMA's
leaves split by the TP rules and the KV cache split over heads on 'model',
and checks each program's per-chip peak and that the decode carries a TP
reduction a layer. Here one rank of a (data 1, model 4) mesh runs both for
real on torch's fake process group (``_fake_group``): its leaves by
``stllm_param_shardings``, the layers on its 8 heads with a cache of those
heads and the head on its quarter of the vocabulary (``llama_tp_plan``).
Each program's collectives are counted where ``parallel/collectives.py``
issues them and held to the plan's: two all-reduces of the activations a
layer (after o and after down) and one all-gather of the fp32 logits, once
for the prefill and once a decode step. The per-rank peak is
``torch.cuda.max_memory_allocated`` from a reset before each program.

    python -m stllm_tpu_torch.evidence.tp7b_serve_check [--cpu]
        [--out-dir DIR]

Writes DIR/TP7B_SERVE.json (default evidence_out/) and exits 1 when a check
fails. The reference's v5e figures (TP7B_SERVE.json) are no target.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from stllm_tpu_torch.evidence import _common
from stllm_tpu_torch.evidence._fake_group import (
    card_memory_bytes, collectives_match, empty_counts, fake_group, gather_collectives, gib,
    measured)
from stllm_tpu_torch.models.generation import _decode_chunk_greedy, _prefill
from stllm_tpu_torch.models.llama import VICUNA_7B, LlamaConfig, init_llama
from stllm_tpu_torch.ops.spmd import model_parallel
from stllm_tpu_torch.parallel.mesh import MODEL_AXIS, by_path, make_mesh
from stllm_tpu_torch.parallel.sharding import (
    compute_tree, llama_tp_plan, shard_tree, stllm_param_shardings)

HARNESS = "stllm_tpu_torch.evidence.tp7b_serve_check"
DOC = "TP7B_SERVE.json"
PROMPT, NEW, CHUNK = 512, 64, 16
MODEL = 4


def program_collectives(cfg: LlamaConfig, rows: int, seq: int, calls: int) -> Dict:
    """``calls`` forwards of (rows, seq) tokens on the tensor-parallel
    stack: two all-reduces a layer of (rows, seq, hidden) activations and
    one all-gather of the (rows, vocab) fp32 logits of a row's last token."""
    out = empty_counts()
    act = rows * seq * cfg.hidden * torch.empty((), dtype=cfg.dtype).element_size()
    out["all_reduce"] = {"calls": 2 * cfg.num_layers * calls,
                         "bytes": 2 * cfg.num_layers * calls * act}
    out["all_gather"] = {"calls": calls, "bytes": calls * rows * cfg.vocab_size * 4}
    return out


@torch.no_grad()
def run(cfg: LlamaConfig, device, rank: int = 0, prompt: int = PROMPT, new: int = NEW,
        chunk: int = CHUNK, model: int = MODEL, min_size: int = 2 ** 14) -> Dict:
    """Rank ``rank`` of a (1, ``model``) fake mesh: the rank's leaves, the
    leaves it computes with, then the prefill and one decode chunk, each
    measured."""
    device = torch.device(device)
    with fake_group(rank, model):
        mesh = make_mesh(1, model)
        params = init_llama(torch.Generator(device=device).manual_seed(0), cfg)
        specs = stllm_param_shardings(mesh, {"llama": params}, min_size)["llama"]
        local = shard_tree(mesh, params, specs)
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
        plan = llama_tp_plan(mesh, local, specs, cfg.heads)
        want_setup = empty_counts()
        gather_collectives(mesh, by_path(local, local), by_path(local, specs), plan, want_setup)
        tree, setup = measured(lambda: compute_tree(mesh, local, specs, plan), device)
        rng = np.random.default_rng(0)
        emb = torch.from_numpy(rng.normal(size=(1, prompt, cfg.hidden)) * 0.02).to(
            device=device, dtype=cfg.dtype)
        mask = torch.ones((1, prompt), dtype=torch.int32, device=device)
        with model_parallel(mesh.groups[MODEL_AXIS], plan):
            (logits, cache), pre = measured(lambda: _prefill(tree, emb, mask, cfg, prompt + new),
                                            device)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            (toks, cache), dec = measured(
                lambda: _decode_chunk_greedy(tree, tok, cache, cfg, chunk), device)
        kv_heads = int(cache.k[0].shape[2])
        return {
            "rank": rank, "mesh": {"data": 1, "model": model}, "tp_plan": plan._asdict(),
            "kv_heads_per_rank": kv_heads, "kv_heads_expected": cfg.heads // model,
            "tokens_shape": list(toks.shape),
            "setup": {**setup, "collectives_expected": want_setup},
            "prefill": {**pre, "collectives_expected": program_collectives(cfg, 1, prompt, 1)},
            "decode_chunk": {**dec,
                             "collectives_expected": program_collectives(cfg, 1, 1, chunk)},
            "card_memory_bytes": card_memory_bytes(device),
        }


def report(result: Dict, cfg: LlamaConfig) -> Dict:
    """The reference's keys less its per-chip v5e peaks and 16 GiB verdict,
    the rank's peaks and the card's verdict in their place."""
    card = result["card_memory_bytes"]
    programs = ("prefill", "decode_chunk")
    peaks = {p: gib(result[p]["peak_bytes"]) for p in programs}
    dec = result["decode_chunk"]["collectives"]
    bad = [p for p in ("setup",) + programs
           if not collectives_match(result[p]["collectives"], result[p]["collectives_expected"])]
    if result["kv_heads_per_rank"] != result["kv_heads_expected"]:
        bad.append("kv_heads")
    if not (result["tp_plan"]["layers"] and result["tp_plan"]["head"]):
        bad.append("tp_plan")
    fits = None if card is None else all(result[p]["peak_bytes"] < card for p in programs)
    if fits is False:
        bad.append("peak")
    reductions_ok = dec["all_reduce"]["calls"] + dec["reduce_scatter"]["calls"] >= cfg.num_layers
    return {
        "what": "TP(4) 7B bf16 serving (prefill + 16-step greedy decode chunk), one rank run "
                "on a fake group",
        "per_rank_peak_gib": peaks,
        "card_memory_gib": gib(card),
        "fits": fits,
        "collectives": {p: result[p]["collectives"] for p in ("setup",) + programs},
        "collectives_expected": {p: result[p]["collectives_expected"]
                                 for p in ("setup",) + programs},
        "tp_reductions_ok": reductions_ok,
        # all-reduces a layer a forward: the prefill is one forward, the
        # chunk one a decoded token
        "tp_reductions_per_layer": {
            p: result[p]["collectives"]["all_reduce"]["calls"] / (cfg.num_layers * n)
            for p, n in (("prefill", 1), ("decode_chunk", result["tokens_shape"][1]))},
        "launches": {p: result[p]["launches"] for p in programs},
        "tp_plan": result["tp_plan"],
        "kv_heads_per_rank": result["kv_heads_per_rank"],
        "mesh": {**result["mesh"], "rank": result["rank"]},
        "failed": bad,
        "ok": not bad and reductions_ok,
    }


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="7B bf16 prefill and decode chunk under TP 4, one rank on one card")
    _common.add_device_args(parser)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    doc = _common.stamp(report(run(VICUNA_7B, device), VICUNA_7B), device, HARNESS)
    print(json.dumps(doc), flush=True)
    _common.write_doc(f"{args.out_dir}/{DOC}", doc)
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
