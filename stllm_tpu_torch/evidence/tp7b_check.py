"""The 7B tensor-parallel rules at work: the MVM train step under FSDP 2 x
TP 4, one rank on one card (script/tp7b_check.py).

The reference lowers the full MVM train step for a v5e 2x4 topology with a
(data 2, model 4) mesh and checks the rule table's placement at the 7B
shapes, that the optimized module holds all-gathers and reductions, and the
per-device peak. Here one rank of that mesh runs the step for real on
torch's fake process group (``_fake_group``), global batch 16 at sequence
768 with the reference's configuration (EVA-ViT-g, ``video_input: all``,
masking with the teacher pass, the LLaMA trainable, recompute), and checks:

  1. ``parallel.sharding.stllm_param_shardings`` puts 'model' on the output
     dim of every column-parallel q, k, v, gate and up and on the input dim
     of every row-parallel o and down, at the 7B shapes;
  2. the step's collectives, counted where ``parallel/collectives.py``
     issues them, equal the count and bytes derived from the plan
     (``llama_tp_plan``: the layers run on this rank's 8 heads and the
     head on its quarter of the vocabulary; ``_fake_group``);
  3. the per-rank peak of ``torch.cuda.max_memory_allocated`` fits the card.

    python -m stllm_tpu_torch.evidence.tp7b_check [--cpu] [--out-dir DIR]

Writes DIR/TP7B_CHECK.json (default evidence_out/) and exits 1 when a check
fails. XLA's module counts in the reference's TP7B_CHECK.json count ops of a
compiled program, not calls: they are no target.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
import sys
from typing import Dict, Optional

import torch

from stllm_tpu_torch.evidence import _common
from stllm_tpu_torch.evidence._fake_group import (
    card_memory_bytes, collectives_match, fake_group, gib)
from stllm_tpu_torch.evidence.mem7b import LR, failures, step_check, training_batch
from stllm_tpu_torch.models.llama import VICUNA_7B
from stllm_tpu_torch.models.stllm import STLLMConfig, init_stllm
from stllm_tpu_torch.models.vit import EVA_VIT_G
from stllm_tpu_torch.parallel.mesh import MODEL_AXIS, by_path, make_mesh
from stllm_tpu_torch.train.step import (
    create_train_state, default_trainable, make_optimizer, make_train_step)

HARNESS = "stllm_tpu_torch.evidence.tp7b_check"
DOC = "TP7B_CHECK.json"
FRAMES = 16
GLOBAL_BATCH = 16
DATA, MODEL = 2, 4
# (family, parallel kind, the weight dim split over 'model')
FAMILIES = (("q", "col", 1), ("k", "col", 1), ("v", "col", 1), ("gate", "col", 1),
            ("up", "col", 1), ("o", "row", 0), ("down", "row", 0))


def full_cfg(**kw) -> STLLMConfig:
    return STLLMConfig(vit=dataclasses.replace(EVA_VIT_G, remat=True),
                       llama=dataclasses.replace(VICUNA_7B, remat=True),
                       video_input="all", use_mask=True, max_txt_len=256, **kw)


def rule_checks(specs: Dict[str, tuple]) -> Dict[str, bool]:
    """{"<family>_<col|row>_parallel": every LLaMA layer's ``w`` of that
    family has 'model' on its dim} over a {path: spec} dict."""
    checks: Dict[str, bool] = {}
    for path, spec in specs.items():
        m = re.fullmatch(r"llama/layers/\d+/(\w+)/w", path)
        if not m:
            continue
        for fam, kind, dim in FAMILIES:
            if m.group(1) == fam:
                key = f"{fam}_{kind}_parallel"
                ok = len(spec) > dim and spec[dim] == MODEL_AXIS
                checks[key] = checks.get(key, True) and ok
    return checks


def run(cfg: STLLMConfig, device, rank: int = 0, global_batch: int = GLOBAL_BATCH,
        frames: int = FRAMES, data: int = DATA, model: int = MODEL,
        min_size: int = 2 ** 14) -> Dict:
    """Rank ``rank`` of a (data, model) fake mesh: the state by
    ``stllm_param_shardings``, its rule checks, then one step, measured."""
    device = torch.device(device)
    with fake_group(rank, data * model):
        mesh = make_mesh(data, model)
        params = init_stllm(torch.Generator(device=device).manual_seed(0), cfg)
        opt = make_optimizer(LR)
        state = create_train_state(params, opt, default_trainable(freeze_llm=False), mesh=mesh,
                                   min_size=min_size)
        del params
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        checks = rule_checks(by_path(state.tree, state.specs))
        step = make_train_step(cfg, opt, mesh=mesh)
        batch = training_batch(cfg, global_batch, frames)
        result = step_check(cfg, mesh, state, step, batch, 1, device)
        result.update(rank=rank, mesh={"data": data, "model": model}, tp_rule_checks=checks,
                      card_memory_bytes=card_memory_bytes(device))
    return result


def report(result: Dict, global_batch: int) -> Dict:
    """The reference's keys less its v5e peak and 16 GiB verdict, the rank's
    peak and the card's verdict in their place."""
    checks = result["tp_rule_checks"]
    card = result["card_memory_bytes"]
    bad = failures(result)
    rules_ok = len(checks) == len(FAMILIES) and all(checks.values())
    if not rules_ok:
        bad.append("tp_rules")
    if not (result["tp_plan"]["layers"] and result["tp_plan"]["head"]):
        bad.append("tp_plan")
    return {
        "what": "FSDP(2) x TP(4) 7B MVM train step, one rank run on a fake group",
        "tp_rule_checks": checks,
        "tp_rules_ok": rules_ok,
        "tp_plan": result["tp_plan"],
        "collectives": result["collectives"],
        "collectives_expected": result["collectives_expected"],
        "collectives_ok": collectives_match(result["collectives"],
                                            result["collectives_expected"]),
        "launches": result["launches"],
        "launches_expected": result.get("launches_expected"),
        "per_rank_peak_gib": gib(result["peak_bytes"]),
        "card_memory_gib": gib(card),
        "fits": None if card is None else bool(result["peak_bytes"] < card),
        "mesh": {**result["mesh"], "rank": result["rank"]},
        "micro_batch": result["micro_batch"],
        "global_batch": global_batch,
        "seq_len": result["seq_len"],
        "failed": bad,
    }


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="the 7B FSDP x TP train step on a (data 2, model 4) mesh, one rank on "
                    "one card")
    _common.add_device_args(parser)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    doc = _common.stamp(report(run(full_cfg(), device), GLOBAL_BATCH), device,
                        HARNESS)
    print(json.dumps(doc), flush=True)
    _common.write_doc(f"{args.out_dir}/{DOC}", doc)
    return 1 if doc["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
