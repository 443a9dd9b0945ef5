"""The 7B MVM train step's memory under FSDP over 8 ranks, one rank on one
card (script/mem7b_v5e8.py).

The reference compiles the full MVM train step ahead of time for a v5e-8
topology and records the compiler's per-device memory analysis. Here the
step runs for real as one rank of a (data 8, model 1) mesh on torch's fake
process group (``_fake_group``): the reference's QA configuration at full
width and depth (EVA-ViT-g with the BTAdapter branch, 16 frames,
``video_input: all``; the Q-Former; the masked student and the no-gradient
teacher Vicuna-7B pass; CE plus the MVM loss with its decoder; AdamW;
recompute on the ViT and the LLaMA), sequence length 768 and global batch
128, its leaves split over 'data' by the script's own rule (its
``fsdp_state_shardings``, min_size 2**15), which ``stllm_param_shardings``
gives on a model-1 mesh at that ``min_size``. The collectives move no data,
so the numbers are the rank's: the bytes of its parameters and optimizer
state, the peak of ``torch.cuda.max_memory_allocated`` over one step (reset
before it) and its micro-batch; the step's collectives and attention
launches are held to what the code implies.

    python -m stllm_tpu_torch.evidence.mem7b [accum_steps] [--cpu]
        [--out-dir DIR]

Writes DIR/MEM7B.json (default evidence_out/) and exits 1 when a check
fails. The reference's v5e figures (MEM7B_V5E8.json) are no target: this
rank gathers the whole tree at the step's start (``compute_tree``), which
the compiled step never holds at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from stllm_tpu_torch.data.packing import pack_training_batch, sample_video_mask
from stllm_tpu_torch.evidence import _common
from stllm_tpu_torch.evidence._fake_group import (
    card_memory_bytes, collectives_match, fake_group, gib, measured, nbytes,
    state_bytes, train_step_collectives, train_step_launches)
from stllm_tpu_torch.models.llama import VICUNA_7B
from stllm_tpu_torch.models.stllm import STLLMConfig, init_stllm
from stllm_tpu_torch.models.vit import EVA_VIT_G
from stllm_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, by_path, make_mesh
from stllm_tpu_torch.parallel.sharding import llama_tp_plan
from stllm_tpu_torch.train.step import (
    create_train_state, default_trainable, make_optimizer, make_train_step)

HARNESS = "stllm_tpu_torch.evidence.mem7b"
DOC = "MEM7B.json"
GLOBAL_BATCH = 128   # reference: 8 GPUs x per_device_train_batch_size 16
FRAMES = 16
DATA = 8
MIN_SIZE = 2 ** 15
LR = 2e-5


def full_cfg(**kw) -> STLLMConfig:
    """The QA configuration at full size, recompute on both towers."""
    return STLLMConfig(vit=dataclasses.replace(EVA_VIT_G, remat=True),
                       llama=dataclasses.replace(VICUNA_7B, remat=True),
                       vit_model="eva_btadapter_g", video_input="all", use_mask=True,
                       mvm_decode=True, max_txt_len=256, **kw)


def training_batch(cfg: STLLMConfig, batch: int, frames: int, seed: int = 0
                   ) -> Dict[str, torch.Tensor]:
    """The reference's synthetic batch: 24 instruction tokens, the video, 40
    more and a 48-token answer a row, masked as the MVM objective masks,
    packed to video tokens + ``max_txt_len``; zero bf16 frames and a
    32-token Q-Former question."""
    v = cfg.num_video_tokens(frames)
    rng = np.random.default_rng(seed)
    keep = sample_video_mask(rng, batch, v)
    out = pack_training_batch([[5] * 24] * batch, [[6] * 40] * batch, [[7] * 48] * batch,
                              num_video=v, seq_len=v + cfg.max_txt_len, pad_id=0, keep=keep)
    t = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in out.items()}
    size = cfg.vit.image_size
    t["frames"] = torch.zeros((batch, frames, size, size, 3), dtype=torch.bfloat16)
    t["qformer_input_ids"] = torch.zeros((batch, 32), dtype=torch.int32)
    t["qformer_attention_mask"] = torch.ones((batch, 32), dtype=torch.int32)
    return t


def step_check(cfg: STLLMConfig, mesh: Mesh, state, step, batch: Dict[str, torch.Tensor],
               accum_steps: int, device) -> Dict:
    """One step of ``step`` on ``state`` with its counts: the measured and
    the derived collectives and (on the card) attention launches, the peak
    and the rank's micro-batch."""
    rows = batch["token_ids"].shape[0]
    n = mesh.shape[DATA_AXIS]
    split = n > 1 and rows % (accum_steps * n) == 0
    local_rows = rows // (accum_steps * n) if split else rows // accum_steps
    seq = batch["token_ids"].shape[1]
    plan = llama_tp_plan(mesh, state.tree.get("llama"), state.specs.get("llama"),
                         cfg.llama.heads)
    teacher = "mvm_weight" in batch
    want = train_step_collectives(mesh, state, plan, cfg.llama, local_rows, seq, accum_steps,
                                  split, teacher, 2 + int(teacher))
    (_, metrics), got = measured(lambda: step(state, batch), device)
    launches = train_step_launches(cfg, accum_steps, teacher)
    out = {"micro_batch": local_rows, "seq_len": seq, "tp_plan": plan._asdict(),
           "collectives": got["collectives"], "collectives_expected": want,
           "peak_bytes": got["peak_bytes"], "launches": got["launches"],
           "metrics": sorted(metrics)}
    if torch.device(device).type == "cuda":
        out["launches_expected"] = launches
    return out


def failures(result: Dict) -> list:
    """The checks a step result fails: its collectives against the
    derivation, on the card its attention launches and its peak against
    the card's memory."""
    bad = []
    if not collectives_match(result["collectives"], result["collectives_expected"]):
        bad.append("collectives")
    want = result.get("launches_expected")
    if want is not None:
        got = {k: result["launches"].get(k, 0) for k in want}
        if got != want or set(result["launches"]) - set(want):
            bad.append("launches")
    if result.get("card_memory_bytes") and result["peak_bytes"] >= result["card_memory_bytes"]:
        bad.append("peak")
    return bad


def run(cfg: STLLMConfig, device, rank: int = 0, global_batch: int = GLOBAL_BATCH,
        frames: int = FRAMES, accum_steps: int = 1, data: int = DATA,
        min_size: int = MIN_SIZE) -> Dict:
    """Rank ``rank`` of a (data ``data``, model 1) fake mesh: the state by
    ``stllm_param_shardings`` at the script's ``min_size`` (on a model-1
    mesh, the script's ZeRO-3 rule), then one step, measured."""
    device = torch.device(device)
    with fake_group(rank, data):
        mesh = make_mesh(data, 1)
        params = init_stllm(torch.Generator(device=device).manual_seed(0), cfg)
        opt = make_optimizer(LR)
        state = create_train_state(params, opt, default_trainable(freeze_llm=False), mesh=mesh,
                                   min_size=min_size)
        del params
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        step = make_train_step(cfg, opt, accum_steps=accum_steps, mesh=mesh)
        batch = training_batch(cfg, global_batch, frames)
        result = step_check(cfg, mesh, state, step, batch, accum_steps, device)
        result.update(
            rank=rank, mesh={"data": data, "model": 1},
            params_bytes=sum(map(nbytes, by_path(state.tree, state.tree).values())),
            trainable_params_bytes=sum(map(nbytes, state.params.values())),
            opt_state_bytes=state_bytes(state.opt_state),
            card_memory_bytes=card_memory_bytes(device))
    return result


def report(result: Dict, global_batch: int, accum_steps: int, frames: int) -> Dict:
    """The document: the reference's keys less its TPU topology and XLA
    memory-analysis fields, the rank's own figures in their place."""
    card = result["card_memory_bytes"]
    return {
        "what": "full MVM train step (student + teacher Vicuna-7B, EVA-ViT-g + BTAdapter, "
                "Q-Former), FSDP over a 'data' axis of 8, one rank run on a fake group",
        "reference_parity": "config/instructblipbase_stllm_qa.yaml + train/zero3.json "
                            "(8-GPU ZeRO-3, batch 16/dev)",
        "global_batch": global_batch,
        "accum_steps": accum_steps,
        "micro_batch_per_device": result["micro_batch"],
        "seq_len": result["seq_len"],
        "frames": frames,
        "mesh": {**result["mesh"], "rank": result["rank"]},
        "per_rank": {"params_gib": gib(result["params_bytes"]),
                     "trainable_params_gib": gib(result["trainable_params_bytes"]),
                     "opt_state_gib": gib(result["opt_state_bytes"]),
                     "peak_gib": gib(result["peak_bytes"])},
        "card_memory_gib": gib(card),
        "fits": None if card is None else bool(result["peak_bytes"] < card),
        "collectives": result["collectives"],
        "collectives_expected": result["collectives_expected"],
        "launches": result["launches"],
        "launches_expected": result.get("launches_expected"),
        "failed": failures(result),
    }


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m " + HARNESS,
        description="7B MVM train step memory under FSDP over 8 ranks, one rank on one card")
    parser.add_argument("accum_steps", nargs="?", type=int, default=1,
                        help="micro-batches a step of the global batch 128 (default 1)")
    _common.add_device_args(parser)
    args = parser.parse_args(argv)
    device = _common.pick_device(args, parser.prog)
    if device is None:
        return 1
    result = run(full_cfg(), device, accum_steps=args.accum_steps)
    doc = _common.stamp(report(result, GLOBAL_BATCH, args.accum_steps, FRAMES), device, HARNESS)
    print(json.dumps(doc), flush=True)
    _common.write_doc(f"{args.out_dir}/{DOC}", doc)
    return 1 if doc["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
