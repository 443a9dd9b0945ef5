"""Training entry point: one config-driven CLI (stllm_tpu/train/train.py).

Usage:
  python -m stllm_tpu_torch.train.train --cfg-path config/instructblipbase_stllm_qa.yaml
  python -m stllm_tpu_torch.train.train --cfg-path config/tiny_debug.yaml \\
      --synthetic-data 8 --cpu   # offline smoke run with synthetic media
  torchrun --nproc-per-node 8 -m stllm_tpu_torch.train.train --cfg-path CFG \\
      --data-parallel 4 --model-parallel 2   # FSDP x TP over 8 cards

It runs on the CUDA card unless given ``--cpu``. Running it again into the
same ``run.output_dir`` resumes from the newest checkpoint there. The
``run:`` section keeps the reference's HF-style keys (learning_rate,
num_train_epochs, per_device_train_batch_size, gradient_accumulation_steps,
warmup_ratio, logging_steps, save_steps, output_dir...). Under ``torchrun``
(a world of more than one rank) each rank joins the process group
(``parallel.mesh.init_distributed``: NCCL on its card, gloo with ``--cpu``)
and trains on a (``--data-parallel``, ``--model-parallel``) mesh; the global
batch is ``per_device_train_batch_size`` times the data axis. A mesh larger
than the world raises.

``run(cfg, args, datasets=None)`` is the CLI without its argument parsing,
so a caller can hand in its own datasets.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
from typing import List, Optional

import numpy as np
import torch.distributed as dist


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg-path", required=True)
    p.add_argument("--options", nargs="+", default=None)
    p.add_argument("--max-steps", type=int, default=None,
                   help="override computed step count")
    p.add_argument("--synthetic-data", type=int, default=0,
                   help="use N synthetic videos instead of the corpus (smoke runs)")
    p.add_argument("--data-parallel", type=int, default=None)
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--cpu", action="store_true", help="train on the CPU")
    return p.parse_args(argv)


def _write_synthetic(tmp_dir: str, n: int, image_size: int) -> str:
    """n flat-colour mp4s written with cv2 and their annotation file."""
    import cv2

    os.makedirs(f"{tmp_dir}/vids", exist_ok=True)
    anno = []
    for i in range(n):
        path = f"{tmp_dir}/vids/{i}.mp4"
        if not os.path.exists(path):
            vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                                 (image_size, image_size))
            for j in range(24):
                vw.write(np.full((image_size, image_size, 3), (i * 37 + j * 5) % 255, np.uint8))
            vw.release()
        anno.append({"video": f"{i}.mp4", "QA": [{"q": f"question {i}?", "a": f"answer {i}"}]})
    ann_path = f"{tmp_dir}/anno.json"
    with open(ann_path, "w") as f:
        json.dump(anno, f)
    return ann_path


def build_datasets(cfg, run_cfg, synthetic: int, tmp_dir: str, device=None):
    """IT video datasets from the corpus registry, or ``synthetic`` mp4s
    written under ``tmp_dir``. Frames take the reference's train transform
    (RandomResizedCrop(image_size, 0.5-1), bicubic, on ``device``) and stay
    uint8: CLIP normalization happens inside encode_img."""
    from stllm_tpu_torch.data.datasets import ITVidTrainDataset
    from stllm_tpu_torch.data.processors import random_resized_crop

    num_frames = int(run_cfg.get("num_frames", 16))
    image_size = int(run_cfg.get("image_size", 224))
    rrc_rng = np.random.default_rng(int(run_cfg.get("seed", 42)))

    def transform(frames):
        return random_resized_crop(rrc_rng, frames, image_size, device=device).astype(np.uint8)

    if synthetic:
        ann_path = _write_synthetic(tmp_dir, synthetic, image_size)
        return [ITVidTrainDataset([ann_path, f"{tmp_dir}/vids", "video"], transform=transform,
                                  num_frames=num_frames, seed=42)]

    from stllm_tpu_torch.data.instruction_data import available_corpus

    datasets = []
    for name, ds_cfg in (cfg.datasets_cfg or {}).items():
        spec = available_corpus[name]
        nf = int(ds_cfg.get("num_frames", num_frames)) if ds_cfg else num_frames
        datasets.append(ITVidTrainDataset(
            spec, transform=transform, num_frames=nf, seed=42,
            video_reader_type=(ds_cfg or {}).get("video_reader_type", "decord")))
    return datasets


def run(cfg, args, datasets=None):
    """Build the model, loaders, schedule and Trainer from ``cfg`` (a
    common.config.Config) and train to the step count; resumes from
    ``run.output_dir`` when it holds a checkpoint. Returns (model, trainer,
    final averages)."""
    from stllm_tpu_torch.common.optim import warmup_cosine_decay
    from stllm_tpu_torch.common.registry import registry
    from stllm_tpu_torch.data.collate import TrainCollator
    from stllm_tpu_torch.data.loaders import DataLoader, IterLoader, MetaLoader
    from stllm_tpu_torch.models.zoo import ensure_tokenizers
    from stllm_tpu_torch.parallel.mesh import DATA_AXIS, init_distributed, make_mesh
    from stllm_tpu_torch.train.step import make_optimizer
    from stllm_tpu_torch.train.trainer import Trainer

    device = init_distributed("cpu" if args.cpu else None)
    mesh = None
    if dist.is_initialized() or (args.data_parallel or 1) * args.model_parallel > 1:
        mesh = make_mesh(data=args.data_parallel, model=args.model_parallel)
    run_cfg = cfg.run_cfg
    model_cfg = cfg.model_cfg
    model = registry.get_model_class(model_cfg["arch"]).from_config(model_cfg, device=device)
    output_dir = str(run_cfg.get("output_dir", "output"))
    if datasets is None:
        # rank 0 writes the synthetic media; the others read them after it
        world = None if mesh is None else mesh.world
        if world is not None and mesh.rank != 0:
            dist.barrier(world)
        datasets = build_datasets(cfg, run_cfg, args.synthetic_data,
                                  os.path.join(output_dir, "synthetic_data"), device=device)
        if world is not None and mesh.rank == 0:
            dist.barrier(world)
    batch_size = int(run_cfg.get("per_device_train_batch_size", 2)) * (
        mesh.shape[DATA_AXIS] if mesh is not None else 1)
    accum = int(run_cfg.get("gradient_accumulation_steps", 1))

    ensure_tokenizers(model)
    collate = TrainCollator(model.cfg, model.llama_tokenizer,
                            qformer_tokenizer=model.qformer_tokenizer, seed=42)
    loaders = [IterLoader(DataLoader(ds, batch_size * accum, collate,
                                     num_workers=int(run_cfg.get("dataloader_num_workers", 4)),
                                     seed=42))
               for ds in datasets]
    meta = iter(MetaLoader(loaders, seed=42))

    steps_per_epoch = sum(len(l) for l in loaders)
    epochs = float(run_cfg.get("num_train_epochs", 1))
    max_steps = args.max_steps or max(1, math.ceil(steps_per_epoch * epochs))
    warmup = int(max_steps * float(run_cfg.get("warmup_ratio", 0.0)))
    lr = warmup_cosine_decay(0.0, float(run_cfg.get("learning_rate", 1e-4)), max(warmup, 1),
                             max_steps)
    optimizer = make_optimizer(lr, weight_decay=float(run_cfg.get("weight_decay", 0.0)))
    trainer = Trainer(
        model.cfg, model.params, optimizer, output_dir=output_dir, device=device, mesh=mesh,
        accum_steps=accum, trainable_fn=model.trainable_fn(),
        log_freq=int(run_cfg.get("logging_steps", 10)),
        save_freq=int(run_cfg.get("save_steps", 1000)))
    trainer.resume_if_available()
    stats = trainer.train(meta, max_steps)
    return model, trainer, stats


def main(argv: Optional[List[str]] = None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from stllm_tpu_torch.common.config import Config

    cfg = Config(args.cfg_path, options=args.options)
    _, _, stats = run(cfg, args)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print("final:", stats)
    return stats


if __name__ == "__main__":
    main()
    if dist.is_initialized():       # under torchrun: each rank leaves its group
        dist.destroy_process_group()
