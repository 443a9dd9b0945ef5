#!/bin/bash
# The port's launcher of script/train/train.sh (run from the repository root).
# Training launcher (reference: script/train/train.sh — deepspeed over 8 GPUs
# becomes one process per card: torchrun --nproc-per-node N -m ... with
# --data-parallel and --model-parallel laying out the mesh).
python -m stllm_tpu_torch.train.train --cfg-path config/instructblipbase_stllm_qa.yaml "$@"
