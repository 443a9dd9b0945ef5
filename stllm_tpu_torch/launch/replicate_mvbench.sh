#!/usr/bin/env bash
# The real-weights MVBench replication gate on the port (the JAX package's
# launcher: script/replicate_mvbench.sh): convert the torch checkpoints,
# verify logit parity against recorded goldens, run the 20-task MVBench
# harness. Real run:
#   stllm_tpu_torch/launch/replicate_mvbench.sh \
#     --cfg config/instructblipbase_stllm_qa.yaml \
#     --llama /ckpts/vicuna-7b-v1.1 \
#     --qformer /ckpts/instruct_blip_vicuna7b_trimmed.pth \
#     --ckpt /ckpts/stllm_instructblip_qa.pth \
#     --anno /data/MVBench/json --data-root /data/MVBench/video
# Dry run (no weights; synthetic tiny checkpoints, the same three stages):
#   stllm_tpu_torch/launch/replicate_mvbench.sh --dry-run
set -euo pipefail
cd "$(dirname "$0")/../.."
exec python -m stllm_tpu_torch.replicate_mvbench "$@"
