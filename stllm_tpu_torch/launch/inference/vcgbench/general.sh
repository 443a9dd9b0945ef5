#!/bin/bash
# The port's launcher of script/inference/vcgbench/general.sh (run from the repository root).
python -m stllm_tpu_torch.evalharness.qabench --bench vcg_general --batch-videos "${BATCH_VIDEOS:-1}" \
  --cfg-path config/instructblipbase_stllm_qa.yaml \
  --ckpt-path "${CKPT:?set CKPT}" \
  --gt_file "${GT_FILE:?set GT_FILE}" --video_dir "${VIDEO_DIR:?set VIDEO_DIR}" \
  --num-frames 64 --num-beams 5 \
  --output_dir output/vcg --output_name vcg_pred "$@"
