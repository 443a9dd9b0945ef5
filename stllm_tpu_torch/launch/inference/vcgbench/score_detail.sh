#!/bin/bash
# The port's launcher of script/inference/vcgbench/score_detail.sh (run from the repository root).
# (reference: script/inference/vcgbench/score_detail.sh — GPT-3.5 judge, rubric "detailed_orientation")
python -m stllm_tpu_torch.evalharness.gpt_eval --rubric detailed_orientation \
  --pred_path "${PRED:-output/vcg/vcg_pred.json}" \
  --output_dir "${OUT_DIR:-output/vcg/detailed_orientation}" \
  --output_json "${OUT_DIR:-output/vcg/detailed_orientation}/detailed_orientation.json" \
  --api_key "${OPENAI_API_KEY:?set OPENAI_API_KEY}" \
  --num_tasks "${NUM_TASKS:-3}" "$@"
