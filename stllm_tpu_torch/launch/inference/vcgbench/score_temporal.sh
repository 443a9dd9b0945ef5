#!/bin/bash
# The port's launcher of script/inference/vcgbench/score_temporal.sh (run from the repository root).
# (reference: script/inference/vcgbench/score_temporal.sh — GPT-3.5 judge, rubric "temporal")
python -m stllm_tpu_torch.evalharness.gpt_eval --rubric temporal \
  --pred_path "${PRED:-output/vcg/vcg_temporal_pred.json}" \
  --output_dir "${OUT_DIR:-output/vcg/temporal}" \
  --output_json "${OUT_DIR:-output/vcg/temporal}/temporal.json" \
  --api_key "${OPENAI_API_KEY:?set OPENAI_API_KEY}" \
  --num_tasks "${NUM_TASKS:-3}" "$@"
