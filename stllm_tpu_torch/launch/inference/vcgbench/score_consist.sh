#!/bin/bash
# The port's launcher of script/inference/vcgbench/score_consist.sh (run from the repository root).
# (reference: script/inference/vcgbench/score_consist.sh — GPT-3.5 judge, rubric "consistency")
python -m stllm_tpu_torch.evalharness.gpt_eval --rubric consistency \
  --pred_path "${PRED:-output/vcg/vcg_consist_pred.json}" \
  --output_dir "${OUT_DIR:-output/vcg/consistency}" \
  --output_json "${OUT_DIR:-output/vcg/consistency}/consistency.json" \
  --api_key "${OPENAI_API_KEY:?set OPENAI_API_KEY}" \
  --num_tasks "${NUM_TASKS:-3}" "$@"
