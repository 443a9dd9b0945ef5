#!/bin/bash
# The port's launcher of script/inference/vcgbench/score_context.sh (run from the repository root).
# (reference: script/inference/vcgbench/score_context.sh — GPT-3.5 judge, rubric "context")
python -m stllm_tpu_torch.evalharness.gpt_eval --rubric context \
  --pred_path "${PRED:-output/vcg/vcg_pred.json}" \
  --output_dir "${OUT_DIR:-output/vcg/context}" \
  --output_json "${OUT_DIR:-output/vcg/context}/context.json" \
  --api_key "${OPENAI_API_KEY:?set OPENAI_API_KEY}" \
  --num_tasks "${NUM_TASKS:-3}" "$@"
