#!/bin/bash
# The port's launcher of script/inference/vcgbench/score_correct.sh (run from the repository root).
# (reference: script/inference/vcgbench/score_correct.sh — GPT-3.5 judge, rubric "correctness")
python -m stllm_tpu_torch.evalharness.gpt_eval --rubric correctness \
  --pred_path "${PRED:-output/vcg/vcg_pred.json}" \
  --output_dir "${OUT_DIR:-output/vcg/correctness}" \
  --output_json "${OUT_DIR:-output/vcg/correctness}/correctness.json" \
  --api_key "${OPENAI_API_KEY:?set OPENAI_API_KEY}" \
  --num_tasks "${NUM_TASKS:-3}" "$@"
