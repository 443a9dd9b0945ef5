#!/bin/bash
# The port's launcher of script/inference/qabench/score_msrvtt.sh (run from the repository root).
# (reference: script/inference/qabench/score_msrvtt.sh — GPT-3.5 yes/no + 0-5 score judge)
python -m stllm_tpu_torch.evalharness.gpt_eval --rubric activitynet_qa \
  --pred_path "${PRED:-output/msrvtt/msrvtt_pred.json}" \
  --output_dir "${OUT_DIR:-output/msrvtt/qa_judge}" \
  --output_json "${OUT_DIR:-output/msrvtt/qa_judge}/msrvtt_qa.json" \
  --api_key "${OPENAI_API_KEY:?set OPENAI_API_KEY}" \
  --num_tasks "${NUM_TASKS:-3}" "$@"
