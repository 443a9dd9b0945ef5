#!/bin/bash
# The port's launcher of script/inference/mvbench/test_mvbench.sh (run from the repository root).
# (reference: script/inference/mvbench/test_mvbench.sh — fps-1 adaptive
# sampling via --num-frames 0, simple prompt mode)
python -m stllm_tpu_torch.evalharness.mvbench \
  --cfg-path config/instructblipbase_stllm_qa.yaml \
  --ckpt-path "${CKPT:?set CKPT}" \
  --anno-path "${MVBENCH_JSON:?set MVBENCH_JSON}" \
  --data-root "${MVBENCH_DATA:?set MVBENCH_DATA}" \
  --num-frames 0 --ask_simple \
  --output_dir output/mvbench --output_name mvbench "$@"
