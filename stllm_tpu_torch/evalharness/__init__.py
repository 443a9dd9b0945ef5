"""Eval harness of the port: MVBench, open-ended VideoQA, VCG-Bench and the
GPT judges."""

from stllm_tpu_torch.evalharness.gpt_eval import RUBRICS, evaluate as gpt_evaluate
from stllm_tpu_torch.evalharness.mvbench import (
    DATA_LIST,
    MVBenchDataset,
    check_ans,
    infer_mvbench,
    infer_mvbench_batch,
    infer_mvbench_serving,
    run_mvbench,
)
from stllm_tpu_torch.evalharness.qabench import (
    run_vcgbench_consistency,
    run_vcgbench_general,
    run_videoqa,
)

__all__ = [
    "DATA_LIST",
    "MVBenchDataset",
    "RUBRICS",
    "check_ans",
    "gpt_evaluate",
    "infer_mvbench",
    "infer_mvbench_batch",
    "infer_mvbench_serving",
    "run_mvbench",
    "run_vcgbench_consistency",
    "run_vcgbench_general",
    "run_videoqa",
]
