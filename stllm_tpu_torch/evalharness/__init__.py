"""Eval harness of the port: MVBench. The open-ended VideoQA, VCG-Bench and
GPT-judge harnesses come with a later slice."""

from stllm_tpu_torch.evalharness.mvbench import (
    DATA_LIST,
    MVBenchDataset,
    check_ans,
    infer_mvbench,
    infer_mvbench_batch,
    infer_mvbench_serving,
    run_mvbench,
)

__all__ = [
    "DATA_LIST",
    "MVBenchDataset",
    "check_ans",
    "infer_mvbench",
    "infer_mvbench_batch",
    "infer_mvbench_serving",
    "run_mvbench",
]
